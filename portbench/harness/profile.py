"""The traced window: ``torch.profiler`` over the window, and what the
per-layer metrics read from it.

The harness puts ``torch.profiler.record_function`` spans named
``portbench.*`` around its own calls into the program (a batch's upload,
the step, the loss's read, ``transcribe``).  After the window the trace is
written as a Chrome trace to a temporary directory, read and deleted.  From
it come the device's events (kernels, copies, memsets) inside the window,
their union (the device's busy time), each kernel's bucket (a frozen copy
of ``port_tools/profile_kernels.py``'s ``BUCKETS``) and the breakdown:
the device operations that took the most time, and the longest idle gaps
with the host span that was open at the middle of each.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gzip
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."
NAME_CHARS = 160  # of a kernel's name in the breakdown

# (bucket, the port's kernel it is, substrings of its kernels' names), in
# the order a name is matched.
BUCKETS = (
    ("K1 persistent", "k1", ("lstm_fwd_persistent_kernel",)),
    ("K2 persistent", "k2", ("lstm_bwd_persistent_kernel",)),
    ("K1 wide", "k1", ("lstm_fwd_wide_kernel",)),
    ("K2 wide", "k2", ("lstm_bwd_wide_kernel",)),
    ("K1 per-step", "k1", ("lstm_step_kernel",)),
    ("K2 per-step", "k2", ("lstm_bwd_step_kernel",)),
    ("K3 transducer lattice fwd", "k3", ("rnnt_fwd_kernel",)),
    ("K4 transducer lattice bwd", "k4", ("rnnt_bwd_kernel",)),
    ("K5 joint tail fwd", "k5", ("joint_tail_fwd_kernel",)),
    ("K6 joint tail bwd", "k6", ("joint_tail_bwd_kernel",)),
    ("K7 CTC lattice fwd", "k7", ("ctc_fwd_kernel",)),
    ("K8 CTC lattice bwd", "k8", ("ctc_bwd_kernel",)),
    ("cuBLAS/cuDNN products", None,
     ("gemm", "gemv", "nvjet", "cublas", "cutlass", "xmma", "cudnn",
      "conv", "fprop", "dgrad", "wgrad", "sm90_", "sm80_", "splitk")),
    ("copies and memsets", None, ("memcpy", "memset")),
    ("elementwise and reductions", None,
     ("elementwise", "vectorized", "reduce", "unrolled", "scatter",
      "gather", "index", "softmax", "cat", "copy", "fill", "where",
      "at::native")),
)
PRODUCTS = "cuBLAS/cuDNN products"
GLUE = "elementwise and reductions"


def bucket(name: str) -> Tuple[str, Optional[str]]:
    """``(bucket, kernel or None)`` of a device event's name."""
    n = name.lower()
    for label, kernel, keys in BUCKETS:
        if any(k in n for k in keys):
            return label, kernel
    return "other", None


@dataclasses.dataclass
class Trace:
    """Device events ``(name, category, start us, duration us)`` and host
    spans ``(name, start us, duration us)`` inside the window."""

    device: List[Tuple[str, str, float, float]]
    spans: List[Tuple[str, float, float]]
    start: float
    end: float

    def busy_s(self) -> float:
        """Seconds in which some device event ran (their union)."""
        total, end = 0.0, float("-inf")
        for _, _, ts, dur in sorted(self.device, key=lambda e: e[2]):
            stop = ts + dur
            if stop > end:
                total += stop - max(ts, end)
                end = stop
        return total / 1e6

    def kernel_count(self) -> int:
        return sum(1 for e in self.device if e[1] == "kernel")

    def bucket_seconds(self) -> Dict[str, float]:
        out = collections.defaultdict(float)
        for name, _, _, dur in self.device:
            out[bucket(name)[0]] += dur / 1e6
        return dict(out)

    def kernel_seconds(self) -> Dict[str, float]:
        """Device seconds of each of the port's kernels (``k1`` ...)."""
        out = collections.defaultdict(float)
        for name, _, _, dur in self.device:
            k = bucket(name)[1]
            if k is not None:
                out[k] += dur / 1e6
        return dict(out)

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals of the device inside the window, in us."""
        out, end = [], self.start
        for _, _, ts, dur in sorted(self.device, key=lambda e: e[2]):
            if ts > end:
                out.append((end, ts))
            end = max(end, ts + dur)
        if self.end > end:
            out.append((end, self.end))
        return out

    def span_at(self, t: float) -> str:
        """The innermost ``portbench.*`` span open at ``t``."""
        best = None
        for name, ts, dur in self.spans:
            if ts <= t <= ts + dur and (best is None or dur < best[1]):
                best = (name, dur)
        return best[0] if best else "outside the harness's spans"

    def breakdown(self, n: int = 10) -> dict:
        ops = collections.defaultdict(float)
        for name, _, _, dur in self.device:
            ops[name] += dur / 1e6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k[:NAME_CHARS], v] for k, v in top],
                "idle_gaps": [[self.span_at((a + b) / 2), (b - a) / 1e6]
                              for a, b in gaps]}


def profiler(enabled: bool):
    """A ``torch.profiler.profile`` of the CPU and the card, or a null
    context."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span(name: str):
    from torch.profiler import record_function
    return record_function(SPAN_PREFIX + name)


def read(prof) -> Trace:
    """The window's trace from a finished profiler: the device events that
    overlap the first to the last ``portbench.*`` span."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json.gz")
        prof.export_chrome_trace(path)
        with open(path, "rb") as f:
            zipped = f.read(2) == b"\x1f\x8b"
        with (gzip.open if zipped else open)(path, "rt") as f:
            events = json.load(f).get("traceEvents", [])
    spans = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    if not spans:
        raise RuntimeError("the trace holds none of the harness's spans")
    start = min(s[1] for s in spans)
    end = max(s[1] + s[2] for s in spans)
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        a, b = max(ts, start), min(ts + dur, end)
        if b > a:
            device.append((e["name"], e["cat"], a, b - a))
    return Trace(device=device, spans=spans, start=start, end=end)
