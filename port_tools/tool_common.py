"""What the port's measurement tools share: the device, the card's line,
CUDA-event times, a traced run, and the kernels' plain versions on demand.

Each tool runs on the card unless the caller asks for the CPU
(``--device cpu``, the tests'); a card that is asked for and missing raises,
never falls back.  A time taken on the CPU is the host's clock and is
printed with the device it ran on.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import tempfile
import time
from typing import Callable, Iterator, Optional, Tuple

import torch

# The kernel wrappers a tool can swap for their plain versions, by module.
KERNELS = {
    "lstm": ("lstm_kernel", ("lstm_fwd", "lstm_bwd")),
    "rnnt": ("rnnt_kernel", ("rnnt_lattice_fwd", "rnnt_lattice_bwd")),
    "joint": ("joint_kernel", ("joint_tail_fwd", "joint_tail_bwd")),
    "ctc": ("ctc_kernel", ("ctc_lattice_fwd", "ctc_lattice_bwd")),
}


def device_of(name: str) -> torch.device:
    """``name`` as a torch device (``run/infer.py::resolve_device``: a CUDA
    device without a card raises), made current with an index."""
    from myrtlespeech_tpu_torch.run.infer import resolve_device

    dev = resolve_device(name)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        # Float32 products in full float32, as the port's entry points set.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def card_line(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them (and the
    versions), or the CPU's mark: every printed time names its device."""
    out = {"device": str(dev), "torch": torch.__version__}
    if dev.type == "cuda":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        out["cuda"] = torch.version.cuda
        out["kind"] = torch.cuda.get_device_name(dev)
    return out


def print_card(dev: torch.device) -> None:
    print(json.dumps({"card": card_line(dev)}), flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_ms(fn: Callable[[], object], dev: torch.device, reps: int = 5,
              warmup: int = 1) -> float:
    """Median ms of ``fn`` over ``reps`` runs after ``warmup``: CUDA events
    on the card (the device's time for the launches ``fn`` makes), the
    host's clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(dev)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def traced(fn: Callable[[], object], dev: torch.device,
           logdir: Optional[str] = None) -> Tuple[float, str]:
    """Run ``fn`` once under ``torch.profiler`` (the CPU and, on the card,
    CUDA) and write its Chrome trace under ``logdir`` (a new temporary
    directory when None), where ``utils/trace.py`` reads it.  Returns the
    host ms of the run (synchronised at both ends) and the directory."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    logdir = logdir or tempfile.mkdtemp(prefix="myrtle_trace_")
    os.makedirs(logdir, exist_ok=True)
    sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    prof.export_chrome_trace(os.path.join(
        logdir, f"capture_{time.time_ns()}.pt.trace.json"))
    return wall_ms, logdir


@contextlib.contextmanager
def plain_versions(*kinds: str) -> Iterator[None]:
    """Run the plain PyTorch versions of the named kernels (``KERNELS``:
    ``lstm``, ``rnnt``, ``joint``, ``ctc``) in place of the kernels while
    entered, on any device: an explicit A/B, never a fallback (their
    callers look the wrappers up at call time)."""
    import importlib

    swaps = []
    for kind in kinds:
        mod_name, fns = KERNELS[kind]
        mod = importlib.import_module(
            f"myrtlespeech_tpu_torch.ops.cuda.{mod_name}")
        for fn in fns:
            swaps.append((mod, fn, getattr(mod, fn)))
    try:
        for mod, fn, _ in swaps:
            setattr(mod, fn, getattr(mod, f"{fn}_reference"))
        yield
    finally:
        for mod, fn, real in swaps:
            setattr(mod, fn, real)


# The work of one call of each kernel wrapper, from its arguments
# (``utils/roofline.py``): ``(kernel, operations, bytes, peak)``.
def _call_work(kind: str, fn: str, a: dict):
    from myrtlespeech_tpu_torch.utils import roofline as R

    if fn == "lstm_fwd":
        T, B, H4 = a["x_proj"].shape
        return ("k1",) + R.k1_work(T, B, H4 // 4, a.get("b") is not None) \
            + (R.PEAK_BF16_FLOPS,)
    if fn == "lstm_bwd":
        T, B, H4 = a["ifgo"].shape
        return ("k2",) + R.k2_work(T, B, H4 // 4, bool(a.get("need_dh0",
                                                             True))) \
            + (R.PEAK_BF16_FLOPS,)
    if kind == "rnnt":
        B, T, U1 = a["lp_blank"].shape
        work = R.k3_work if fn.endswith("fwd") else R.k4_work
        return ("k3" if fn.endswith("fwd") else "k4",) + work(B, T, U1) \
            + (R.PEAK_FP32_FLOPS,)
    if kind == "joint":
        B, T, K = a["fp"].shape
        U1, V = a["gp"].shape[1], a["w2"].shape[1]
        k5, k6 = R.k56_work(B, T, U1, K, V, a["fp"].element_size(),
                            a["w2"].element_size())
        return (("k5",) + k5 if fn.endswith("fwd") else ("k6",) + k6) \
            + (R.PEAK_BF16_FLOPS,)
    B, T, S = a["lp_ext"].shape
    k7, k8 = R.k78_work(B, T, S)
    return (("k7",) + k7 if fn.endswith("fwd") else ("k8",) + k8) \
        + (R.PEAK_FP32_FLOPS,)


class _Recorded:
    """A kernel wrapper that records each call's work, then runs it.  Its
    ``launches`` is the wrapper's own counter, which the wrapper bumps
    through its module's name."""

    def __init__(self, kind: str, fn: str, real, calls: dict):
        import inspect

        self._kind, self._fn, self._real, self._calls = kind, fn, real, calls
        self._sig = inspect.signature(real)

    @property
    def launches(self):
        return self._real.launches

    @launches.setter
    def launches(self, n):
        self._real.launches = n

    def __call__(self, *args, **kwargs):
        k, flops, nbytes, peak = _call_work(
            self._kind, self._fn, self._sig.bind(*args, **kwargs).arguments)
        self._calls.setdefault(k, []).append((flops, nbytes, peak))
        return self._real(*args, **kwargs)


@contextlib.contextmanager
def kernel_work(calls: dict) -> Iterator[dict]:
    """While entered, every call of a kernel wrapper (or of the plain
    version in its place) appends ``(operations, bytes, peak)`` to
    ``calls[kernel]`` (``k1`` ... ``k8``), then runs."""
    import importlib

    swaps = []
    for kind, (mod_name, fns) in KERNELS.items():
        mod = importlib.import_module(
            f"myrtlespeech_tpu_torch.ops.cuda.{mod_name}")
        for fn in fns:
            swaps.append((kind, mod, fn, getattr(mod, fn)))
    try:
        for kind, mod, fn, real in swaps:
            setattr(mod, fn, _Recorded(kind, fn, real, calls))
        yield calls
    finally:
        for _, mod, fn, real in swaps:
            setattr(mod, fn, real)


def bound_of(calls) -> Tuple[float, str]:
    """``utils/roofline.py::bound`` of the summed work of ``calls``
    (``[(operations, bytes, peak)]``, one peak)."""
    from myrtlespeech_tpu_torch.utils.roofline import bound

    return bound(sum(c[0] for c in calls), sum(c[1] for c in calls),
                 peak=calls[0][2])
