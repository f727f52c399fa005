"""Self time by operation from a ``torch.profiler`` capture.

The port of ``myrtlespeech_tpu/utils/trace.py``.  A capture is the Chrome
trace that ``torch.profiler.tensorboard_trace_handler`` (and
``run/callbacks.py::ProfilerCallback``) writes, ``*.pt.trace.json[.gz]``.
Only the newest capture under a directory counts, newest by modification
time (the JAX package's picks the largest name, which is not always the
newest): summing stale captures would multiply every figure.

Events are grouped by lane (``(pid, tid)``: a card's stream, a host
thread); within a lane an event's self time is its duration less its
children's, so nested spans (a host op and the ops it calls) are counted
once.  The card's lanes hold the categories in ``DEVICE_CATEGORIES``.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import List, Optional, Sequence, Tuple

Row = Tuple[str, str, float]  # (name, category, self us)

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def newest_capture(logdir: str) -> Optional[str]:
    """The most recently modified capture under ``logdir``, or None."""
    paths = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json*"),
                      recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def _events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _spans(logdir: str, categories: Sequence[str]):
    path = newest_capture(logdir)
    if path is None:
        return None
    return [e for e in _events(path)
            if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in categories]


def aggregate_trace(logdir: str,
                    categories: Sequence[str] = DEVICE_CATEGORIES
                    ) -> Optional[List[Row]]:
    """The self time of each event of ``categories`` in the newest capture
    under ``logdir``; None without a capture or without such events."""
    spans = _spans(logdir, categories)
    if not spans:
        return None
    lanes = {}
    for e in spans:
        lanes.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    rows: List[Row] = []
    for evs in lanes.values():
        rows.extend(_self_time_rows(evs))
    return rows


def _self_time_rows(events) -> List[Row]:
    """One lane's spans as self-time rows: a span's duration less that of
    its immediate children (a nesting sweep over start-sorted spans)."""
    evs = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    out: List[Row] = []
    stack = []  # [end_ts, self_us, event]

    def emit(frame):
        e = frame[2]
        out.append((e["name"], e.get("cat", "?"), max(frame[1], 0.0)))

    for e in evs:
        ts, dur = e["ts"], e["dur"]
        while stack and stack[-1][0] <= ts + 1e-9:
            emit(stack.pop())
        if stack:  # nested: subtract from the parent's self time
            stack[-1][1] -= dur
        stack.append([ts + dur, float(dur), e])
    while stack:
        emit(stack.pop())
    return out


def busy_ms(logdir: str,
            categories: Sequence[str] = DEVICE_CATEGORIES) -> Optional[float]:
    """The ms in which at least one event of ``categories`` ran (the union of
    their intervals) in the newest capture: with a window's wall time, the
    device's idle share is ``1 - busy / wall``."""
    spans = _spans(logdir, categories)
    if not spans:
        return None
    total, end = 0.0, float("-inf")
    for e in sorted(spans, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3
