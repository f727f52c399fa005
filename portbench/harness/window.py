"""What a traced window hands the per-layer metrics' readers.

A reader (``portbench/metrics/<name>.py``) gets one :class:`Window` and
returns a number, or None where it finds nothing to read: then the harness
leaves the metric out of the line.  A share of a roofline is never 0 for
want of a reading, and never capped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from portbench.harness.profile import Trace
from portbench.work import kernels as K


@dataclasses.dataclass
class Window:
    entry: str                      # "train" or "serve"
    units: int                      # steps or batches completed
    window_s: float                 # first to last harness span, s
    trace: Trace
    model_flops: float              # a unit's analytic model FLOPs
    work: Dict[str, List[Tuple[float, float, float]]]  # a unit's calls

    def busy_s(self) -> float:
        return self.trace.busy_s()

    def least_s(self, kernels) -> Tuple[float, str]:
        """A unit's least seconds for the calls of ``kernels``, and what
        bounds most of it (operations or bytes)."""
        ops = by = 0.0
        for k in kernels:
            for flops, nbytes, peak in self.work.get(k, []):
                o, b = flops / peak, nbytes / K.PEAK_BYTES
                ops += o if o >= b else 0.0
                by += b if b > o else 0.0
        return ops + by, ("operations" if ops >= by else "bytes")

    def roofline(self, kernels) -> Optional[float]:
        """Percent: the least time of the calls of ``kernels`` over the
        device time of the events that the trace names so; None without
        such work or such events."""
        least, _ = self.least_s(kernels)
        secs = self.trace.kernel_seconds()
        spent = sum(secs.get(k, 0.0) for k in kernels) / self.units
        if least <= 0.0 or spent <= 0.0:
            return None
        return 100.0 * least / spent

    def bucket_ms(self, bucket: str) -> Optional[float]:
        s = self.trace.bucket_seconds().get(bucket)
        return None if s is None else 1e3 * s / self.units

    def mfu(self) -> Optional[float]:
        """Percent of the bf16 peak: the units' model FLOPs over the
        window."""
        if self.model_flops <= 0.0:
            return None
        return 100.0 * self.model_flops * self.units / self.window_s \
            / K.PEAK_BF16_FLOPS

    def idle_share(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)
