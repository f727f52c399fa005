"""Device kernels a batch: the kernel events of the traced window over its
batches (copies and memsets not counted)."""

LAYER = "Host dispatch"
SOURCE = "device_trace"
UNIT = "count"
BETTER = "lower"
MOVES = "serve_audio_s_per_s"


def read(w):
    if w.entry != "serve":
        return None
    return w.trace.kernel_count() / w.units
