"""Device kernels a step: the kernel events of the traced window over its
steps (copies and memsets not counted)."""

LAYER = "Host dispatch"
SOURCE = "device_trace"
UNIT = "count"
BETTER = "lower"
MOVES = "train_audio_s_per_s"


def read(w):
    if w.entry != "train":
        return None
    return w.trace.kernel_count() / w.units
