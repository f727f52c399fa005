"""Device ms a step in PyTorch's elementwise and reduction kernels
(features, masks, dropout, SpecAugment, the optimizer)."""

from portbench.harness.profile import GLUE

LAYER = "Glue: PyTorch elementwise and reductions"
SOURCE = "device_trace"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_audio_s_per_s"


def read(w):
    if w.entry != "train":
        return None
    return w.bucket_ms(GLUE)
