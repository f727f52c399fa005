"""Device ms a step in the products bucket (cuBLAS and cuDNN kernels: the
projections, the joint, the dense layers)."""

from portbench.harness.profile import PRODUCTS

LAYER = "Products: cuBLAS"
SOURCE = "device_trace"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_audio_s_per_s"


def read(w):
    if w.entry != "train":
        return None
    return w.bucket_ms(PRODUCTS)
