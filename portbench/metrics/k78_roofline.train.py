"""The CTC lattice's share of its roofline: the least time of one K7 and one
K8 call (``k78_work``; float32 operations at 67 TFLOP/s or bytes) over
the device time of the kernels named K7 and K8."""

LAYER = "Lattices: ops/rnnt.py K3/K4, ops/ctc.py K7/K8"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "train_audio_s_per_s"


def read(w):
    if w.entry != "train":
        return None
    return w.roofline(["k7", "k8"])
