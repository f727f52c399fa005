"""The transducer lattice's share of its roofline: the least time of one K3
and one K4 call (``k3_work``, ``k4_work``; float32 operations at 67
TFLOP/s or bytes) over the device time of the kernels named K3 and K4."""

LAYER = "Lattices: ops/rnnt.py K3/K4, ops/ctc.py K7/K8"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "train_audio_s_per_s"


def read(w):
    if w.entry != "train":
        return None
    return w.roofline(["k3", "k4"])
