"""K2's share of its roofline in a train step: the least time of the K2
work of every LSTM call of a step (``k2_work``) over the device time of
the kernels that the trace names K2."""

LAYER = "Recurrent layers: ops/rnn.py lstm_scan, K1/K2"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "train_audio_s_per_s"


def read(w):
    if w.entry != "train":
        return None
    return w.roofline(["k2"])
