"""K1's share of its roofline in a transcribed batch: the least time of the
K1 work of every LSTM call of a batch (``k1_work``) over the device time
of the kernels that the trace names K1."""

LAYER = "Recurrent layers: ops/rnn.py lstm_scan, K1/K2"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "serve_audio_s_per_s"


def read(w):
    if w.entry != "serve":
        return None
    return w.roofline(["k1"])
