"""K1's share of its roofline in a train step: the least time of the K1
work that the cell's shapes need (every LSTM call of a step,
``portbench/work/kernels.py::k1_work``, each call bound by operations at
the bf16 peak or by bytes at 3.35 TB/s, whichever is larger) over the
device time of the kernels that the trace names K1."""

LAYER = "Recurrent layers: ops/rnn.py lstm_scan, K1/K2"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "train_audio_s_per_s"


def read(w):
    if w.entry != "train":
        return None
    return w.roofline(["k1"])
