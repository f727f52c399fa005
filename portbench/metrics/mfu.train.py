"""The whole step's share of the bf16 peak: the analytic model FLOPs of
a step (``portbench/work/<config>.py``; forward and backward, the
backward counted as twice the forward, no recomputation counted) times
the steps of the traced window, over the window's host time, over 989
TFLOP/s."""

LAYER = "Train entry: run/train.py make_train_step"
SOURCE = "host_clock"
UNIT = "%"
BETTER = "higher"
MOVES = "train_audio_s_per_s"


def read(w):
    if w.entry != "train":
        return None
    return w.mfu()
