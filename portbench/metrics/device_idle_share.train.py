"""The share of the traced window of train steps in which no kernel, copy
or memset runs on the card."""

LAYER = "Device: one H100"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
MOVES = "train_audio_s_per_s"


def read(w):
    if w.entry != "train":
        return None
    return w.idle_share()
