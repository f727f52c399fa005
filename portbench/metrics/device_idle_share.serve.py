"""The share of the traced window of transcribed batches in which no
kernel, copy or memset runs on the card."""

LAYER = "Device: one H100"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
MOVES = "serve_audio_s_per_s"


def read(w):
    if w.entry != "serve":
        return None
    return w.idle_share()
