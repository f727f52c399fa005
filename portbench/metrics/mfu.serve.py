"""The whole batch's share of the bf16 peak: the analytic FLOPs of a
forward (``portbench/work/<config>.py``) times the batches of the traced
window, over the window's host time, over 989 TFLOP/s."""

LAYER = "Serve entry: run/infer.py Transcriber.transcribe"
SOURCE = "host_clock"
UNIT = "%"
BETTER = "higher"
MOVES = "serve_audio_s_per_s"


def read(w):
    if w.entry != "serve":
        return None
    return w.mfu()
