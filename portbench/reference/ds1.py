"""Plain reference of DeepSpeech1 (the family of ``deep_speech_1_en``),
from the configuration's sizes alone: its train step and its logits.

MFCC -> standardise -> context frames -> 3 x (dense, ReLU clipped at
``relu_clip``, dropout) -> bidirectional LSTM (both directions' outputs
side by side) -> dense, clipped ReLU, dropout -> dense to the vocabulary;
the CTC loss (``F.ctc_loss`` in float64, each row's loss over its label
count, then the batch mean), clipping, L2 and Adam (``common.py``).
Dropout draws one uniform a site and entry from a generator on the card,
site after site in the order above, as the configuration's model states.
"""

from __future__ import annotations

import torch

from portbench.reference import common as C


def param_spec(cfg: dict) -> list:
    m = cfg["model"]
    H, V = m["n_hidden"], cfg["vocab_size"]
    f_in = cfg["features"]["n_mfcc"] * (2 * cfg["features"]["context_frames"]
                                        + 1)
    spec = C.dense_spec("Dense_0", f_in, H) + C.dense_spec("Dense_1", H, H) \
        + C.dense_spec("Dense_2", H, H)
    spec += C.lstm_spec("RNN_0.l0_fwd", H, H, m["forget_gate_bias"])
    spec += C.lstm_spec("RNN_0.l0_bwd", H, H, m["forget_gate_bias"])
    return spec + C.dense_spec("Dense_3", 2 * H, H) \
        + C.dense_spec("Dense_4", H, V)


def logits(P, x, lens, cfg: dict, prec: str, gen=None):
    """``x (B, T, F)`` features -> ``(B, T, V)``; dropout where ``gen`` is
    given (train)."""
    m = cfg["model"]
    cdt = getattr(torch, cfg["compute_dtype"])

    def hidden(name, y):
        y = torch.clamp(C.mm(y, P[name + ".kernel"], prec)
                        + P[name + ".bias"], 0.0, m["relu_clip"])
        return y if gen is None else C.dropout(y, m["drop_prob"], gen, cdt)

    y = x
    for name in ("Dense_0", "Dense_1", "Dense_2"):
        y = hidden(name, y)
    f = C.lstm(y, lens, P["RNN_0.l0_fwd_w_ih"], P["RNN_0.l0_fwd_w_hh"],
               P["RNN_0.l0_fwd_b"], prec)
    b = C.lstm(y, lens, P["RNN_0.l0_bwd_w_ih"], P["RNN_0.l0_bwd_w_hh"],
               P["RNN_0.l0_bwd_b"], prec, reverse=True)
    y = hidden("Dense_3", torch.cat([f, b], dim=-1))
    return C.mm(y, P["Dense_4.kernel"], prec) + P["Dense_4.bias"]


def ctc_loss(lg, lens, labels, label_lens, blank: int):
    lp = torch.log_softmax(lg.double(), dim=-1).transpose(0, 1)
    nll = torch.nn.functional.ctc_loss(
        lp, labels.long(), lens.long(), label_lens.long(), blank=blank,
        reduction="none", zero_infinity=False)
    return (nll / torch.clamp(label_lens.to(nll.device), min=1)).mean()


def make_step(cfg: dict, prec: str, gen: torch.Generator):
    def step(params, batch, i):
        P = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.no_grad():
            x, frames = C.features(batch["wav"], batch["wav_lens"],
                                   cfg["features"])
        loss = ctc_loss(logits(P, x, frames, cfg, prec, gen), frames,
                        batch["labels"], batch["label_lens"],
                        cfg["blank_index"])
        loss.backward()
        return loss.detach(), {k: v.grad for k, v in P.items()}

    return step


def dropout_generator(seed: int, device) -> torch.Generator:
    """The dropout stream of a train state seeded with ``seed``: a
    generator on the model's device seeded with ``seed ^ 0x64726F70``."""
    return torch.Generator(device=device).manual_seed(seed ^ 0x64726F70)


def train_readings(cfg: dict, params, batches, seed: int, prec: str = "fp32",
                   steps: int = 3) -> dict:
    C.no_tf32()
    gen = dropout_generator(seed, next(iter(params.values())).device)
    return C.train_readings(make_step(cfg, prec, gen), params, batches,
                            cfg["optimizer"], steps)


@torch.no_grad()
def serve_logits(cfg: dict, params, wav, lens, prec: str = "fp32"):
    """``(logits (B, T, V) float32, frames (B,))`` in eval mode."""
    C.no_tf32()
    x, frames = C.features(wav, lens, cfg["features"])
    return logits(params, x, frames, cfg, prec).float(), frames
