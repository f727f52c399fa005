"""Analytic work of ``deep_speech_1_en`` at a cell's shapes: the model
FLOPs of a forward (the five dense products and both LSTM directions'
input and recurrent products; a train step counts the backward as twice
the forward, as ``rnn_t_en.py`` does) and the work of each kernel call
(``kernels.py``).  ``shape``: ``B`` rows, ``T0`` frames, ``U1`` the label
positions plus one (the CTC lattice holds ``2 (U1 - 1) + 1`` states).
"""

from __future__ import annotations

from portbench.work import kernels as K


def flop_entries(cfg: dict, B: int, T: int) -> dict:
    H, V = cfg["model"]["n_hidden"], cfg["vocab_size"]
    feat = cfg["features"]
    F = feat["n_mfcc"] * (2 * feat["context_frames"] + 1)
    rows = 2 * B * T
    return {"dense 0-2": rows * (F * H + 2 * H * H),
            "BiLSTM": 2 * rows * (H * 4 * H + H * 4 * H),
            "dense 3-4": rows * (2 * H * H + H * V)}


def model_flops(cfg: dict, shape: dict, train: bool) -> float:
    fwd = sum(flop_entries(cfg, shape["B"], shape["T0"]).values())
    return 3.0 * fwd if train else float(fwd)


def kernel_work(cfg: dict, shape: dict, train: bool) -> dict:
    B, T = shape["B"], shape["T0"]
    H = cfg["model"]["n_hidden"]
    bf16, fp32 = K.PEAK_BF16_FLOPS, K.PEAK_FP32_FLOPS
    out = {"k1": [K.k1_work(T, B, H) + (bf16,)] * 2}
    if not train:
        return out
    S = 2 * (shape["U1"] - 1) + 1
    k7, k8 = K.k78_work(B, T, S)
    out["k2"] = [K.k2_work(T, B, H) + (bf16,)] * 2
    out["k7"] = [k7 + (fp32,)]
    out["k8"] = [k8 + (fp32,)]
    return out
