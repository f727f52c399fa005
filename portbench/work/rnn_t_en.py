"""Analytic work of ``rnn_t_en`` at a cell's shapes: the model FLOPs of a
step (frozen from the port's ``port_tools/roofline.py``: the LSTM products,
the factored joint's hidden layer and its logits, forward only) and the
work of each kernel call that those shapes need (``kernels.py``).

``shape``: ``B`` rows, ``T0`` feature frames (``samples // hop + 1``),
``U1`` label positions plus the start; ``joint_tail``: whether the step's
joint runs in K5/K6 (then no product of the joint is counted twice: the
FLOPs count the model, not the route).
"""

from __future__ import annotations

from portbench.work import kernels as K


def lstm_flops(T, B, F, H, layers):
    """Forward FLOPs of a unidirectional LSTM stack (products only)."""
    total = 0
    fin = F
    for _ in range(layers):
        total += 2 * T * B * fin * 4 * H      # x W_ih
        total += 2 * T * B * H * 4 * H        # h W_hh
        fin = H
    return total


def flop_entries(cfg: dict, B: int, T0: int, U1: int) -> dict:
    enc, pred = cfg["encoder"], cfg["prediction"]
    r = enc["time_reduction_factor"]
    T1 = (T0 + r - 1) // r
    He, Hp = enc["hidden_size"], pred["hidden_size"]
    Hj, V = cfg["joint"]["hidden_size"], cfg["vocab_size"]
    f = {}
    f["encoder pre-reduction LSTMs"] = lstm_flops(
        T0, B, cfg["features"]["n_mels"], He, enc["rnn1_layers"])
    f["encoder post-reduction LSTMs"] = lstm_flops(
        T1, B, He * r, He, enc["rnn2_layers"])
    f["prediction net"] = lstm_flops(U1, B, pred["embedding_dim"], Hp,
                                     pred["layers"])
    f["joint hidden (factored)"] = 2 * B * (T1 * He + U1 * Hp) * Hj
    f["joint logits"] = 2 * B * T1 * U1 * Hj * V
    return f


def model_flops(cfg: dict, shape: dict, train: bool) -> float:
    """A step's model FLOPs: the forward, and twice it for the backward."""
    fwd = sum(flop_entries(cfg, shape["B"], shape["T0"], shape["U1"])
              .values())
    return 3.0 * fwd if train else float(fwd)


def kernel_work(cfg: dict, shape: dict, train: bool) -> dict:
    """``{kernel: [(operations, bytes, peak FLOP/s), ...]}``, one entry a
    call of a step."""
    enc, pred = cfg["encoder"], cfg["prediction"]
    B, T0, U1 = shape["B"], shape["T0"], shape["U1"]
    r = enc["time_reduction_factor"]
    T1 = (T0 + r - 1) // r
    He, Hp = enc["hidden_size"], pred["hidden_size"]
    calls = ([(T0, He)] * enc["rnn1_layers"] + [(T1, He)] * enc["rnn2_layers"]
             + [(U1, Hp)] * pred["layers"])
    bf16, fp32 = K.PEAK_BF16_FLOPS, K.PEAK_FP32_FLOPS
    out = {"k1": [K.k1_work(T, B, H) + (bf16,) for T, H in calls]}
    if not train:
        return out
    out["k2"] = [K.k2_work(T, B, H) + (bf16,) for T, H in calls]
    out["k3"] = [K.k3_work(B, T1, U1) + (fp32,)]
    out["k4"] = [K.k4_work(B, T1, U1) + (fp32,)]
    if shape.get("joint_tail"):
        k5, k6 = K.k56_work(B, T1, U1, cfg["joint"]["hidden_size"],
                            cfg["vocab_size"])
        out["k5"] = [k5 + (bf16,)]
        out["k6"] = [k6 + (bf16,)]
    return out
