"""Roofline of the flagship RNN-T train step on the card.

The port's counterpart of ``tools/roofline.py``.  It counts the analytic
FLOPs of one train step of the port's ``rnn_t_en`` (the JAX tool's model:
the LSTM products, the factored joint's hidden layer and its logits; the
backward taken as twice the forward), then bounds the step on one H100
(``utils/roofline.py``'s peaks): each kernel's least time at this step's
shapes, from the work counts ``chip_smoke.py`` uses (K1/K2 for the five
encoder and two prediction-net layers, K3/K4 for the lattice, and K5/K6,
which run where the memory planner sends the joint to the joint tail), and
the products outside the kernels at the bf16 peak.  With ``--measure`` it
times the step through ``port_tools/profile_step.py`` on the card, or takes
a recorded time with ``--ms-per-step``, and reports the model FLOP/s and
the shares of the peak and of the bound.

Usage:
  python port_tools/roofline.py [--batch 32] [--seconds 5.0] [--measure]
  python port_tools/roofline.py --ms-per-step 40.4     # a recorded time
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = 64  # bench label length, as the JAX tool's U1 = 64 + 1


def lstm_flops(T, B, F, H, layers):
    """Forward FLOPs for a unidirectional LSTM stack (matmuls only).

    Per layer: x_proj (T*B, F)x(F, 4H) hoisted + recurrent (B, H)x(H, 4H)
    per step.  First layer consumes F features, the rest H.
    """
    total = 0
    fin = F
    for _ in range(layers):
        total += 2 * T * B * fin * 4 * H      # x W_ih
        total += 2 * T * B * H * 4 * H        # h W_hh (T sequential steps)
        fin = H
    return total


def flop_entries(cfg, B: int, seconds: float) -> dict:
    """The JAX tool's five forward FLOP entries of one step of ``cfg``."""
    enc = cfg.speech_to_text.model.encoder
    pred = cfg.speech_to_text.model.prediction
    joint = cfg.speech_to_text.model.joint
    n_mels = cfg.speech_to_text.pre_process_steps[0].step.n_mels
    V = len(cfg.speech_to_text.alphabet)

    # Shapes for --seconds of 16 kHz audio, 10 ms hop, reduction factor.
    T0 = int(seconds * 100)                        # frames
    r = enc.time_reduction_factor
    T1 = (T0 + r - 1) // r                          # post-reduction
    U1 = LABELS + 1
    He, Hp = enc.rnn1.hidden_size, pred.rnn.hidden_size
    Hj = joint.fc.hidden_size

    f = {}
    f["encoder pre-reduction LSTMs"] = lstm_flops(
        T0, B, n_mels, He, enc.rnn1.num_layers)
    f["encoder post-reduction LSTMs"] = lstm_flops(
        T1, B, He * r, He, enc.rnn2.num_layers if enc.rnn2 else 0)
    f["prediction net"] = lstm_flops(U1, B, pred.embedding_dim, Hp,
                                     pred.rnn.num_layers)
    cells = B * T1 * U1
    # The joint's first layer is factored: act(f) @ W_f + act(g) @ W_g
    # costs 2*B*(T1*He + U1*Hp)*Hj instead of 2*cells*(He+Hp)*Hj.
    f["joint hidden (factored)"] = 2 * B * (T1 * He + U1 * Hp) * Hj
    f["joint logits"] = 2 * cells * Hj * V
    return f


def kernel_bounds(cfg, B: int, seconds: float) -> dict:
    """Each kernel's least ms for one step on the card at the step's real
    shapes (frames ``samples // hop + 1``, as the features make them):
    ``{kernel: (ms, bound_by, calls)}``."""
    from myrtlespeech_tpu_torch.utils.roofline import (PEAK_FP32_FLOPS,
                                                       bound, k1_work,
                                                       k2_work, k3_work,
                                                       k4_work, k56_work)

    stt = cfg.speech_to_text
    enc, pred = stt.model.encoder, stt.model.prediction
    mf = stt.pre_process_steps[0].step
    samples = int(mf.sample_rate * seconds)
    T0 = samples // int(mf.sample_rate * mf.hop_length_ms / 1000) + 1
    r = enc.time_reduction_factor
    T1 = (T0 + r - 1) // r
    U1 = LABELS + 1
    He, Hp = enc.rnn1.hidden_size, pred.rnn.hidden_size
    shapes = ([(T0, He)] * enc.rnn1.num_layers
              + [(T1, He)] * (enc.rnn2.num_layers if enc.rnn2 else 0)
              + [(U1, Hp)] * pred.rnn.num_layers)
    out = {}
    for name, work in (("K1", lambda T, H: k1_work(T, B, H)),
                       ("K2", lambda T, H: k2_work(T, B, H))):
        ws = [work(T, H) for T, H in shapes]
        out[name] = bound(sum(w[0] for w in ws), sum(w[1] for w in ws)) \
            + (len(ws),)
    out["K3"] = bound(*k3_work(B, T1, U1), peak=PEAK_FP32_FLOPS) + (1,)
    out["K4"] = bound(*k4_work(B, T1, U1), peak=PEAK_FP32_FLOPS) + (1,)
    k5, k6 = k56_work(B, T1, U1, stt.model.joint.fc.hidden_size,
                      len(stt.alphabet))
    out["K5 (joint tail only)"] = bound(*k5) + (1,)
    out["K6 (joint tail only)"] = bound(*k6) + (1,)
    return out


def measured_ms(B: int, seconds: float) -> float:
    """The step's ms from ``port_tools/profile_step.py`` on the card."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "port_tools", "profile_step.py"),
         "--batch", str(B), "--seconds", str(seconds)],
        capture_output=True, text=True, timeout=1800, check=True).stdout
    return float(re.findall(r":\s*([0-9.]+) ms/step", out)[-1])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--measure", action="store_true",
                   help="time the real step on the card "
                        "(port_tools/profile_step.py)")
    p.add_argument("--ms-per-step", type=float, default=None)
    args = p.parse_args(argv)

    from myrtlespeech_tpu_torch.configs.rnn_t_en import task_config as cfg
    from myrtlespeech_tpu_torch.utils.roofline import (PEAK_BF16_FLOPS,
                                                       PEAK_BYTES,
                                                       PEAK_FP32_FLOPS)

    B = args.batch
    f = flop_entries(cfg, B, args.seconds)
    fwd = sum(f.values())
    total = 3 * fwd  # backward ~= 2x forward for matmul-dominated nets

    print(f"Analytic FLOPs per train step (B={B}, {args.seconds}s audio):")
    for k, v in f.items():
        print(f"  {k:32s} {v/1e9:8.1f} GFLOP fwd")
    print(f"  {'TOTAL (fwd+bwd ~ 3x fwd)':32s} {total/1e12:8.2f} TFLOP")

    # The recurrent products run inside K1 (forward) and K2 (backward),
    # whose bounds below count them; the rest are cuBLAS products.
    enc = cfg.speech_to_text.model.encoder
    pred = cfg.speech_to_text.model.prediction
    T0 = int(args.seconds * 100)
    T1 = (T0 + enc.time_reduction_factor - 1) // enc.time_reduction_factor
    He, Hp = enc.rnn1.hidden_size, pred.rnn.hidden_size
    rec_flops = (T0 * enc.rnn1.num_layers * 2 * B * He * 4 * He
                 + T1 * (enc.rnn2.num_layers if enc.rnn2 else 0)
                 * 2 * B * He * 4 * He
                 + (LABELS + 1) * pred.rnn.num_layers * 2 * B * Hp * 4 * Hp)
    par_bound_ms = (total - 3 * rec_flops) / PEAK_BF16_FLOPS * 1e3
    kb = kernel_bounds(cfg, B, args.seconds)
    print(f"\nBounds on one H100 (bf16 {PEAK_BF16_FLOPS/1e12:.0f} TFLOP/s, "
          f"fp32 {PEAK_FP32_FLOPS/1e12:.0f} TFLOP/s, "
          f"{PEAK_BYTES/1e12:.2f} TB/s):")
    for name, (ms, by, calls) in kb.items():
        print(f"  {name:24s} {ms:10.6f} ms  ({by}; {calls} call"
              f"{'s' if calls > 1 else ''} a step)")
    full_joint = sum(kb[k][0] for k in ("K1", "K2", "K3", "K4"))
    print(f"  {'products outside them':24s} {par_bound_ms:10.6f} ms  "
          f"(the step's other FLOPs at the bf16 peak)")
    sol_ms = full_joint + par_bound_ms
    print(f"  step lower bound ~{sol_ms:.3f} ms (full joint: K1-K4 and the "
          f"products) -> {B*args.seconds/(sol_ms/1e3):.0f} audio-s/s")
    print(json.dumps({"batch": B, "seconds": args.seconds,
                      "flops_fwd": f, "flops_step": total,
                      "kernel_bound_ms": {k: v[0] for k, v in kb.items()},
                      "kernel_bound_by": {k: v[1] for k, v in kb.items()},
                      "products_bound_ms": par_bound_ms,
                      "step_bound_ms": sol_ms}))

    ms = args.ms_per_step
    if args.measure:
        print("\nmeasuring on the card via port_tools/profile_step.py ...",
              flush=True)
        ms = measured_ms(B, args.seconds)
    if ms:
        print(f"\nMeasured: {ms:.1f} ms/step -> "
              f"{total/(ms/1e3)/1e12:.1f} model TFLOP/s "
              f"({total/(ms/1e3)/PEAK_BF16_FLOPS:.1%} of the bf16 peak; "
              f"{sol_ms/ms:.1%} of the step's bound)")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
