"""Smoke run of the PyTorch/CUDA port (``myrtlespeech_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line; any failure exits non-zero:

1. card      the card's name and power limit (nvidia-smi).
2. build     every kernel under ``myrtlespeech_tpu_torch/csrc``, one nvcc per
             source, all started together; the build time and ptxas report.
3. k1        K1 (the LSTM recurrence) against its plain PyTorch version at the
             flagship's encoder shapes and its prediction-net shape, with
             ragged lengths: the largest error per output, and the kernel's,
             the plain version's and cuDNN's ``nn.LSTM`` times (CUDA events,
             median), beside the least time the card could take; the
             kernel's time again with its launches queued behind a spin
             kernel (the device's own time, without the host's launch rate).
4. k2        K2 (the LSTM backward) against its plain version at the train
             step's shapes (T=501 and 251 at H=1024, T=65 at H=320; B=32,
             ragged lengths, from K1's own saved tensors): errors, and the
             kernel's (also queued, as in k1), the plain version's and
             cuDNN's ``nn.LSTM`` backward times (the yardstick also computes
             dW and dx).
5. k34       K3 and K4 (the transducer lattice forward and backward) against
             their plain versions on the 5 s (B=32, T'=251, U+1=65) and 15 s
             (T'=751, U+1=193) lattices: errors and times (no single library
             call computes the lattice, so no yardstick).
6. flagship  ``rnn_t_en`` at full width with seeded random weights transcribes
             B=32 x 5 s of seeded audio through ``build_transcriber``: one
             warm-up and three timed runs, K1's launches on that path, a
             stage split, and one run traced with ``torch.profiler`` for
             K1's device time on the main path and the device's idle share.
7. k1_main_path  every K1 call of one such run, recorded and replayed
             through K1 (errors against the plain version on the main
             path's own inputs), the plain version and cuDNN (device time
             of each replay, traced alike).
8. train     ``rnn_t_en`` at full width trains on B=32 x 5 s with 64 labels
             through ``make_train_step``: a warm-up step, then timed steps
             in which K1 and K2 launch 1,885 times a step and K3 and K4 once
             and no plain version runs; finite loss and gradient norm, every
             parameter moved after step 1; a forward/backward/optimizer
             split; one step traced for each kernel's device time and the
             idle share; every K1, K2, K3 and K4 call of one step replayed
             through its kernel (errors), its plain version and (K2) cuDNN,
             each replay's device time traced.
             Then the medium config from seeded weights, warmup off, takes
             20 steps on one repeated batch: its loss must fall.
9. trained   the trained medium RNN-T (committed npz) decodes its
             256-utterance eval split greedily at B=32; its WER must lie
             within 0.01 of the JAX package's greedy WER for the same weights;
             its eval loss over the split and the gradient norm of the first
             batch must lie within tolerance of the JAX package's.

Then a ``kernels`` line (one entry per ported kernel: ``ms`` is the kernel's
device time on its main path, traced; ``plain_ms`` and ``library_ms`` the
device times of the replays; ``bound_ms`` counted from the recorded calls),
the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.  Without a
CUDA card the script exits non-zero before it prints any result.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import myrtlespeech_tpu_torch  # noqa: F401  (fails at once outside a checkout)

# The JAX package's greedy WER for benchmarks/data/rnnt_medium/
# trained_params_bf16.npz on the 256-utterance eval split of
# configs/synthetic_medium_rnnt.py (max_symbols_per_step=8, batches of 32
# padded to the split's longest utterance), measured on the CPU by
# ``python port_tools/medium_greedy_wer.py``: {"jax_cpu_wer":
# 0.10714285714285714, "port_cpu_wer": 0.10714285714285714}.
JAX_GREEDY_WER = 0.10714285714285714
WER_TOLERANCE = 0.01

# K1 against its plain version on the card, over up to 501 steps.  The kernel
# sums h @ W_hh in another order (mma tiles, then warps) and uses CUDA's
# expf/tanhf, and h is rounded to bf16 before every product, so a difference
# of one bf16 step can arise and feed back through the recurrence.  bf16
# outputs (ys, ifgo) hold within 2^-5 (four bf16 steps at magnitude 1).  The
# fp32 state (cs, hT, cT) read at most 5.4e-4, 2.0e-4 and 3.9e-4 at T=501 in
# four runs on an H100 (PERF.md); 4e-3 leaves 7-20x room for another
# summation order, and none for a state path that drifts.
K1_TOL = {"ys": 2.0 ** -5, "cs": 4e-3, "ifgo": 2.0 ** -5,
          "hT": 4e-3, "cT": 4e-3}
K1_OUTPUTS = ("ys", "cs", "ifgo", "hT", "cT")

# K2 against its plain version: both round dz to bf16 before each product
# and sum it in another order, so one element can land a bf16 step (2^-8 of
# its value) apart and carry that step back through the recurrence.  Over
# each output's largest magnitude, three runs on an H100 read at most 3.5e-4
# at the k2 shapes (T=501, 251 at H=1024, T=65 at H=320) and 2.0e-4 on the
# train step's own calls (PERF.md): 2e-3 leaves some 6x room.
K2_TOL = 2e-3
K2_OUTPUTS = ("dz", "dh0", "dc0")

# K3 and K4 against their plain versions: the same fp32 recursion in the same
# order; CUDA's expf/log1pf and the library's may differ by an ulp, which the
# long chain of rows compounds: 1e-5 of the magnitude (plus 1e-3 absolute)
# for alphas and the log-likelihood (some 10^3 at the 15 s shape), 1e-4
# absolute for the occupancy gradients (in [0, 1]).
K3_RTOL, K3_ATOL, K4_ATOL = 1e-5, 1e-3, 1e-4

# The JAX package's eval-mode transducer loss (mean over the 256-utterance
# eval split of configs/synthetic_medium_rnnt.py, batches of 32, full joint)
# and the global gradient norm of the first batch's loss, for
# benchmarks/data/rnnt_medium/trained_params_bf16.npz, measured on the CPU by
# ``python port_tools/medium_eval_loss.py``: {"jax_cpu_eval_loss":
# 1.523649051785469, "jax_cpu_grad_norm": 6.285726070404053,
# "port_cpu_eval_loss": 1.5238218754529953, "port_cpu_grad_norm":
# 6.282566547393799}.  The port on the CPU differs by 1.1e-4 and 5.0e-4 of
# the JAX figures; the card may sum in other orders: ten times those.
JAX_EVAL_LOSS = 1.523649051785469
JAX_GRAD_NORM = 6.285726070404053
EVAL_LOSS_RTOL = 1.2e-3
GRAD_NORM_RTOL = 5e-3

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12

# The flagship train step: K1 and K2 run once per step of every LSTM layer
# (2 x 501 + 3 x 251 encoder, 2 x 65 prediction net), K3 and K4 once.
TRAIN_LABELS = 64
TRAIN_LAUNCHES = {"k1": 1885, "k2": 1885, "k3": 1, "k4": 1}
TRAIN_STEPS = 5
MEDIUM_STEPS = 20

FLAGSHIP_BATCH, FLAGSHIP_SECONDS = 32, 5.0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events),
    after one warm-up call.

    With ``queued`` every run waits behind a spin kernel of about 25 ms
    (``torch.cuda._sleep``), so that the host has enqueued all of ``fn``'s
    launches before the device reaches the start event: the events then
    bracket the device's own work, not the rate at which the host launches
    (a call of up to some thousand launches)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(50_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_work(T: int, B: int, H: int, bias: bool = True):
    """(operations, bytes) of one K1 call at (T, B, H): the in-kernel
    product, and the bytes that must move (x_proj, valid, W_hh in bf16, b,
    h0, c0 read once; ys, cs, ifgo, hT, cT written once).  Every step runs,
    padded ones included, so the work does not depend on the lengths."""
    flops = 2.0 * B * H * 4 * H * T
    nbytes = (T * B * 4 * H * 2 + T * B * 4 + H * 4 * H * 2
              + (4 * H * 4 if bias else 0) + 2 * B * H * 4
              + T * B * H * (2 + 4) + T * B * 4 * H * 2 + 2 * B * H * 4)
    return flops, nbytes


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """Least ms for that work on the card, and what bounds it."""
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def device_trace(fn):
    """Run ``fn`` once under ``torch.profiler``.  Returns the wall ms of the
    call (profiler overhead included) and its device events as ``(name,
    start_us, end_us)``: kernels, copies and memsets."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
             and "dur" in e]
    if not spans:
        raise AssertionError("torch.profiler traced no device event")
    return wall_ms, spans


def span_ms(spans) -> float:
    """Summed device ms of the events."""
    return sum(e - s for _, s, e in spans) / 1e3


def busy_ms(spans) -> float:
    """Device ms in which at least one of the events ran."""
    ivs = sorted((s, e) for _, s, e in spans)
    total, (lo, hi) = 0.0, ivs[0]
    for s, e in ivs[1:]:
        if s > hi:
            total += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (total + hi - lo) / 1e3


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=out, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return out


def phase_build():
    from myrtlespeech_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    seconds = build.build()
    report = {}
    for name in build.sources():
        log = build.library_path(name).with_suffix(".log").read_text()
        report[name] = [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, per_source=seconds,
         ptxas=report)


def _k1_case(T, B, H, seed, dev, random_state: bool):
    rng = np.random.default_rng(seed)
    lens = rng.integers(max(T // 2, 1), T + 1, B)
    lens[0] = T
    x_proj = torch.from_numpy(
        (0.5 * rng.standard_normal((T, B, 4 * H))).astype(np.float32)
    ).to(dev, torch.bfloat16)
    valid = torch.from_numpy(
        (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)).to(dev)
    w_hh = torch.from_numpy((rng.standard_normal((H, 4 * H)) / np.sqrt(H))
                            .astype(np.float32)).to(dev)
    b = torch.from_numpy((0.1 * rng.standard_normal(4 * H))
                         .astype(np.float32)).to(dev)
    scale = 0.5 if random_state else 0.0
    h0, c0 = (torch.from_numpy((scale * rng.standard_normal((B, H)))
                               .astype(np.float32)).to(dev) for _ in range(2))
    return x_proj, valid, w_hh, h0, c0, b


def k1_errors(got, want, label: str):
    """Largest |kernel - plain| per output; raises on a dtype or shape that
    differs."""
    errs = {}
    for name, g, w in zip(K1_OUTPUTS, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"K1 {label} {name}: {g.dtype} "
                                 f"{tuple(g.shape)} vs plain {w.dtype} "
                                 f"{tuple(w.shape)}")
        errs[name] = (g.float() - w.float()).abs().max().item()
    return errs


def check_errors(errs, label: str) -> None:
    if any(not np.isfinite(e) or e > K1_TOL[n] for n, e in errs.items()):
        raise AssertionError(f"K1 {label}: max |err| {errs} beyond the "
                             f"tolerance {K1_TOL}")


def phase_k1(dev):
    """K1 against its plain version, timed, at the main path's shapes.

    The flagship's encoder runs K1 at T=501 (layers 1-2, input widths 80 and
    1024) and T=251 (layers 3-5, input widths 2048, 1024, 1024), H=1024; its
    prediction net at T=1, H=320, once per layer and decode iteration.
    """
    from torch import nn

    from myrtlespeech_tpu_torch.ops.cuda.lstm_kernel import (
        lstm_fwd, lstm_fwd_reference)

    B = FLAGSHIP_BATCH
    # label: (T, H, input widths of the layers that run it); the encoder
    # starts from a zero state, the prediction net from a carried one.
    shapes = {"enc_T501": (501, 1024, (80, 1024)),
              "enc_T251": (251, 1024, (2048, 1024, 1024)),
              "pred_T1": (1, 320, (320,))}
    torch.manual_seed(0)  # the yardstick's weights and inputs
    for i, (label, (T, H, widths)) in enumerate(shapes.items()):
        args = _k1_case(T, B, H, seed=10 + i, dev=dev,
                        random_state=label == "pred_T1")
        got = lstm_fwd(*args)
        torch.cuda.synchronize()
        errs = k1_errors(got, lstm_fwd_reference(*args), label)
        check_errors(errs, label)
        reps = 20 if T > 1 else 200
        kernel_ms = cuda_ms(lambda: lstm_fwd(*args), reps)
        queued_ms = cuda_ms(lambda: lstm_fwd(*args), 5, queued=True)
        plain_ms = cuda_ms(lambda: lstm_fwd_reference(*args),
                           3 if T > 1 else 50)
        # Yardstick only, never called by the port: cuDNN's LSTM in bf16 at
        # full lengths for each layer input width at this shape.  It also
        # computes the input projection, which the port does outside K1.
        # PyTorch flattens only fp16/fp32 weights for cuDNN, so in bf16
        # each call also compacts the weights (tens of MB at most).
        lib = []
        for F in widths:
            cell = nn.LSTM(F, H).to(dev, torch.bfloat16)
            x = torch.randn(T, B, F, device=dev, dtype=torch.bfloat16)
            h0 = torch.zeros(1, B, H, device=dev, dtype=torch.bfloat16)
            with torch.inference_mode():
                lib.append(cuda_ms(lambda: cell(x, (h0, h0)), reps))
        bound_ms, bound_by = bound(*k1_work(T, B, H))
        # Per-call event times: at T=1 they hold the wrapper's host time.
        emit("k1", shape=label, T=T, B=B, H=H, max_abs_err=errs,
             kernel_ms=kernel_ms, kernel_queued_ms=queued_ms,
             plain_ms=plain_ms,
             library_ms=dict(zip(widths, lib)), bound_ms=bound_ms,
             bound_by=bound_by, tolerance=K1_TOL)


def k2_work(T: int, B: int, H: int, need_dh0: bool = False):
    """(operations, bytes) of one K2 call: the in-kernel products (one per
    step after the last, plus dh0's), and the bytes that must move (valid,
    W_hh in bf16, c0, cs, ifgo, dys, dhT, dcT read once; dz, dc0 and dh0
    written once)."""
    flops = 2.0 * B * 4 * H * H * (T - 1 + int(need_dh0))
    nbytes = (T * B * 4 + H * 4 * H * 2 + B * H * 4 + T * B * H * 4
              + T * B * 4 * H * 2 + T * B * H * 2 + 2 * B * H * 4
              + T * B * 4 * H * 4 + B * H * 4 * (1 + int(need_dh0)))
    return flops, nbytes


def lattice_passes(U1: int) -> int:
    """Hillis-Steele passes of one lattice row."""
    return max(0, (U1 - 1).bit_length())


def k3_work(B: int, T: int, U1: int):
    """(fp32 operations, bytes) of one K3 call: some 8 operations per cell
    and scan pass (logaddexp: max, difference, |.|, exp, log1p, add; and the
    running sum of C), and the bytes that must move (both log-prob tensors
    and the lengths read once; alphas and ll written once)."""
    flops = 8.0 * B * T * U1 * lattice_passes(U1)
    nbytes = 2 * B * T * U1 * 4 + 2 * B * 4 + T * B * U1 * 4 + B * 4
    return flops, nbytes


def k4_work(B: int, T: int, U1: int):
    """(fp32 operations, bytes) of one K4 call: K3's scan work plus two
    exponentials and some 8 additions per cell, and the bytes that must move
    (log-probs, alphas, lengths, ll and g read once; the two occupancy
    tensors written once)."""
    flops = 8.0 * B * T * U1 * lattice_passes(U1) + 10.0 * B * T * U1
    nbytes = 5 * B * T * U1 * 4 + 2 * B * 4 + 2 * B * 4
    return flops, nbytes


def _k2_case(T, B, H, seed, dev):
    """K2's inputs at (T, B, H) from K1's own forward: ragged lengths, zero
    initial state (as the encoder and prediction net start), a random
    cotangent of ys and zero cotangents of the final state (unused by the
    train step's loss)."""
    from myrtlespeech_tpu_torch.ops.cuda.lstm_kernel import lstm_fwd

    x_proj, valid, w_hh, h0, c0, b = _k1_case(T, B, H, seed, dev,
                                              random_state=False)
    _, cs, ifgo, _, _ = lstm_fwd(x_proj, valid, w_hh, h0, c0, b)
    rng = np.random.default_rng(seed + 100)
    dys = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(dev, torch.bfloat16)
    zeros = torch.zeros((B, H), device=dev)
    return valid, w_hh, c0, cs, ifgo, dys, zeros, zeros.clone()


def k2_errors(got, want, label: str):
    """Largest |kernel - plain| per output, and each over the output's
    largest magnitude; raises beyond K2_TOL of that magnitude."""
    errs, rel = {}, {}
    for name, g, w in zip(K2_OUTPUTS, got, want):
        if w is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"K2 {label} {name}: {g.dtype} "
                                 f"{tuple(g.shape)} vs plain {w.dtype} "
                                 f"{tuple(w.shape)}")
        errs[name] = (g - w).abs().max().item()
        rel[name] = errs[name] / (w.abs().max().item() + 1e-30)
    if any(not np.isfinite(e) or e > K2_TOL for e in rel.values()):
        raise AssertionError(f"K2 {label}: max |err| {errs}, relative "
                             f"{rel}, beyond {K2_TOL} of the magnitude")
    return errs, rel


def cudnn_lstm_backward(shapes, dev):
    """Yardstick only, never called by the port: a function that runs the
    backward of cuDNN's ``nn.LSTM(H, H)`` in bf16 at full lengths (dx and
    every weight's gradient, not only what K2 computes) once for each ``(T,
    B, H)`` of ``shapes``, from forwards kept for it."""
    from torch import nn

    work = []
    for T, B, H in shapes:
        cell = nn.LSTM(H, H).to(dev, torch.bfloat16)
        x = torch.randn(T, B, H, device=dev, dtype=torch.bfloat16,
                        requires_grad=True)
        out, _ = cell(x)
        work.append((out, [x] + list(cell.parameters()),
                     torch.randn_like(out)))

    def run():
        for out, inputs, grad in work:
            torch.autograd.grad(out, inputs, grad, retain_graph=True)

    return run


def phase_k2(dev):
    """K2 against its plain version, timed, at the train step's shapes."""
    from myrtlespeech_tpu_torch.ops.cuda.lstm_kernel import (
        lstm_bwd, lstm_bwd_reference)

    B = FLAGSHIP_BATCH
    shapes = {"enc_T501": (501, 1024), "enc_T251": (251, 1024),
              "pred_T65": (65, 320)}
    torch.manual_seed(1)  # the yardstick's weights and inputs
    for i, (label, (T, H)) in enumerate(shapes.items()):
        args = _k2_case(T, B, H, seed=20 + i, dev=dev)
        got = lstm_bwd(*args, need_dh0=False)
        torch.cuda.synchronize()
        errs, rel = k2_errors(got, lstm_bwd_reference(*args, need_dh0=False),
                              label)
        kernel_ms = cuda_ms(lambda: lstm_bwd(*args, need_dh0=False), 10)
        queued_ms = cuda_ms(lambda: lstm_bwd(*args, need_dh0=False), 5,
                            queued=True)
        plain_ms = cuda_ms(lambda: lstm_bwd_reference(*args, need_dh0=False),
                           2)
        lib_ms = cuda_ms(cudnn_lstm_backward([(T, B, H)], dev), 10)
        bound_ms, bound_by = bound(*k2_work(T, B, H))
        emit("k2", shape=label, T=T, B=B, H=H, max_abs_err=errs,
             err_over_magnitude=rel, tolerance=K2_TOL, kernel_ms=kernel_ms,
             kernel_queued_ms=queued_ms,
             plain_ms=plain_ms, library_ms=lib_ms,
             library="cuDNN nn.LSTM(H, H) bf16 backward (also dW, dx)",
             bound_ms=bound_ms, bound_by=bound_by)


def _lattice_case(B, T, U1, seed, dev):
    """Blank and emit log-probs of random joint logits (V=29, labels in
    [1, 27]), ragged frame and label lengths (the first row full)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((B, T, U1, 29), device=dev, generator=gen)
    lp = torch.log_softmax(logits, dim=-1)
    labels = torch.randint(1, 28, (B, U1), device=dev, generator=gen)
    lp_blank = lp[..., 0].contiguous()
    lp_emit = torch.gather(lp, 3, labels[:, None, :, None].expand(
        B, T, U1, 1))[..., 0].contiguous()
    rng = np.random.default_rng(seed)
    fl = rng.integers(T // 2, T + 1, B).astype(np.int32)
    ul = rng.integers((U1 - 1) // 2, U1, B).astype(np.int32)
    fl[0], ul[0] = T, U1 - 1
    return (lp_blank, lp_emit, torch.from_numpy(fl).to(dev),
            torch.from_numpy(ul).to(dev))


def lattice_errors(fwd, bwd, fwd_ref, bwd_ref, label: str):
    """Largest errors of K3 (alphas of reachable cells, ll) and K4 (both
    occupancies) against the plain versions; raises beyond tolerance."""
    alphas, ll = fwd
    a_ref, ll_ref = fwd_ref
    reach = a_ref > -1e29
    errs = {
        "alphas": (alphas[reach] - a_ref[reach]).abs().max().item(),
        "ll": (ll - ll_ref).abs().max().item(),
        "gblank": (bwd[0] - bwd_ref[0]).abs().max().item(),
        "gemit": (bwd[1] - bwd_ref[1]).abs().max().item()}
    ok = (bool((alphas[~reach] < -1e29).all())
          and torch.allclose(alphas[reach], a_ref[reach], rtol=K3_RTOL,
                             atol=K3_ATOL)
          and torch.allclose(ll, ll_ref, rtol=K3_RTOL, atol=K3_ATOL)
          and errs["gblank"] <= K4_ATOL and errs["gemit"] <= K4_ATOL)
    if not ok:
        raise AssertionError(f"K3/K4 {label}: max |err| {errs} beyond rtol "
                             f"{K3_RTOL} atol {K3_ATOL} (K3), atol "
                             f"{K4_ATOL} (K4)")
    return errs


def phase_k34(dev):
    """K3 and K4 against their plain versions, timed, on the 5 s and 15 s
    lattices of the flagship at B=32."""
    from myrtlespeech_tpu_torch.ops.cuda import rnnt_kernel as k

    shapes = {"5s": (32, 251, 65), "15s": (32, 751, 193)}
    for i, (label, (B, T, U1)) in enumerate(shapes.items()):
        args = _lattice_case(B, T, U1, seed=30 + i, dev=dev)
        g = torch.ones((B,), device=dev) / B  # d mean(-ll) / d ll, negated
        fwd = k.rnnt_lattice_fwd(*args)
        bwd = k.rnnt_lattice_bwd(*args, *fwd, g)
        torch.cuda.synchronize()
        fwd_ref = k.rnnt_lattice_fwd_reference(*args)
        bwd_ref = k.rnnt_lattice_bwd_reference(*args, *fwd_ref, g)
        errs = lattice_errors(fwd, bwd, fwd_ref, bwd_ref, label)
        times = {
            "k3_ms": cuda_ms(lambda: k.rnnt_lattice_fwd(*args), 10),
            "k4_ms": cuda_ms(lambda: k.rnnt_lattice_bwd(*args, *fwd, g), 10),
            "k3_plain_ms": cuda_ms(lambda: k.rnnt_lattice_fwd_reference(
                *args), 2),
            "k4_plain_ms": cuda_ms(lambda: k.rnnt_lattice_bwd_reference(
                *args, *fwd, g), 2)}
        b3, by3 = bound(*k3_work(B, T, U1), peak=PEAK_FP32_FLOPS)
        b4, by4 = bound(*k4_work(B, T, U1), peak=PEAK_FP32_FLOPS)
        emit("k34", shape=label, B=B, T=T, U1=U1, max_abs_err=errs,
             tolerance={"k3_rtol": K3_RTOL, "k3_atol": K3_ATOL,
                        "k4_atol": K4_ATOL}, **times, library_ms=None,
             k3_bound_ms=b3, k3_bound_by=by3, k4_bound_ms=b4,
             k4_bound_by=by4)


def stage_ms(tr, wav, lens, runs: int = 3):
    """Median host-clock ms of features, encoder and greedy decode (joint
    projection plus the loop), each ending in a synchronise."""
    out = collections.defaultdict(list)
    for _ in range(runs):
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats, flens = tr.preprocess(
                torch.as_tensor(wav, device=tr.device),
                torch.as_tensor(lens, device=tr.device))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            f, f_lens = tr.model.encode(feats, flens)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            tr.decode(f, f_lens)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        out["features_ms"].append(1e3 * (t1 - t0))
        out["encoder_ms"].append(1e3 * (t2 - t1))
        out["decode_ms"].append(1e3 * (t3 - t2))
    return {k: statistics.median(v) for k, v in out.items()}


def record_many(targets, fn, snapshot: bool = False):
    """Run ``fn()`` with each ``module.name`` of ``targets`` (``{key:
    (module, name)}``, kernel wrappers that their callers look up at call
    time) recording its arguments; returns ``{key: [args, ...]}`` in call
    order, keyword arguments appended in order as the positional ones they
    are (``need_dh0``, K2's last parameter).  With ``snapshot`` each tensor
    is recorded as a detached copy, as it was at the call: a train step's
    optimizer later writes its weights in place.  A wrapper's own count,
    which it keeps under its module name, lands on the recorder during the
    run: a recorded run is never a counted one."""
    calls = {key: [] for key in targets}
    real = {key: getattr(m, n) for key, (m, n) in targets.items()}
    for key, (m, n) in targets.items():
        def recording(*args, _key=key, **kwargs):
            rec = args + tuple(kwargs.values())
            if snapshot:
                rec = tuple(a.detach().clone()
                            if isinstance(a, torch.Tensor) else a
                            for a in rec)
            calls[_key].append(rec)
            return real[_key](*args, **kwargs)

        recording.launches = 0
        setattr(m, n, recording)
    try:
        fn()
    finally:
        for key, (m, n) in targets.items():
            setattr(m, n, real[key])
    return calls


class PlainGuard:
    """Counts the calls of the named plain versions while it is entered;
    the main path on the card must make none."""

    def __init__(self, pairs):
        self.pairs = pairs  # [(module, name)]
        self.calls = collections.Counter()

    def __enter__(self):
        self.real = [getattr(m, n) for m, n in self.pairs]
        for (m, n), real in zip(self.pairs, self.real):
            def counting(*a, _n=n, _real=real, **k):
                self.calls[_n] += 1
                return _real(*a, **k)
            setattr(m, n, counting)
        return self

    def __exit__(self, *exc):
        for (m, n), real in zip(self.pairs, self.real):
            setattr(m, n, real)
        return False


def phase_flagship(dev):
    """Transcribe B=32 x 5 s with ``rnn_t_en``: latency over three runs, a
    stage split, and one traced run for K1's device time on the main path
    and the device's idle share."""
    from myrtlespeech_tpu_torch.builders.build import random_params
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel
    from myrtlespeech_tpu_torch.run.infer import (build_transcriber,
                                                  load_config, random_audio)

    cfg = load_config("rnn_t_en")
    t0 = time.perf_counter()
    tr = build_transcriber(cfg, random_params(cfg, seed=0), device=str(dev))
    setup_s = time.perf_counter() - t0
    wav, lens = random_audio(FLAGSHIP_BATCH, FLAGSHIP_SECONDS, seed=0)
    tr.transcribe(wav, lens)  # warm-up

    # The main path must not reach K1's plain version on the card.
    plain_calls = []
    plain = lstm_kernel.lstm_fwd_reference

    def counting_plain(*a, **k):
        plain_calls.append(1)
        return plain(*a, **k)

    lstm_kernel.lstm_fwd_reference = counting_plain
    launches, times = [], []
    try:
        for _ in range(3):
            lstm_kernel.lstm_fwd.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tr.transcribe(wav, lens)  # ends in a copy to the host
            times.append(time.perf_counter() - t0)
            launches.append(lstm_kernel.lstm_fwd.launches)
        stages = stage_ms(tr, wav, lens)
        # K1's own device time on the main path: one more run, traced.
        lstm_kernel.lstm_fwd.launches = 0
        traced_wall_ms, spans = device_trace(lambda: tr.transcribe(wav, lens))
        launches.append(lstm_kernel.lstm_fwd.launches)
    finally:
        lstm_kernel.lstm_fwd_reference = plain
    if plain_calls:
        raise AssertionError(f"K1's plain version ran {len(plain_calls)} "
                             "times on the card's main path")
    if min(launches) == 0 or len(set(launches)) != 1:
        raise AssertionError(f"K1 launches per run on the main path: "
                             f"{launches}")
    k1_spans = [sp for sp in spans if "lstm_step_kernel" in sp[0]]
    if len(k1_spans) != launches[-1]:
        raise AssertionError(f"the trace holds {len(k1_spans)} K1 kernels, "
                             f"the counter {launches[-1]}")
    by_kernel = collections.Counter()
    for name, s, e in spans:
        by_kernel[name[:80]] += (e - s) / 1e3

    # What came out: token ids of the vocabulary, lengths in range, and a
    # finite encoder output of the expected shape.
    toks, tlens = out.tokens.cpu().numpy(), out.lengths.cpu().numpy()
    V = len(cfg.speech_to_text.alphabet)
    if toks.shape != (FLAGSHIP_BATCH, 200) or not (
            (0 <= tlens).all() and (tlens <= 200).all()
            and (0 <= toks).all() and (toks < V).all()):
        raise AssertionError(f"bad tokens {toks.shape} lens {tlens}")
    with torch.inference_mode():
        feats, flens = tr.preprocess(
            torch.as_tensor(wav, device=dev), torch.as_tensor(lens,
                                                              device=dev))
        f, f_lens = tr.model.encode(feats, flens)
    if tuple(f.shape) != (FLAGSHIP_BATCH, 251, 1024) \
            or not torch.isfinite(f.float()).all():
        raise AssertionError(f"encoder output {tuple(f.shape)} not finite "
                             "or of the wrong shape")

    enc = 2 * 501 + 3 * 251
    pred = launches[0] - enc
    if pred <= 0 or pred % 2:
        raise AssertionError(f"K1 launches {launches[0]}: expected {enc} "
                             "encoder steps plus 2 per prediction step")
    ms = 1e3 * statistics.median(times)
    busy = busy_ms(spans)
    emit("flagship", config="rnn_t_en", batch=FLAGSHIP_BATCH,
         seconds=FLAGSHIP_SECONDS, setup_s=setup_s, ms_per_batch=ms,
         ms_runs=[1e3 * t for t in times],
         audio_s_per_s=FLAGSHIP_BATCH * FLAGSHIP_SECONDS / (ms / 1e3),
         k1_launches=launches[0], k1_encoder_launches=enc,
         k1_prediction_launches=pred, decode_iterations=pred // 2 - 1,
         **stages, traced_wall_ms=traced_wall_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / traced_wall_ms,
         device_events=len(spans), k1_device_ms=span_ms(k1_spans),
         device_ms_by_kernel=dict(by_kernel.most_common(10)),
         token_lens=tlens.tolist())
    return {"launches": launches[-1], "k1_ms": span_ms(k1_spans),
            "calls": record_many({"k1": (lstm_kernel, "lstm_fwd")},
                                 lambda: tr.transcribe(wav, lens))["k1"]}


def phase_main_path_k1(dev, flagship):
    """K1 on the flagship main path's own inputs: every K1 call of one
    ``transcribe``, replayed through K1, its plain version and cuDNN.

    The replays are traced like the main path, so all three times are
    device time.  The cuDNN yardstick is ``nn.LSTM(4H, H)`` in bf16 with an
    identity input matrix, so that it takes ``x_proj`` as it is; it also
    runs that (T*B, 4H) x (4H, 4H) product, drops the length mask and keeps
    its state in bf16.
    """
    from torch import nn

    from myrtlespeech_tpu_torch.ops.cuda.lstm_kernel import (
        lstm_fwd, lstm_fwd_reference)

    calls = flagship["calls"]
    if sum(a[0].shape[0] for a in calls) != flagship["launches"]:
        raise AssertionError("the recorded K1 calls do not add up to the "
                             "main path's launches")
    errs = dict.fromkeys(K1_OUTPUTS, 0.0)
    with torch.inference_mode():  # the recorded inputs are inference tensors
        for args in calls:
            got = lstm_fwd(*args)
            for n, e in k1_errors(got, lstm_fwd_reference(*args),
                                  "main path").items():
                errs[n] = max(errs[n], e)
    check_errors(errs, "main path")

    def plain_replay():
        with torch.inference_mode():
            for args in calls:
                lstm_fwd_reference(*args)

    _, plain_spans = device_trace(plain_replay)

    cells, lib_args = {}, []
    with torch.inference_mode():
        for x_proj, _valid, w_hh, h0, c0, b in calls:
            if id(w_hh) not in cells:
                H = w_hh.shape[0]
                cell = nn.LSTM(4 * H, H).to(dev)
                cell.weight_ih_l0.copy_(torch.eye(4 * H, device=dev))
                cell.weight_hh_l0.copy_(w_hh.t())
                cell.bias_ih_l0.zero_()
                cell.bias_hh_l0.zero_()
                if b is not None:
                    cell.bias_ih_l0.copy_(b)
                cells[id(w_hh)] = cell.to(torch.bfloat16)
            lib_args.append((cells[id(w_hh)], x_proj,
                             (h0[None].to(torch.bfloat16),
                              c0[None].to(torch.bfloat16))))

    def library_replay():
        with torch.inference_mode():
            for cell, x, state in lib_args:
                cell(x, state)

    _, lib_spans = device_trace(library_replay)

    flops = nbytes = 0.0
    for x_proj, _valid, w_hh, _h0, _c0, b in calls:
        T, B, H4 = x_proj.shape
        f, n = k1_work(T, B, H4 // 4, bias=b is not None)
        flops, nbytes = flops + f, nbytes + n
    bound_ms, bound_by = bound(flops, nbytes)
    emit("k1_main_path", calls=len(calls), launches=flagship["launches"],
         max_abs_err=errs, tolerance=K1_TOL, kernel_device_ms=flagship["k1_ms"],
         plain_device_ms=span_ms(plain_spans),
         plain_device_events=len(plain_spans),
         library_device_ms=span_ms(lib_spans),
         library_device_events=len(lib_spans), gflop=flops / 1e9,
         gbytes=nbytes / 1e9, bound_ms=bound_ms, bound_by=bound_by)
    return {
        "name": "K1 lstm_fwd", "route": "cuda",
        "source": "myrtlespeech_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "myrtlespeech_tpu/ops/pallas/lstm_kernel.py:38 "
                    "(_lstm_kernel, pallas_call in _lstm_pallas_fwd_call :92)",
        "launches": flagship["launches"], "max_abs_err": max(errs.values()),
        "ms": flagship["k1_ms"], "kernel_ms": flagship["k1_ms"],
        "plain_ms": span_ms(plain_spans), "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": span_ms(lib_spans),
    }


def _train_kernels():
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel, rnnt_kernel

    return {"k1": lstm_kernel.lstm_fwd, "k2": lstm_kernel.lstm_bwd,
            "k3": rnnt_kernel.rnnt_lattice_fwd,
            "k4": rnnt_kernel.rnnt_lattice_bwd}


def _zero_counts():
    for fn in _train_kernels().values():
        fn.launches = 0


def _read_counts():
    return {k: fn.launches for k, fn in _train_kernels().items()}


def _plain_guard():
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel, rnnt_kernel

    return PlainGuard([(lstm_kernel, "lstm_fwd_reference"),
                       (lstm_kernel, "lstm_bwd_reference"),
                       (rnnt_kernel, "rnnt_lattice_fwd_reference"),
                       (rnnt_kernel, "rnnt_lattice_bwd_reference")])


# Kernel names in a profiler trace.
TRACE_NAMES = {"k1": "lstm_step_kernel", "k2": "lstm_bwd_step_kernel",
               "k3": "rnnt_fwd_kernel", "k4": "rnnt_bwd_kernel"}


def phase_train(dev):
    """``rnn_t_en`` at full width trains on B=32 x 5 s, 64 labels."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.run import train
    from myrtlespeech_tpu_torch.run.infer import load_config

    B, secs = FLAGSHIP_BATCH, FLAGSHIP_SECONDS
    task = build_task(load_config("rnn_t_en"))
    t0 = time.perf_counter()
    state = train.init_state(task, seed=0, device=str(dev))
    batch = train.to_device(train.example_batch(B, secs, TRAIN_LABELS, 0),
                            dev)
    step = train.make_train_step(task)
    state, m = step(state, batch)  # warm-up: step 0, whose lr is 0
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}

    torch.cuda.reset_peak_memory_stats(dev)
    times, losses, gnorms, lrs = [], [], [], []
    with _plain_guard() as guard:
        _zero_counts()
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))  # waits for the step
            times.append(time.perf_counter() - t0)
            gnorms.append(float(m["grad_norm"]))
            lrs.append(m["lr"])
            if i == 0:
                moved = {n: (p.detach() - before[n]).abs().max().item()
                         for n, p in state.model.named_parameters()}
        launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del before
    if guard.calls:
        raise AssertionError(f"plain versions ran on the card's train path: "
                             f"{dict(guard.calls)}")
    want = {k: n * TRAIN_STEPS for k, n in TRAIN_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"launches over {TRAIN_STEPS} train steps: "
                             f"{launches}, expected {want}")
    if not all(np.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"loss {losses} or grad_norm {gnorms} not "
                             "finite")
    lr1 = task.lr_schedule(1)
    if min(moved.values()) <= 0 or max(moved.values()) < 0.5 * lr1:
        raise AssertionError(f"parameters after step 1 (lr {lr1}) moved by "
                             f"{moved}")

    # Stage split of one more step, host clock, synced at each boundary.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state.optimizer.zero_grad()
    loss, _ = train._forward(task, state.model, batch, True, state.gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state.optimizer.step(state.step)
    state.step += 1
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del loss

    # One step traced: each kernel's device time and the idle share.
    _zero_counts()
    traced_wall_ms, spans = device_trace(lambda: step(state, batch))
    traced = _read_counts()
    if traced != TRAIN_LAUNCHES:
        raise AssertionError(f"traced step launches {traced}, expected "
                             f"{TRAIN_LAUNCHES}")
    kernel_spans = {k: [sp for sp in spans if name in sp[0]]
                    for k, name in TRACE_NAMES.items()}
    for k, sp in kernel_spans.items():
        if len(sp) != traced[k]:
            raise AssertionError(f"the trace holds {len(sp)} {k} kernels, "
                                 f"the counter {traced[k]}")
    by_kernel = collections.Counter()
    for name, s, e in spans:
        by_kernel[name[:80]] += (e - s) / 1e3
    busy = busy_ms(spans)
    # A second traced step, to show how far one trace's device times vary.
    again_wall_ms, again = device_trace(lambda: step(state, batch))
    again_ms = {k: span_ms([sp for sp in again if name in sp[0]])
                for k, name in TRACE_NAMES.items()}
    ms = 1e3 * statistics.median(times)
    emit("train", config="rnn_t_en", batch=B, seconds=secs,
         labels=TRAIN_LABELS, setup_s=setup_s, ms_per_step=ms,
         ms_runs=[1e3 * t for t in times],
         audio_s_per_s=B * secs / (ms / 1e3), losses=losses,
         grad_norms=gnorms, lrs=lrs, launches_per_step=TRAIN_LAUNCHES,
         max_param_move_step1=max(moved.values()), lr_step1=lr1,
         forward_ms=1e3 * (t1 - t0), backward_ms=1e3 * (t2 - t1),
         optimizer_ms=1e3 * (t3 - t2), peak_memory_gb=peak_gb,
         traced_wall_ms=traced_wall_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / traced_wall_ms,
         device_events=len(spans),
         kernel_device_ms={k: span_ms(sp) for k, sp in kernel_spans.items()},
         device_ms_by_kernel=dict(by_kernel.most_common(12)),
         again_traced_wall_ms=again_wall_ms,
         again_device_busy_ms=busy_ms(again), again_kernel_device_ms=again_ms)

    # Every K1, K2, K3 and K4 call of one more step, recorded as it was
    # made for the replays.
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel, rnnt_kernel

    calls = record_many({"k1": (lstm_kernel, "lstm_fwd"),
                         "k2": (lstm_kernel, "lstm_bwd"),
                         "k3": (rnnt_kernel, "rnnt_lattice_fwd"),
                         "k4": (rnnt_kernel, "rnnt_lattice_bwd")},
                        lambda: step(state, batch), snapshot=True)
    torch.cuda.synchronize()
    del state
    return {"ms": {k: span_ms(sp) for k, sp in kernel_spans.items()},
            "launches": traced, "calls": calls}


def phase_train_main_path(dev, trained):
    """K1, K2, K3 and K4 on the train step's own inputs: every call of one
    step replayed through the kernel (errors against the plain version),
    the plain version and, for K2, cuDNN's LSTM backward; device times
    traced.  Returns K1's errors and plain time on the train step, and the
    kernels line's entries for K2, K3 and K4."""
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel, rnnt_kernel

    calls = trained["calls"]
    k1_calls = calls["k1"]
    if sum(a[0].shape[0] for a in k1_calls) != trained["launches"]["k1"]:
        raise AssertionError("the recorded K1 calls do not add up to the "
                             "step's launches")
    k1_errs = dict.fromkeys(K1_OUTPUTS, 0.0)
    with torch.no_grad():
        for args in k1_calls:
            for n, e in k1_errors(lstm_kernel.lstm_fwd(*args),
                                  lstm_kernel.lstm_fwd_reference(*args),
                                  "train step").items():
                k1_errs[n] = max(k1_errs[n], e)
    check_errors(k1_errs, "train step")

    def k1_plain_replay():
        with torch.no_grad():
            for args in k1_calls:
                lstm_kernel.lstm_fwd_reference(*args)

    _, k1_plain = device_trace(k1_plain_replay)

    k2_calls = calls["k2"]
    if sum(a[4].shape[0] + int(a[8]) for a in k2_calls) \
            != trained["launches"]["k2"]:
        raise AssertionError("the recorded K2 calls do not add up to the "
                             "step's launches")
    errs, rels = {}, {}
    for args in k2_calls:
        e, r = k2_errors(lstm_kernel.lstm_bwd(*args),
                         lstm_kernel.lstm_bwd_reference(*args), "train step")
        for n in e:
            errs[n] = max(errs.get(n, 0.0), e[n])
            rels[n] = max(rels.get(n, 0.0), r[n])
    _, k2_plain = device_trace(
        lambda: [lstm_kernel.lstm_bwd_reference(*a) for a in k2_calls])
    k2_shapes = [(a[4].shape[0], a[4].shape[1], a[4].shape[2] // 4)
                 for a in k2_calls]
    cudnn = cudnn_lstm_backward(k2_shapes, dev)
    cudnn()  # warm-up
    _, k2_lib = device_trace(cudnn)
    del cudnn
    flops = nbytes = 0.0
    for args in k2_calls:
        T, B, H4 = args[4].shape
        f, n = k2_work(T, B, H4 // 4, need_dh0=bool(args[8]))
        flops, nbytes = flops + f, nbytes + n
    k2_bound, k2_by = bound(flops, nbytes)

    (k3_args,), (k4_args,) = calls["k3"], calls["k4"]
    fwd = rnnt_kernel.rnnt_lattice_fwd(*k3_args)
    fwd_ref = rnnt_kernel.rnnt_lattice_fwd_reference(*k3_args)
    bwd = rnnt_kernel.rnnt_lattice_bwd(*k4_args)
    bwd_ref = rnnt_kernel.rnnt_lattice_bwd_reference(*k4_args)
    lat_errs = lattice_errors(fwd, bwd, fwd_ref, bwd_ref, "train step")
    _, k3_plain = device_trace(
        lambda: rnnt_kernel.rnnt_lattice_fwd_reference(*k3_args))
    _, k4_plain = device_trace(
        lambda: rnnt_kernel.rnnt_lattice_bwd_reference(*k4_args))
    B, T, U1 = k3_args[0].shape
    k3_bound, k3_by = bound(*k3_work(B, T, U1), peak=PEAK_FP32_FLOPS)
    k4_bound, k4_by = bound(*k4_work(B, T, U1), peak=PEAK_FP32_FLOPS)
    emit("train_main_path", k1_calls=len(k1_calls),
         k1_max_abs_err=k1_errs, k1_tolerance=K1_TOL,
         k1_plain_device_ms=span_ms(k1_plain), k2_calls=len(k2_calls),
         k2_shapes=[list(a[4].shape) for a in k2_calls],
         k2_max_abs_err=errs, k2_err_over_magnitude=rels,
         k2_tolerance=K2_TOL, k2_plain_device_ms=span_ms(k2_plain),
         k2_library_device_ms=span_ms(k2_lib),
         k2_library_device_events=len(k2_lib),
         k2_library="cuDNN nn.LSTM(H, H) bf16 backward (also dW, dx)",
         k2_bound_ms=k2_bound, k2_bound_by=k2_by, lattice=[B, T, U1],
         lattice_max_abs_err=lat_errs,
         k3_plain_device_ms=span_ms(k3_plain),
         k4_plain_device_ms=span_ms(k4_plain), k3_bound_ms=k3_bound,
         k4_bound_ms=k4_bound)
    ms, launches = trained["ms"], trained["launches"]
    rnnt_src = "myrtlespeech_tpu_torch/csrc/rnnt_lattice.cu"
    k1_train = {"train_max_abs_err": max(k1_errs.values()),
                "train_plain_ms": span_ms(k1_plain)}
    return k1_train, [
        {"name": "K2 lstm_bwd", "route": "cuda",
         "source": "myrtlespeech_tpu_torch/csrc/lstm_bwd.cu",
         "replaces": "myrtlespeech_tpu/ops/pallas/lstm_kernel.py:156 "
                     "(_bwd_kernel, pallas_call in _bwd_pallas_call :221)",
         "launches": launches["k2"], "max_abs_err": max(errs.values()),
         "ms": ms["k2"], "plain_ms": span_ms(k2_plain), "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": span_ms(k2_lib)},
        {"name": "K3 rnnt_lattice_fwd", "route": "cuda", "source": rnnt_src,
         "replaces": "myrtlespeech_tpu/ops/pallas/rnnt_kernel.py:76 "
                     "(_fwd_kernel, pallas_call in _call_fwd :199)",
         "launches": launches["k3"],
         "max_abs_err": max(lat_errs["alphas"], lat_errs["ll"]),
         "ms": ms["k3"], "plain_ms": span_ms(k3_plain), "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None},
        {"name": "K4 rnnt_lattice_bwd", "route": "cuda", "source": rnnt_src,
         "replaces": "myrtlespeech_tpu/ops/pallas/rnnt_kernel.py:119 "
                     "(_bwd_kernel, pallas_call in _vjp_bwd :260)",
         "launches": launches["k4"],
         "max_abs_err": max(lat_errs["gblank"], lat_errs["gemit"]),
         "ms": ms["k4"], "plain_ms": span_ms(k4_plain), "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": None},
    ]


def phase_medium_falls(dev):
    """The medium config from seeded weights, warmup off, takes
    MEDIUM_STEPS steps on one repeated batch of its train split: the loss
    must fall to under half its first value."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.configs.synthetic_medium_rnnt import \
        task_config
    from myrtlespeech_tpu_torch.data.dataset.synthetic import SyntheticSpeech
    from myrtlespeech_tpu_torch.run import train

    cfg = S.replace(task_config, train_config=S.replace(
        task_config.train_config, lr_warmup_steps=0))
    task = build_task(cfg)
    state = train.init_state(task, seed=0, device=str(dev))
    data = train.text_batches(SyntheticSpeech(cfg.train_dataset),
                              task.alphabet, 32, 32)
    batch = train.to_device(data[0], dev)
    step = train.make_train_step(task)
    losses = []
    t0 = time.perf_counter()
    for _ in range(MEDIUM_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    seconds = time.perf_counter() - t0
    emit("medium_falls", config="synthetic_medium_rnnt", batch=32,
         steps=MEDIUM_STEPS, losses=losses, seconds=seconds)
    if not (all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0]):
        raise AssertionError(f"the repeated-batch loss did not fall to half: "
                             f"{losses}")


def phase_trained(dev):
    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.configs.synthetic_medium_rnnt import \
        task_config
    from myrtlespeech_tpu_torch.data.dataset.synthetic import SyntheticSpeech
    from myrtlespeech_tpu_torch.decoding.wer import wer
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel
    from myrtlespeech_tpu_torch.run.infer import (build_transcriber,
                                                  pad_waveforms)
    from myrtlespeech_tpu_torch.weights import params_from_npz

    stt = task_config.speech_to_text
    cfg = S.replace(task_config, speech_to_text=S.replace(
        stt, post_process=S.RNNTGreedyDecoderConfig(
            blank_index=stt.loss.blank_index, max_symbols_per_step=8)))
    npz = "benchmarks/data/rnnt_medium/trained_params_bf16.npz"
    tr = build_transcriber(cfg, params_from_npz(npz, cfg), device=str(dev))
    ds = SyntheticSpeech(cfg.eval_dataset)
    items = [ds[i] for i in range(len(ds))]
    s_max = max(len(w) for w, _ in items)
    refs, hyps = [], []
    lstm_kernel.lstm_fwd.launches = 0
    t0 = time.perf_counter()
    for i in range(0, len(items), 32):
        chunk = items[i:i + 32]
        wav, lens = pad_waveforms([w for w, _ in chunk])
        wav = np.pad(wav, ((0, 0), (0, s_max - wav.shape[1])))
        hyps += tr.transcribe(wav, lens).texts
        refs += [t for _, t in chunk]
    seconds = time.perf_counter() - t0
    launches = lstm_kernel.lstm_fwd.launches
    w = wer(refs, hyps)
    emit("trained", config="synthetic_medium_rnnt", utterances=len(refs),
         wer=w, jax_wer=JAX_GREEDY_WER, tolerance=WER_TOLERANCE,
         decode_seconds=seconds, k1_launches=launches,
         examples=[[r, h] for r, h in zip(refs[:3], hyps[:3])])
    if launches == 0:
        raise AssertionError("the trained path launched K1 no time")
    if not abs(w - JAX_GREEDY_WER) <= WER_TOLERANCE:
        raise AssertionError(f"WER {w} is not within {WER_TOLERANCE} of the "
                             f"JAX package's {JAX_GREEDY_WER}")
    del tr
    trained_loss(dev, npz)


def trained_loss(dev, npz: str):
    """The trained medium model's eval loss over the 256-utterance split
    and the gradient norm of the first batch's loss, on the card, against
    the JAX package's (``port_tools/medium_eval_loss.py``)."""
    from myrtlespeech_tpu_torch.builders.build import build_task, global_norm
    from myrtlespeech_tpu_torch.configs.synthetic_medium_rnnt import \
        task_config
    from myrtlespeech_tpu_torch.data.dataset.synthetic import SyntheticSpeech
    from myrtlespeech_tpu_torch.run import train
    from myrtlespeech_tpu_torch.weights import params_from_npz

    task = build_task(task_config)
    state = train.init_state(task, params=params_from_npz(npz, task_config),
                             device=str(dev))
    data = train.text_batches(SyntheticSpeech(task_config.eval_dataset),
                              task.alphabet, 32)
    evaluate = train.eval_step_body(task)
    _zero_counts()
    losses = [float(evaluate(state, train.to_device(b, dev))["loss"])
              for b in data]
    loss, _ = train._forward(task, state.model,
                             train.to_device(data[0], dev), False)
    grads = torch.autograd.grad(loss, list(state.model.parameters()))
    gnorm = float(global_norm(grads))
    launches = _read_counts()
    mean_loss = float(np.mean(losses))
    emit("trained_loss", config="synthetic_medium_rnnt",
         utterances=sum(len(b["texts"]) for b in data), eval_loss=mean_loss,
         jax_eval_loss=JAX_EVAL_LOSS, eval_loss_rtol=EVAL_LOSS_RTOL,
         grad_norm=gnorm, jax_grad_norm=JAX_GRAD_NORM,
         grad_norm_rtol=GRAD_NORM_RTOL, launches=launches)
    if min(launches.values()) == 0:
        raise AssertionError(f"the trained loss path skipped a kernel: "
                             f"{launches}")
    if not abs(mean_loss - JAX_EVAL_LOSS) <= EVAL_LOSS_RTOL * JAX_EVAL_LOSS:
        raise AssertionError(f"eval loss {mean_loss} is not within "
                             f"{EVAL_LOSS_RTOL} of the JAX package's "
                             f"{JAX_EVAL_LOSS}")
    if not abs(gnorm - JAX_GRAD_NORM) <= GRAD_NORM_RTOL * JAX_GRAD_NORM:
        raise AssertionError(f"gradient norm {gnorm} is not within "
                             f"{GRAD_NORM_RTOL} of the JAX package's "
                             f"{JAX_GRAD_NORM}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    phase_k1(dev)
    phase_k2(dev)
    phase_k34(dev)
    flagship = phase_flagship(dev)
    k1 = phase_main_path_k1(dev, flagship)
    del flagship
    trained = phase_train(dev)
    k1["train_launches"] = trained["launches"]["k1"]
    k1["train_ms"] = trained["ms"]["k1"]
    k1_train, k234 = phase_train_main_path(dev, trained)
    k1.update(k1_train)
    del trained
    phase_medium_falls(dev)
    phase_trained(dev)
    print(json.dumps({"kernels": [k1] + k234}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
