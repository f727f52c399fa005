"""Smoke run of the PyTorch/CUDA port (``myrtlespeech_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line; any failure exits non-zero:

1. card      the card's name and power limit (nvidia-smi).
2. build     every kernel under ``myrtlespeech_tpu_torch/csrc``, one nvcc per
             source, all started together; the build time and ptxas report.
3. k1        K1 (the LSTM recurrence) against its plain PyTorch version at the
             flagship's encoder shapes and its prediction-net shape, with
             ragged lengths, on both routes (the persistent kernel, which
             these shapes take, and the per-step kernel): the largest error
             per output, and each route's, the plain version's and cuDNN's
             ``nn.LSTM`` times (CUDA events, median), beside the least time
             the card could take; each route's time again with its launches
             queued behind a spin kernel (the device's own time, without the
             host's launch rate).
4. k2        K2 (the LSTM backward) against its plain version at the train
             step's shapes (T=501 and 251 at H=1024, T=65 at H=320; B=32,
             ragged lengths, from K1's own saved tensors), on both routes:
             errors, and each route's (also queued, as in k1), the plain
             version's and cuDNN's ``nn.LSTM`` backward times (the yardstick
             also computes dW and dx).
5. k34       K3 and K4 (the transducer lattice forward and backward) against
             their plain versions on the 5 s (B=32, T'=251, U+1=65), 15 s
             (T'=751, U+1=193) and long-step (B=128, T'=836, U+1=215)
             lattices, K4 and its plain version on K3's own alphas and ll,
             and both against a float64 run of the plain K4 there: errors,
             times and bounds (no single library call computes the lattice,
             so no yardstick); at the 15 s lattice and the long lattice's
             first 8 rows, the K3-then-K4 chain's and the fp32 plain chain's
             errors against a float64 run of the plain chain.
6. k56       K5 and K6 (the joint tail forward and backward) against their
             plain versions at the flagship's lattice (B=32, T'=251, U+1=65),
             on the first 8 rows of the long step's lattice (T'=836,
             U+1=215) and at V=1024: errors, the kernels' and the plain
             versions' times beside the bounds, K6's split plan and scratch
             bytes at each shape; first ``k5_attrs`` and ``k6_attrs`` lines
             (each kernel's registers, local, shared bytes and blocks an SM
             for each activation), which fail if either spills to local
             memory.
7. flagship  ``rnn_t_en`` at full width with seeded random weights transcribes
             B=32 x 5 s of seeded audio through ``build_transcriber``: one
             warm-up and three timed runs, K1's launches on that path, a
             stage split, and one run traced with ``torch.profiler`` for
             K1's device time on the main path and the device's idle share;
             the same batch again with K1's per-step route swapped in
             (``StepwiseRoute``): latency in turns with the persistent
             route, and one traced run for the per-step route's device time
             on the same path.
8. k1_main_path  every K1 call of one such run, recorded and replayed
             through both routes (errors against the plain version on the
             main path's own inputs), the plain version and, at the same
             shapes, cuDNN (device time of each replay, traced).
9. train     ``rnn_t_en`` at full width trains on B=32 x 5 s with 64 labels
             through ``make_train_step``: a warm-up step, then timed steps
             in which K1 and K2 launch 7 times a step (one persistent launch
             per LSTM layer; the per-step route never) and K3 and K4 once
             and no plain version runs; finite loss and gradient norm, every
             parameter moved after step 1; a forward/backward/optimizer
             split; one step traced for each kernel's device time and the
             idle share; one step traced with K1 and K2 on the per-step
             route; every K1, K2, K3 and K4 call of one step replayed
             through its kernel (errors; K1 and K2 on both routes), its plain
             version and (K1, K2) cuDNN, each replay's device time traced.
             Then ``path_equality``: from one encode/predict at B=32 x 5 s,
             the loss and the gradients of f, g and the joint's weights
             through the full joint, the joint tail (K5, K6) and the chunked
             path agree.  Then ``train_long``: B=128 x 16.7 s with 214
             labels, over the memory planner's budget, trains through the
             joint tail: K1 and K2 7 launches a step, K3 to K6 one, no
             plain version; step time, split, peak memory, one traced step
             and one on K1's and K2's per-step route; the step's K1 and K2
             calls against the plain versions on both routes (one call of
             each shape), cuDNN at their shapes, the K5 and K6 calls
             against their plain versions; then the same batch through the
             chunked path (time and peak memory, or its
             out-of-memory error) as the yardstick.  Then the medium config
             (which forces the chunked path) from seeded weights, warmup
             off, takes 20 steps on one repeated batch: its loss must fall.
    After ``k56``, ``k78``: K7 and K8 (the CTC lattice forward and
             backward) against their plain versions on the DeepSpeech2
             step's lattice (B=32, T'=836, S=429), a small one with an empty
             target and the blank last, and one with U=700 (S=1401, above a
             block's 1,024 threads): errors (K7 also against a float64
             run of its plain version, at most CHAIN_RATIO times the fp32
             plain version's error; K8 bit-equal to its plain version on
             K7's alphas and ll; the K7-then-K8 chain against a float64 run
             of the plain chain), kernel and plain times, bounds,
             and PyTorch's ``F.ctc_loss`` forward and backward against the
             port's whole CTC loss on the same logits.
    After ``train_long``, ``train_ctc``: ``deep_speech_2_en`` at full width
             trains on B=32 x 16.7 s with 214 labels through
             ``make_train_step``: K1 and K2 10 launches a step at H=800,
             K7 and K8 one, K3-K6 none, no plain version; finite loss and
             gradient norm, every parameter and BatchNorm statistic moved
             after step 1; step time, split, peak memory, one traced step
             and one on the per-step route; one K1 and K2 call against the
             plain versions on both routes, cuDNN's bidirectional LSTM at
             the calls' shapes, the K7 and K8 calls against their plain
             versions (K7 and the chain also against float64, as in
             ``k78``), with ``F.ctc_loss``'s forward and backward on the
             step's logits as the yardstick; the step's loss and gradient
             norm against the same batch with the plain versions forced on
             the card; a finite eval loss.  Then
             ``ctc_falls``: ``synthetic_ctc`` from seeded weights, warmup
             off, 20 steps on one repeated batch: the loss must fall below
             half its start.
10. trained  the trained medium RNN-T (committed npz) decodes its
             256-utterance eval split greedily at B=32; its WER must lie
             within 0.01 of the JAX package's greedy WER for the same weights;
             its eval loss over the split and the gradient norm of the first
             batch must lie within tolerance of the JAX package's.

Then a ``kernels`` line (one entry per ported kernel: ``ms`` is the kernel's
device time on its main path, traced; ``plain_ms`` and ``library_ms`` the
device times of the replays; ``bound_ms`` counted from the recorded calls;
K1's and K2's entries also hold ``us_per_step``, the per-step route's
``stepwise_ms`` and ``stepwise_us_per_step``, and ``paths``: these figures
for each main path, serve, train, long and ds2), the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.  Every main path also asserts that
K1's and K2's per-step route launched no time.  Without a CUDA card the
script exits non-zero before it prints any result.
"""

from __future__ import annotations

import collections
import contextlib
import gc
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

# K3 against its plain version: the same fp32 recursion, K3 by anti-diagonals
# and the plain version by the TPU kernel's scan, so the sums run in another
# order, and CUDA's expf/log1pf and the library's may differ by an ulp, all
# compounded along the lattice: 1e-5 of the magnitude (plus 1e-3 absolute) for
# alphas and the log-likelihood (some 10^3 at the 15 s shape; K3 read 2.9e-6
# of the magnitude at the long lattice on an H100: PERF.md section 6).  K4
# walks the same anti-diagonals from the end, so it sums beta in another
# order than its plain version's scan too, and the two no longer agree bit
# for bit on the same alphas and ll.  Every K4 check holds it, on the same
# alphas and ll, against a float64 run of the plain K4: its error there may
# be at most CHAIN_RATIO times the fp32 plain K4's, on each occupancy.
# On an H100 K4 read 0.25-0.52 of the plain K4's error there (all sites).
# Where it still holds, K4 also stays within 1e-4 absolute of the plain K4
# (occupancies in [0, 1/B] at g = 1/B): it read 2.1e-5 at the 5 s lattice,
# 6.2e-5 at the long one, 1.8e-5 and 3.2e-5 on the flagship and long steps'
# own calls.  At the 15 s lattice it read 1.75e-4 (a float32 model of the
# two orders on the CPU, port_tools/lattice_order_model.py: 1.7e-4), so
# there the float64 check alone holds K4 (PERF.md section 6).  The K3-then-K4 chain against a float64 run of
# the plain chain may err by at most CHAIN_RATIO times the fp32 plain
# chain's, on ll and each occupancy.
K3_RTOL, K3_ATOL, K4_ATOL = 1e-5, 1e-3, 1e-4
CHAIN_RATIO = 3.0
K4_DIRECT_SHAPES = ("5s", "long")

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

# K5 against its plain version: the same bf16 hidden and fp32 sums in
# another order (mma tiles, an online log-sum-exp over 32-column chunks).
# Over the outputs' largest magnitude it read at most 5.5e-7 on an H100
# (the flagship lattice, the long lattice's first 8 rows, V=1024 and the long
# step's own call; PERF.md): 1e-5 leaves some 18x room.  K6 rounds dlogits to
# bf16 as the plain version does, but a sum taken in another order can put
# one element on the neighbouring bf16 value (2^-8 of it) before the
# products, and dfp and dgp come back in fp's dtype, bf16, where one
# rounding step is up to 2^-7 of the largest element.  The K6 of
# csrc/joint_tail_bwd.cu read at most 4.2e-3 of each gradient's largest
# magnitude on an H100 (dgp at long_8_rows; 3.4e-3 on the long step's own
# call; PERF.md), the kernel it replaced 6.8e-3: 2e-2 leaves some 5x room.
K5_TOL = 1e-5
K6_TOL = 2e-2
K56_OUTPUTS = ("lp_blank", "lp_emit", "dfp", "dgp", "dw2", "db2")

# The flagship train step: K1 and K2 launch once per LSTM layer (5 encoder
# layers at T=501 and 251, 2 prediction-net layers at T=65), on the
# persistent route; K3 and K4 once; its full joint fits, so K5 and K6 do not
# run.  ``k1_step``/``k2_step`` count the per-step route's launches, which no
# main path makes.
TRAIN_LABELS = 64
TRAIN_LAUNCHES = {"k1": 7, "k2": 7, "k1_step": 0, "k2_step": 0, "k3": 1,
                  "k4": 1, "k5": 0, "k6": 0, "k7": 0, "k8": 0}
TRAIN_STEPS = 5
TRAIN_LSTM_STEPS = 2 * 501 + 3 * 251 + 2 * 65  # steps of K1's / K2's calls
MEDIUM_STEPS = 20

# The long train step: rnn_t_en at B=128 x 16.7 s (the configs'
# max_duration_s) with 214 labels (bench.py's 12.8 labels a second): T=1671
# frames, T'=836 after the time reduction, U+1=215.  Its full joint is
# projected at 78.7 GB, over the planner's budget, so it trains through the
# joint tail: K1 and K2 once per LSTM layer (T=1671, 836 and 215), K3 to
# K6 once.
LONG_BATCH, LONG_SECONDS, LONG_LABELS = 128, 16.7, 214
LONG_LAUNCHES = {"k1": 7, "k2": 7, "k1_step": 0, "k2_step": 0, "k3": 1,
                 "k4": 1, "k5": 1, "k6": 1, "k7": 0, "k8": 0}
LONG_STEPS = 3
LONG_LSTM_STEPS = 2 * 1671 + 3 * 836 + 2 * 215

FLAGSHIP_BATCH, FLAGSHIP_SECONDS = 32, 5.0

# The DeepSpeech2 train step: deep_speech_2_en at B=32 x 16.7 s (its
# max_duration_s) with 214 labels: T=1671 frames, T'=836 after the first
# conv's stride 2, S=429 lattice columns.  K1 and K2 launch once for each
# of the 10 LSTM directions (5 BiLSTM-800 layers, T'=836 steps each); K7 and
# K8 once; no transducer kernel runs.
CTC_BATCH, CTC_SECONDS, CTC_LABELS = 32, 16.7, 214
CTC_LAUNCHES = {"k1": 10, "k2": 10, "k1_step": 0, "k2_step": 0, "k3": 0,
                "k4": 0, "k5": 0, "k6": 0, "k7": 1, "k8": 1}
CTC_STEPS = 3
CTC_LSTM_STEPS = 10 * 836
CTC_FALLS_STEPS = 20

# K7 against its plain version: the same fp32 stencil, but K7 sums each
# cell's three terms with one log (the largest plus the log of one plus the
# other two's exps, by ex2.approx and lg2.approx) where the plain
# version nests two precise logaddexps, all compounded along the chain of
# rows: 1e-5 of the magnitude (plus 1e-3 absolute) for alphas and the
# log-likelihood (some 3e3 at the DeepSpeech2 lattice; a float32 model of the
# two orders on the CPU, port_tools/lattice_order_model.py, read 4.4e-3 apart
# there, within 1.2e-2 of the allowance at every k78 shape).  Every K7 check
# also holds it against a float64 run of the plain version: its error there,
# on the alphas of reachable cells and on ll, may be at most CHAIN_RATIO
# times the fp32 plain version's (the model: 0.45-1.12), and the K7-then-K8
# chain's gradient at most CHAIN_RATIO times the fp32 plain chain's.  K8
# keeps its plain version's order: on the same inputs (K7's alphas and ll)
# it stays within 1e-4 absolute of it, bit-equal in fact (the occupancy
# gradients lie in [0, 1] times |g|).  PyTorch's F.ctc_loss sums its own
# recursion in another order: its per-example losses within 1e-4 of ours.
K7_RTOL, K7_ATOL, K8_ATOL = 1e-5, 1e-3, 1e-4
CTC_LIBRARY_RTOL = 1e-4

# The DeepSpeech2 step with the kernels against the same step with the plain
# versions forced on the card (same batch, weights and SpecAugment masks).
# K1 and K2 differ from their plain versions by a bf16 step here and there
# (K1_TOL, K2_TOL), which ten LSTM directions and four BatchNorms carry into
# the logits; K7 sums in another order than its plain version (some 1e-3 on
# an ll of 3e3) and K8 is bit-equal to its own.  In two runs on an H100 the
# loss read 2.1e-7 and 3.7e-6 apart and the gradient norm 3.2e-4 and 6.4e-5,
# relative (PERF.md): 1e-4 and 5e-3 leave some 15-25x room.
CTC_PLAIN_TOL = {"loss": 1e-4, "grad_norm": 5e-3}


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


def device_trace(fn, or_events: bool = False):
    """Run ``fn`` once under ``torch.profiler``.  Returns the wall ms of the
    call (profiler overhead included) and its device events as ``(name,
    start_us, end_us)``: kernels, copies and memsets.  A trace can come back
    with no device event at all (seen with ``F.ctc_loss``'s kernels: once,
    and in another run three times in a row); then ``fn`` runs traced
    again, at most twice more.  If all three are empty, a caller that needs
    only the summed time (``or_events``) gets one span of ``EVENTS_SPAN``
    lasting the CUDA-event median of three runs queued behind a spin kernel
    (``cuda_ms``), and a ``trace_fallback`` line says so; any other caller
    gets an error."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
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
        spans = [(e["name"], float(e["ts"]),
                  float(e["ts"]) + float(e["dur"]))
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and "dur" in e]
        if spans:
            return wall_ms, spans
    if not or_events:
        raise AssertionError("torch.profiler traced no device event, three "
                             "times")
    ms = cuda_ms(fn, 3, queued=True)
    code = getattr(fn, "__code__", None)
    emit("trace_fallback", cuda_event_ms=ms,
         call=f"{code.co_qualname} at line {code.co_firstlineno}" if code
         else repr(fn))
    return wall_ms, [(EVENTS_SPAN, 0.0, 1e3 * ms)]


# The one span of a call that the profiler did not trace (``device_trace``).
EVENTS_SPAN = "(cuda events: the profiler traced no device event)"


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
    """K1 against its plain version, timed, at the main path's shapes, on
    both routes: the persistent kernel (where :func:`lstm_route` sends these
    shapes) and the per-step kernel, each also queued behind a spin kernel.

    The flagship's encoder runs K1 at T=501 (layers 1-2, input widths 80 and
    1024) and T=251 (layers 3-5, input widths 2048, 1024, 1024), H=1024; its
    prediction net at T=1, H=320, once per layer and decode iteration.
    """
    from torch import nn

    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as k

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
        route = k._route(dev, B, H)
        if route != "persistent":
            raise AssertionError(f"K1 {label} takes the {route} route")
        want = k.lstm_fwd_reference(*args)
        errs = k1_errors(k.lstm_fwd(*args), want, label)
        check_errors(errs, label)
        step_errs = k1_errors(k.lstm_fwd_stepwise(*args), want, label)
        check_errors(step_errs, f"{label} per-step route")
        del want
        reps = 20 if T > 1 else 200
        times = {}
        for name, fn in (("kernel", k.lstm_fwd_persistent),
                         ("stepwise", k.lstm_fwd_stepwise)):
            times[f"{name}_ms"] = cuda_ms(lambda: fn(*args), reps)
            times[f"{name}_queued_ms"] = cuda_ms(lambda: fn(*args), 5,
                                                 queued=True)
            times[f"{name}_queued_us_per_step"] = \
                1e3 * times[f"{name}_queued_ms"] / T
        plain_ms = cuda_ms(lambda: k.lstm_fwd_reference(*args),
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
        emit("k1", shape=label, T=T, B=B, H=H, route=route, max_abs_err=errs,
             stepwise_max_abs_err=step_errs, **times, plain_ms=plain_ms,
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


def k3_work(B: int, T: int, U1: int):
    """(fp32 operations, bytes) of one K3 call: the function's own work, one
    logaddexp (max, difference, |.|, exp, log1p, add) and two additions
    (alpha + blank, alpha + emit) per cell, whatever order computes it; and
    the bytes that must move (both log-prob tensors and the lengths read
    once; alphas and ll written once)."""
    flops = 8.0 * B * T * U1
    nbytes = 2 * B * T * U1 * 4 + 2 * B * 4 + T * B * U1 * 4 + B * 4
    return flops, nbytes


def k4_work(B: int, T: int, U1: int):
    """(fp32 operations, bytes) of one K4 call: the function's own work,
    whatever order computes it: for beta one logaddexp and two additions
    per cell (as K3's alpha), for the two occupancies two exponentials and
    some 8 additions and multiplications; and the bytes that must move
    (log-probs, alphas, lengths, ll and g read once; the two occupancy
    tensors written once)."""
    flops = (8.0 + 2.0 + 8.0) * B * T * U1
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


def cudnn_lstm_backward(shapes, dev, bidirectional: bool = False):
    """Yardstick only, never called by the port: a function that runs the
    backward of cuDNN's ``nn.LSTM(H, H)`` in bf16 at full lengths (dx and
    every weight's gradient, not only what K2 computes) once for each ``(T,
    B, H)`` of ``shapes``, from forwards kept for it; ``bidirectional``
    runs both directions of a layer in each call."""
    from torch import nn

    work = []
    for T, B, H in shapes:
        cell = nn.LSTM(H, H, bidirectional=bidirectional).to(dev,
                                                              torch.bfloat16)
        x = torch.randn(T, B, H, device=dev, dtype=torch.bfloat16,
                        requires_grad=True)
        out, _ = cell(x)
        work.append((out, [x] + list(cell.parameters()),
                     torch.randn_like(out)))

    def run():
        for out, inputs, grad in work:
            torch.autograd.grad(out, inputs, grad, retain_graph=True)

    return run


def cudnn_lstm_forward(shapes, dev, bidirectional: bool = False):
    """Yardstick only, never called by the port: a function that runs
    cuDNN's ``nn.LSTM(H, H)`` forward in bf16 at full lengths, inference
    mode, once for each ``(T, B, H)`` of ``shapes`` (it also computes the
    input projection, which the port does outside K1)."""
    from torch import nn

    cells, work = {}, []
    for T, B, H in shapes:
        if H not in cells:
            cells[H] = nn.LSTM(H, H, bidirectional=bidirectional).to(
                dev, torch.bfloat16)
        work.append((cells[H], torch.randn(T, B, H, device=dev,
                                           dtype=torch.bfloat16)))

    def run():
        with torch.inference_mode():
            for cell, x in work:
                cell(x)

    return run


def cudnn_replay(calls, kind: str, dev, bidirectional: bool = False):
    """Yardstick only: the traced device ms of cuDNN's ``nn.LSTM(H, H)``
    forward (``kind`` "k1") or backward ("k2") at the shapes of recorded
    K1 or K2 calls (``bidirectional``: one call for each pair of
    directions), after a warm-up.  Returns ``(ms, description)``."""
    shapes = [tuple(a[0].shape[:2]) + (a[0].shape[2] // 4,) if kind == "k1"
              else tuple(a[4].shape[:2]) + (a[4].shape[2] // 4,)
              for a in calls]
    if bidirectional:
        shapes = shapes[::2]
    run = (cudnn_lstm_forward if kind == "k1"
           else cudnn_lstm_backward)(shapes, dev, bidirectional)
    run()  # warm-up
    _, spans = device_trace(run, or_events=True)
    del run
    torch.cuda.empty_cache()
    what = ("forward (also the input projection)" if kind == "k1"
            else "backward (also dW, dx)")
    bi = ", bidirectional" if bidirectional else ""
    return span_ms(spans), (f"cuDNN nn.LSTM(H, H{bi}) bf16 {what}, "
                            f"{len(shapes)} calls")


def phase_k2(dev):
    """K2 against its plain version, timed, at the train step's shapes, on
    both routes, each also queued (as in k1)."""
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as k

    B = FLAGSHIP_BATCH
    shapes = {"enc_T501": (501, 1024), "enc_T251": (251, 1024),
              "pred_T65": (65, 320)}
    torch.manual_seed(1)  # the yardstick's weights and inputs
    for i, (label, (T, H)) in enumerate(shapes.items()):
        args = _k2_case(T, B, H, seed=20 + i, dev=dev)
        want = k.lstm_bwd_reference(*args, need_dh0=False)
        errs, rel = k2_errors(k.lstm_bwd(*args, need_dh0=False), want, label)
        step_errs, step_rel = k2_errors(
            k.lstm_bwd_stepwise(*args, need_dh0=False), want,
            f"{label} per-step route")
        del want
        times = {}
        for name, fn in (("kernel", k.lstm_bwd_persistent),
                         ("stepwise", k.lstm_bwd_stepwise)):
            times[f"{name}_ms"] = cuda_ms(lambda: fn(*args, need_dh0=False),
                                          10)
            times[f"{name}_queued_ms"] = cuda_ms(
                lambda: fn(*args, need_dh0=False), 5, queued=True)
            times[f"{name}_queued_us_per_step"] = \
                1e3 * times[f"{name}_queued_ms"] / T
        plain_ms = cuda_ms(lambda: k.lstm_bwd_reference(*args,
                                                        need_dh0=False), 2)
        lib_ms = cuda_ms(cudnn_lstm_backward([(T, B, H)], dev), 10)
        bound_ms, bound_by = bound(*k2_work(T, B, H))
        emit("k2", shape=label, T=T, B=B, H=H, route=k._route(dev, B, H),
             max_abs_err=errs, err_over_magnitude=rel,
             stepwise_max_abs_err=step_errs,
             stepwise_err_over_magnitude=step_rel, tolerance=K2_TOL,
             **times, plain_ms=plain_ms, library_ms=lib_ms,
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


def _float64_ratio(ek: float, ep: float) -> float:
    return ek / ep if ep > 0 else (0.0 if ek == 0 else float("inf"))


def k4_vs_float64(k4_args, bwd, bwd_ref):
    """K4 (``bwd``) and its fp32 plain version (``bwd_ref``), both fed
    ``k4_args`` (K3's alphas and ll among them), each against a float64 run
    of the plain version on the same inputs: for each occupancy the largest
    |error| of each and the kernel's over the plain version's."""
    from myrtlespeech_tpu_torch.ops.cuda import rnnt_kernel as k

    occ64 = k.rnnt_lattice_bwd_reference(*k4_args, dtype=torch.float64)
    out = {}
    for name, got, ref, want in zip(("gblank", "gemit"), bwd, bwd_ref, occ64):
        ek = (got.double() - want).abs().max().item()
        ep = (ref.double() - want).abs().max().item()
        out[name] = {"kernel": ek, "plain": ep,
                     "ratio": _float64_ratio(ek, ep)}
    return out


def lattice_errors(fwd, bwd, fwd_ref, bwd_ref, k4_args, label: str,
                   k4_direct: bool = True):
    """Largest errors of K3 (alphas of reachable cells, ll) against its plain
    version and of K4 (both occupancies) against its plain version on the
    same inputs: ``bwd_ref`` is the plain K4 fed ``k4_args``, K3's own
    alphas and ll among them, as ``bwd`` is; and ``k4_float64``, K4's and
    the plain K4's errors against a float64 run of the plain K4 on those
    inputs (``k4_vs_float64``).  Raises beyond K3's tolerance, where K4
    errs by more than CHAIN_RATIO times the plain K4 against float64, or,
    with ``k4_direct``, beyond K4_ATOL from the plain K4."""
    alphas, ll = fwd
    a_ref, ll_ref = fwd_ref
    reach = a_ref > -1e29
    errs = {
        "alphas": (alphas[reach] - a_ref[reach]).abs().max().item(),
        "ll": (ll - ll_ref).abs().max().item(),
        "gblank": (bwd[0] - bwd_ref[0]).abs().max().item(),
        "gemit": (bwd[1] - bwd_ref[1]).abs().max().item(),
        "k4_float64": k4_vs_float64(k4_args, bwd, bwd_ref)}
    ok = (bool((alphas[~reach] < -1e29).all())
          and torch.allclose(alphas[reach], a_ref[reach], rtol=K3_RTOL,
                             atol=K3_ATOL)
          and torch.allclose(ll, ll_ref, rtol=K3_RTOL, atol=K3_ATOL)
          and all(e["ratio"] <= CHAIN_RATIO
                  for e in errs["k4_float64"].values())
          and (not k4_direct or (errs["gblank"] <= K4_ATOL
                                 and errs["gemit"] <= K4_ATOL)))
    if not ok:
        raise AssertionError(
            f"K3/K4 {label}: max |err| {errs} beyond rtol {K3_RTOL} atol "
            f"{K3_ATOL} (K3), {CHAIN_RATIO}x the plain K4 against float64 "
            f"(K4)" + (f" or atol {K4_ATOL} (K4)" if k4_direct else ""))
    return errs


def lattice_chain_errors(args, g, label: str):
    """The kernels' chain (K3, then K4 on its alphas) and the plain chain in
    fp32, each against a float64 run of the plain chain: the largest |error|
    of alphas (reachable cells), ll and each occupancy.  Raises when the
    kernels' error on ll or an occupancy exceeds CHAIN_RATIO times the plain
    chain's."""
    from myrtlespeech_tpu_torch.ops.cuda import rnnt_kernel as k

    f64 = torch.float64
    a64, ll64 = k.rnnt_lattice_fwd_reference(*args, dtype=f64)
    occ64 = k.rnnt_lattice_bwd_reference(*args, a64, ll64, g, dtype=f64)
    reach = a64 > -1e29

    def errs(fwd, occ):
        return {"alphas": (fwd[0].double() - a64)[reach].abs().max().item(),
                "ll": (fwd[1].double() - ll64).abs().max().item(),
                "gblank": (occ[0].double() - occ64[0]).abs().max().item(),
                "gemit": (occ[1].double() - occ64[1]).abs().max().item()}

    kf = k.rnnt_lattice_fwd(*args)
    kernels = errs(kf, k.rnnt_lattice_bwd(*args, *kf, g))
    pf = k.rnnt_lattice_fwd_reference(*args)
    plain = errs(pf, k.rnnt_lattice_bwd_reference(*args, *pf, g))
    ratio = {n: _float64_ratio(kernels[n], plain[n]) for n in kernels}
    bad = {n: ratio[n] for n in ("ll", "gblank", "gemit")
           if not ratio[n] <= CHAIN_RATIO}
    if bad:
        raise AssertionError(f"K3->K4 chain {label}: error against float64 "
                             f"{kernels}, the plain chain's {plain}: ratios "
                             f"{bad} over {CHAIN_RATIO}")
    return {"kernels": kernels, "plain": plain, "ratio": ratio}


def phase_k34(dev):
    """K3 and K4 against their plain versions, timed, on the 5 s and 15 s
    lattices of the flagship at B=32 and the long step's (B=128, T'=836,
    U+1=215); K4's plain version takes K3's own alphas and ll.  Then both
    chains against float64 at the 15 s lattice and the long lattice's first
    8 rows."""
    from myrtlespeech_tpu_torch.ops.cuda import rnnt_kernel as k

    shapes = {"5s": (32, 251, 65), "15s": (32, 751, 193),
              "long": (LONG_BATCH, 836, LONG_LABELS + 1)}
    for i, (label, (B, T, U1)) in enumerate(shapes.items()):
        args = _lattice_case(B, T, U1, seed=30 + i, dev=dev)
        g = torch.ones((B,), device=dev) / B  # d mean(-ll) / d ll, negated
        fwd = k.rnnt_lattice_fwd(*args)
        bwd = k.rnnt_lattice_bwd(*args, *fwd, g)
        torch.cuda.synchronize()
        fwd_ref = k.rnnt_lattice_fwd_reference(*args)
        bwd_ref = k.rnnt_lattice_bwd_reference(*args, *fwd, g)
        errs = lattice_errors(fwd, bwd, fwd_ref, bwd_ref, (*args, *fwd, g),
                              label, k4_direct=label in K4_DIRECT_SHAPES)
        del fwd_ref, bwd_ref, bwd
        times = {
            "k3_ms": cuda_ms(lambda: k.rnnt_lattice_fwd(*args), 10),
            "k4_ms": cuda_ms(lambda: k.rnnt_lattice_bwd(*args, *fwd, g), 10),
            "k3_plain_ms": cuda_ms(lambda: k.rnnt_lattice_fwd_reference(
                *args), 2),
            "k4_plain_ms": cuda_ms(lambda: k.rnnt_lattice_bwd_reference(
                *args, *fwd, g), 2)}
        chain = None
        if label != "5s":
            rows = min(B, 8)
            chain = lattice_chain_errors(
                [a[:rows].contiguous() for a in args], g[:rows].contiguous(),
                f"{label} (first {rows} rows)")
        b3, by3 = bound(*k3_work(B, T, U1), peak=PEAK_FP32_FLOPS)
        b4, by4 = bound(*k4_work(B, T, U1), peak=PEAK_FP32_FLOPS)
        emit("k34", shape=label, B=B, T=T, U1=U1, max_abs_err=errs,
             tolerance={"k3_rtol": K3_RTOL, "k3_atol": K3_ATOL,
                        "k4_atol": K4_ATOL if label in K4_DIRECT_SHAPES
                        else None, "k4_float64_ratio": CHAIN_RATIO,
                        "chain_ratio": CHAIN_RATIO},
             chain_vs_float64=chain, **times, library_ms=None,
             k3_bound_ms=b3, k3_bound_by=by3, k4_bound_ms=b4,
             k4_bound_by=by4)
        del args, fwd
        torch.cuda.empty_cache()


def k56_work(B: int, T: int, U1: int, K: int, V: int, in_bytes: int = 2,
             w_bytes: int = 4):
    """(operations, bytes) of one K5 and one K6 call: K5's product (2 *
    cells * K * V), K6's three; the bytes that must move: fp, gp (``in_bytes``
    an element), W2 (``w_bytes``), b2 and the labels read once, K5's two
    (B, T, U+1) fp32 outputs written once; K6 reads the same inputs and the
    two cotangents and writes dfp, dgp, dW2 and db2 once."""
    cells = B * T * U1
    ins = (B * T + B * U1) * K * in_bytes + K * V * w_bytes + V * 4 \
        + B * U1 * 4
    k5 = (2.0 * cells * K * V, ins + 2 * cells * 4)
    k6 = (6.0 * cells * K * V, ins + 2 * cells * 4
          + (B * T + B * U1) * K * in_bytes + K * V * w_bytes + V * 4)
    return k5, k6


def _k56_case(B, T, U1, K, V, seed, dev):
    """K5/K6 inputs as the main path makes them: bf16 projections, an fp32
    W2 and b2, labels in [1, V) padded with 0 at column U; cotangents of the
    size of the lattice's (some 1/B)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dev)

    fp = normal(B, T, K).to(torch.bfloat16)
    gp = normal(B, U1, K).to(torch.bfloat16)
    lab = torch.from_numpy(rng.integers(1, V, (B, U1)).astype(
        np.int32)).to(dev)
    lab[:, -1] = 0
    args = (fp, gp, normal(K, V, scale=1 / np.sqrt(K)), normal(V, scale=0.1),
            lab)
    return args, (normal(B, T, U1, scale=1 / B), normal(B, T, U1, scale=1 / B))


def k56_errors(got, want, label: str):
    """Largest |kernel - plain| per output of K5 and K6, and each over the
    output's largest magnitude; raises beyond K5_TOL / K6_TOL of it."""
    errs, rel = {}, {}
    for name, g, w in zip(K56_OUTPUTS, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"K5/K6 {label} {name}: {g.dtype} "
                                 f"{tuple(g.shape)} vs plain {w.dtype} "
                                 f"{tuple(w.shape)}")
        errs[name] = (g.float() - w.float()).abs().max().item()
        rel[name] = errs[name] / (w.float().abs().max().item() + 1e-30)
    bad = {n: r for n, r in rel.items()
           if not np.isfinite(r)
           or r > (K5_TOL if n.startswith("lp") else K6_TOL)}
    if bad:
        raise AssertionError(f"K5/K6 {label}: max |err| {errs}, relative "
                             f"{rel}, beyond {K5_TOL} (K5) / {K6_TOL} (K6) "
                             "of the magnitude")
    return errs, rel


JOINT_CFG = (0, "relu", 20.0, "bfloat16")  # blank, act, clip, mxu dtype


def phase_k56(dev):
    """K5 and K6 against their plain versions, timed: at the flagship's
    lattice, on the long lattice's first 8 rows (where the plain version's
    (B, T', U+1, K) tensors fit) and at a vocabulary of 1,024 (32 chunks of
    the online log-sum-exp).  Times are CUDA-event medians of the wrapper
    calls (operand layout and, for K6, the sums of its slabs included).
    First K6's kernel attributes for each activation, at K=512 and V=29
    (one vocabulary chunk, the main path) and V=1024 (its chunked form), and
    K5's likewise: neither may spill."""
    from myrtlespeech_tpu_torch.ops.cuda import joint_kernel as k

    spills = {}
    for name, query in (("k5", k.k5_attributes), ("k6", k.k6_attributes)):
        attrs = {act: query(dev, act) for act in k.ACTS}
        attrs.update({f"{act}_V1024": query(dev, act, 1024)
                      for act in k.ACTS})
        emit(f"{name}_attrs", K=512, **attrs)
        spills.update({f"{name}_{a}": v["localSizeBytes"]
                       for a, v in attrs.items() if v["localSizeBytes"] > 0})
    if spills:
        raise AssertionError(f"K5/K6 spill to local memory: {spills} bytes a "
                             "thread")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {"5s": (32, 251, 65, 512, 29),
              "long_8_rows": (8, 836, 215, 512, 29),
              "V1024": (4, 64, 33, 512, 1024)}
    for i, (label, (B, T, U1, K, V)) in enumerate(shapes.items()):
        args, cot = _k56_case(B, T, U1, K, V, seed=40 + i, dev=dev)
        got = k.joint_tail_fwd(*args, *JOINT_CFG) \
            + k.joint_tail_bwd(*args, *cot, *JOINT_CFG)
        torch.cuda.synchronize()
        want = k.joint_tail_fwd_reference(*args, *JOINT_CFG) \
            + k.joint_tail_bwd_reference(*args, *cot, *JOINT_CFG)
        errs, rel = k56_errors(got, want, label)
        del got, want
        times = {
            "k5_ms": cuda_ms(lambda: k.joint_tail_fwd(*args, *JOINT_CFG), 10),
            "k6_ms": cuda_ms(lambda: k.joint_tail_bwd(*args, *cot,
                                                      *JOINT_CFG), 10),
            "k5_plain_ms": cuda_ms(lambda: k.joint_tail_fwd_reference(
                *args, *JOINT_CFG), 2),
            "k6_plain_ms": cuda_ms(lambda: k.joint_tail_bwd_reference(
                *args, *cot, *JOINT_CFG), 2)}
        (f5, n5), (f6, n6) = k56_work(B, T, U1, K, V)
        b5, by5 = bound(f5, n5)
        b6, by6 = bound(f6, n6)
        Vp = -(-V // k.V_TILE) * k.V_TILE
        n_split, t_tile = k.k6_plan(B, T, U1, K, sms,
                                    k.k6_attributes(dev)["blocksPerSM"], Vp)
        emit("k56", shape=label, B=B, T=T, U1=U1, K=K, V=V, max_abs_err=errs,
             err_over_magnitude=rel, k6_n_split=n_split, k6_t_tile=t_tile,
             k6_scratch_bytes=k.k6_scratch_bytes(B, U1, K, Vp, n_split),
             tolerance={"k5": K5_TOL, "k6": K6_TOL}, **times,
             library_ms=None, k5_bound_ms=b5, k5_bound_by=by5,
             k6_bound_ms=b6, k6_bound_by=by6)
        del args, cot
        torch.cuda.empty_cache()


def k78_work(B: int, T: int, S: int):
    """(fp32 operations, bytes) of one K7 and one K8 call: some 15
    operations per cell for the stencil (two logaddexps of max, difference,
    |.|, exp, log1p and add; the add of lp), K8 six more for the occupancy
    (three adds, exp, multiply); the bytes that must move: K7 reads lp_ext,
    can_skip and the lengths once and writes alphas and ll once, K8 reads
    lp_ext, alphas, can_skip, the lengths, ll and g once and writes the
    gradient once.  Every frame runs, padded ones included, so the work does
    not depend on the lengths."""
    cells = B * T * S
    k7 = (15.0 * cells, 2 * cells * 4 + B * S * 4 + 2 * B * 4)
    k8 = (21.0 * cells, 3 * cells * 4 + B * S * 4 + 3 * B * 4)
    return k7, k8


def _ctc_case(B, T, U, V, blank, seed, dev, empty_row: bool = False):
    """Random logits (B, T, V) and labels (never the blank) with ragged
    frame and label lengths, the first row full and 2 label_len <=
    logit_len, so that every row has a path; with ``empty_row`` the last row
    has an empty target."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    fl = rng.integers(3 * T // 4, T + 1, B).astype(np.int32)
    fl[0] = T
    lab = rng.integers(0, V - 1, (B, U))
    lab = (np.where(lab >= blank, lab + 1, lab) % V).astype(np.int32)
    ul = np.minimum(rng.integers(3 * U // 4, U + 1, B), fl // 2).astype(
        np.int32)
    ul[0] = min(U, T // 2)
    if empty_row:
        ul[-1] = 0
    return tuple(torch.from_numpy(a).to(dev) for a in (logits, fl, lab, ul))


def k7_vs_float64(k7_args, fwd, fwd_ref):
    """K7 (``fwd``) and its fp32 plain version (``fwd_ref``) on ``k7_args``,
    each against a float64 run of the plain version on the same inputs: for
    the alphas of reachable cells and ll, the largest |error| of each and
    the kernel's over the plain version's."""
    from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel as k

    want = k.ctc_lattice_fwd_reference(*k7_args, dtype=torch.float64)
    reach = want[0] > -1e29
    out = {}
    for i, name in enumerate(("alphas", "ll")):
        got, ref, w = fwd[i].double(), fwd_ref[i].double(), want[i]
        if name == "alphas":
            got, ref, w = got[reach], ref[reach], w[reach]
        ek = (got - w).abs().max().item()
        ep = (ref - w).abs().max().item()
        out[name] = {"kernel": ek, "plain": ep,
                     "ratio": _float64_ratio(ek, ep)}
    return out


def ctc_errors(fwd, bwd, fwd_ref, bwd_ref, k7_args, label: str):
    """Largest errors of K7 (alphas of reachable cells, ll) against its plain
    version and of K8 (the gradient) against its plain version on the same
    inputs: ``bwd_ref`` is the plain K8 fed K7's own alphas and ll, as
    ``bwd`` is; and ``k7_float64``, K7's and the plain K7's errors against a
    float64 run of the plain version on ``k7_args`` (``k7_vs_float64``).
    Raises beyond K7's tolerance, where K7 errs by more than CHAIN_RATIO
    times the plain version against float64, or beyond K8_ATOL (K8)."""
    alphas, ll = fwd
    a_ref, ll_ref = fwd_ref
    reach = a_ref > -1e29
    errs = {"alphas": (alphas[reach] - a_ref[reach]).abs().max().item(),
            "ll": (ll - ll_ref).abs().max().item(),
            "grad": (bwd - bwd_ref).abs().max().item(),
            "k7_float64": k7_vs_float64(k7_args, fwd, fwd_ref)}
    ok = (bool((alphas[~reach] < -1e29).all())
          and torch.allclose(alphas[reach], a_ref[reach], rtol=K7_RTOL,
                             atol=K7_ATOL)
          and torch.allclose(ll, ll_ref, rtol=K7_RTOL, atol=K7_ATOL)
          and all(e["ratio"] <= CHAIN_RATIO
                  for e in errs["k7_float64"].values())
          and errs["grad"] <= K8_ATOL)
    if not ok:
        raise AssertionError(f"K7/K8 {label}: max |err| {errs} beyond rtol "
                             f"{K7_RTOL} atol {K7_ATOL} (K7), {CHAIN_RATIO}x "
                             f"the plain K7 against float64, atol {K8_ATOL} "
                             f"(K8)")
    return errs


def ctc_chain_errors(k7_args, g, label: str):
    """The kernels' chain (K7, then K8 on its alphas) and the plain chain in
    fp32, each against a float64 run of the plain chain: the largest |error|
    of ll and the gradient.  Raises when the kernels' error on either
    exceeds CHAIN_RATIO times the plain chain's."""
    from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel as k

    f64 = torch.float64
    a64, ll64 = k.ctc_lattice_fwd_reference(*k7_args, dtype=f64)
    grad64 = k.ctc_lattice_bwd_reference(*k7_args, a64, ll64, g, dtype=f64)
    del a64

    def errs(fwd, grad):
        return {"ll": (fwd[1].double() - ll64).abs().max().item(),
                "grad": (grad.double() - grad64).abs().max().item()}

    kf = k.ctc_lattice_fwd(*k7_args)
    kernels = errs(kf, k.ctc_lattice_bwd(*k7_args, *kf, g))
    del kf
    pf = k.ctc_lattice_fwd_reference(*k7_args)
    plain = errs(pf, k.ctc_lattice_bwd_reference(*k7_args, *pf, g))
    del pf
    ratio = {n: _float64_ratio(kernels[n], plain[n]) for n in kernels}
    bad = {n: r for n, r in ratio.items() if not r <= CHAIN_RATIO}
    if bad:
        raise AssertionError(f"K7->K8 chain {label}: error against float64 "
                             f"{kernels}, the plain chain's {plain}: ratios "
                             f"{bad} over {CHAIN_RATIO}")
    return {"kernels": kernels, "plain": plain, "ratio": ratio}


def _library_ctc(logits, logit_lens, labels, label_lens, blank):
    """Yardstick only, never called by the port: PyTorch's ``F.ctc_loss``
    on the log-softmax of ``logits``, per example."""
    return torch.nn.functional.ctc_loss(
        torch.log_softmax(logits.float(), -1).transpose(0, 1), labels.long(),
        logit_lens.long(), label_lens.long(), blank=blank, reduction="none")


def phase_k78(dev):
    """K7 and K8 against their plain versions, timed: on the DeepSpeech2
    step's lattice, a small one with an empty target and the blank last,
    and one with S=1401 (two columns a thread).  K7 also against a float64
    run of its plain version, K8 and its plain version both fed K7's alphas
    and ll, and the K7-then-K8 chain against a float64 run of the plain
    chain.  Times are CUDA-event medians of the wrapper calls; the yardstick
    is ``F.ctc_loss``'s forward and backward (from the logits, log-softmax
    included) against the port's whole CTC loss, forward and backward, on
    the same logits."""
    from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel as k

    shapes = {"ds2": (32, 836, 214, 29, 0, False),
              "empty_blank_last": (5, 50, 12, 29, 28, True),
              "U700": (4, 1500, 700, 29, 0, False)}
    for i, (label, (B, T, U, V, blank, empty)) in enumerate(shapes.items()):
        logits, fl, lab, ul = _ctc_case(B, T, U, V, blank, 50 + i, dev,
                                        empty)
        lp, skip = k.ctc_lattice_inputs(logits, fl, lab, ul, blank)
        g = torch.full((B,), -1.0 / B, device=dev)  # d mean(-ll) / d ll
        fwd = k.ctc_lattice_fwd(lp, skip, ul)
        bwd = k.ctc_lattice_bwd(lp, skip, ul, *fwd, g)
        torch.cuda.synchronize()
        fwd_ref = k.ctc_lattice_fwd_reference(lp, skip, ul)
        bwd_ref = k.ctc_lattice_bwd_reference(lp, skip, ul, *fwd, g)
        errs = ctc_errors(fwd, bwd, fwd_ref, bwd_ref, (lp, skip, ul), label)
        # K8 keeps its plain version's stencil and sums: bit-equal on the
        # same inputs.
        k8_bit_equal = torch.equal(bwd, bwd_ref)
        if not k8_bit_equal:
            raise AssertionError(f"K8 {label}: not bit-equal to its plain "
                                 "version on the same inputs")
        chain = ctc_chain_errors((lp, skip, ul), g, label)
        lib_nll = _library_ctc(logits, fl, lab, ul, blank)
        lib_rel = ((lib_nll + fwd[1]).abs() / lib_nll.abs()).max().item()
        if not lib_rel <= CTC_LIBRARY_RTOL:
            raise AssertionError(f"K7 {label}: F.ctc_loss differs by {lib_rel}"
                                 f" relative, beyond {CTC_LIBRARY_RTOL}")
        del fwd_ref, bwd_ref

        def port_loss():
            x = logits.detach().requires_grad_()
            k.ctc_loss_lattice(x, fl, lab, ul, blank).sum().backward()

        def library_loss():
            x = logits.detach().requires_grad_()
            _library_ctc(x, fl, lab, ul, blank).sum().backward()

        times = {
            "k7_ms": cuda_ms(lambda: k.ctc_lattice_fwd(lp, skip, ul), 10),
            "k8_ms": cuda_ms(lambda: k.ctc_lattice_bwd(lp, skip, ul, *fwd, g),
                             10),
            "k7_plain_ms": cuda_ms(lambda: k.ctc_lattice_fwd_reference(
                lp, skip, ul), 2),
            "k8_plain_ms": cuda_ms(lambda: k.ctc_lattice_bwd_reference(
                lp, skip, ul, *fwd, g), 2),
            "port_loss_fwd_bwd_ms": cuda_ms(port_loss, 10),
            "library_ms": cuda_ms(library_loss, 10)}
        S = 2 * U + 1
        (f7, n7), (f8, n8) = k78_work(B, T, S)
        b7, by7 = bound(f7, n7, peak=PEAK_FP32_FLOPS)
        b8, by8 = bound(f8, n8, peak=PEAK_FP32_FLOPS)
        emit("k78", shape=label, B=B, T=T, U=U, S=S, V=V, blank=blank,
             empty_targets=int((ul == 0).sum()), max_abs_err=errs,
             k8_bit_equal=k8_bit_equal, chain_vs_float64=chain,
             library_rel_diff=lib_rel,
             tolerance={"k7_rtol": K7_RTOL, "k7_atol": K7_ATOL,
                        "k7_float64_ratio": CHAIN_RATIO,
                        "chain_ratio": CHAIN_RATIO, "k8_atol": K8_ATOL,
                        "library_rtol": CTC_LIBRARY_RTOL},
             **times,
             library="F.ctc_loss forward + backward from the logits, "
                     "against log_softmax + gather + K7 + K8 + scatter",
             k7_bound_ms=b7, k7_bound_by=by7, k8_bound_ms=b8, k8_bound_by=by8)
        del logits, lp, skip, fwd, bwd
        torch.cuda.empty_cache()


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
    lstm_kernel.lstm_fwd_stepwise.launches = 0
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
    if lstm_kernel.lstm_fwd_stepwise.launches:
        raise AssertionError(f"K1's per-step route launched "
                             f"{lstm_kernel.lstm_fwd_stepwise.launches} "
                             "times on the serve path")
    # Latency by route within one run: the same batch with K1's per-step
    # route in its place (StepwiseRoute), in turns with the persistent one.
    turns = []
    for route in ("persistent", "stepwise", "stepwise", "persistent"):
        with StepwiseRoute() if route == "stepwise" \
                else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.transcribe(wav, lens)
            turns.append([route, 1e3 * (time.perf_counter() - t0)])
    if min(launches) == 0 or len(set(launches)) != 1:
        raise AssertionError(f"K1 launches per run on the main path: "
                             f"{launches}")
    k1_spans = named(spans, TRACE_NAMES["k1"])
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

    enc = 5  # one persistent launch per encoder layer
    pred = launches[0] - enc
    if pred <= 0 or pred % 2:
        raise AssertionError(f"K1 launches {launches[0]}: expected {enc} "
                             "encoder layers plus 2 per prediction step")
    # The per-step route on the same path, traced: one launch per encoder
    # step (2 x 501 + 3 x 251) and per prediction call (T=1).
    steps = 2 * 501 + 3 * 251 + pred
    stepwise_ms = stepwise_trace(
        lambda: tr.transcribe(wav, lens),
        dict.fromkeys(TRACE_NAMES, 0) | {"k1_step": steps})["k1"]
    ms = 1e3 * statistics.median(times)
    busy = busy_ms(spans)
    emit("flagship", config="rnn_t_en", batch=FLAGSHIP_BATCH,
         seconds=FLAGSHIP_SECONDS, setup_s=setup_s, ms_per_batch=ms,
         ms_runs=[1e3 * t for t in times],
         audio_s_per_s=FLAGSHIP_BATCH * FLAGSHIP_SECONDS / (ms / 1e3),
         k1_launches=launches[0], k1_encoder_launches=enc,
         k1_prediction_launches=pred, decode_iterations=pred // 2 - 1,
         k1_steps=steps, k1_stepwise_device_ms=stepwise_ms,
         **stages, route_turns_ms=turns, traced_wall_ms=traced_wall_ms,
         device_busy_ms=busy,
         device_idle_share=1.0 - busy / traced_wall_ms,
         device_events=len(spans), k1_device_ms=span_ms(k1_spans),
         device_ms_by_kernel=dict(by_kernel.most_common(10)),
         token_lens=tlens.tolist())
    return {"launches": launches[-1], "k1_ms": span_ms(k1_spans),
            "stepwise_ms": stepwise_ms,
            "calls": record_many({"k1": (lstm_kernel, "lstm_fwd")},
                                 lambda: tr.transcribe(wav, lens))["k1"]}


def max_into(acc: dict, errs: dict) -> None:
    """acc[name] = max(acc.get(name, 0), errs[name]) for every name."""
    for n, e in errs.items():
        acc[n] = max(acc.get(n, 0.0), e)


def path_figures(launches: int, ms: float, steps: int, stepwise_ms: float,
                 replays: dict) -> dict:
    """One main path's K1 or K2 figures for the kernels line: launches and
    device ms of the traced main path (persistent route), its steps and us
    a step; the per-step route's device ms and us a step on the same path
    (``stepwise_trace``); cuDNN's and the plain version's ms and the bound
    (``lstm_replays``, or the serve path's own)."""
    return {"launches": launches, "ms": ms, "steps": steps,
            "us_per_step": 1e3 * ms / steps, "stepwise_ms": stepwise_ms,
            "stepwise_us_per_step": 1e3 * stepwise_ms / steps,
            **{k: replays[k] for k in ("library_ms", "library", "plain_ms",
                                       "plain_calls", "bound_ms",
                                       "max_abs_err") if k in replays}}


def phase_main_path_k1(dev, flagship):
    """K1 on the flagship main path's own inputs: every K1 call of one
    ``transcribe``, replayed through both routes (errors against the plain
    version), through the plain version and, at the same shapes, cuDNN's
    ``nn.LSTM(H, H)`` forward, each replay traced for device time."""
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as k

    calls = flagship["calls"]
    if len(calls) != flagship["launches"]:
        raise AssertionError("the recorded K1 calls do not match the main "
                             "path's launches")
    errs, step_errs = {}, {}
    with torch.inference_mode():  # the recorded inputs are inference tensors
        for args in calls:
            want = k.lstm_fwd_reference(*args)
            max_into(errs, k1_errors(k.lstm_fwd(*args), want, "main path"))
            max_into(step_errs, k1_errors(k.lstm_fwd_stepwise(*args), want,
                                          "main path"))
    check_errors(errs, "main path")
    check_errors(step_errs, "main path, per-step route")

    def plain_replay():
        with torch.inference_mode():
            for args in calls:
                k.lstm_fwd_reference(*args)

    _, plain_spans = device_trace(plain_replay, or_events=True)
    library_ms, library = cudnn_replay(calls, "k1", dev)

    flops = nbytes = 0.0
    for x_proj, _valid, w_hh, _h0, _c0, b in calls:
        T, B, H4 = x_proj.shape
        f, n = k1_work(T, B, H4 // 4, bias=b is not None)
        flops, nbytes = flops + f, nbytes + n
    bound_ms, bound_by = bound(flops, nbytes)
    serve = path_figures(
        flagship["launches"], flagship["k1_ms"],
        sum(a[0].shape[0] for a in calls), flagship["stepwise_ms"],
        {"library_ms": library_ms, "library": library,
         "plain_ms": span_ms(plain_spans), "bound_ms": bound_ms})
    emit("k1_main_path", calls=len(calls), max_abs_err=errs,
         stepwise_max_abs_err=step_errs, tolerance=K1_TOL,
         plain_device_events=len(plain_spans), gflop=flops / 1e9,
         gbytes=nbytes / 1e9, bound_by=bound_by, **serve)
    serve["max_abs_err"] = max(list(errs.values())
                               + list(step_errs.values()))
    return {
        "name": "K1 lstm_fwd", "route": "cuda",
        "source": "myrtlespeech_tpu_torch/csrc/lstm_fwd_persistent.cu",
        "stepwise_source": "myrtlespeech_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "myrtlespeech_tpu/ops/pallas/lstm_kernel.py:38 "
                    "(_lstm_kernel, pallas_call in _lstm_pallas_fwd_call :92)",
        "launches": flagship["launches"], "max_abs_err": serve["max_abs_err"],
        "ms": flagship["k1_ms"], "us_per_step": serve["us_per_step"],
        "stepwise_ms": serve["stepwise_ms"],
        "stepwise_us_per_step": serve["stepwise_us_per_step"],
        "plain_ms": serve["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "paths": {"serve": serve},
    }


def _train_kernels():
    from myrtlespeech_tpu_torch.ops.cuda import (ctc_kernel, joint_kernel,
                                                 lstm_kernel, rnnt_kernel)

    return {"k1": lstm_kernel.lstm_fwd, "k2": lstm_kernel.lstm_bwd,
            "k1_step": lstm_kernel.lstm_fwd_stepwise,
            "k2_step": lstm_kernel.lstm_bwd_stepwise,
            "k3": rnnt_kernel.rnnt_lattice_fwd,
            "k4": rnnt_kernel.rnnt_lattice_bwd,
            "k5": joint_kernel.joint_tail_fwd,
            "k6": joint_kernel.joint_tail_bwd,
            "k7": ctc_kernel.ctc_lattice_fwd,
            "k8": ctc_kernel.ctc_lattice_bwd}


def _zero_counts():
    for fn in _train_kernels().values():
        fn.launches = 0


def _read_counts():
    return {k: fn.launches for k, fn in _train_kernels().items()}


def no_stepwise(launches, label: str) -> None:
    """Raises when K1's or K2's per-step route launched (``launches`` from
    ``_read_counts``): every main path of the repo's configs takes the
    persistent route."""
    if launches["k1_step"] or launches["k2_step"]:
        raise AssertionError(f"the per-step K1/K2 route launched on the "
                             f"{label} path: {launches}")


def _plain_guard():
    from myrtlespeech_tpu_torch.ops.cuda import (ctc_kernel, joint_kernel,
                                                 lstm_kernel, rnnt_kernel)

    return PlainGuard([(lstm_kernel, "lstm_fwd_reference"),
                       (lstm_kernel, "lstm_bwd_reference"),
                       (rnnt_kernel, "rnnt_lattice_fwd_reference"),
                       (rnnt_kernel, "rnnt_lattice_bwd_reference"),
                       (joint_kernel, "joint_tail_fwd_reference"),
                       (joint_kernel, "joint_tail_bwd_reference"),
                       (ctc_kernel, "ctc_lattice_fwd_reference"),
                       (ctc_kernel, "ctc_lattice_bwd_reference")])


# Kernel names in a profiler trace.  On a main path K1's and K2's launches
# are the persistent kernels' (``k1``, ``k2``); ``k1_step``/``k2_step`` are
# the per-step route's.
TRACE_NAMES = {"k1": "lstm_fwd_persistent_kernel",
               "k2": "lstm_bwd_persistent_kernel",
               "k1_step": "lstm_step_kernel",
               "k2_step": "lstm_bwd_step_kernel",
               "k3": "rnnt_fwd_kernel", "k4": "rnnt_bwd_kernel",
               "k5": "joint_tail_fwd_kernel", "k6": "joint_tail_bwd_kernel",
               "k7": "ctc_fwd_kernel", "k8": "ctc_bwd_kernel"}


def named(spans, name: str):
    """The spans of the kernels whose name holds ``name``."""
    return [sp for sp in spans if name in sp[0]]


def trace_step(fn, want):
    """One run of ``fn`` traced, with the launch counters zeroed first: its
    wall ms, device events and each kernel's events.  The counters must read
    ``want``.  The profiler has been seen to drop a kernel's event from a
    trace (one trace in eight, its other events kept); when a kernel's
    events do not number its launches, ``fn`` runs traced again, at most
    twice more.  Returns ``(wall_ms, spans, kernel_spans, retries)``."""
    for retries in range(3):
        _zero_counts()
        wall_ms, spans = device_trace(fn)
        counts = _read_counts()
        if counts != want:
            raise AssertionError(f"traced launches {counts}, expected {want}")
        kernel_spans = {k: named(spans, name)
                        for k, name in TRACE_NAMES.items()}
        found = {k: len(sp) for k, sp in kernel_spans.items()}
        if found == counts:
            return wall_ms, spans, kernel_spans, retries
    raise AssertionError(f"three traces held {found} kernels, the counters "
                         f"{counts}")


class StepwiseRoute:
    """Runs K1's and K2's per-step route in place of their dispatchers
    while it is entered (the wrappers' callers look them up at call time):
    the same main path, for the per-step route's time on it."""

    def __init__(self):
        from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel

        self.module = lstm_kernel

    def __enter__(self):
        m = self.module
        self.real = m.lstm_fwd, m.lstm_bwd
        m.lstm_fwd, m.lstm_bwd = m.lstm_fwd_stepwise, m.lstm_bwd_stepwise
        return self

    def __exit__(self, *exc):
        self.module.lstm_fwd, self.module.lstm_bwd = self.real
        return False


def stepwise_trace(fn, want):
    """``fn`` (a main path) traced under ``StepwiseRoute``, with the launch
    counters zeroed first; they must read ``want`` after it (``k1_step`` and
    ``k2_step`` the path's LSTM steps, ``k1`` and ``k2`` 0).  As in
    ``trace_step``, a trace whose per-step kernels do not number their
    launches is taken again, at most twice more.  Returns the per-step
    route's device ms of K1 and K2."""
    for _ in range(3):
        _zero_counts()
        with StepwiseRoute():
            _, spans = device_trace(fn)
        counts = _read_counts()
        if counts != want:
            raise AssertionError(f"per-step route launches {counts}, "
                                 f"expected {want}")
        kern = {k: named(spans, TRACE_NAMES[f"{k}_step"])
                for k in ("k1", "k2")}
        if all(len(kern[k]) == counts[f"{k}_step"] for k in kern):
            return {k: span_ms(sp) for k, sp in kern.items()}
    raise AssertionError(f"three traces held {[len(v) for v in kern.values()]}"
                         f" per-step kernels, the counters {counts}")


def with_stepwise(launches: dict, steps: int) -> dict:
    """A path's launch counts with K1 and K2 on the per-step route: one
    launch a step each, none of the persistent kernels."""
    return dict(launches, k1=0, k2=0,
                k1_step=steps if launches["k1"] else 0,
                k2_step=steps if launches["k2"] else 0)


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
    traced = TRAIN_LAUNCHES
    traced_wall_ms, spans, kernel_spans, retries = trace_step(
        lambda: step(state, batch), traced)
    by_kernel = collections.Counter()
    for name, s, e in spans:
        by_kernel[name[:80]] += (e - s) / 1e3
    busy = busy_ms(spans)
    # A second traced step, to show how far one trace's device times vary.
    again_wall_ms, again = device_trace(lambda: step(state, batch))
    again_ms = {k: span_ms(named(again, name))
                for k, name in TRACE_NAMES.items()}
    # The same step with K1 and K2 on the per-step route, traced.
    stepwise_ms = stepwise_trace(lambda: step(state, batch),
                                 with_stepwise(traced, TRAIN_LSTM_STEPS))
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
         device_events=len(spans), trace_retries=retries,
         kernel_device_ms={k: span_ms(sp) for k, sp in kernel_spans.items()},
         device_ms_by_kernel=dict(by_kernel.most_common(12)),
         again_traced_wall_ms=again_wall_ms,
         again_device_busy_ms=busy_ms(again), again_kernel_device_ms=again_ms,
         stepwise_kernel_device_ms=stepwise_ms)

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
            "stepwise_ms": stepwise_ms, "launches": traced, "calls": calls}


def lstm_replays(k1_calls, k2_calls, label: str, dev,
                 plain_per_shape: bool = False, bidirectional: bool = False):
    """K1 and K2 on a main path's recorded calls.  Each call checked (all,
    or with ``plain_per_shape`` the first of each shape) goes through both
    routes and the plain version: the largest errors, raising beyond
    K1_TOL / K2_TOL; the plain version's traced device time over the same
    calls; cuDNN's at the shapes of every call (``cudnn_replay``); the
    bound over every call.  Returns ``{"k1": ..., "k2": ...}``, each with
    ``max_abs_err`` the largest error of either route."""
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as k

    checked = {"k1": k1_calls, "k2": k2_calls}
    if plain_per_shape:
        checked = {"k1": list(_first_per_shape(
            k1_calls, lambda a: a[0].shape).values()),
            "k2": list(_first_per_shape(
                k2_calls, lambda a: a[4].shape).values())}
    out = {}
    with torch.no_grad():
        errs, step_errs = {}, {}
        for args in checked["k1"]:
            want = k.lstm_fwd_reference(*args)
            max_into(errs, k1_errors(k.lstm_fwd(*args), want, label))
            max_into(step_errs, k1_errors(k.lstm_fwd_stepwise(*args), want,
                                          label))
            del want
        check_errors(errs, label)
        check_errors(step_errs, f"{label}, per-step route")
        out["k1"] = {"max_abs_err": errs, "stepwise_max_abs_err": step_errs}
        errs, rels, step_errs, step_rels = {}, {}, {}, {}
        for args in checked["k2"]:
            want = k.lstm_bwd_reference(*args)
            e, r = k2_errors(k.lstm_bwd(*args), want, label)
            max_into(errs, e)
            max_into(rels, r)
            e, r = k2_errors(k.lstm_bwd_stepwise(*args), want,
                             f"{label}, per-step route")
            max_into(step_errs, e)
            max_into(step_rels, r)
            del want
        out["k2"] = {"max_abs_err": errs, "err_over_magnitude": rels,
                     "stepwise_max_abs_err": step_errs,
                     "stepwise_err_over_magnitude": step_rels}

    def plain(ref, calls):
        def run():
            with torch.no_grad():
                for args in calls:
                    ref(*args)
        return span_ms(device_trace(run, or_events=True)[1])

    out["k1"]["plain_ms"] = plain(k.lstm_fwd_reference, checked["k1"])
    out["k2"]["plain_ms"] = plain(k.lstm_bwd_reference, checked["k2"])
    works = {"k1": [k1_work(*a[0].shape[:2], a[0].shape[2] // 4,
                            a[5] is not None) for a in k1_calls],
             "k2": [k2_work(*a[4].shape[:2], a[4].shape[2] // 4, bool(a[8]))
                    for a in k2_calls]}
    for kind, calls in (("k1", k1_calls), ("k2", k2_calls)):
        o = out[kind]
        o["plain_calls"] = len(checked[kind])
        o["library_ms"], o["library"] = cudnn_replay(calls, kind, dev,
                                                     bidirectional)
        o["bound_ms"], o["bound_by"] = bound(
            sum(w[0] for w in works[kind]), sum(w[1] for w in works[kind]))
        o["persistent_max_abs_err"] = o.pop("max_abs_err")
        o["max_abs_err"] = max(list(o["persistent_max_abs_err"].values())
                               + list(o["stepwise_max_abs_err"].values()))
    return out


def phase_train_main_path(dev, trained):
    """K1, K2, K3 and K4 on the train step's own inputs: every call of one
    step replayed through the kernel (errors against the plain version),
    the plain version and, for K1 and K2, the other route and cuDNN
    (``lstm_replays``); device times traced.  Returns K1's train-step
    figures and the kernels line's entries for K2, K3 and K4."""
    from myrtlespeech_tpu_torch.ops.cuda import rnnt_kernel

    calls = trained["calls"]
    launches, ms = trained["launches"], trained["ms"]
    if (len(calls["k1"]), len(calls["k2"])) != (launches["k1"],
                                                launches["k2"]):
        raise AssertionError("the recorded K1/K2 calls do not match the "
                             "step's launches")
    lstm = lstm_replays(calls["k1"], calls["k2"], "train step", dev)
    k1, k2 = lstm["k1"], lstm["k2"]
    k1_train, k2_train = (
        path_figures(launches[k], ms[k], TRAIN_LSTM_STEPS,
                     trained["stepwise_ms"][k], lstm[k]) for k in ("k1", "k2"))

    (k3_args,), (k4_args,) = calls["k3"], calls["k4"]
    fwd = rnnt_kernel.rnnt_lattice_fwd(*k3_args)
    fwd_ref = rnnt_kernel.rnnt_lattice_fwd_reference(*k3_args)
    bwd = rnnt_kernel.rnnt_lattice_bwd(*k4_args)
    bwd_ref = rnnt_kernel.rnnt_lattice_bwd_reference(*k4_args)
    lat_errs = lattice_errors(fwd, bwd, fwd_ref, bwd_ref, k4_args,
                              "train step")
    _, k3_plain = device_trace(
        lambda: rnnt_kernel.rnnt_lattice_fwd_reference(*k3_args),
        or_events=True)
    _, k4_plain = device_trace(
        lambda: rnnt_kernel.rnnt_lattice_bwd_reference(*k4_args),
        or_events=True)
    B, T, U1 = k3_args[0].shape
    k3_bound, k3_by = bound(*k3_work(B, T, U1), peak=PEAK_FP32_FLOPS)
    k4_bound, k4_by = bound(*k4_work(B, T, U1), peak=PEAK_FP32_FLOPS)
    emit("train_main_path", k1_calls=len(calls["k1"]),
         k2_calls=len(calls["k2"]),
         k2_shapes=[list(a[4].shape) for a in calls["k2"]], k1=k1, k2=k2,
         k1_train=k1_train, k2_train=k2_train,
         k1_tolerance=K1_TOL, k2_tolerance=K2_TOL, lattice=[B, T, U1],
         lattice_max_abs_err=lat_errs,
         k3_plain_device_ms=span_ms(k3_plain),
         k4_plain_device_ms=span_ms(k4_plain), k3_bound_ms=k3_bound,
         k4_bound_ms=k4_bound)
    rnnt_src = "myrtlespeech_tpu_torch/csrc/rnnt_lattice.cu"
    return k1_train, [
        {"name": "K2 lstm_bwd", "route": "cuda",
         "source": "myrtlespeech_tpu_torch/csrc/lstm_bwd_persistent.cu",
         "stepwise_source": "myrtlespeech_tpu_torch/csrc/lstm_bwd.cu",
         "replaces": "myrtlespeech_tpu/ops/pallas/lstm_kernel.py:156 "
                     "(_bwd_kernel, pallas_call in _bwd_pallas_call :221)",
         "launches": launches["k2"], "max_abs_err": k2["max_abs_err"],
         "ms": ms["k2"], "us_per_step": k2_train["us_per_step"],
         "stepwise_ms": k2_train["stepwise_ms"],
         "stepwise_us_per_step": k2_train["stepwise_us_per_step"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
         "paths": {"train": k2_train}},
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


# Path equality at the flagship shape: the loss and the gradients of f, g
# and the joint's parameters through the joint-tail and chunked paths
# against the full joint, over the loss's magnitude and each gradient's
# largest magnitude.  The full joint's backward runs in bf16 (the Dense
# layer's dtype): it rounds dlogits @ W2^T to bf16 for every cell before the
# sums over u and t, where the joint tail and the JAX package's kernel sum
# in fp32, and f's gradient, a sum over 65 u of terms that largely cancel,
# shows it most.  On an H100 the joint tail read 0.0497 (f) and at most
# 0.0108 elsewhere, the chunked path 0.0066 (its per-chunk sums run in
# another order), both losses bit-equal to the full joint's (PERF.md): 2x
# and 3x room on the gradients, 1e-5 on the loss.
PATH_TOL = {"chunked": {"loss": 1e-5, "grads": 2e-2},
            "joint_tail": {"loss": 1e-5, "grads": 0.1}}


def _flagship_f_g(task, model, batch):
    """Eval-mode encoder and prediction outputs of one batch, as leaves."""
    with torch.no_grad():
        feats, flens = task.preprocess(batch["wav"], batch["wav_lens"], False)
        f, f_lens = model.encode(feats, flens)
        g = model.predict(batch["labels"], batch["label_lens"])
    return f.detach().requires_grad_(), f_lens, g.detach().requires_grad_()


def phase_path_equality(dev):
    """From one encode/predict of rnn_t_en at B=32 x 5 s, the transducer loss
    through the full joint, the joint tail (K5, K6, then K3, K4) and the
    chunked path (chunk 64): the loss and the gradients of f, g, W1, b1, W2
    and b2 agree within PATH_TOL."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.run import train
    from myrtlespeech_tpu_torch.run.infer import load_config

    task = build_task(load_config("rnn_t_en"))
    state = train.init_state(task, seed=0, device=str(dev))
    model = state.model
    batch = train.to_device(train.example_batch(
        FLAGSHIP_BATCH, FLAGSHIP_SECONDS, TRAIN_LABELS, 0), dev)
    f, f_lens, g = _flagship_f_g(task, model, batch)
    labels, label_lens = batch["labels"], batch["label_lens"]
    dense = model.joint_net.rest.Dense_0
    leaves = {"f": f, "g": g, "W1": model.joint_net.kernel,
              "b1": model.joint_net.bias, "W2": dense.kernel,
              "b2": dense.bias}
    paths = {
        "full": lambda: task.loss_fn(model.joint(f, g, True), f_lens, labels,
                                     label_lens),
        "joint_tail": lambda: task.joint_tail_loss(
            model, f, f_lens, g, labels, label_lens, True),
        "chunked": lambda: task.fused_loss_auto(
            model, f, f_lens, g, labels, label_lens, True, chunk_size=64)}
    out, launches = {}, {}
    for name, fn in paths.items():
        _zero_counts()
        loss = fn()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        launches[name] = _read_counts()
        out[name] = (loss.item(), [gr.float() for gr in grads])
    loss_full, grads_full = out["full"]
    errs = {}
    for name in ("joint_tail", "chunked"):
        loss, grads = out[name]
        errs[name] = {"loss": abs(loss - loss_full) / abs(loss_full)}
        for leaf, gr, w in zip(leaves, grads, grads_full):
            errs[name][leaf] = ((gr - w).abs().max().item()
                                / (w.abs().max().item() + 1e-30))
    emit("path_equality", config="rnn_t_en", batch=FLAGSHIP_BATCH,
         seconds=FLAGSHIP_SECONDS, lattice=[FLAGSHIP_BATCH, f.shape[1],
                                            g.shape[1]],
         losses={n: o[0] for n, o in out.items()},
         err_over_magnitude=errs, tolerance=PATH_TOL, launches=launches)
    if launches["joint_tail"]["k5"] != 1 or launches["joint_tail"]["k6"] != 1:
        raise AssertionError(f"the joint-tail path did not run K5 and K6 "
                             f"once each: {launches['joint_tail']}")
    for name, e in errs.items():
        tol = PATH_TOL[name]
        if not (e["loss"] <= tol["loss"]
                and all(np.isfinite(v) and v <= tol["grads"]
                        for k, v in e.items() if k != "loss")):
            raise AssertionError(f"the {name} path differs from the full "
                                 f"joint by {e}, beyond {tol}")
    del state, model, out


def _first_per_shape(calls, shape_of):
    """The first recorded call of each distinct shape."""
    seen = {}
    for args in calls:
        seen.setdefault(tuple(shape_of(args)), args)
    return seen


def _plain_in_rows(ref, args, n_tensor_args: int, rows: int = 8):
    """The plain version of K5 (``n_tensor_args`` 5) or K6 (7) over a call's
    batch rows, ``rows`` at a time (its (rows, T', U+1, K) tensors fit where
    the whole batch's do not): the row-wise outputs concatenated, K6's dW2
    and db2 summed."""
    tensors, cfg = args[:n_tensor_args], args[n_tensor_args:]
    parts = [ref(*(t[i:i + rows] for t in tensors[:2]), *tensors[2:4],
                 *(t[i:i + rows] for t in tensors[4:]), *cfg)
             for i in range(0, tensors[0].shape[0], rows)]
    out = [torch.cat([p[j] for p in parts]) for j in range(2)]
    for j in range(2, len(parts[0])):
        out.append(sum(p[j].float() for p in parts).to(parts[0][j].dtype))
    return tuple(out)


def peaks_around(module, name: str, fn, dev) -> dict:
    """Peak device memory of one run of ``fn`` before, during and after its
    call of ``module.name`` (one call), in GB: where the run's peak lies."""
    real = getattr(module, name)
    peaks = {}

    def measured(*args, **kwargs):
        torch.cuda.synchronize()
        peaks["before_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        peaks["during_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        return out

    measured.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    setattr(module, name, measured)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, real)
    peaks["after_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return peaks


def phase_train_long(dev):
    """rnn_t_en at full width trains on B=128 x 16.7 s with 214 labels:
    the planner sends it to the joint-tail path; K1-K6 launch as
    LONG_LAUNCHES a step and no plain version runs; finite loss, every
    parameter moved after step 1; step time, split, peak memory; one traced
    step (device time by kernel, idle share); the step's K1, K2 (one call of
    each shape), K3, K4, K5 and K6 calls replayed against their plain
    versions; then
    the same batch through the chunked path (the planner's chunk) for its
    time and peak memory, or its out-of-memory error."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.ops.cuda import (joint_kernel, lstm_kernel,
                                                 rnnt_kernel)
    from myrtlespeech_tpu_torch.run import train
    from myrtlespeech_tpu_torch.run.infer import load_config

    B, secs, U = LONG_BATCH, LONG_SECONDS, LONG_LABELS
    task = build_task(load_config("rnn_t_en"))
    t0 = time.perf_counter()
    state = train.init_state(task, seed=0, device=str(dev))
    batch = train.to_device(train.example_batch(B, secs, U, 0), dev)
    frames = int(16000 * secs) // 160 + 1
    T2 = -(-frames // 2)
    probe = (torch.zeros((B, T2, 1024), device=dev),
             torch.zeros((B, U + 1, 320), device=dev))
    fused, chunk = train._select_joint_path(task, *probe, backward=True)
    if fused is not task.joint_tail_loss:
        raise AssertionError(f"the long batch (B, T', U+1) = {(B, T2, U + 1)} "
                             "did not take the joint-tail path")
    step = train.make_train_step(task)
    state, m = step(state, batch)  # warm-up: step 0, whose lr is 0
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}

    torch.cuda.reset_peak_memory_stats(dev)
    times, losses, gnorms = [], [], []
    with _plain_guard() as guard:
        _zero_counts()
        for i in range(LONG_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
            gnorms.append(float(m["grad_norm"]))
            if i == 0:
                moved = {n: (p.detach() - before[n]).abs().max().item()
                         for n, p in state.model.named_parameters()}
        launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del before
    if guard.calls:
        raise AssertionError(f"plain versions ran on the long train path: "
                             f"{dict(guard.calls)}")
    want = {k: n * LONG_STEPS for k, n in LONG_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"launches over {LONG_STEPS} long steps: "
                             f"{launches}, expected {want}")
    if not all(np.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"long step loss {losses} or grad_norm {gnorms} "
                             "not finite")
    if min(moved.values()) <= 0:
        raise AssertionError(f"parameters after step 1 moved by {moved}")

    # Stage split of one more step, host clock, synced at each boundary.
    torch.cuda.synchronize()
    split = [time.perf_counter()]
    state.optimizer.zero_grad()
    loss, _ = train._forward(task, state.model, batch, True, state.gen)
    torch.cuda.synchronize()
    split.append(time.perf_counter())
    loss.backward()
    torch.cuda.synchronize()
    split.append(time.perf_counter())
    state.optimizer.step(state.step)
    state.step += 1
    torch.cuda.synchronize()
    split.append(time.perf_counter())
    del loss
    k6_peaks = peaks_around(joint_kernel, "joint_tail_bwd",
                            lambda: step(state, batch), dev)

    traced = LONG_LAUNCHES
    traced_wall_ms, spans, kernel_spans, retries = trace_step(
        lambda: step(state, batch), traced)
    by_kernel = collections.Counter()
    for name, s, e in spans:
        by_kernel[name[:80]] += (e - s) / 1e3
    busy = busy_ms(spans)
    stepwise_ms = stepwise_trace(lambda: step(state, batch),
                                 with_stepwise(traced, LONG_LSTM_STEPS))

    # The step's calls, for the replays: every K1 and K2 call (the plain
    # versions on the first of each shape), K5's and K6's one call each.
    calls = record_many({"k1": (lstm_kernel, "lstm_fwd"),
                         "k2": (lstm_kernel, "lstm_bwd"),
                         "k3": (rnnt_kernel, "rnnt_lattice_fwd"),
                         "k4": (rnnt_kernel, "rnnt_lattice_bwd"),
                         "k5": (joint_kernel, "joint_tail_fwd"),
                         "k6": (joint_kernel, "joint_tail_bwd")},
                        lambda: step(state, batch))
    torch.cuda.synchronize()
    lstm = lstm_replays(calls.pop("k1"), calls.pop("k2"), "long step", dev,
                        plain_per_shape=True)
    (k3_args,), (k4_args,) = calls.pop("k3"), calls.pop("k4")
    lat_errs = lattice_errors(
        rnnt_kernel.rnnt_lattice_fwd(*k3_args),
        rnnt_kernel.rnnt_lattice_bwd(*k4_args),
        rnnt_kernel.rnnt_lattice_fwd_reference(*k3_args),
        rnnt_kernel.rnnt_lattice_bwd_reference(*k4_args), k4_args,
        "long step")
    del k3_args, k4_args
    (k5_args,), (k6_args,) = calls["k5"], calls["k6"]
    del calls
    torch.cuda.empty_cache()
    with torch.no_grad():
        got = joint_kernel.joint_tail_fwd(*k5_args) \
            + joint_kernel.joint_tail_bwd(*k6_args)
        want = _plain_in_rows(joint_kernel.joint_tail_fwd_reference, k5_args,
                              5) \
            + _plain_in_rows(joint_kernel.joint_tail_bwd_reference, k6_args, 7)
        k56_errs, k56_rel = k56_errors(got, want, "long step")
        del got, want
        torch.cuda.empty_cache()
        _, k5_plain = device_trace(lambda: _plain_in_rows(
            joint_kernel.joint_tail_fwd_reference, k5_args, 5), or_events=True)
        _, k6_plain = device_trace(lambda: _plain_in_rows(
            joint_kernel.joint_tail_bwd_reference, k6_args, 7), or_events=True)
    fp, gp, w2 = k5_args[0], k5_args[1], k5_args[2]
    Bk, Tk, K = fp.shape
    U1k, V = gp.shape[1], w2.shape[1]
    (f5, n5), (f6, n6) = k56_work(Bk, Tk, U1k, K, V, fp.element_size(),
                                  w2.element_size())
    b5, by5 = bound(f5, n5)
    b6, by6 = bound(f6, n6)
    Vp = -(-V // joint_kernel.V_TILE) * joint_kernel.V_TILE
    k6_split, _ = joint_kernel.k6_plan(
        Bk, Tk, U1k, joint_kernel.MAX_K, torch.cuda.get_device_properties(dev)
        .multi_processor_count,
        joint_kernel.k6_attributes(dev, k6_args[8], Vp)["blocksPerSM"], Vp)
    del k5_args, k6_args
    torch.cuda.empty_cache()

    # The yardstick: the same batch's step through the chunked path, which
    # the port takes when the joint tail is switched off.
    os.environ["MYRTLE_DISABLE_PALLAS_JOINT"] = "1"
    try:
        c_fused, c_chunk = train._select_joint_path(task, *probe,
                                                    backward=True)
        if c_fused is not task.fused_loss_auto:
            raise AssertionError("the long batch did not take the chunked "
                                 "path with the joint tail switched off")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        c_times = []
        try:
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                c_loss = float(m["loss"])
                c_times.append(time.perf_counter() - t0)
            chunked = {"chunk": c_chunk, "ms_runs": [1e3 * t for t in c_times],
                       "ms_per_step": 1e3 * statistics.median(c_times[1:]),
                       "peak_memory_gb":
                           torch.cuda.max_memory_allocated(dev) / 1e9,
                       "loss": c_loss}
        except torch.cuda.OutOfMemoryError as exc:
            chunked = {"chunk": c_chunk, "out_of_memory": str(exc)[:400],
                       "ms_runs": [1e3 * t for t in c_times]}
    finally:
        del os.environ["MYRTLE_DISABLE_PALLAS_JOINT"]
    del state, probe
    gc.collect()
    torch.cuda.empty_cache()

    ms = 1e3 * statistics.median(times)
    kernel_ms = {k: span_ms(sp) for k, sp in kernel_spans.items()}
    k1_long, k2_long = (
        path_figures(traced[k], kernel_ms[k], LONG_LSTM_STEPS,
                     stepwise_ms[k], lstm[k]) for k in ("k1", "k2"))
    emit("train_long", config="rnn_t_en", batch=B, seconds=secs, labels=U,
         lattice=[B, T2, U + 1], path="joint_tail", setup_s=setup_s,
         ms_per_step=ms, ms_runs=[1e3 * t for t in times],
         audio_s_per_s=B * secs / (ms / 1e3), losses=losses,
         grad_norms=gnorms, launches_per_step=LONG_LAUNCHES,
         max_param_move_step1=max(moved.values()),
         forward_ms=1e3 * (split[1] - split[0]),
         backward_ms=1e3 * (split[2] - split[1]),
         optimizer_ms=1e3 * (split[3] - split[2]), peak_memory_gb=peak_gb,
         peak_memory_around_k6=k6_peaks, traced_wall_ms=traced_wall_ms,
         device_busy_ms=busy,
         device_idle_share=1.0 - busy / traced_wall_ms,
         device_events=len(spans), trace_retries=retries,
         kernel_device_ms=kernel_ms,
         device_ms_by_kernel=dict(by_kernel.most_common(12)),
         k1=lstm["k1"], k2=lstm["k2"], k1_long=k1_long, k2_long=k2_long,
         k1_tolerance=K1_TOL, k2_tolerance=K2_TOL,
         lattice_max_abs_err=lat_errs, k56_max_abs_err=k56_errs,
         k56_err_over_magnitude=k56_rel,
         k5_plain_device_ms=span_ms(k5_plain),
         k6_plain_device_ms=span_ms(k6_plain), k5_bound_ms=b5,
         k6_bound_ms=b6, k6_n_split=k6_split,
         k6_scratch_bytes=joint_kernel.k6_scratch_bytes(
             Bk, U1k, joint_kernel.MAX_K, Vp, k6_split),
         k3_bound_ms=bound(*k3_work(B, T2, U + 1), peak=PEAK_FP32_FLOPS)[0],
         k4_bound_ms=bound(*k4_work(B, T2, U + 1), peak=PEAK_FP32_FLOPS)[0],
         chunked=chunked)
    src = "myrtlespeech_tpu_torch/csrc/joint_tail.cu"
    return k1_long, k2_long, [
        {"name": "K5 joint_tail_fwd", "route": "cuda", "source": src,
         "replaces": "myrtlespeech_tpu/ops/pallas/joint_kernel.py:106 "
                     "(_fwd_kernel, pallas_call in _jt_impl :271)",
         "launches": traced["k5"],
         "max_abs_err": max(k56_errs["lp_blank"], k56_errs["lp_emit"]),
         "ms": kernel_ms["k5"], "plain_ms": span_ms(k5_plain),
         "bound_ms": b5, "bound_by": by5, "library_ms": None},
        {"name": "K6 joint_tail_bwd", "route": "cuda",
         "source": "myrtlespeech_tpu_torch/csrc/joint_tail_bwd.cu",
         "replaces": "myrtlespeech_tpu/ops/pallas/joint_kernel.py:134 "
                     "(_bwd_kernel, pallas_call in _jt_bwd :336)",
         "launches": traced["k6"],
         "max_abs_err": max(k56_errs[n] for n in K56_OUTPUTS[2:]),
         "ms": kernel_ms["k6"], "plain_ms": span_ms(k6_plain),
         "bound_ms": b6, "bound_by": by6, "library_ms": None},
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
    # The config sets fused_chunk_size=32, so training takes the chunked
    # path (K3/K4 once a step, no K5/K6), as in the JAX package.
    if task.fused_loss is None:
        raise AssertionError("the medium config builds no chunked loss")
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(MEDIUM_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    emit("medium_falls", config="synthetic_medium_rnnt", batch=32,
         steps=MEDIUM_STEPS, path="chunked", losses=losses, seconds=seconds,
         launches=launches)
    no_stepwise(launches, "medium train")
    if (launches["k3"], launches["k5"]) != (MEDIUM_STEPS, 0):
        raise AssertionError(f"the medium steps did not take the chunked "
                             f"path: {launches}")
    if not (all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0]):
        raise AssertionError(f"the repeated-batch loss did not fall to half: "
                             f"{losses}")


class ForcePlain:
    """Runs the plain versions in place of the kernels (K1, K2, K7, K8) on
    the card while it is entered: the wrappers' callers look them up at call
    time."""

    def __init__(self):
        from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel, lstm_kernel

        self.swaps = [(lstm_kernel, "lstm_fwd"), (lstm_kernel, "lstm_bwd"),
                      (ctc_kernel, "ctc_lattice_fwd"),
                      (ctc_kernel, "ctc_lattice_bwd")]

    def __enter__(self):
        self.real = [getattr(m, n) for m, n in self.swaps]
        for m, n in self.swaps:
            setattr(m, n, getattr(m, f"{n}_reference"))
        return self

    def __exit__(self, *exc):
        for (m, n), real in zip(self.swaps, self.real):
            setattr(m, n, real)
        return False


def _loss_and_grad_norm(task, model, batch, seed: int = 123):
    """One train-mode forward and backward (SpecAugment from a fresh
    generator of ``seed``): the loss and the global gradient norm."""
    from myrtlespeech_tpu_torch.builders.build import global_norm
    from myrtlespeech_tpu_torch.run import train

    model.zero_grad(set_to_none=True)
    loss, _ = train._forward(task, model, batch, True,
                             torch.Generator().manual_seed(seed))
    loss.backward()
    gnorm = global_norm([p.grad for p in model.parameters()])
    out = float(loss.detach()), float(gnorm)
    model.zero_grad(set_to_none=True)
    return out


def phase_train_ctc(dev):
    """deep_speech_2_en at full width trains on B=32 x 16.7 s with 214
    labels: K1 and K2 launch 8,360 times a step at H=800, K7 and K8 once, no
    plain version runs; finite loss, every parameter and BatchNorm statistic
    moved after the first timed step (at the end of warmup); step time,
    split, peak memory; one traced step
    (device time by kernel, idle share); the step's K1 and K2 (one call of
    each shape), K7 and K8 calls replayed against their plain versions, and
    F.ctc_loss on the step's own logits as the yardstick; the step's loss
    and gradient norm against the plain versions forced on the card; the
    eval loss.  Returns K1's and K2's DeepSpeech2 figures and the kernels
    line's K7 and K8 entries."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel, lstm_kernel
    from myrtlespeech_tpu_torch.run import train
    from myrtlespeech_tpu_torch.run.infer import load_config

    B, secs, U = CTC_BATCH, CTC_SECONDS, CTC_LABELS
    task = build_task(load_config("deep_speech_2_en"))
    t0 = time.perf_counter()
    state = train.init_state(task, seed=0, device=str(dev))
    n_params = sum(p.numel() for p in state.model.parameters())
    batch = train.to_device(train.example_batch(B, secs, U, 0), dev)
    step = train.make_train_step(task)
    state, m = step(state, batch)  # warm-up: step 0, whose lr is 0
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # The timed steps run from the end of the schedule's warmup, at the
    # config's rate of 3e-4: at step 1 the rate is 3e-7, and an update of a
    # BatchNorm scale of 1 rounds away under half an fp32 step.
    state.step = task.cfg.train_config.lr_warmup_steps
    before = {n: t.detach().clone()
              for n, t in state.model.state_dict().items()}

    torch.cuda.reset_peak_memory_stats(dev)
    times, losses, gnorms, lrs = [], [], [], []
    with _plain_guard() as guard:
        _zero_counts()
        for i in range(CTC_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))  # waits for the step
            times.append(time.perf_counter() - t0)
            gnorms.append(float(m["grad_norm"]))
            lrs.append(m["lr"])
            if i == 0:
                moved = {n: (t.detach() - before[n]).abs().max().item()
                         for n, t in state.model.state_dict().items()}
        launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del before
    if guard.calls:
        raise AssertionError(f"plain versions ran on the CTC train path: "
                             f"{dict(guard.calls)}")
    want = {k: n * CTC_STEPS for k, n in CTC_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"launches over {CTC_STEPS} CTC steps: "
                             f"{launches}, expected {want}")
    if not all(np.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"CTC step loss {losses} or grad_norm {gnorms} "
                             "not finite")
    still = [n for n, v in moved.items() if not v > 0]
    if still:
        raise AssertionError(f"after the first timed step these did not "
                             f"move: {still}")

    # Stage split of one more step, host clock, synced at each boundary.
    torch.cuda.synchronize()
    split = [time.perf_counter()]
    state.optimizer.zero_grad()
    loss, _ = train._forward(task, state.model, batch, True, state.gen)
    torch.cuda.synchronize()
    split.append(time.perf_counter())
    loss.backward()
    torch.cuda.synchronize()
    split.append(time.perf_counter())
    state.optimizer.step(state.step)
    state.step += 1
    torch.cuda.synchronize()
    split.append(time.perf_counter())
    del loss

    traced_wall_ms, spans, kernel_spans, retries = trace_step(
        lambda: step(state, batch), CTC_LAUNCHES)
    stepwise_ms = stepwise_trace(lambda: step(state, batch),
                                 with_stepwise(CTC_LAUNCHES, CTC_LSTM_STEPS))
    by_kernel = collections.Counter()
    for name, s, e in spans:
        by_kernel[name[:80]] += (e - s) / 1e3
    busy = busy_ms(spans)
    kernel_ms = {k: span_ms(sp) for k, sp in kernel_spans.items()}

    # The step's calls, for the replays: every K1 and K2 call (the plain
    # versions on the first of each shape), K7's and K8's one call each,
    # and the CTC loss's own inputs.
    calls = record_many({"k1": (lstm_kernel, "lstm_fwd"),
                         "k2": (lstm_kernel, "lstm_bwd"),
                         "k7": (ctc_kernel, "ctc_lattice_fwd"),
                         "k8": (ctc_kernel, "ctc_lattice_bwd"),
                         "loss": (ctc_kernel, "ctc_loss_lattice")},
                        lambda: step(state, batch))
    torch.cuda.synchronize()
    lstm = lstm_replays(calls.pop("k1"), calls.pop("k2"), "CTC step", dev,
                        plain_per_shape=True, bidirectional=True)
    (k7_args,), (k8_args,), (loss_args,) = (calls["k7"], calls["k8"],
                                            calls["loss"])
    del calls
    torch.cuda.empty_cache()
    with torch.no_grad():
        fwd = ctc_kernel.ctc_lattice_fwd(*k7_args)
        bwd = ctc_kernel.ctc_lattice_bwd(*k8_args)
        fwd_ref = ctc_kernel.ctc_lattice_fwd_reference(*k7_args)
        bwd_ref = ctc_kernel.ctc_lattice_bwd_reference(*k8_args)
        k78_errs = ctc_errors(fwd, bwd, fwd_ref, bwd_ref, k7_args,
                              "CTC step")
        del fwd, bwd, fwd_ref, bwd_ref
        k78_chain = ctc_chain_errors(k7_args, k8_args[-1], "CTC step")
        _, k7_plain = device_trace(
            lambda: ctc_kernel.ctc_lattice_fwd_reference(*k7_args),
            or_events=True)
        _, k8_plain = device_trace(
            lambda: ctc_kernel.ctc_lattice_bwd_reference(*k8_args),
            or_events=True)

    # Yardstick: F.ctc_loss's forward (from the log-probs) and its backward
    # on the step's own logits, each traced; log_softmax is left out of
    # both, as it is outside K7 and K8.
    logits, logit_lens, labels, label_lens, blank = loss_args
    logp = torch.log_softmax(logits.detach().float(), -1).transpose(0, 1)
    logp = logp.detach().requires_grad_()
    lib_args = (labels.long(), logit_lens.long(), label_lens.long())
    torch.nn.functional.ctc_loss(logp, *lib_args, blank=blank,
                                 reduction="none")  # warm-up
    _, lib_fwd = device_trace(lambda: torch.nn.functional.ctc_loss(
        logp, *lib_args, blank=blank, reduction="none"), or_events=True)
    lib_nll = torch.nn.functional.ctc_loss(logp, *lib_args, blank=blank,
                                           reduction="none")
    ones = torch.ones_like(lib_nll)
    torch.autograd.grad(lib_nll, logp, ones, retain_graph=True)  # warm-up
    _, lib_bwd = device_trace(lambda: torch.autograd.grad(
        lib_nll, logp, ones, retain_graph=True), or_events=True)
    del logp, lib_nll, loss_args, logits
    Bk, Tk, S = k7_args[0].shape
    (f7, n7), (f8, n8) = k78_work(Bk, Tk, S)
    b7, by7 = bound(f7, n7, peak=PEAK_FP32_FLOPS)
    b8, by8 = bound(f8, n8, peak=PEAK_FP32_FLOPS)
    del k7_args, k8_args
    torch.cuda.empty_cache()

    # The whole step's loss and gradient norm, kernels against the plain
    # versions forced on the card (same batch, weights, SpecAugment draws).
    _zero_counts()
    kern = _loss_and_grad_norm(task, state.model, batch)
    kern_launches = _read_counts()
    _zero_counts()
    with ForcePlain():
        plain = _loss_and_grad_norm(task, state.model, batch)
    plain_launches = _read_counts()
    rel = {"loss": abs(kern[0] - plain[0]) / abs(plain[0]),
           "grad_norm": abs(kern[1] - plain[1]) / abs(plain[1])}
    no_stepwise(kern_launches, "DS2 loss and gradient")
    if kern_launches["k7"] != 1 or any(plain_launches.values()):
        raise AssertionError(f"kernel run launches {kern_launches}, plain "
                             f"run {plain_launches}")
    if not all(rel[k] <= CTC_PLAIN_TOL[k] for k in rel):
        raise AssertionError(f"CTC step with kernels {kern} against plain "
                             f"{plain}: relative {rel} beyond "
                             f"{CTC_PLAIN_TOL}")

    _zero_counts()
    eval_loss = float(train.eval_step_body(task)(state, batch)["loss"])
    eval_launches = _read_counts()
    if not np.isfinite(eval_loss) or eval_launches["k7"] != 1 \
            or eval_launches["k8"] != 0:
        raise AssertionError(f"eval loss {eval_loss}, launches "
                             f"{eval_launches}")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    ms = 1e3 * statistics.median(times)
    k1_ds2, k2_ds2 = (
        path_figures(CTC_LAUNCHES[k], kernel_ms[k], CTC_LSTM_STEPS,
                     stepwise_ms[k], lstm[k]) for k in ("k1", "k2"))
    emit("train_ctc", config="deep_speech_2_en", batch=B, seconds=secs,
         labels=U, lattice=[Bk, Tk, S], parameters=n_params,
         setup_s=setup_s, ms_per_step=ms, ms_runs=[1e3 * t for t in times],
         audio_s_per_s=B * secs / (ms / 1e3), losses=losses,
         grad_norms=gnorms, lrs=lrs, launches_per_step=CTC_LAUNCHES,
         max_move_step1=max(moved.values()),
         min_move_step1=min(moved.values()),
         forward_ms=1e3 * (split[1] - split[0]),
         backward_ms=1e3 * (split[2] - split[1]),
         optimizer_ms=1e3 * (split[3] - split[2]), peak_memory_gb=peak_gb,
         traced_wall_ms=traced_wall_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / traced_wall_ms,
         device_events=len(spans), trace_retries=retries,
         kernel_device_ms=kernel_ms,
         device_ms_by_kernel=dict(by_kernel.most_common(12)),
         k1=lstm["k1"], k2=lstm["k2"], k1_ds2=k1_ds2, k2_ds2=k2_ds2,
         k1_tolerance=K1_TOL, k2_tolerance=K2_TOL,
         k78_max_abs_err=k78_errs, k78_chain_vs_float64=k78_chain,
         k7_plain_device_ms=span_ms(k7_plain),
         k8_plain_device_ms=span_ms(k8_plain),
         library_fwd_device_ms=span_ms(lib_fwd),
         library_bwd_device_ms=span_ms(lib_bwd), k7_bound_ms=b7,
         k8_bound_ms=b8, kernels_loss_grad_norm=kern,
         plain_loss_grad_norm=plain, plain_rel_diff=rel,
         plain_tolerance=CTC_PLAIN_TOL, eval_loss=eval_loss,
         eval_launches=eval_launches)
    src = "myrtlespeech_tpu_torch/csrc/ctc_lattice.cu"
    return k1_ds2, k2_ds2, [
        {"name": "K7 ctc_lattice_fwd (rows of lp by cp.async into a "
                 "shared ring, one log a cell)", "route": "cuda",
         "source": src,
         "replaces": "myrtlespeech_tpu/ops/pallas/ctc_kernel.py:45 "
                     "(_fwd_kernel, pallas_call in _fwd_impl :151)",
         "launches": CTC_LAUNCHES["k7"],
         "max_abs_err": max(k78_errs["alphas"], k78_errs["ll"]),
         "ms": kernel_ms["k7"], "plain_ms": span_ms(k7_plain),
         "bound_ms": b7, "bound_by": by7, "library_ms": span_ms(lib_fwd)},
        {"name": "K8 ctc_lattice_bwd", "route": "cuda", "source": src,
         "replaces": "myrtlespeech_tpu/ops/pallas/ctc_kernel.py:79 "
                     "(_bwd_kernel, pallas_call in _vjp_bwd :182)",
         "launches": CTC_LAUNCHES["k8"], "max_abs_err": k78_errs["grad"],
         "ms": kernel_ms["k8"], "plain_ms": span_ms(k8_plain),
         "bound_ms": b8, "bound_by": by8, "library_ms": span_ms(lib_bwd)},
    ]


def phase_ctc_falls(dev):
    """synthetic_ctc from seeded weights, warmup off, takes CTC_FALLS_STEPS
    steps on one repeated batch of 32 of its train split: the loss must fall
    to under half its first value."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.configs.synthetic_ctc import task_config
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
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(CTC_FALLS_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    emit("ctc_falls", config="synthetic_ctc", batch=32,
         steps=CTC_FALLS_STEPS, losses=losses, seconds=seconds,
         launches=launches)
    no_stepwise(launches, "synthetic_ctc train")
    if (launches["k7"], launches["k8"], launches["k3"]) != (
            CTC_FALLS_STEPS, CTC_FALLS_STEPS, 0):
        raise AssertionError(f"the CTC steps did not run K7/K8 once each: "
                             f"{launches}")
    if not (all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0]):
        raise AssertionError(f"the repeated-batch CTC loss did not fall to "
                             f"half: {losses}")


def phase_trained(dev):
    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.configs.synthetic_medium_rnnt import \
        task_config
    from myrtlespeech_tpu_torch.data.dataset.synthetic import SyntheticSpeech
    from myrtlespeech_tpu_torch.decoding.wer import wer
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
    _zero_counts()
    t0 = time.perf_counter()
    for i in range(0, len(items), 32):
        chunk = items[i:i + 32]
        wav, lens = pad_waveforms([w for w, _ in chunk])
        wav = np.pad(wav, ((0, 0), (0, s_max - wav.shape[1])))
        hyps += tr.transcribe(wav, lens).texts
        refs += [t for _, t in chunk]
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    launches = counts["k1"]
    w = wer(refs, hyps)
    emit("trained", config="synthetic_medium_rnnt", utterances=len(refs),
         wer=w, jax_wer=JAX_GREEDY_WER, tolerance=WER_TOLERANCE,
         decode_seconds=seconds, k1_launches=launches,
         examples=[[r, h] for r, h in zip(refs[:3], hyps[:3])])
    if launches == 0:
        raise AssertionError("the trained path launched K1 no time")
    no_stepwise(counts, "trained serve")
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
    if min(launches[k] for k in ("k1", "k2", "k3", "k4")) == 0:
        raise AssertionError(f"the trained loss path skipped a kernel: "
                             f"{launches}")
    no_stepwise(launches, "trained loss")
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
    phase_k56(dev)
    phase_k78(dev)
    flagship = phase_flagship(dev)
    k1 = phase_main_path_k1(dev, flagship)
    del flagship
    trained = phase_train(dev)
    k1["paths"]["train"], k234 = phase_train_main_path(dev, trained)
    del trained
    phase_path_equality(dev)
    k1["paths"]["long"], k234[0]["paths"]["long"], k56 = \
        phase_train_long(dev)
    k1["paths"]["ds2"], k234[0]["paths"]["ds2"], k78 = phase_train_ctc(dev)
    for entry in (k1, k234[0]):
        entry["max_abs_err"] = max(p["max_abs_err"]
                                   for p in entry["paths"].values())
    phase_ctc_falls(dev)
    phase_medium_falls(dev)
    phase_trained(dev)
    print(json.dumps({"kernels": [k1] + k234 + k56 + k78}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
