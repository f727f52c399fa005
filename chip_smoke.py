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
             the card; a finite eval loss.  Then ``ds2_serve``:
             ``deep_speech_2_en`` at full width with seeded weights
             transcribes B=32 x 16.7 s of seeded noise through
             ``build_transcriber`` and its beam decoder (W=16): K1 10
             launches a batch and nothing else, no plain version; three
             timed runs, a stage split, one traced run (K1's device time,
             the idle share), the decode window traced alone (its kernels
             and copies to the host: only the transcript's), the same
             logits decoded greedily and, greedy and beam, on the CPU
             (tokens equal), K1's calls replayed against the plain version
             and cuDNN.  Then ``rnnt_beam_serve``: ``rnn_t_960_beam`` (the
             flagship model, 5 encoder LSTM-1024 and 2 prediction LSTM-320
             layers, joint 512, V=29) with seeded weights transcribes
             B=32 x 5 s of seeded noise through ``build_transcriber`` and
             its beam decoder (W=16, expand_topk 16, speculative_frames 8,
             max_symbols_per_step 8, max_output_len 200): three timed runs,
             no plain version, K1 on both routes (the encoder's 5 calls
             persistent; the prediction net at B*W = 512 rows on the
             per-step route, 2 launches a call), block steps, expansion
             rounds and flags read from the device a batch, a stage split,
             one traced run (K1's device ms by route, the idle share), the
             decode window traced alone (kernels a loop iteration, copies to
             the host), K1's calls against the plain version (the first of
             each shape), plain and cuDNN replays.  Then
             ``ctc_decode_fixture``: the logits of
             ``port_tools/ctc_decode_fixture.npz`` decoded on the card must
             give the JAX package's stored tokens exactly.  Then
             ``ctc_falls``: ``synthetic_ctc`` from seeded weights, warmup
             off, 20 steps on one repeated batch: the loss must fall below
             half its start; then the batch decoded by the eval step (the
             config's beam) and greedily, each one's WER, card and CPU
             tokens equal on the same logits.
10. trained  the trained medium RNN-T (committed npz) decodes its
             256-utterance eval split greedily at B=32; its WER must lie
             within 0.01 of the JAX package's greedy WER for the same weights;
             its eval loss over the split and the gradient norm of the first
             batch must lie within tolerance of the JAX package's.  Then
             ``trained_beam``: the same split through the config's own beam
             (W=8, expand_topk 16, speculative_frames 8, length_norm): its
             WER within 0.01 of the JAX package's beam WER for the same
             weights, decode seconds, K1's launches by route (no plain
             version), rounds a frame and the share of frames consumed as
             pure blank (the decoder's tallies, in the same pass), and K1's
             calls of one batch against the plain version (the first of
             each shape: the encoder's and the prediction net's at
             B*W = 256 rows).
    After ``trained``, the run loop (``run/train.py::fit``, the bucketed
    loader, checkpoints, the CLI), on ``deep_speech_2_en`` and ``rnn_t_en``
    at full width with their datasets swapped for the synthetic corpus:
             ``fit_ds2``: the CLI in a subprocess (``--guarded-cli``, which
             counts the plain versions there) trains ``deep_speech_2_en``
             one epoch of 8 batches of 32 with ``--checkpoint_dir`` and
             ``--log_dir``, then decodes the 64-utterance eval split by its
             beam; K1/K2/K7/K8 10/10/1/1 launches a step, no plain version;
             steps, step ms, loader wait, audio-s/s, eval ms, the reports
             (finite losses and WER), the checkpoint's ms and bytes.
             ``resume_ds2``: in-process, an uninterrupted fit against one
             stopped after 3 batches, saved, restored through the CLI's
             ``_restore_state`` and resumed: the final parameters,
             BatchNorm statistics, optimizer state, step and generator
             bit-equal, or the nondeterministic operation named and the
             difference within ``RESUME_RTOL``; 3 resumed steps traced (the
             device's idle share); the fit's batches through the bare train
             step, and the fit with its loader in the main thread; then
             ``--eval_only`` through the CLI from the resumed checkpoint
             gives the fit's WER.  ``fit_rnnt``: ``rnn_t_en`` trains 4
             batches of 16 through ``fit`` and decodes one greedily: the
             joint path taken at each batch shape, K1-K4 7/7/1/1 a step (K5,
             K6 where the joint tail is taken), finite losses and WER.
    Then the hard-corpus configs at their widths and batch (32), their
    datasets cut to 128 train and 32 eval utterances of the hard corpus,
    each through the CLI for 4 train batches and one eval batch decoded by
    its beam (W=8), no plain version:
             ``fit_preddrop``: ``synthetic_hard_rnnt_preddrop`` (embedding
             dropout 0.3, the T-chunked joint): step ms, K1-K4 5/5/1/1 a
             step, the embedding masks' kept share over the run within 4
             binomial standard deviations of 0.7; then, in-process, a fit
             stopped after 2 batches, saved, restored and resumed to 4,
             bit-equal to the uninterrupted fit: parameters, optimizer
             state, step, SpecAugment's generator and the dropout generator
             (on the card).  ``fit_hard_ctc``: ``synthetic_hard_ctc``: K1/K2
             at H=256 (3 BiLSTM layers) 6/6 and K7/K8 1/1 a step, the eval
             batch by the prefix beam.  ``ft_hard_rnnt``: the committed
             medium npz written as a port checkpoint; the CLI's warm start
             from it holds the npz's parameters bit for bit, step 0, no
             optimizer state and the LR schedule's start; then
             ``synthetic_hard_rnnt_ft`` with ``--init_from`` it: K1-K4
             5/5/1/1 a step; the first eval batch's beam WER.  Each of the
             three also takes one train step in process with every kernel
             call recorded, and holds each kernel against its plain version
             on those inputs (K1/K2 the first call of each shape, both
             routes): the errors join each kernel's ``paths`` in the
             ``kernels`` line.
    ``fit_phases(dev)`` runs the run-loop phases alone (after
    ``phase_build()``).

Then a ``kernels`` line (one entry per ported kernel: ``ms`` is the kernel's
device time on its main path, traced; ``plain_ms`` and ``library_ms`` the
device times of the replays; ``bound_ms`` counted from the recorded calls;
K1's and K2's entries also hold ``us_per_step``, the per-step route's
``stepwise_ms`` and ``stepwise_us_per_step``, and ``paths``: these figures
for each main path, serve, train, long and ds2, K1's also ds2_serve,
rnnt_beam_serve, with its launches and device ms by route, and
trained_beam, with its launches by route and errors; K1, K2, K3, K4, K7
and K8 the hard-corpus fits' paths, fit_preddrop, fit_hard_ctc and
ft_hard_rnnt, with their errors against the plain versions), the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.  Every main
path but the RNN-T beam's also asserts that K1's and K2's per-step route
launched no time.
Without a CUDA card the script exits non-zero before it prints any result.
"""

from __future__ import annotations

import collections
import contextlib
import functools
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

# The JAX package's beam WER for the same npz and split, decoded by the
# config's own beam (W=8, length_norm, max_symbols_per_step=8, expand_topk
# 16, speculative_frames 8), measured on the CPU by ``python
# port_tools/medium_beam_wer.py``: {"jax_cpu_wer": 0.08850931677018634,
# "port_cpu_wer": 0.09083850931677019, "transcripts_differing": 6} (both in
# the config's bfloat16; the 6 transcripts differ through rounding: in
# float32 the two agree, PERF.md section 2).  The TPU-era A/B figure for W=8
# (benchmarks/data/ab/rnnt_medium_ab.txt:4) is printed beside it.
JAX_BEAM_WER = 0.08850931677018634
AB_BEAM_WER = 0.0908

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
# The DS2 serve path: K1 launches once per LSTM direction (5 layers x 2) a
# batch, and no other kernel.
DS2_SERVE_LAUNCHES = {"k1": 10, "k2": 0, "k1_step": 0, "k2_step": 0,
                      "k3": 0, "k4": 0, "k5": 0, "k6": 0, "k7": 0, "k8": 0}
# Copies to the host allowed in the decode window: the transcript's tokens
# and lengths at its end.
DECODE_DTOH_COPIES = 2
# The RNN-T beam's serve path: rnn_t_960_beam (the flagship model, W=16) at
# B=32 x 5 s.  Its encoder takes K1's persistent route (5 launches, B=32);
# the prediction net runs at B*W = 512 rows, over the persistent route's 128,
# so its T=1 calls take the per-step route (2 launches a call, one a layer).
BEAM_BATCH, BEAM_SECONDS = 32, 5.0
BEAM_FRAMES, BEAM_ENCODER_WIDTH = 251, 1024
BEAM_ENCODER_LAUNCHES = 5

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


# The card's name and power limit (nvidia-smi), set by ``phase_card``: every
# later line carries it.
CARD = {}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **CARD, **fields}), flush=True)


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
    CARD["card"] = out
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


def stage_ms(tr, wav, lens, runs: int = 3, model_key: str = "encoder_ms"):
    """Median host-clock ms of features, the model (an RNN-T's encoder, a
    CTC model's logits: ``model_key``) and the decode (an RNN-T's joint
    projection plus the greedy loop, a CTC decoder), each ending in a
    synchronise."""
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
            x, x_lens = tr.outputs(feats, flens)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            tr.decode_outputs(x, x_lens)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        out["features_ms"].append(1e3 * (t1 - t0))
        out[model_key].append(1e3 * (t2 - t1))
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
    eval_loss = float(train.eval_step_body(task, decode=False)(
        state, batch)["loss"])
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
    ctc_falls_decode(task, state, batch, data[0]["texts"])


def ctc_falls_decode(task, state, batch, refs):
    """The trained repeated batch decoded by the eval step (the config's
    beam, W=8) and greedily: each one's WER; the model's logits decoded
    on the card and on the CPU give equal tokens, greedy and beam."""
    from myrtlespeech_tpu_torch.decoding.ctc_greedy import ctc_greedy_decode
    from myrtlespeech_tpu_torch.decoding.wer import wer
    from myrtlespeech_tpu_torch.run import train

    blank = task.cfg.speech_to_text.post_process.blank_index
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = train.eval_step_body(task, decode=True)(state, batch)
    eval_beam = (metrics["decoded_tokens"].cpu(),
                 metrics["decoded_lens"].cpu())
    eval_s = time.perf_counter() - t0
    launches = _read_counts()
    with torch.no_grad():
        feats, flens = task.preprocess(batch["wav"], batch["wav_lens"])
        logits, out_lens = state.model(feats, flens, False)
        card = {"beam": task.decoder(logits, out_lens),
                "greedy": ctc_greedy_decode(logits, out_lens, blank)}
        logits_cpu, lens_cpu = logits.cpu(), out_lens.cpu()
        cpu = {"beam": task.decoder(logits_cpu, lens_cpu),
               "greedy": ctc_greedy_decode(logits_cpu, lens_cpu, blank)}

    def texts(out):
        toks, tl = (np.asarray(a.cpu()) for a in out)
        return [task.alphabet.get_symbols(toks[i, :tl[i]])
                for i in range(len(tl))]

    rows = {n: rows_differing([a.cpu() for a in card[n]], cpu[n])
            for n in card}
    emit("ctc_falls_decode", config="synthetic_ctc", eval_seconds=eval_s,
         eval_loss=float(metrics["loss"]), eval_launches=launches,
         wer_beam=wer(refs, texts(eval_beam)),
         wer_greedy=wer(refs, texts(card["greedy"])),
         eval_beam_equals_card_beam=not rows_differing(eval_beam,
                                                       card["beam"]),
         card_cpu_rows_differing=rows,
         examples=[[r, h] for r, h in zip(refs[:2], texts(eval_beam)[:2])])
    no_stepwise(launches, "synthetic_ctc eval")
    if launches["k7"] != 1 or launches["k8"] or not launches["k1"]:
        raise AssertionError(f"the eval step's launches {launches}")
    if rows["beam"] or rows["greedy"]:
        raise AssertionError(f"card and CPU tokens differ on the same "
                             f"logits in rows {rows}")


def kernels_and_copies(spans):
    """``(kernels, device-to-host copies, host-to-device copies)`` among a
    trace's device events."""
    copies = [n for n, _, _ in spans if n.startswith("Memcpy")]
    kernels = [n for n, _, _ in spans
               if not n.startswith(("Memcpy", "Memset"))]
    return (kernels, [n for n in copies if "DtoH" in n],
            [n for n in copies if "HtoD" in n])


def rows_differing(got, want):
    """Rows whose lengths or tokens differ, of two ``(tokens, lens)``."""
    (gt, gl), (wt, wl) = ((np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                      else a) for a in x)
                          for x in (got, want))
    return [i for i in range(len(wl))
            if gl[i] != wl[i] or not np.array_equal(gt[i, :wl[i]],
                                                    wt[i, :wl[i]])]


def phase_ds2_serve(dev):
    """deep_speech_2_en at full width with seeded weights transcribes B=32
    x 16.7 s of seeded noise through ``build_transcriber`` and the config's
    own beam decoder (W=16, expand_topk 16, prune 1e-3): one warm-up and
    three timed runs, K1 launched 10 times a batch and nothing else, no
    plain version; a stage split (features, model, decode); one traced run
    (K1's device time, the idle share); the decode window alone, traced: its
    kernels (a frame) and copies to the host (only the transcript's, at the
    end); the same logits decoded greedily, and by the port on the CPU,
    greedy and beam: tokens equal.  K1's calls of one run replayed against
    the plain version, the plain version's and cuDNN's device times.
    Returns the ``ds2_serve`` path of K1's ``kernels`` entry."""
    from myrtlespeech_tpu_torch.builders.build import random_params
    from myrtlespeech_tpu_torch.decoding.ctc_greedy import ctc_greedy_decode
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as k
    from myrtlespeech_tpu_torch.run.infer import (build_transcriber,
                                                  load_config, random_audio)

    cfg = load_config("deep_speech_2_en")
    pc = cfg.speech_to_text.post_process
    t0 = time.perf_counter()
    tr = build_transcriber(cfg, random_params(cfg, seed=0), device=str(dev))
    setup_s = time.perf_counter() - t0
    B, secs = CTC_BATCH, CTC_SECONDS
    wav, lens = random_audio(B, secs, seed=0)
    tr.transcribe(wav, lens)  # warm-up
    times = []
    with _plain_guard() as guard:
        _zero_counts()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tr.transcribe(wav, lens)  # ends in a copy to the host
            times.append(time.perf_counter() - t0)
        launches = _read_counts()
        stages = stage_ms(tr, wav, lens, model_key="model_ms")
        traced_wall_ms, spans, kernel_spans, retries = trace_step(
            lambda: tr.transcribe(wav, lens), DS2_SERVE_LAUNCHES)
    if guard.calls:
        raise AssertionError(f"plain versions ran on the DS2 serve path: "
                             f"{dict(guard.calls)}")
    if launches != {n: 3 * c for n, c in DS2_SERVE_LAUNCHES.items()}:
        raise AssertionError(f"launches over 3 DS2 batches: {launches}")
    by_kernel = collections.Counter()
    for name, s0, e0 in spans:
        by_kernel[name[:80]] += (e0 - s0) / 1e3
    busy = busy_ms(spans)

    # The decode window alone, on the model's logits: its kernels and its
    # copies, the final copy to the host included.
    with torch.inference_mode():
        feats, flens = tr.preprocess(torch.as_tensor(wav, device=dev),
                                     torch.as_tensor(lens, device=dev))
        logits, out_lens = tr.outputs(feats, flens)
    T = logits.shape[1]
    if tuple(logits.shape) != (B, CTC_LSTM_STEPS // 10, 29) \
            or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or "
                             "of the wrong shape")

    def decode_to_host():
        with torch.inference_mode():
            return tuple(a.cpu() for a in tr.decode_outputs(logits,
                                                            out_lens))

    beam_card = decode_to_host()
    dec_wall_ms, dec_spans = device_trace(decode_to_host)
    kernels, dtoh, htod = kernels_and_copies(dec_spans)
    if len(dtoh) > DECODE_DTOH_COPIES:
        raise AssertionError(f"the decode window copied to the host "
                             f"{len(dtoh)} times: {dtoh}")
    if rows_differing(beam_card, (out.tokens, out.lengths)):
        raise AssertionError("the decode of the traced logits differs from "
                             "the transcriber's")

    # The same logits decoded greedily, and both decoders on the CPU.
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy_card = tuple(a.cpu() for a in ctc_greedy_decode(
            logits, out_lens, pc.blank_index))
        greedy_ms = 1e3 * (time.perf_counter() - t0)
        logits_cpu, lens_cpu = logits.cpu(), out_lens.cpu()
        t0 = time.perf_counter()
        beam_cpu = tr.decode_outputs(logits_cpu, lens_cpu)
        cpu_beam_s = time.perf_counter() - t0
        greedy_cpu = ctc_greedy_decode(logits_cpu, lens_cpu, pc.blank_index)
    cpu_rows = {"beam": rows_differing(beam_card, beam_cpu),
                "greedy": rows_differing(greedy_card, greedy_cpu)}
    if cpu_rows["beam"] or cpu_rows["greedy"]:
        raise AssertionError(f"card and CPU tokens differ on the same "
                             f"logits in rows {cpu_rows}")
    tlens = beam_card[1].numpy()
    V = logits.shape[2]
    if not ((0 <= tlens) & (tlens <= T)).all() or not (
            (0 <= beam_card[0].numpy()) & (beam_card[0].numpy() < V)).all():
        raise AssertionError(f"bad tokens, lengths {tlens}")
    del feats, logits, logits_cpu

    # K1 on this path's own calls: against the plain version (the first
    # call of each shape), the plain version and cuDNN over every call.
    calls = record_many({"k1": (k, "lstm_fwd")},
                        lambda: tr.transcribe(wav, lens))["k1"]
    errs = {}
    with torch.inference_mode():
        for args in _first_per_shape(calls, lambda a: a[0].shape).values():
            max_into(errs, k1_errors(k.lstm_fwd(*args),
                                     k.lstm_fwd_reference(*args),
                                     "DS2 serve"))

        def plain_replay():
            with torch.inference_mode():
                for args in calls:
                    k.lstm_fwd_reference(*args)

        _, plain_spans = device_trace(plain_replay, or_events=True)
    check_errors(errs, "DS2 serve")
    library_ms, library = cudnn_replay(calls, "k1", dev, bidirectional=True)
    works = [k1_work(*a[0].shape[:2], a[0].shape[2] // 4, a[5] is not None)
             for a in calls]
    bound_ms, bound_by = bound(sum(w[0] for w in works),
                               sum(w[1] for w in works))
    del calls
    stepwise_ms = stepwise_trace(
        lambda: tr.transcribe(wav, lens),
        with_stepwise(DS2_SERVE_LAUNCHES, CTC_LSTM_STEPS))["k1"]
    k1_ms = span_ms(kernel_spans["k1"])
    figures = path_figures(
        DS2_SERVE_LAUNCHES["k1"], k1_ms, CTC_LSTM_STEPS, stepwise_ms,
        {"library_ms": library_ms, "library": library,
         "plain_ms": span_ms(plain_spans), "plain_calls": len(works),
         "bound_ms": bound_ms})
    figures["max_abs_err"] = max(errs.values())
    ms = 1e3 * statistics.median(times)
    emit("ds2_serve", config="deep_speech_2_en", batch=B, seconds=secs,
         decoder=f"beam W={pc.beam_width} expand_topk={pc.expand_topk} "
                 f"prune={pc.prune_threshold}", setup_s=setup_s,
         ms_per_batch=ms, ms_runs=[1e3 * t for t in times],
         audio_s_per_s=B * secs / (ms / 1e3), **stages,
         launches_per_batch=DS2_SERVE_LAUNCHES, traced_wall_ms=traced_wall_ms,
         trace_retries=retries, device_busy_ms=busy,
         device_idle_share=1.0 - busy / traced_wall_ms,
         device_events=len(spans), k1_device_ms=k1_ms,
         device_ms_by_kernel=dict(by_kernel.most_common(10)), frames=T,
         decode_wall_ms_traced=dec_wall_ms,
         decode_device_busy_ms=busy_ms(dec_spans),
         decode_kernels=len(kernels),
         decode_kernels_per_frame=len(kernels) / T,
         decode_dtoh_copies=len(dtoh), decode_htod_copies=len(htod),
         decode_ms_per_frame=stages["decode_ms"] / T,
         decode_kernels_by_name=dict(collections.Counter(
             n[:60] for n in kernels).most_common(8)),
         greedy_ms=greedy_ms, cpu_beam_s=cpu_beam_s,
         card_cpu_rows_differing=cpu_rows, token_lens=tlens.tolist(),
         greedy_token_lens=greedy_card[1].tolist(),
         beam_greedy_rows_differing=len(rows_differing(beam_card,
                                                       greedy_card)),
         k1=dict(figures, errors=errs, tolerance=K1_TOL, bound_by=bound_by))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return figures


def k1_routes(counts) -> dict:
    """K1's launches by route from ``_read_counts()``: every launch of
    ``lstm_fwd`` not made by the per-step route is the persistent one's."""
    return {"persistent": counts["k1"] - counts["k1_step"],
            "stepwise": counts["k1_step"]}


def phase_rnnt_beam_serve(dev):
    """rnn_t_960_beam at full width and depth with seeded weights
    transcribes B=32 x 5 s of seeded noise through ``build_transcriber``
    and the config's beam (W=16, expand_topk 16, speculative_frames 8,
    max_symbols_per_step 8, max_output_len 200): one warm-up and three timed
    runs, no plain version, K1 on both routes (the encoder persistent, the
    prediction net at 512 rows per-step); the loop's block steps, rounds and
    flags read from the device a batch; a stage split; one traced run (K1's
    device ms by route, the idle share) and the decode window alone traced
    (kernels a loop iteration, copies to the host); K1's calls of one run
    against the plain version (the first call of each shape), the plain
    version's and cuDNN's device times over all of them.  Returns the
    ``rnnt_beam_serve`` path of K1's ``kernels`` entry."""
    from myrtlespeech_tpu_torch.builders.build import random_params
    from myrtlespeech_tpu_torch.decoding import rnnt_beam
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as k
    from myrtlespeech_tpu_torch.run.infer import (build_transcriber,
                                                  load_config, random_audio)

    cfg = load_config("rnn_t_960_beam")
    pc = cfg.speech_to_text.post_process
    t0 = time.perf_counter()
    tr = build_transcriber(cfg, random_params(cfg, seed=0), device=str(dev))
    setup_s = time.perf_counter() - t0
    B, secs = BEAM_BATCH, BEAM_SECONDS
    wav, lens = random_audio(B, secs, seed=0)
    tr.transcribe(wav, lens)  # warm-up
    times, routes, loops = [], [], []
    with _plain_guard() as guard:
        for _ in range(3):
            _zero_counts()
            rnnt_beam.LOOP_COUNTS.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tr.transcribe(wav, lens)  # ends in a copy to the host
            times.append(time.perf_counter() - t0)
            launches = _read_counts()
            routes.append(k1_routes(launches))
            loops.append(dict(rnnt_beam.LOOP_COUNTS))
        stages = stage_ms(tr, wav, lens)
        _zero_counts()
        traced_wall_ms, spans = device_trace(lambda: tr.transcribe(wav,
                                                                   lens))
        traced_routes = k1_routes(_read_counts())
    if guard.calls:
        raise AssertionError(f"plain versions ran on the beam serve path: "
                             f"{dict(guard.calls)}")
    if any(r != routes[0] for r in routes + [traced_routes]) \
            or any(lp != loops[0] for lp in loops):
        raise AssertionError(f"K1 launches or loop counts differ from run "
                             f"to run: {routes} {traced_routes} {loops}")
    per_run = routes[0]
    if per_run["persistent"] != BEAM_ENCODER_LAUNCHES \
            or per_run["stepwise"] == 0 or per_run["stepwise"] % 2:
        raise AssertionError(f"K1 launches by route a batch: {per_run}; "
                             f"expected {BEAM_ENCODER_LAUNCHES} persistent "
                             "(the encoder) and 2 per-step a prediction call")
    others = {n: c for n, c in launches.items()
              if n not in ("k1", "k1_step") and c}
    if others:
        raise AssertionError(f"other kernels ran on the beam serve path: "
                             f"{others}")
    k1_spans = {"persistent": named(spans, TRACE_NAMES["k1"]),
                "stepwise": named(spans, TRACE_NAMES["k1_step"])}
    found = {r: len(sp) for r, sp in k1_spans.items()}
    if found != traced_routes:
        raise AssertionError(f"the trace holds {found} K1 kernels, the "
                             f"counters {traced_routes}")
    by_kernel = collections.Counter()
    for name, s0, e0 in spans:
        by_kernel[name[:80]] += (e0 - s0) / 1e3
    busy = busy_ms(spans)

    # What came out: token ids of the vocabulary, lengths in range, and a
    # finite encoder output of the expected shape; then the decode window
    # alone, traced.
    toks, tlens = out.tokens.cpu().numpy(), out.lengths.cpu().numpy()
    V = len(cfg.speech_to_text.alphabet)
    if toks.shape != (B, 200) or not (
            (0 <= tlens).all() and (tlens <= 200).all()
            and (0 <= toks).all() and (toks < V).all()):
        raise AssertionError(f"bad tokens {toks.shape} lens {tlens}")
    with torch.inference_mode():
        feats, flens = tr.preprocess(torch.as_tensor(wav, device=dev),
                                     torch.as_tensor(lens, device=dev))
        f, f_lens = tr.outputs(feats, flens)
    if tuple(f.shape) != (B, BEAM_FRAMES, BEAM_ENCODER_WIDTH) \
            or not torch.isfinite(f.float()).all():
        raise AssertionError(f"encoder output {tuple(f.shape)} not finite "
                             "or of the wrong shape")

    def decode_to_host():
        with torch.inference_mode():
            return tuple(a.cpu() for a in tr.decode_outputs(f, f_lens))

    rnnt_beam.LOOP_COUNTS.clear()
    dec_wall_ms, dec_spans = device_trace(decode_to_host)
    dec_loops = dict(rnnt_beam.LOOP_COUNTS)
    kernels, dtoh, htod = kernels_and_copies(dec_spans)
    iterations = dec_loops["block_steps"] + dec_loops["rounds"]
    del feats, f

    # K1 on this path's own calls: against the plain version (the first
    # call of each shape), the plain version and cuDNN over every call.
    calls = record_many({"k1": (k, "lstm_fwd")},
                        lambda: tr.transcribe(wav, lens))["k1"]
    errs = {}
    with torch.inference_mode():
        for args in _first_per_shape(calls, lambda a: a[0].shape).values():
            max_into(errs, k1_errors(k.lstm_fwd(*args),
                                     k.lstm_fwd_reference(*args),
                                     "beam serve"))

        def plain_replay():
            with torch.inference_mode():
                for args in calls:
                    k.lstm_fwd_reference(*args)

        _, plain_spans = device_trace(plain_replay, or_events=True)
    check_errors(errs, "beam serve")
    library_ms, library = cudnn_replay(calls, "k1", dev)
    works = [k1_work(*a[0].shape[:2], a[0].shape[2] // 4, a[5] is not None)
             for a in calls]
    bound_ms, bound_by = bound(sum(w[0] for w in works),
                               sum(w[1] for w in works))
    steps = sum(a[0].shape[0] for a in calls)
    del calls
    k1_ms = {r: span_ms(sp) for r, sp in k1_spans.items()}
    figures = {"launches": sum(traced_routes.values()),
               "launches_by_route": traced_routes,
               "ms": sum(k1_ms.values()), "ms_by_route": k1_ms,
               "steps": steps, "plain_ms": span_ms(plain_spans),
               "plain_calls": len(works), "library_ms": library_ms,
               "library": library, "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": max(errs.values())}
    ms = 1e3 * statistics.median(times)
    emit("rnnt_beam_serve", config="rnn_t_960_beam", batch=B, seconds=secs,
         decoder=f"beam W={pc.beam_width} expand_topk={pc.expand_topk} "
                 f"speculative_frames={pc.speculative_frames} "
                 f"max_symbols_per_step={pc.max_symbols_per_step} "
                 f"length_norm={pc.length_norm} max_output_len=200",
         setup_s=setup_s, ms_per_batch=ms, ms_runs=[1e3 * t for t in times],
         audio_s_per_s=B * secs / (ms / 1e3), **stages,
         k1_launches_by_route=per_run, loop_counts=loops[0],
         flags_read=loops[0]["flag_reads"],
         block_steps=loops[0]["block_steps"], rounds=loops[0]["rounds"],
         traced_wall_ms=traced_wall_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / traced_wall_ms,
         device_events=len(spans), k1_device_ms_by_route=k1_ms,
         device_ms_by_kernel=dict(by_kernel.most_common(10)),
         decode_wall_ms_traced=dec_wall_ms,
         decode_device_busy_ms=busy_ms(dec_spans),
         decode_kernels=len(kernels),
         decode_kernels_per_iteration=len(kernels) / iterations,
         decode_dtoh_copies=len(dtoh), decode_htod_copies=len(htod),
         decode_kernels_by_name=dict(collections.Counter(
             n[:60] for n in kernels).most_common(8)),
         token_lens=tlens.tolist(),
         k1=dict(figures, errors=errs, tolerance=K1_TOL))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return figures


def phase_ctc_decode_fixture(dev):
    """The port decodes the fixture's stored logits (B=4 x 836 x 29) on the
    card with each stored decoder (``port_tools/ctc_decode_fixture.py``:
    the configs' beam, every symbol expanded, the char-bigram LM, the word
    bigram LM, greedy); every output must equal the JAX package's, stored
    beside the logits, exactly."""
    from port_tools import ctc_decode_fixture as fixture

    with np.load(fixture.PATH) as z:
        data = {name: z[name] for name in z.files}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fixture.port_decodes(data, dev)
    seconds = time.perf_counter() - t0
    rows = {name: rows_differing(out, (data[f"{name}_tokens"],
                                       data[f"{name}_lens"]))
            for name, out in got.items()}
    emit("ctc_decode_fixture", shape=list(data["logits"].shape),
         jax_version=str(data["jax_version"]), cases=sorted(got),
         token_lens={n: o[1].tolist() for n, o in got.items()},
         rows_differing=rows, seconds=seconds)
    if any(rows.values()):
        raise AssertionError(f"the card's decodes differ from the JAX "
                             f"package's in rows {rows}")


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


def phase_trained_beam(dev):
    """The trained medium npz decodes the 256-utterance eval split through
    ``synthetic_medium_rnnt``'s own beam (W=8, length_norm,
    max_symbols_per_step 8, expand_topk 16, speculative_frames 8), batched
    as ``phase_trained`` batches it: its WER must lie within WER_TOLERANCE of
    the JAX package's beam WER for the same weights; decode seconds, K1's
    launches by route (the encoder persistent, the prediction net at 256
    rows per-step), no plain version, and the decoder's tallies of the same
    pass: rounds a frame and the share of frames consumed as pure blank.
    Then K1's calls of one batch against the plain version, the first call
    of each shape.  Returns the ``trained_beam`` path of K1's ``kernels``
    entry."""
    from myrtlespeech_tpu_torch.configs.synthetic_medium_rnnt import \
        task_config as cfg
    from myrtlespeech_tpu_torch.data.dataset.synthetic import SyntheticSpeech
    from myrtlespeech_tpu_torch.decoding import rnnt_beam
    from myrtlespeech_tpu_torch.decoding.wer import wer
    from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as k
    from myrtlespeech_tpu_torch.run.infer import (build_transcriber,
                                                  pad_waveforms)
    from myrtlespeech_tpu_torch.weights import params_from_npz

    pc = cfg.speech_to_text.post_process
    npz = "benchmarks/data/rnnt_medium/trained_params_bf16.npz"
    tr = build_transcriber(cfg, params_from_npz(npz, cfg), device=str(dev))
    ds = SyntheticSpeech(cfg.eval_dataset)
    items = [ds[i] for i in range(len(ds))]
    s_max = max(len(w) for w, _ in items)
    batches = []
    for i in range(0, len(items), 32):
        chunk = items[i:i + 32]
        wav, lens = pad_waveforms([w for w, _ in chunk])
        batches.append((np.pad(wav, ((0, 0), (0, s_max - wav.shape[1]))),
                        lens, [t for _, t in chunk]))
    refs = [t for _, _, texts in batches for t in texts]
    tr.transcribe(*batches[0][:2])  # warm-up
    # The decoder's device tallies ride along in the timed pass: a few
    # reductions a loop iteration, read once a batch after its transcript.
    decode, tally, hyps = tr.decode, collections.Counter(), []
    with _plain_guard() as guard:
        _zero_counts()
        rnnt_beam.LOOP_COUNTS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for wav, lens, _ in batches:
            t = {}
            tr.decode = functools.partial(decode, tally=t)
            hyps += tr.transcribe(wav, lens).texts
            tally.update({n: int(v) for n, v in t.items()})
        seconds = time.perf_counter() - t0
        tr.decode = decode
        counts = _read_counts()
        loops = dict(rnnt_beam.LOOP_COUNTS)
    if guard.calls:
        raise AssertionError(f"plain versions ran on the trained beam path: "
                             f"{dict(guard.calls)}")
    routes = k1_routes(counts)

    # K1 on this path's own calls (one batch): the encoder's persistent
    # calls and the prediction net's per-step ones at B*W = 256 rows.
    calls = record_many({"k1": (k, "lstm_fwd")},
                        lambda: tr.transcribe(*batches[0][:2]))["k1"]
    errs = {}
    firsts = _first_per_shape(calls, lambda a: a[0].shape)
    with torch.inference_mode():
        for args in firsts.values():
            max_into(errs, k1_errors(k.lstm_fwd(*args),
                                     k.lstm_fwd_reference(*args),
                                     "trained beam"))
    del calls
    w = wer(refs, hyps)
    emit("trained_beam", config="synthetic_medium_rnnt",
         decoder=f"beam W={pc.beam_width} expand_topk={pc.expand_topk} "
                 f"speculative_frames={pc.speculative_frames} "
                 f"max_symbols_per_step={pc.max_symbols_per_step} "
                 f"length_norm={pc.length_norm}",
         utterances=len(refs), wer=w, jax_wer=JAX_BEAM_WER,
         tolerance=WER_TOLERANCE, ab_wer_tpu_era=AB_BEAM_WER,
         greedy_jax_wer=JAX_GREEDY_WER, decode_seconds=seconds,
         k1_launches_by_route=routes, launches=counts, loop_counts=loops,
         tally=dict(tally),
         rounds_per_frame=(tally["pure_blank_frames"] + tally["row_rounds"])
         / tally["valid_frames"],
         pure_blank_share=tally["pure_blank_frames"] / tally["valid_frames"],
         k1_shapes_checked=[list(s) for s in firsts], k1_errors=errs,
         k1_tolerance=K1_TOL,
         examples=[[r, h] for r, h in zip(refs[:3], hyps[:3])])
    check_errors(errs, "trained beam")
    if not (routes["persistent"] and routes["stepwise"]):
        raise AssertionError(f"K1 did not launch on both routes: {routes}")
    if not abs(w - JAX_BEAM_WER) <= WER_TOLERANCE:
        raise AssertionError(f"beam WER {w} is not within {WER_TOLERANCE} "
                             f"of the JAX package's {JAX_BEAM_WER}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": sum(routes.values()), "launches_by_route": routes,
            "shapes_checked": [list(s) for s in firsts], "errors": errs,
            "max_abs_err": max(errs.values())}


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
    evaluate = train.eval_step_body(task, decode=False)
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


# ---------------------------------------------------------------------------
# The run loop: fit, the bucketed loader, checkpoints and the CLI.
# ---------------------------------------------------------------------------

# deep_speech_2_en with its LibriSpeech datasets swapped for the synthetic
# corpus (2-8 words, some 1-4 s an utterance): 256 train and 64 eval
# utterances, batches of 32 (the config's).  A run takes FIT_BATCHES train
# batches of one epoch (``--max_batches``) and the eval split's 2 packed
# batches, decoded by the config's beam (W=16).
FIT_TRAIN_LEN, FIT_EVAL_LEN, FIT_BATCHES = 256, 64, 8
# A DS2 train step launches K1 and K2 once per LSTM direction, K7 and K8
# once; an eval batch K1 10 times and K7 once (the eval loss).
FIT_DS2_STEP = {"k1": 10, "k2": 10, "k3": 0, "k4": 0, "k5": 0, "k6": 0,
                "k7": 1, "k8": 1}
FIT_DS2_EVAL = {"k1": 10, "k2": 0, "k3": 0, "k4": 0, "k5": 0, "k6": 0,
                "k7": 1, "k8": 0}
# resume_ds2 stops its first fit after FIT_STOP batches and resumes it.
FIT_STOP = 3
# Where the resumed state is not bit-equal to the uninterrupted one, the
# operation that is not deterministic is named (``resume_ds2``) and each
# tensor of the state must lie within RESUME_RTOL of its largest magnitude
# (PERF.md section 6).
RESUME_RTOL = 1e-4
# rnn_t_en on the synthetic corpus: FIT_RNNT_BATCHES train batches of 16,
# one eval batch of 16 decoded greedily.  A train step launches K1 and K2
# once per LSTM layer, K3 and K4 once (the full joint fits).
FIT_RNNT_BATCH, FIT_RNNT_BATCHES = 16, 4
FIT_RNNT_STEP = {"k1": 7, "k2": 7, "k3": 1, "k4": 1, "k5": 0, "k6": 0,
                 "k7": 0, "k8": 0}


def _synthetic_datasets(cfg, n_train: int, n_eval: int):
    from myrtlespeech_tpu_torch.config import schema as S

    return S.replace(
        cfg, train_dataset=S.SyntheticSpeechConfig(dataset_len=n_train,
                                                   split="train"),
        eval_dataset=S.SyntheticSpeechConfig(dataset_len=n_eval,
                                             split="eval"))


def guarded_cli(argv) -> int:
    """``run/cli.py``'s ``main(argv)`` with the plain versions counted
    (``--guarded-cli``: the fit phases run the CLI so, in a subprocess) and
    the dropout masks tallied (``draw_keep``'s draws: masks, entries and
    entries kept, summed on the device).  Its last line is
    ``{"plain_calls": {...}, "dropout": {...}}``."""
    from myrtlespeech_tpu_torch.ops import dropout
    from myrtlespeech_tpu_torch.run import cli

    tally = {"masks": 0, "entries": 0, "kept_per_mask": [], "shapes": []}
    draw = dropout.draw_keep

    def counting_draw(shape, keep_prob, gen):
        keep = draw(shape, keep_prob, gen)
        tally["masks"] += 1
        tally["entries"] += keep.numel()
        tally["kept_per_mask"].append(keep.sum())  # read at the end
        if list(shape) not in tally["shapes"]:
            tally["shapes"].append(list(shape))
        return keep

    dropout.draw_keep = counting_draw
    try:
        with _plain_guard() as guard:
            rc = cli.main(argv)
    finally:
        dropout.draw_keep = draw
    tally["kept_per_mask"] = [int(k) for k in tally["kept_per_mask"]]
    tally["kept"] = sum(tally["kept_per_mask"])
    print(json.dumps({"plain_calls": dict(guard.calls), "dropout": tally}),
          flush=True)
    return rc


def run_cli(args, timeout: int = 600):
    """The CLI in a subprocess under ``guarded_cli``: ``(reports, wall_s,
    stdout, last)``, ``last`` its last line (the dropout tally).  Fails if
    it exits non-zero or a plain version ran."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--guarded-cli", *args],
        capture_output=True, text=True, timeout=timeout)
    wall_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the CLI exited {out.returncode}: "
                             f"{out.stderr[-4000:]}")
    head, last = out.stdout.rstrip().rsplit("\n", 1)
    last = json.loads(last)
    if last["plain_calls"]:
        raise AssertionError(f"plain versions ran in the CLI: "
                             f"{last['plain_calls']}")
    reports = json.loads(head[head.rindex("\n{\n") + 1:])
    return reports, wall_s, out.stdout, last


def _times(reports, stage: str, first: int = 1):
    """Median step ms and mean loader-wait ms of a stage's batches from
    ``first`` on (ThroughputMonitor's lists)."""
    step = reports[f"{stage}_step_ms"][first:]
    wait = reports[f"{stage}_wait_ms"][first:]
    return statistics.median(step), statistics.fmean(wait)


def phase_fit_ds2(dev, workdir: str):
    """deep_speech_2_en at full width trains one epoch on the synthetic
    corpus through the CLI in a subprocess (``--checkpoint_dir``,
    ``--log_dir``): FIT_BATCHES train batches, then the eval split decoded
    by the beam; K1/K2/K7/K8 10/10/1/1 launches a step, no plain version;
    steps, the median step ms over steps 2-8, audio-s/s, the loader wait,
    eval ms, the reports, the checkpoint's ms and bytes."""
    import csv

    from myrtlespeech_tpu_torch.config.serde import save_json
    from myrtlespeech_tpu_torch.run.infer import load_config

    cfg_path = os.path.join(workdir, "ds2_fit.json")
    save_json(_synthetic_datasets(load_config("deep_speech_2_en"),
                                  FIT_TRAIN_LEN, FIT_EVAL_LEN), cfg_path)
    ck, log = os.path.join(workdir, "ds2_ck"), os.path.join(workdir, "log")
    reports, wall_s, _, _ = run_cli(
        ["--config", cfg_path, "--epochs", "1", "--max_batches",
         str(FIT_BATCHES), "--checkpoint_dir", ck, "--log_dir", log])
    with open(os.path.join(log, "metrics.csv"), newline="") as fh:
        rows = list(csv.DictReader(fh))
    train_rows = [r for r in rows if r["stage"] == "train"]
    losses = [float(r["loss"]) for r in train_rows]
    step_ms, wait_ms = _times(reports, "train")
    eval_ms = sum(reports["eval_step_ms"]) + sum(reports["eval_wait_ms"])
    want_train = {k: n * FIT_BATCHES for k, n in FIT_DS2_STEP.items()}
    n_eval = len(reports["eval_step_ms"])
    want_eval = {k: n * n_eval for k, n in FIT_DS2_EVAL.items()}
    emit("fit_ds2", config="deep_speech_2_en", datasets="synthetic",
         train_utterances=FIT_TRAIN_LEN, eval_utterances=FIT_EVAL_LEN,
         batch=32, steps=len(train_rows), losses=losses,
         step_ms_median_2_8=step_ms, step_ms=reports["train_step_ms"],
         loader_wait_ms_mean_2_8=wait_ms, wait_ms=reports["train_wait_ms"],
         train_audio_s_per_s=reports["train_audio_sec_per_sec"],
         eval_batches=n_eval, eval_ms=eval_ms,
         eval_step_ms=reports["eval_step_ms"],
         train_mean_loss=reports.get("train_mean_loss"),
         eval_mean_loss=reports.get("eval_mean_loss"),
         wer=reports.get("wer"), cer=reports.get("cer"),
         checkpoint_save_ms=reports.get("checkpoint_save_ms"),
         checkpoint_bytes=reports.get("checkpoint_bytes"),
         train_launches=reports["train_launches"],
         eval_launches=reports["eval_launches"], cli_wall_s=wall_s,
         plain_calls=0)
    if len(train_rows) != FIT_BATCHES or n_eval != 2:
        raise AssertionError(f"{len(train_rows)} train and {n_eval} eval "
                             f"batches, expected {FIT_BATCHES} and 2")
    if reports["train_launches"] != want_train \
            or reports["eval_launches"] != want_eval:
        raise AssertionError(f"launches {reports['train_launches']}, "
                             f"{reports['eval_launches']}; expected "
                             f"{want_train}, {want_eval}")
    for key in ("train_mean_loss", "eval_mean_loss", "wer"):
        if not np.isfinite(reports.get(key, float("nan"))):
            raise AssertionError(f"report {key} missing or not finite: "
                                 f"{reports.get(key)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"fit losses not finite: {losses}")


def _state_tensors(state) -> dict:
    """A train state's tensors by name: the model's parameters and buffers,
    the optimizer's state, the step and both generators' states."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.inner.state_dict()["state"].items():
        for k, v in st.items():
            out[f"optimizer.{i}.{k}"] = torch.as_tensor(v).clone()
    out["step"] = torch.tensor(state.step)
    out["gen"] = state.gen.get_state()
    out["dropout_gen"] = state.dropout_gen.get_state()
    return out


def _compare_states(a: dict, b: dict) -> dict:
    """Bit-equality of two ``_state_tensors``, and each category's largest
    difference, absolute and over the tensor's largest magnitude."""
    diff = {"bit_equal": True, "unequal": []}
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if torch.equal(x, y):
            continue
        diff["bit_equal"] = False
        diff["unequal"].append(k)
        if not x.is_floating_point():
            diff["integer_mismatch"] = k
            continue
        cat = ("buffer" if k.endswith((".mean", ".var")) else
               k.split(".", 1)[0])
        d = (x.double() - y.double()).abs().max().item()
        scale = max(y.double().abs().max().item(), 1e-30)
        prev = diff.setdefault(cat, {"max_abs": 0.0, "max_rel": 0.0})
        prev["max_abs"] = max(prev["max_abs"], d)
        prev["max_rel"] = max(prev["max_rel"], d / scale)
    diff["n_unequal"] = len(diff.pop("unequal"))
    return diff


def find_nondeterminism(straight, resumed, first: dict) -> dict:
    """Where a resumed fit's state is not bit-equal to the uninterrupted
    one's (``first``): whether a second uninterrupted fit differs too, and
    whether both fits agree bit for bit with cuDNN held to deterministic
    algorithms, and then with ``torch.use_deterministic_algorithms`` (whose
    warnings name the operations that have no deterministic version)."""
    import warnings

    out = {"straight_twice": _compare_states(straight(), first)}
    torch.backends.cudnn.deterministic = True
    try:
        out["cudnn_deterministic"] = _compare_states(resumed("det_ck"),
                                                     straight())
    finally:
        torch.backends.cudnn.deterministic = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out["torch_deterministic"] = _compare_states(
                resumed("det_all_ck"), straight())
        finally:
            torch.use_deterministic_algorithms(False)
    out["no_deterministic_version"] = sorted(
        {str(w.message).split(".")[0] for w in caught
         if "deterministic" in str(w.message)})
    out["op"] = (
        "cuDNN's convolution (its default algorithms)"
        if out["cudnn_deterministic"]["bit_equal"] else
        "operations torch's deterministic mode replaces: "
        + "; ".join(out["no_deterministic_version"] or ["none named"])
        if out["torch_deterministic"]["bit_equal"] else
        "not found: neither deterministic mode makes the resume bit-equal")
    return out


def phase_resume_ds2(dev, workdir: str):
    """In-process: deep_speech_2_en on the fit's corpus, an uninterrupted
    1-epoch fit of FIT_BATCHES batches against a fit stopped by
    ``StopEpochAfter(FIT_STOP)``, saved, restored through the CLI's
    ``_restore_state`` and resumed (one traced window of its steps, for the
    device's idle share); their final states compared bit for bit.  Where
    they differ, the nondeterministic operation is sought
    (``find_nondeterminism``).  Then ``--eval_only`` through the CLI from
    the resumed fit's checkpoint: its WER must equal the fit's last.  Also
    the fit's step time against each of its batches through the bare train
    step, and against a fit whose loader runs in the main thread."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.config.serde import save_json
    from myrtlespeech_tpu_torch.data.batch import BucketedLoader
    from myrtlespeech_tpu_torch.run import callbacks as C
    from myrtlespeech_tpu_torch.run import cli, train
    from myrtlespeech_tpu_torch.run.checkpoint import (CheckpointCallback,
                                                       CheckpointManager)
    from myrtlespeech_tpu_torch.run.infer import load_config
    from myrtlespeech_tpu_torch.utils import trace

    cfg = _synthetic_datasets(load_config("deep_speech_2_en"),
                              FIT_TRAIN_LEN, FIT_EVAL_LEN)
    cfg_path = os.path.join(workdir, "ds2_resume.json")
    save_json(cfg, cfg_path)
    task = build_task(cfg, steps_per_epoch=FIT_TRAIN_LEN // 32)

    def straight(decode: bool):
        wer = C.ReportDecoderWER(task.alphabet)
        h = train.fit(task, epochs=1, decode_eval=decode, device=str(dev),
                      callbacks=[C.StopEpochAfter(FIT_BATCHES), wer,
                                 C.ThroughputMonitor()])
        return h

    def interrupted(ck: str, profile_dir=None):
        mgr = CheckpointManager(ck)
        train.fit(task, epochs=1, decode_eval=False, device=str(dev),
                  callbacks=[C.StopEpochAfter(FIT_STOP),
                             CheckpointCallback(mgr)])
        state, epoch, skip = cli._restore_state(task, mgr, str(dev))
        cbs = [C.StopEpochAfter(FIT_BATCHES), CheckpointCallback(mgr),
               C.ReportDecoderWER(task.alphabet), C.ReportMeanBatchLoss()]
        prof = None
        if profile_dir:
            prof = C.ProfilerCallback(profile_dir, start_step=FIT_STOP + 1,
                                      num_steps=3)
            cbs.append(prof)
        h = train.fit(task, epochs=1, initial_state=state, start_epoch=epoch,
                      skip_batches=skip, device=str(dev), callbacks=cbs,
                      decode_eval=profile_dir is not None)
        return h, (epoch, skip), prof

    with _plain_guard() as guard:
        a = straight(decode=True)
        sa = _state_tensors(a.state["train_state"])
        ck = os.path.join(workdir, "resume_ck")
        prof_dir = os.path.join(workdir, "fit_trace")
        b, cursor, prof = interrupted(ck, prof_dir)
        sb = _state_tensors(b.state["train_state"])
        diff = _compare_states(sb, sa)
        nondeterministic = None
        if not diff["bit_equal"]:
            nondeterministic = find_nondeterminism(
                lambda: _state_tensors(straight(
                    decode=False).state["train_state"]),
                lambda d: _state_tensors(interrupted(os.path.join(
                    workdir, d))[0].state["train_state"]), sa)
        # The fit's own batches through the bare train step, one at a time.
        bare_ms = []
        loader = BucketedLoader(task.train_dataset, task.alphabet, 32,
                                      seed=cfg.train_config.seed,
                                      num_workers=4,
                                      bucket_growth=cfg.train_config
                                      .audio_bucket_growth,
                                      label_bucket=cfg.train_config
                                      .label_bucket)
        loader.set_epoch(0)
        state = b.state["train_state"]
        step = train.make_train_step(task)
        for i, batch in zip(range(FIT_BATCHES), loader):
            arrays = train.to_device(batch, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, arrays)
            float(m["loss"])
            bare_ms.append(1e3 * (time.perf_counter() - t0))
        # The same fit with the loader in the main thread (no prefetch
        # thread, no sample-fetch threads): whether the loader's threads
        # slow the step they overlap.
        sync = train.fit(task, epochs=1, decode_eval=False, device=str(dev),
                         loader_kwargs={"prefetch": 0, "num_workers": 0},
                         callbacks=[C.StopEpochAfter(FIT_BATCHES),
                                    C.ThroughputMonitor()])
    if guard.calls:
        raise AssertionError(f"plain versions ran in resume_ds2: "
                             f"{dict(guard.calls)}")
    busy = trace.busy_ms(prof_dir)
    fit_ms = a.state["reports"]["train_step_ms"]
    wer = b.state["reports"]["wer"]
    eval_reports, eval_wall_s, _, _ = run_cli(
        ["--config", cfg_path, "--eval_only", "--checkpoint_dir", ck])
    emit("resume_ds2", config="deep_speech_2_en", batches=FIT_BATCHES,
         stopped_after=FIT_STOP, cursor=list(cursor),
         step=int(sb["step"]), **diff,
         nondeterministic=nondeterministic, resume_rtol=RESUME_RTOL,
         fit_wer=wer, straight_wer=a.state["reports"].get("wer"),
         eval_only_wer=eval_reports.get("wer"), eval_only_s=eval_wall_s,
         fit_step_ms=fit_ms, bare_step_ms=bare_ms,
         fit_step_ms_median_2_8=statistics.median(fit_ms[1:]),
         bare_step_ms_median_2_8=statistics.median(bare_ms[1:]),
         fit_wait_ms=a.state["reports"]["train_wait_ms"],
         sync_loader_step_ms=sync.state["reports"]["train_step_ms"],
         sync_loader_wait_ms=sync.state["reports"]["train_wait_ms"],
         sync_loader_step_ms_median_2_8=_times(sync.state["reports"],
                                               "train")[0],
         sync_loader_wait_ms_mean_2_8=_times(sync.state["reports"],
                                             "train")[1],
         traced_steps=3, traced_wall_ms=prof.wall_ms, traced_busy_ms=busy,
         idle_share=1 - busy / prof.wall_ms, plain_calls=0)
    if int(sb["step"]) != FIT_BATCHES or cursor != (0, FIT_STOP):
        raise AssertionError(f"resumed at {cursor}, ended at step "
                             f"{int(sb['step'])}")
    if not diff["bit_equal"]:
        if "integer_mismatch" in diff:
            raise AssertionError(f"the resumed state's "
                                 f"{diff['integer_mismatch']} differs")
        worst = max((v["max_rel"] for v in diff.values()
                     if isinstance(v, dict)), default=0.0)
        if worst > RESUME_RTOL:
            raise AssertionError(f"the resumed state differs by {worst} "
                                 f"relative, over {RESUME_RTOL}")
    if eval_reports.get("wer") != wer or not np.isfinite(wer):
        raise AssertionError(f"--eval_only WER {eval_reports.get('wer')} "
                             f"against the fit's {wer}")


def phase_fit_rnnt(dev):
    """rnn_t_en at full width trains through ``fit`` on the synthetic corpus:
    FIT_RNNT_BATCHES train batches of FIT_RNNT_BATCH and one eval batch
    decoded greedily; the joint path the planner took for each batch shape,
    K1-K4 launches a step (K5/K6 where the joint tail is taken), no plain
    version, finite losses and WER."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.run import callbacks as C
    from myrtlespeech_tpu_torch.run import train
    from myrtlespeech_tpu_torch.run.infer import load_config

    cfg = _synthetic_datasets(load_config("rnn_t_en"),
                              FIT_RNNT_BATCH * FIT_RNNT_BATCHES,
                              FIT_RNNT_BATCH)
    task = build_task(cfg, steps_per_epoch=FIT_RNNT_BATCHES)
    paths = []
    select = train._select_joint_path

    def recording(task_, f, g, backward):
        fused, chunk = select(task_, f, g, backward)
        name = ("full joint" if fused is None else
                "joint tail" if fused is task_.joint_tail_loss else
                f"chunked ({chunk})")
        paths.append({"stage": "train" if backward else "eval",
                      "B": f.shape[0], "T'": f.shape[1], "U+1": g.shape[1],
                      "path": name})
        return fused, chunk

    train._select_joint_path = recording
    try:
        with _plain_guard() as guard:
            h = train.fit(task, epochs=1, batch_size=FIT_RNNT_BATCH,
                          device=str(dev),
                          callbacks=[C.StopEpochAfter(FIT_RNNT_BATCHES),
                                     C.ReportMeanBatchLoss(),
                                     C.ReportDecoderWER(task.alphabet),
                                     C.ThroughputMonitor(),
                                     C.KernelLaunches()])
    finally:
        train._select_joint_path = select
    r = h.state["reports"]
    steps = len(r["train_step_ms"])
    tail = sum(p["path"] == "joint tail" for p in paths
               if p["stage"] == "train")
    want = dict({k: n * steps for k, n in FIT_RNNT_STEP.items()},
                k5=tail, k6=tail)
    emit("fit_rnnt", config="rnn_t_en", datasets="synthetic",
         batch=FIT_RNNT_BATCH, steps=steps, joint_paths=paths,
         train_launches=r["train_launches"],
         eval_launches=r["eval_launches"],
         train_mean_loss=r.get("train_mean_loss"),
         eval_mean_loss=r.get("eval_mean_loss"), wer=r.get("wer"),
         step_ms=r["train_step_ms"], wait_ms=r["train_wait_ms"],
         eval_step_ms=r["eval_step_ms"],
         train_audio_s_per_s=r["train_audio_sec_per_sec"],
         plain_calls=dict(guard.calls))
    if guard.calls:
        raise AssertionError(f"plain versions ran in fit_rnnt: "
                             f"{dict(guard.calls)}")
    if steps != FIT_RNNT_BATCHES or r["train_launches"] != want:
        raise AssertionError(f"{steps} steps, launches "
                             f"{r['train_launches']}; expected "
                             f"{FIT_RNNT_BATCHES}, {want}")
    for key in ("train_mean_loss", "eval_mean_loss", "wer"):
        if not np.isfinite(r.get(key, float("nan"))):
            raise AssertionError(f"report {key} missing or not finite: "
                                 f"{r.get(key)}")


# The hard-corpus configs (synthetic_hard_rnnt_preddrop, synthetic_hard_ctc,
# synthetic_hard_rnnt_ft) at their widths and batch (32), their datasets cut
# to HARD_TRAIN_LEN and HARD_EVAL_LEN utterances of the hard corpus: a run
# takes HARD_BATCHES train batches and one eval batch, decoded by the
# config's beam (W=8).  The RNN-T configs force the T-chunked joint
# (fused_chunk_size=32), so a train step launches K1 and K2 once per LSTM
# layer (4 encoder, 1 prediction net), K3 and K4 once, and K5/K6 never; the
# CTC config K1 and K2 once per direction of its 3 BiLSTM layers, K7 and K8
# once.
HARD_TRAIN_LEN, HARD_EVAL_LEN, HARD_BATCHES = 128, 32, 4
HARD_RNNT_STEP = {"k1": 5, "k2": 5, "k3": 1, "k4": 1, "k5": 0, "k6": 0,
                  "k7": 0, "k8": 0}
HARD_CTC_STEP = {"k1": 6, "k2": 6, "k3": 0, "k4": 0, "k5": 0, "k6": 0,
                 "k7": 1, "k8": 1}
HARD_CTC_EVAL = {"k1": 6, "k2": 0, "k3": 0, "k4": 0, "k5": 0, "k6": 0,
                 "k7": 1, "k8": 0}
# preddrop's resume check: stop after HARD_STOP of HARD_BATCHES batches.
HARD_STOP = 2
# The embedding's keep probability in synthetic_hard_rnnt_preddrop, and the
# standard deviations within which the kept share over a run must lie.
PREDDROP_KEEP, KEPT_SIGMAS = 0.7, 4.0
MEDIUM_NPZ = "benchmarks/data/rnnt_medium/trained_params_bf16.npz"


def _hard_config(name: str, workdir: str):
    """The port's config ``name`` with its hard-corpus datasets cut to
    HARD_TRAIN_LEN and HARD_EVAL_LEN utterances (speakers, filters and
    noise kept), saved as JSON: ``(cfg, path)``."""
    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.config.serde import save_json
    from myrtlespeech_tpu_torch.run.infer import load_config

    cfg = load_config(name)
    cfg = S.replace(
        cfg,
        train_dataset=S.replace(cfg.train_dataset, dataset_len=HARD_TRAIN_LEN),
        eval_dataset=S.replace(cfg.eval_dataset, dataset_len=HARD_EVAL_LEN))
    path = os.path.join(workdir, f"{name}.json")
    save_json(cfg, path)
    return cfg, path


def _hard_fit(name: str, workdir: str, extra=()):
    """``name`` (cut by ``_hard_config``) through the CLI in a subprocess:
    one epoch of HARD_BATCHES train batches and the eval batch, the CSV
    log's train rows; ``(cfg, reports, wall_s, last, rows)``."""
    import csv

    cfg, path = _hard_config(name, workdir)
    log = os.path.join(workdir, f"{name}_log")
    reports, wall_s, _, last = run_cli(
        ["--config", path, "--epochs", "1", "--max_batches",
         str(HARD_BATCHES), "--log_dir", log, *extra])
    with open(os.path.join(log, "metrics.csv"), newline="") as fh:
        rows = [r for r in csv.DictReader(fh) if r["stage"] == "train"]
    return cfg, reports, wall_s, last, rows


def _check_fit(label: str, reports, rows, want_train, want_eval=None):
    """The fit's steps, launches (train; eval where ``want_eval``), finite
    losses and WER."""
    if len(rows) != HARD_BATCHES or len(reports["eval_step_ms"]) != 1:
        raise AssertionError(f"{label}: {len(rows)} train and "
                             f"{len(reports['eval_step_ms'])} eval batches, "
                             f"expected {HARD_BATCHES} and 1")
    want_train = {k: n * HARD_BATCHES for k, n in want_train.items()}
    if reports["train_launches"] != want_train:
        raise AssertionError(f"{label}: train launches "
                             f"{reports['train_launches']}, expected "
                             f"{want_train}")
    if want_eval is not None and reports["eval_launches"] != want_eval:
        raise AssertionError(f"{label}: eval launches "
                             f"{reports['eval_launches']}, expected "
                             f"{want_eval}")
    losses = [float(r["loss"]) for r in rows]
    for key in ("train_mean_loss", "eval_mean_loss", "wer"):
        if not np.isfinite(reports.get(key, float("nan"))):
            raise AssertionError(f"{label}: report {key} missing or not "
                                 f"finite: {reports.get(key)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses not finite: {losses}")
    return losses


def _fit_fields(reports, rows, wall_s) -> dict:
    return dict(batch=32, steps=len(rows),
                losses=[float(r["loss"]) for r in rows],
                step_ms=reports["train_step_ms"],
                step_ms_median_2_4=statistics.median(
                    reports["train_step_ms"][1:]),
                wait_ms=reports["train_wait_ms"],
                eval_step_ms=reports["eval_step_ms"],
                train_mean_loss=reports.get("train_mean_loss"),
                eval_mean_loss=reports.get("eval_mean_loss"),
                wer=reports.get("wer"), cer=reports.get("cer"),
                train_launches=reports["train_launches"],
                eval_launches=reports["eval_launches"], cli_wall_s=wall_s,
                plain_calls=0)


def _longest_train_batch(task, dev, n: int):
    """The longest of the first ``n`` batches of the task's train loader in
    epoch 0 (those the fit phases train on), on ``dev``: on the chunked
    joint, the one of most chunks."""
    from myrtlespeech_tpu_torch.data.batch import BucketedLoader
    from myrtlespeech_tpu_torch.run import train

    tc = task.cfg.train_config
    loader = BucketedLoader(task.train_dataset, task.alphabet, tc.batch_size,
                            shuffle=tc.shuffle_batches_before_every_epoch,
                            seed=tc.seed, bucket_growth=tc.audio_bucket_growth,
                            label_bucket=tc.label_bucket)
    loader.set_epoch(0)
    batches = [b for _, b in zip(range(n), loader)]
    return train.to_device(max(batches, key=lambda b: b["wav"].shape[1]),
                           dev)


def hard_step_replays(task, state, dev, label: str, want: dict) -> dict:
    """One train step of a hard-corpus config from ``state`` on the longest
    batch of its fit (``_longest_train_batch``), every call of the kernels that ``want`` (a step's
    launches) launches recorded as it was made, and as many calls as it
    says.  Each kernel is held against its plain version on those inputs:
    K1 and K2 through both routes, the first call of each shape
    (``lstm_replays``, bidirectional for the CTC model), K3 and K4 on the
    step's lattice (``lattice_errors``), K7 and K8 (``ctc_errors`` and
    ``ctc_chain_errors``), at the tolerances of the other phases.  Returns
    each kernel's path figures for the ``kernels`` line."""
    from myrtlespeech_tpu_torch.ops.cuda import (ctc_kernel, lstm_kernel,
                                                 rnnt_kernel)
    from myrtlespeech_tpu_torch.run import train

    wrappers = {"k1": (lstm_kernel, "lstm_fwd"),
                "k2": (lstm_kernel, "lstm_bwd"),
                "k3": (rnnt_kernel, "rnnt_lattice_fwd"),
                "k4": (rnnt_kernel, "rnnt_lattice_bwd"),
                "k7": (ctc_kernel, "ctc_lattice_fwd"),
                "k8": (ctc_kernel, "ctc_lattice_bwd")}
    targets = {k: w for k, w in wrappers.items() if want[k]}
    batch = _longest_train_batch(task, dev, HARD_BATCHES)
    step = train.make_train_step(task)
    calls = record_many(targets, lambda: step(state, batch), snapshot=True)
    torch.cuda.synchronize()
    made = {k: len(c) for k, c in calls.items()}
    if made != {k: want[k] for k in targets}:
        raise AssertionError(f"{label}: the recorded step made {made} "
                             f"calls, expected {want}")
    shapes = {"k1": sorted({tuple(a[0].shape) for a in calls["k1"]}),
              "k2": sorted({tuple(a[4].shape) for a in calls["k2"]})}
    lstm = lstm_replays(calls.pop("k1"), calls.pop("k2"), label, dev,
                        plain_per_shape=True,
                        bidirectional=not task.transducer)
    out = {k: dict(lstm[k], step_calls=want[k],
                   shapes_checked=[list(sh) for sh in shapes[k]])
           for k in ("k1", "k2")}
    with torch.no_grad():
        if "k3" in calls:
            (k3_args,), (k4_args,) = calls.pop("k3"), calls.pop("k4")
            errs = lattice_errors(
                rnnt_kernel.rnnt_lattice_fwd(*k3_args),
                rnnt_kernel.rnnt_lattice_bwd(*k4_args),
                rnnt_kernel.rnnt_lattice_fwd_reference(*k3_args),
                rnnt_kernel.rnnt_lattice_bwd_reference(*k4_args), k4_args,
                label)
            lattice = list(k3_args[0].shape)
            out["k3"] = {"step_calls": 1, "lattice": lattice,
                         "errors": {n: errs[n] for n in ("alphas", "ll")},
                         "max_abs_err": max(errs["alphas"], errs["ll"])}
            out["k4"] = {"step_calls": 1, "lattice": lattice,
                         "errors": {n: errs[n] for n in
                                    ("gblank", "gemit", "k4_float64")},
                         "max_abs_err": max(errs["gblank"], errs["gemit"])}
        if "k7" in calls:
            (k7_args,), (k8_args,) = calls.pop("k7"), calls.pop("k8")
            errs = ctc_errors(ctc_kernel.ctc_lattice_fwd(*k7_args),
                              ctc_kernel.ctc_lattice_bwd(*k8_args),
                              ctc_kernel.ctc_lattice_fwd_reference(*k7_args),
                              ctc_kernel.ctc_lattice_bwd_reference(*k8_args),
                              k7_args, label)
            chain = ctc_chain_errors(k7_args, k8_args[-1], label)
            lattice = list(k7_args[0].shape)
            out["k7"] = {"step_calls": 1, "lattice": lattice,
                         "errors": {n: errs[n] for n in
                                    ("alphas", "ll", "k7_float64")},
                         "chain_vs_float64": chain,
                         "max_abs_err": max(errs["alphas"], errs["ll"])}
            out["k8"] = {"step_calls": 1, "lattice": lattice,
                         "errors": {"grad": errs["grad"]},
                         "max_abs_err": errs["grad"]}
    del calls
    torch.cuda.empty_cache()
    return out


def phase_fit_preddrop(dev, workdir: str):
    """``synthetic_hard_rnnt_preddrop`` trains HARD_BATCHES batches of 32
    through the CLI (embedding dropout 0.3 on the chunked path), then
    decodes one eval batch by its beam: step ms, K1-K4 5/5/1/1 a step, no
    plain version, finite losses and WER; the embedding masks' kept share
    over the run within KEPT_SIGMAS binomial standard deviations of
    PREDDROP_KEEP, every mask ``(B, U, 1)``.  Then, in-process, an
    uninterrupted fit of HARD_BATCHES batches against one stopped after
    HARD_STOP, saved, restored through the CLI's ``_restore_state`` and
    resumed: parameters, optimizer state, step and both generators (the
    dropout generator on the card) bit-equal.  The resumed fit's last step
    is traced: K1-K4's device ms and the device's idle share.  Then one
    more step from the resumed state, its K1-K4 calls (the embedding mask
    in K2's gradient) held against the plain versions
    (``hard_step_replays``); returns their path figures."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.run import callbacks as C
    from myrtlespeech_tpu_torch.run import cli, train
    from myrtlespeech_tpu_torch.run.checkpoint import (CheckpointCallback,
                                                       CheckpointManager)
    from myrtlespeech_tpu_torch.utils import trace

    name = "synthetic_hard_rnnt_preddrop"
    cfg, reports, wall_s, last, rows = _hard_fit(name, workdir)
    drops = last["dropout"]
    n, kept = drops["entries"], drops["kept"]
    share = kept / max(n, 1)
    sigma = (PREDDROP_KEEP * (1 - PREDDROP_KEEP) / max(n, 1)) ** 0.5

    task = build_task(cfg, steps_per_epoch=HARD_TRAIN_LEN // 32)
    with _plain_guard() as guard:
        straight = _state_tensors(train.fit(
            task, epochs=1, decode_eval=False, device=str(dev),
            callbacks=[C.StopEpochAfter(HARD_BATCHES)]).state["train_state"])
        mgr = CheckpointManager(os.path.join(workdir, "preddrop_ck"))
        train.fit(task, epochs=1, decode_eval=False, device=str(dev),
                  callbacks=[C.StopEpochAfter(HARD_STOP),
                             CheckpointCallback(mgr)])
        state, epoch, skip = cli._restore_state(task, mgr, str(dev))
        prof_dir = os.path.join(workdir, "preddrop_trace")
        prof = C.ProfilerCallback(prof_dir, start_step=HARD_BATCHES - 1,
                                  num_steps=1)
        resumed_state = train.fit(
            task, epochs=1, decode_eval=False, device=str(dev),
            initial_state=state, start_epoch=epoch, skip_batches=skip,
            callbacks=[C.StopEpochAfter(HARD_BATCHES),
                       prof]).state["train_state"]
        resumed = _state_tensors(resumed_state)
    diff = _compare_states(resumed, straight)
    replays = hard_step_replays(task, resumed_state, dev, "preddrop step",
                                HARD_RNNT_STEP)
    rows_traced = trace.aggregate_trace(prof_dir) or []
    kernel_ms = {k: sum(us for name, _, us in rows_traced
                        if TRACE_NAMES[k] in name) / 1e3
                 for k in ("k1", "k2", "k3", "k4")}
    busy = trace.busy_ms(prof_dir)
    emit("fit_preddrop", config=name, datasets="hard synthetic",
         train_utterances=HARD_TRAIN_LEN, eval_utterances=HARD_EVAL_LEN,
         **_fit_fields(reports, rows, wall_s), dropout_masks=drops["masks"],
         mask_shapes=drops["shapes"], mask_entries=n, kept=kept,
         kept_share=share, kept_share_sigma=sigma,
         kept_share_z=(share - PREDDROP_KEEP) / max(sigma, 1e-30),
         kept_per_mask=drops["kept_per_mask"],
         traced_step=HARD_BATCHES - 1, traced_kernel_ms=kernel_ms,
         traced_wall_ms=prof.wall_ms, traced_busy_ms=busy,
         idle_share=None if busy is None else 1 - busy / prof.wall_ms,
         resume_cursor=[epoch, skip], resume_step=int(resumed["step"]),
         resume_generator=str(state.dropout_gen.device), **diff,
         step_replays=replays, k1_tolerance=K1_TOL, k2_tolerance=K2_TOL,
         k3_tolerance={"rtol": K3_RTOL, "atol": K3_ATOL},
         k4_tolerance={"atol": K4_ATOL, "float64_ratio": CHAIN_RATIO})
    _check_fit("fit_preddrop", reports, rows, HARD_RNNT_STEP)
    if drops["masks"] != HARD_BATCHES or any(
            len(sh) != 3 or sh[0] != 32 or sh[2] != 1
            for sh in drops["shapes"]):
        raise AssertionError(f"fit_preddrop: {drops['masks']} masks of "
                             f"shapes {drops['shapes']}, expected "
                             f"{HARD_BATCHES} of (32, U, 1)")
    if abs(share - PREDDROP_KEEP) > KEPT_SIGMAS * sigma:
        raise AssertionError(f"fit_preddrop: kept share {share} of {n} is "
                             f"not within {KEPT_SIGMAS} sigma ({sigma}) of "
                             f"{PREDDROP_KEEP}")
    if guard.calls:
        raise AssertionError(f"plain versions ran in fit_preddrop: "
                             f"{dict(guard.calls)}")
    if (epoch, skip) != (0, HARD_STOP) \
            or int(resumed["step"]) != HARD_BATCHES:
        raise AssertionError(f"fit_preddrop: resumed at {(epoch, skip)}, "
                             f"ended at step {int(resumed['step'])}")
    if state.dropout_gen.device.type != "cuda":
        raise AssertionError("the dropout generator is not on the card")
    if not diff["bit_equal"]:
        raise AssertionError(f"fit_preddrop: the resumed state is not "
                             f"bit-equal to the uninterrupted one: {diff}")
    # The eval batch: the encoder's 4 layers, the beam's prediction net,
    # the eval loss's lattice once.
    if reports["eval_launches"]["k3"] != 1 \
            or reports["eval_launches"]["k1"] < 4:
        raise AssertionError(f"fit_preddrop: eval launches "
                             f"{reports['eval_launches']}")
    return replays


def phase_fit_hard_ctc(dev, workdir: str):
    """``synthetic_hard_ctc`` trains HARD_BATCHES batches of 32 through the
    CLI and decodes one eval batch by its prefix beam (W=8): step ms, K1/K2
    at H=256 (bidirectional) 6/6 and K7/K8 1/1 a step, K1 6 and K7 1 on
    the eval batch, no plain version, finite losses and WER.  Then, in
    process, one step from the config's seeded weights, its K1/K2/K7/K8
    calls held against the plain versions (``hard_step_replays``); returns
    their path figures."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.run import train

    name = "synthetic_hard_ctc"
    cfg, reports, wall_s, _, rows = _hard_fit(name, workdir)
    task = build_task(cfg, steps_per_epoch=HARD_TRAIN_LEN // 32)
    state = train.init_state(task, seed=cfg.train_config.seed,
                             device=str(dev))
    replays = hard_step_replays(task, state, dev, "hard CTC step",
                                HARD_CTC_STEP)
    del state
    emit("fit_hard_ctc", config=name, datasets="hard synthetic",
         train_utterances=HARD_TRAIN_LEN, eval_utterances=HARD_EVAL_LEN,
         **_fit_fields(reports, rows, wall_s), step_replays=replays,
         k1_tolerance=K1_TOL, k2_tolerance=K2_TOL,
         k7_tolerance={"rtol": K7_RTOL, "atol": K7_ATOL,
                       "float64_ratio": CHAIN_RATIO},
         k8_tolerance={"atol": K8_ATOL})
    _check_fit("fit_hard_ctc", reports, rows, HARD_CTC_STEP, HARD_CTC_EVAL)
    return replays


def phase_ft_hard_rnnt(dev, workdir: str):
    """Stage 2 of the curriculum: the committed medium npz (stage 1, the
    hard configs' architecture) as a port checkpoint.  In process, the
    CLI's own warm start from it (``cli._warm_start``, what
    ``--init_from`` runs) must hold every parameter of the npz bit for bit,
    step 0, no optimizer state and the LR schedule's step-0 value; one
    step from that state, its K1-K4 calls held against the plain versions
    (``hard_step_replays``).  Then ``synthetic_hard_rnnt_ft`` through the
    CLI with ``--init_from`` it for HARD_BATCHES batches of 32 and one eval
    batch by its beam: the first step's logged LR the schedule's start,
    K1-K4 5/5/1/1 a step, no plain version, finite losses; the eval batch's
    beam WER.  Returns the replays' path figures."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.run import cli, train
    from myrtlespeech_tpu_torch.run.checkpoint import (CheckpointManager,
                                                       load_params_npz)

    name = "synthetic_hard_rnnt_ft"
    cfg, _ = _hard_config(name, workdir)
    task = build_task(cfg, steps_per_epoch=HARD_TRAIN_LEN // 32)
    init_dir = os.path.join(workdir, "medium_ck")
    want = load_params_npz(MEDIUM_NPZ, cfg)
    state = train.init_state(task, params=want, device=str(dev))
    CheckpointManager(init_dir).save(0, state)
    state = cli._warm_start(task, CheckpointManager(init_dir), str(dev))
    got = state.model.state_dict()
    lr0 = task.lr_schedule(0)
    init = {"params": len(want),
            "params_bit_equal": sorted(got) == sorted(want) and all(
                torch.equal(got[k].cpu(), want[k]) for k in want),
            "step": state.step,
            "optimizer_state_entries": len(state.optimizer.inner.state),
            "lr_at_start": task.lr_schedule(state.step)}
    if not init["params_bit_equal"] or init["step"] != 0 \
            or init["optimizer_state_entries"] != 0 \
            or init["lr_at_start"] != lr0:
        raise AssertionError(f"ft_hard_rnnt: the warm start is not the "
                             f"npz's weights with a fresh optimizer and "
                             f"schedule: {init}")
    replays = hard_step_replays(task, state, dev, "ft step", HARD_RNNT_STEP)
    del state, got
    _, reports, wall_s, _, rows = _hard_fit(
        name, workdir, extra=["--init_from", init_dir])
    emit("ft_hard_rnnt", config=name, init_from=MEDIUM_NPZ,
         datasets="hard synthetic", train_utterances=HARD_TRAIN_LEN,
         eval_utterances=HARD_EVAL_LEN, **_fit_fields(reports, rows, wall_s),
         init=init, first_logged_lr=float(rows[0]["lr"]), lr_at_step_0=lr0,
         first_eval_batch_beam_wer=reports.get("wer"), step_replays=replays)
    _check_fit("ft_hard_rnnt", reports, rows, HARD_RNNT_STEP)
    if float(rows[0]["lr"]) != lr0:
        raise AssertionError(f"ft_hard_rnnt: the first step's LR "
                             f"{rows[0]['lr']}, not the schedule's start "
                             f"{lr0}")
    return replays


def fit_phases(dev) -> dict:
    """The run-loop phases; returns the hard-corpus phases' kernel figures
    by path and kernel (``hard_step_replays``)."""
    with tempfile.TemporaryDirectory() as workdir:
        phase_fit_ds2(dev, workdir)
        phase_resume_ds2(dev, workdir)
    phase_fit_rnnt(dev)
    with tempfile.TemporaryDirectory() as workdir:
        return {"fit_preddrop": phase_fit_preddrop(dev, workdir),
                "fit_hard_ctc": phase_fit_hard_ctc(dev, workdir),
                "ft_hard_rnnt": phase_ft_hard_rnnt(dev, workdir)}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if argv[:1] == ["--guarded-cli"]:
        return guarded_cli(argv[1:])
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
    k1["paths"]["ds2_serve"] = phase_ds2_serve(dev)
    k1["paths"]["rnnt_beam_serve"] = phase_rnnt_beam_serve(dev)
    phase_ctc_decode_fixture(dev)
    phase_ctc_falls(dev)
    phase_medium_falls(dev)
    phase_trained(dev)
    k1["paths"]["trained_beam"] = phase_trained_beam(dev)
    for entry in (k1, k234[0]):
        entry["max_abs_err"] = max(p["max_abs_err"]
                                   for p in entry["paths"].values())
    # The hard-corpus fits' kernel calls, each held against its plain
    # version, join each kernel's paths and its largest error.
    entries = dict(zip(("k1", "k2", "k3", "k4", "k7", "k8"),
                       [k1, *k234, *k78]))
    for path, figures in fit_phases(dev).items():
        for kernel, fig in figures.items():
            entry = entries[kernel]
            entry.setdefault("paths", {})[path] = fig
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       fig["max_abs_err"])
    print(json.dumps({"kernels": [k1] + k234 + k56 + k78}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
