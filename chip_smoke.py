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
             median), beside the least time the card could take.
4. flagship  ``rnn_t_en`` at full width with seeded random weights transcribes
             B=32 x 5 s of seeded audio through ``build_transcriber``: one
             warm-up and three timed runs, K1's launches on that path, a
             stage split, and one run traced with ``torch.profiler`` for
             K1's device time on the main path and the device's idle share.
5. k1_main_path  every K1 call of one such run, recorded and replayed
             through K1 (errors against the plain version on the main
             path's own inputs), the plain version and cuDNN (device time
             of each replay, traced alike).
6. trained   the trained medium RNN-T (committed npz) decodes its
             256-utterance eval split greedily at B=32; its WER must lie
             within 0.01 of the JAX package's greedy WER for the same weights.

Then a ``kernels`` line (one entry per ported kernel: ``ms`` is the kernel's
device time on the flagship main path, ``plain_ms`` and ``library_ms`` the
device times of the replays, ``bound_ms`` counted from the recorded calls),
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

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FLAGSHIP_BATCH, FLAGSHIP_SECONDS = 32, 5.0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def bound(flops: float, nbytes: float):
    """Least ms for that work on the card, and what bounds it."""
    ops_ms, bytes_ms = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES
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
             kernel_ms=kernel_ms, plain_ms=plain_ms,
             library_ms=dict(zip(widths, lib)), bound_ms=bound_ms,
             bound_by=bound_by, tolerance=K1_TOL)


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


def record_k1_calls(tr, wav, lens):
    """The arguments of every K1 call of one ``transcribe``, in order."""
    from myrtlespeech_tpu_torch.ops import rnn as rnn_ops

    real, calls = rnn_ops.lstm_fwd, []

    def recording(*args):
        calls.append(args)
        return real(*args)

    rnn_ops.lstm_fwd = recording
    try:
        tr.transcribe(wav, lens)
    finally:
        rnn_ops.lstm_fwd = real
    return calls


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
            "calls": record_k1_calls(tr, wav, lens)}


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
    flagship = phase_flagship(dev)
    k1 = phase_main_path_k1(dev, flagship)
    del flagship
    phase_trained(dev)
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
