"""The serve entry: one caller in a closed loop of batches through the
program's ``run/infer.py::Transcriber.transcribe``.

Set-up makes the cell's host batches and the weights from the seed, builds
the program's transcriber on them (``build_transcriber(params)``) and
transcribes two batches to warm up.  In the window each batch is timed
from the call until its texts are on the host.  After the window the
transcriber is freed; a sample of the finished calls, drawn from the seed,
is held to the reference's logits on the same audio: the widest gap by
which a served token lies below the reference's best
(``checks.ctc_min_max_gap``).
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench.harness import checks, manifest, profile, traffic, weights
from portbench.harness.window import Window

WARMUP_CALLS = 2
SAMPLED_CALLS = 2


def build(cell, seed: int, device):
    from myrtlespeech_tpu_torch.run.infer import build_transcriber, load_config

    cfg = cell.config
    ref = manifest.reference_module(cell.root, cfg["family"])
    spec = ref.param_spec(cfg)
    params = weights.make(spec, seed, device)
    tr = build_transcriber(load_config(cfg["port_config"]), params,
                           str(device))
    del params
    if tr.dtype != getattr(torch, cfg["compute_dtype"]):
        raise ValueError("the program's compute dtype differs from the "
                         "configuration file's")
    weights.check_layout(tr.model.state_dict(), spec)
    return tr


def transcribe(tr, batch) -> list:
    with profile.span("transcribe"):
        return tr.transcribe(batch["wav"], batch["wav_lens"]).texts


def token_ids(texts, alphabet: str) -> list:
    index = {c: i for i, c in enumerate(alphabet)}
    return [[index[c] for c in t] for t in texts]


def reference_logits(cell, seed: int, device, batch, prec: str = "fp32"):
    cfg = cell.config
    ref = manifest.reference_module(cell.root, cfg["family"])
    params = weights.make(ref.param_spec(cfg), seed, device)
    wav = torch.as_tensor(batch["wav"]).to(device)
    lens = torch.as_tensor(batch["wav_lens"]).to(device)
    return ref.serve_logits(cfg, params, wav, lens, prec)


def served_gap(cell, seed: int, device, batch, texts) -> float:
    """The widest gap of one call's served transcripts."""
    lg, frames = reference_logits(cell, seed, device, batch)
    gaps = checks.ctc_min_max_gap(lg, frames, token_ids(
        texts, cell.config["alphabet"]), cell.config["blank_index"])
    return float(gaps.max())


def sample_calls(calls: list, seed: int) -> list:
    """Calls to check, drawn from the seed among the finished ones, each of
    another batch.  Every batch holds a row of the longest length."""
    rng = np.random.default_rng(seed)
    latest = {}
    for i, (b, _) in enumerate(calls):
        latest[b] = i
    picks = rng.permutation(sorted(latest))[:SAMPLED_CALLS]
    return [calls[latest[int(b)]] for b in picks]


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    from myrtlespeech_tpu_torch.run.train import kernel_launches

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = cell.config
    host = traffic.make_batches(cell.traffic, cell.workload["batch"], seed,
                                cfg)
    audio = [traffic.audio_seconds(b, cfg) for b in host]
    tr = build(cell, seed, dev)
    for i in range(WARMUP_CALLS):
        transcribe(tr, host[i % len(host)])
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    launches0 = kernel_launches()
    calls, times, total = [], [], 0.0
    with profile.profiler(trace) as prof:
        t0 = time.perf_counter()
        n = 0
        while True:
            b = n % len(host)
            n += 1
            a = time.perf_counter()
            texts = transcribe(tr, host[b])
            times.append(time.perf_counter() - a)
            calls.append((b, texts))
            total += audio[b]
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = {k: (v - launches0[k]) / n
                for k, v in kernel_launches().items()}
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ms = [1e3 * t for t in times]
    p95 = statistics.quantiles(ms, n=100, method="inclusive")[94] \
        if len(ms) > 1 else ms[0]
    values = {"serve_audio_s_per_s": total / (t1 - t0),
              "serve_batch_ms.p95": p95, "setup_s": setup_s}
    out = {"attempted": n, "failed": 0, "values": values,
           "memory_peak_bytes": peak, "launches": launches}
    if trace:
        t = profile.read(prof)
        work = manifest.work_module(cell.root, cfg["name"])
        sr = cfg["features"]["sample_rate"]
        hop = int(cfg["features"]["hop_length_ms"] * sr / 1000)
        shape = {"B": cell.workload["batch"],
                 "T0": int(round(cell.traffic["pad_seconds"] * sr)) // hop
                 + 1}
        out["window"] = Window(
            entry="serve", units=n, window_s=(t.end - t.start) / 1e6,
            trace=t, model_flops=work.model_flops(cfg, shape, False),
            work=work.kernel_work(cfg, shape, False))

    gap = max(served_gap(cell, seed, dev, host[b], texts)
              for b, texts in sample_calls(calls, seed))
    out["checks"] = checks.judged({"logit_gap": gap},
                                  cell.workload["limits"])
    return out
