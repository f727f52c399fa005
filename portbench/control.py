"""Readings that set a cell's correctness limits, at the cell's own sizes,
many seeds in one process (the benchmark's own runs never run this).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out FILE]
    python3 portbench/control.py --look embedding_sum \
        --workload rnn_t_en:bucket_long:128 --seeds 1,2,3

For each seed of ``--seeds``: the program's readings (a train cell's first
three steps; a serve cell's transcripts of the calls a run would sample)
against the float32 reference's, every number of ``harness/checks.py``:
the lower readings.  For each seed of ``--control-seeds`` also the
control: the reference computed in float8 (``prec="fp8"``, every
product's operands rounded to e4m3) in the program's place, judged by the
same comparison as the program (a serve cell's control decodes its logits
greedily into transcripts); and for a train cell the fault of half the
batch left out (the reference on the first half of the rows, the mean
over them).

``--look embedding_sum`` (an RNN-T train cell, or ``config:traffic:batch``
for one that ``BENCHMARK.json`` does not list): the program's first
gradient against the reference's with the embedding's gradient summed in
float32, serially in bfloat16, and by PyTorch's bfloat16 ``index_put_``.

One JSON line a seed and kind, to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_lines(cell, seed: int, dev, control: bool):
    from portbench.entries import train
    from portbench.harness import checks

    sess = train.Session(cell, seed, dev)
    program = sess.readings
    sess.close()
    ref = train.reference_readings(cell, seed, dev)

    def gaps(other):
        return {**checks.train_gaps(other, ref),
                "detail": checks.detail(other, ref)}

    yield "program", gaps(program)
    if not control:
        return
    yield "control_fp8", gaps(train.reference_readings(cell, seed, dev,
                                                       "fp8"))
    yield "fault_half_batch", gaps(half_batch_readings(cell, seed, dev))


def look_lines(cell, seed: int, dev):
    """The program's first gradient against the reference's three ways of
    summing the embedding's gradient."""
    import torch

    from portbench.entries import train
    from portbench.harness import checks, manifest, traffic, weights

    sess = train.Session(cell, seed, dev)
    program = sess.readings
    sess.close()
    cfg = cell.config
    ref = manifest.reference_module(cell.root, cfg["family"])
    host = traffic.make_batches(cell.traffic, cell.workload["batch"], seed,
                                cfg)
    first = [{k: torch.as_tensor(v).to(dev) for k, v in host[0].items()}]
    leaf = "embedding.embedding"
    out = {"program": program["grad1"][leaf]}
    for way in ("fp32", "serial", "index_put"):
        params = weights.make(ref.param_spec(cfg), seed, dev)
        r = ref.train_readings(cfg, params, first, seed, "fp32", 1,
                               embedding_sum=way)
        out[way] = r["grad1"][leaf]
        out[way + "_grad1_gap"] = checks.train_gaps(program, r,
                                                    ["grad1_gap"])["grad1_gap"]
        out[way + "_worst"] = checks.detail(program, r)["grad1"][:2]
    yield "look_embedding_sum", out


def half_batch_readings(cell, seed: int, dev) -> dict:
    """The reference's readings with each batch cut to its first half of
    rows (the mean over them)."""
    import torch

    from portbench.entries import train
    from portbench.harness import manifest, traffic, weights

    cfg = cell.config
    ref = manifest.reference_module(cell.root, cfg["family"])
    host = traffic.make_batches(cell.traffic, cell.workload["batch"], seed,
                                cfg)
    half = cell.workload["batch"] // 2
    batches = [{k: torch.as_tensor(v[:half]).to(dev) for k, v in b.items()}
               for b in host[:train.CHECKED_STEPS]]
    params = weights.make(ref.param_spec(cfg), seed, dev)
    return ref.train_readings(cfg, params, batches, seed, "fp32",
                              train.CHECKED_STEPS)


def serve_lines(cell, seed: int, dev, control: bool):
    import gc

    import torch

    from portbench.entries import serve
    from portbench.harness import checks, traffic

    host = traffic.make_batches(cell.traffic, cell.workload["batch"], seed,
                                cell.config)
    tr = serve.build(cell, seed, dev)
    calls = [(b, serve.transcribe(tr, host[b])) for b in range(len(host))]
    del tr
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sampled = serve.sample_calls(calls, seed)
    gaps = {b: serve.served_gap(cell, seed, dev, host[b], texts)
            for b, texts in calls}
    yield "program", {"logit_gap": max(gaps[b] for b, _ in sampled),
                      "logit_gap_all_batches": max(gaps.values())}
    if not control:
        return
    blank = cell.config["blank_index"]
    worst = 0.0
    for b, _ in sampled:
        lg, frames = serve.reference_logits(cell, seed, dev, host[b])
        low, _ = serve.reference_logits(cell, seed, dev, host[b], "fp8")
        tokens = checks.greedy_tokens(low, frames, blank)
        worst = max(worst, float(checks.ctc_min_max_gap(
            lg, frames, tokens, blank).max()))
    yield "control_fp8", {"logit_gap": worst}


def main(argv=None) -> int:
    sys.path[0] = ROOT
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--look", choices=("embedding_sum",), default=None)
    args = p.parse_args(argv)
    import torch

    from portbench.harness import manifest

    if ":" in args.workload:
        config, traffic_name, batch = args.workload.split(":")
        cell = manifest.unlisted_cell(ROOT, config, traffic_name, "train",
                                      int(batch))
    else:
        cell = manifest.load_cell(ROOT, args.workload)
    dev = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    if args.look:
        def lines(cell, seed, dev, _):
            return look_lines(cell, seed, dev)
    elif cell.workload["entry"] == "train":
        lines = train_lines
    else:
        lines = serve_lines
    out = open(args.out, "a") if args.out else None
    try:
        for seed in sorted(set(seeds) | control):
            t0 = time.perf_counter()
            for kind, values in lines(cell, seed, dev, seed in control):
                if kind == "program" and seed not in seeds:
                    continue
                rec = json.dumps({"workload": cell.name, "seed": seed,
                                  "kind": kind, **values,
                                  "s": time.perf_counter() - t0})
                print(rec, flush=True)
                if out:
                    print(rec, file=out, flush=True)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
