"""Transcription latency of two checkouts of the port, in turns, on one card.

Each turn is a process of its own that imports ``myrtlespeech_tpu_torch``
from one checkout (``--trees``, taken in the order ``--order`` gives),
builds its kernels there, and transcribes the same batch with the same
seeded weights: ``--config`` (``rnn_t_en``) at ``--batch`` x ``--seconds``
of seeded noise (32 x 5 s, as ``chip_smoke.py``'s flagship serve phase).
After one warm-up it times ``--runs`` calls of ``Transcriber.transcribe``
(from a synchronized card to the transcript on the host) and as many of the
decoder alone on the same encoder output.  Each turn prints one JSON line:
its medians, every run, and a digest of the tokens; then a summary line
gives each tree's medians over its turns.  The tokens of every turn must be
equal, or the script exits 1.  Compare two versions only within one run.

    git archive HEAD | tar -x -C build/parent    # the parent, beside the tree
    python port_tools/serve_ab.py --trees build/parent . --order 0 1 1 0
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time


def turn(tree: str, config: str, batch: int, seconds: float,
         runs: int) -> dict:
    """One tree's timings, in this process (``--worker``)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import myrtlespeech_tpu_torch
    from myrtlespeech_tpu_torch.builders.build import random_params
    from myrtlespeech_tpu_torch.run.infer import (build_transcriber,
                                                  load_config, random_audio)

    cfg = load_config(config)
    tr = build_transcriber(cfg, random_params(cfg, seed=0), device="cuda")
    wav, lens = random_audio(batch, seconds, seed=0)
    out = tr.transcribe(wav, lens)  # warm-up, kernels built
    total, decode = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tr.transcribe(wav, lens)
        total.append(1e3 * (time.perf_counter() - t0))
    with torch.inference_mode():
        x, x_lens = tr.outputs(*tr.preprocess(
            torch.as_tensor(wav, device=tr.device),
            torch.as_tensor(lens, device=tr.device)))
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, _ = tr.decode_outputs(x, x_lens)
            toks.cpu()
            decode.append(1e3 * (time.perf_counter() - t0))
    digest = hashlib.sha256(out.tokens.cpu().numpy().tobytes()
                            + out.lengths.cpu().numpy().tobytes())
    return {"tree": tree, "package": os.path.dirname(
                myrtlespeech_tpu_torch.__file__),
            "config": config, "batch": batch, "seconds": seconds,
            "ms_per_batch": statistics.median(total), "ms_runs": total,
            "decode_ms": statistics.median(decode), "decode_ms_runs": decode,
            "tokens_sha256": digest.hexdigest()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--order", nargs="+", type=int)
    ap.add_argument("--config", default="rnn_t_en")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(turn(a.worker, a.config, a.batch, a.seconds,
                              a.runs)), flush=True)
        return 0
    order = a.order or list(range(len(a.trees)))
    turns = []
    for i in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             a.trees[i], "--config", a.config, "--batch", str(a.batch),
             "--seconds", str(a.seconds), "--runs", str(a.runs)],
            capture_output=True, text=True, check=False)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    summary = {
        tree: {key: [t[key] for t in turns if t["tree"] == tree]
               for key in ("ms_per_batch", "decode_ms")}
        for tree in dict.fromkeys(t["tree"] for t in turns)}
    same = len({t["tokens_sha256"] for t in turns}) == 1
    print(json.dumps({"order": [a.trees[i] for i in order],
                      "by_tree": summary, "tokens_equal": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
