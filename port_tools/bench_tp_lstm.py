"""Tensor-parallel RNN layout A/B of the port, on gloo ranks on the CPU.

The port's counterpart of ``tools/bench_tp_lstm.py``.  Under tensor
parallelism the port either column-shards the RNN gate matrices over the
``model`` ranks (``tp_rnn_weights=True``, the default: each layer gathers
``W_hh`` whole for K1/K2 and splits the input projections) or replicates
the RNN weights and shards only the joint, FC and embedding matrices
(``tp_rnn_weights=False``).  It starts 8 gloo ranks on the CPU (a
``file://`` rendezvous) and times the tiny RNN-T's train step
(``convergence_check.tiny_rnnt_config``) at the global ``--batch`` under
three meshes: data parallel only (8, 1), gate matrices sharded (4, 2) and
replicated RNN with a sharded joint (4, 2).  These are the collectives'
cost trends on the host, not a card's speed.

Usage (CPU, no card needed):
  python port_tools/bench_tp_lstm.py [--batch 16] [--steps 5]
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
LAYOUTS = (("DP only (8,1)", 8, 1, True),
           ("TP gate matrices sharded (4,2)", 4, 2, True),
           ("replicated RNN + TP joint (4,2)", 4, 2, False))


def time_layout(data: int, model: int, tp_rnn: bool, B: int, seconds: float,
                steps: int) -> float:
    """This rank's ms a step of the tiny RNN-T under a (data, model) mesh
    (every rank must call it, in the same order)."""
    import numpy as np

    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.parallel.mesh import make_mesh
    from myrtlespeech_tpu_torch.run.train import (example_batch, init_state,
                                                  make_train_step, to_device)

    from port_tools.convergence_check import tiny_rnnt_config

    mesh = make_mesh(data, model)
    task = build_task(tiny_rnnt_config(B), steps_per_epoch=4)
    batch = example_batch(B, seconds, 32)
    batch["labels"] = np.clip(batch["labels"], 1, 27)
    n = B // data
    rows = to_device({k: v[mesh.data_index * n:(mesh.data_index + 1) * n]
                      for k, v in batch.items()}, "cpu")
    state = init_state(task, seed=0, device="cpu", mesh=mesh,
                       tp_rnn_weights=tp_rnn)
    step = make_train_step(task)
    state, m = step(state, rows)  # warm-up
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, rows)
    float(m["loss"])
    return (time.perf_counter() - t0) / steps * 1e3


def _rank(rank: int, init: str, args, results) -> None:
    """One gloo rank: every layout in turn; rank 0 reports its times."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from myrtlespeech_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(init, WORLD, rank, "gloo")
    try:
        for name, data, model, tp_rnn in LAYOUTS:
            ms = time_layout(data, model, tp_rnn, args.batch, args.seconds,
                             args.steps)
            if rank == 0:
                results.put((name, ms))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    print(f"== TP x LSTM layout A/B (B={args.batch}, {args.seconds}s audio, "
          f"{args.steps} steps, {WORLD} gloo ranks on the CPU) ==",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="myrtle_tp_") as d:
        init = "file://" + os.path.join(d, "rendezvous")
        procs = [ctx.Process(target=_rank, args=(r, init, args, results))
                 for r in range(WORLD)]
        for pr in procs:
            pr.start()
        ms = {}
        try:
            while len(ms) < len(LAYOUTS):  # drained before the joins
                alive = any(pr.is_alive() for pr in procs)
                try:
                    name, t = results.get(timeout=5)
                except queue.Empty:  # check the ranks again
                    if not alive:
                        break
                    continue
                ms[name] = t
                print(f"{name:44s} {t:8.1f} ms/step", flush=True)
        finally:
            for pr in procs:
                pr.join(timeout=60)
                if pr.is_alive():
                    pr.kill()
                    pr.join()
    if len(ms) < len(LAYOUTS) or any(pr.exitcode for pr in procs):
        raise SystemExit(f"a rank failed: exit codes "
                         f"{[pr.exitcode for pr in procs]}")
    dp, tp, rep = (ms[name] for name, *_ in LAYOUTS)
    print(f"\nTP-sharded-RNN / DP: {tp/dp:.2f}x   "
          f"replicated-RNN / DP: {rep/dp:.2f}x   "
          f"replicated / TP-sharded: {rep/tp:.2f}x")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
