"""Scaling harness of the port: audio-s/s against the number of ranks.

The port's counterpart of ``tools/bench_scaling.py``.  It times the tiny
RNN-T's train step (``convergence_check.tiny_rnnt_config``: the RNN-T family
of the flagship on 2 s utterances, 16 labels) at a fixed batch a rank
(weak scaling) under ``torchrun``: first rank 0 alone (one process, no
mesh), then every rank together over the ``(data, model=1)`` mesh, each
rank on its rows of the global batch.  It prints one JSON line per rank
count and, with more than one, ``{"scaling_efficiency": ...}``: the
N-rank rate over N times the one-rank rate.  Run without ``torchrun`` (or
with one process, as on a machine with one card) it prints the one row.

Usage:
  torchrun --nproc_per_node N port_tools/bench_scaling.py [--per_device_batch 8]
  python port_tools/bench_scaling.py [--device cpu]

Each rank drives ``cuda:LOCAL_RANK`` over NCCL unless ``--device cpu``
(gloo).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(per_device_batch: int, seconds_per_utt: float, dev, mesh=None,
            n_steps: int = 8) -> float:
    """The global batch's audio-s/s of the tiny RNN-T's train step, best of
    3 runs of ``n_steps`` steps, on ``mesh`` (None: one process)."""
    import torch

    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.run.train import (example_batch, init_state,
                                                  make_train_step, to_device)

    from port_tools.convergence_check import tiny_rnnt_config
    from port_tools.tool_common import sync

    data = 1 if mesh is None else mesh.data
    B = per_device_batch * data
    task = build_task(tiny_rnnt_config(B), steps_per_epoch=4)
    batch = example_batch(B, seconds_per_utt, 16)
    i = 0 if mesh is None else mesh.data_index
    rows = {k: v[i * per_device_batch:(i + 1) * per_device_batch]
            for k, v in batch.items()}
    placed = to_device(rows, dev)
    state = init_state(task, seed=0, device=str(dev), mesh=mesh)
    step = make_train_step(task)
    state, m = step(state, placed)  # warm-up: kernel builds, allocator
    float(m["loss"])
    dt = float("inf")
    for _ in range(3):
        if mesh is not None:
            torch.distributed.barrier()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, m = step(state, placed)
        float(m["loss"])  # waits for the last step
        dt = min(dt, time.perf_counter() - t0)
    return n_steps * B * seconds_per_utt / dt


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--per_device_batch", type=int, default=8)
    p.add_argument("--seconds_per_utt", type=float, default=2.0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:LOCAL_RANK); 'cpu' runs "
                        "the kernels' plain versions over gloo")
    args = p.parse_args(argv)

    import torch

    from myrtlespeech_tpu_torch.parallel.mesh import (initialize_distributed,
                                                      make_mesh)

    from port_tools.tool_common import device_of, print_card

    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = device_of(args.device or f"cuda:{local}")
    if rank == 0:
        print_card(dev)
    rows = []
    if rank == 0:  # the one-rank rate, before the others join
        rate = measure(args.per_device_batch, args.seconds_per_utt, dev)
        rows.append({"devices": 1, "audio_s_per_s": rate,
                     "audio_s_per_s_per_chip": rate,
                     "efficiency_vs_1": 1.0, "device": str(dev)})
        print(json.dumps(rows[-1]), flush=True)
    if world > 1:
        initialize_distributed("env://", world, rank,
                               "nccl" if dev.type == "cuda" else "gloo",
                               device=dev)
        try:
            rate = measure(args.per_device_batch, args.seconds_per_utt, dev,
                           make_mesh(model=1))
        finally:
            torch.distributed.destroy_process_group()
        if rank == 0:
            base = rows[0]["audio_s_per_s"]
            rows.append({"devices": world, "audio_s_per_s": rate,
                         "audio_s_per_s_per_chip": rate / world,
                         "efficiency_vs_1": rate / (base * world),
                         "device": str(dev)})
            print(json.dumps(rows[-1]), flush=True)
            print(json.dumps({"scaling_efficiency": rows[-1][
                "efficiency_vs_1"], "devices": world}))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
