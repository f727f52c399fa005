"""Command-line entry point: train (or evaluate) a config on its datasets.

Port of ``myrtlespeech_tpu/run/cli.py``:

    python -m myrtlespeech_tpu_torch.run.cli --config myrtlespeech_tpu_torch/configs/ctc_tiny_fake.py \\
        [--epochs N] [--log_dir DIR] [--checkpoint_dir DIR] [--resume] \\
        [--init_from DIR] [--eval_only] [--max_batches N] [--no_decode] \\
        [--batch_size N] [--device cuda] [--mesh_model M] \\
        [--coordinator HOST:PORT --num_processes N --process_id I] \\
        [--dist_backend nccl|gloo]

``--config`` is a ``.json`` (``config/serde.py``) or a ``.py`` file that
defines the port's ``task_config``.  It runs ``fit`` on the card unless
``--device cpu`` and prints each epoch's reports as a JSON line (rank 0),
then the last reports as one JSON object (every rank).

Several processes train one model over the ``(data, model)`` mesh
(``parallel/``): start one per rank with the JAX CLI's ``--coordinator``,
``--num_processes`` and ``--process_id``, or under ``torchrun``, whose
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``) is read when those flags are absent:

    torchrun --nproc_per_node 2 -m myrtlespeech_tpu_torch.run.cli \\
        --config myrtlespeech_tpu_torch/configs/rnn_t_960_multihost.py

``--mesh_model`` overrides the config's ``mesh_model`` (the tensor-parallel
ranks of a replica; the data ranks are the rest).  A rank drives
``cuda:LOCAL_RANK`` unless ``--device`` says otherwise.  ``--dist_backend``
is ``nccl`` on the card and ``gloo`` on the CPU by default; NCCL takes one
card a rank (two ranks on one card raise), gloo lets ranks share one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from myrtlespeech_tpu_torch.builders.build import (Task, build_dataset,
                                                   build_task)
from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.config.serde import load
from myrtlespeech_tpu_torch.parallel.mesh import Mesh, initialize_distributed
from myrtlespeech_tpu_torch.run import callbacks as C
from myrtlespeech_tpu_torch.run.checkpoint import (CheckpointCallback,
                                                   CheckpointManager)
from myrtlespeech_tpu_torch.run.infer import resolve_device
from myrtlespeech_tpu_torch.run.train import (TrainState, fit, init_state,
                                              run_mesh)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train a speech task (PyTorch)")
    p.add_argument("--config", required=True, help=".py or .json TaskConfig")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--log_dir", default=None, help="TensorBoard/CSV dir")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init_from", default=None,
                   help="warm-start weights (parameters and BatchNorm "
                        "statistics) from another run's checkpoint dir; "
                        "optimizer, step and LR schedule start fresh")
    p.add_argument("--max_batches", type=int, default=None,
                   help="cap batches per stage (smoke runs)")
    p.add_argument("--no_decode", action="store_true",
                   help="skip decoding during eval (loss only)")
    p.add_argument("--eval_only", action="store_true",
                   help="skip training: restore from --checkpoint_dir "
                        "(or init fresh) and run one eval pass with "
                        "decoding + WER")
    p.add_argument("--batch_size", type=int, default=None,
                   help="override train_config.batch_size")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:LOCAL_RANK); 'cpu' runs "
                        "the kernels' plain versions")
    p.add_argument("--mesh_model", type=int, default=None,
                   help="override train_config.mesh_model (tensor-parallel "
                        "ranks a replica)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (or a tcp://, file:// URL)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on the card, gloo on the CPU")
    args = p.parse_args(argv)

    local_rank = read_launch(args, os.environ)
    device = args.device or f"cuda:{local_rank}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    backend = args.dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    distributed = initialize_distributed(
        args.coordinator, args.num_processes, args.process_id, backend,
        device=dev)
    try:
        return _run(args, device)
    finally:
        if distributed:
            dist.destroy_process_group()


def read_launch(args, env) -> int:
    """Fill ``args``' ``num_processes``, ``process_id`` and ``coordinator``
    from ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``, rendezvous
    ``env://``) where the flags leave them unset, as ``jax.distributed``
    detects a pod's; returns this process's local rank (``LOCAL_RANK``, else
    the process id modulo the cards on the host)."""
    if args.num_processes is None and int(env.get("WORLD_SIZE", "1")) > 1:
        args.num_processes = int(env["WORLD_SIZE"])
        args.process_id = int(env["RANK"])
        args.coordinator = args.coordinator or "env://"
    if "LOCAL_RANK" in env:
        return int(env["LOCAL_RANK"])
    return (args.process_id or 0) % max(torch.cuda.device_count(), 1)


def _run(args, device: str) -> int:
    cfg = load(args.config)
    if args.mesh_model is not None:
        cfg = S.replace(cfg, train_config=S.replace(
            cfg.train_config, mesh_model=args.mesh_model))
    steps_per_epoch = max(
        1, math.ceil(_dataset_len(cfg.train_dataset)
                     / cfg.train_config.batch_size))
    task = build_task(cfg, steps_per_epoch=steps_per_epoch)
    mesh = run_mesh(cfg.train_config.mesh_model)
    lead = mesh is None or mesh.rank == 0

    cbs = [C.ReportMeanBatchLoss(), C.ThroughputMonitor(),
           C.ReportDecoderWER(task.alphabet), C.KernelLaunches(),
           C.LogReports()]
    if args.log_dir:
        cbs.append(C.CSVLogger(f"{args.log_dir}/metrics.csv"))
        cbs.append(C.TensorBoardLogger(args.log_dir))
    initial_state, start_epoch, skip_batches = None, 0, 0
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir)
        if not args.eval_only:
            cbs.append(CheckpointCallback(mgr))
        # --eval_only restores the checkpoint (evaluating random weights is
        # never what an eval means); --resume restores the cursor too.
        if (args.resume or args.eval_only) and mgr.latest_step() is not None:
            initial_state, start_epoch, skip_batches = _restore_state(
                task, mgr, device, mesh)
            if lead:
                print(f"resumed from step {initial_state.step} "
                      f"(epoch {start_epoch}, batch {skip_batches})")
    if args.init_from and initial_state is None:
        initial_state = _warm_start(task, CheckpointManager(args.init_from),
                                    device, mesh)
        if lead:
            print(f"warm-started weights from {args.init_from}")
    if args.max_batches:
        cbs.append(C.StopEpochAfter(args.max_batches))

    handler = fit(task, epochs=args.epochs, callbacks=cbs,
                  batch_size=args.batch_size,
                  decode_eval=not args.no_decode,
                  initial_state=initial_state, start_epoch=start_epoch,
                  skip_batches=skip_batches, eval_only=args.eval_only,
                  device=device, mesh=mesh)
    print(json.dumps(handler.state.get("reports", {}), indent=2,
                     default=str))
    return 0


def _dataset_len(ds_cfg) -> int:
    return len(build_dataset(ds_cfg))


def _template_state(task: Task, device: str = "cuda",
                    mesh: Optional[Mesh] = None) -> TrainState:
    """A fresh ``TrainState`` of the task's model on ``device`` (this rank's
    shards of it under ``mesh``): the template a checkpoint is restored
    into."""
    return init_state(task, seed=task.cfg.train_config.seed, device=device,
                      mesh=mesh)


def _warm_start(task: Task, mgr: CheckpointManager, device: str = "cuda",
                mesh: Optional[Mesh] = None) -> TrainState:
    """Weights-only init from another run's checkpoint (``--init_from``)."""
    return mgr.restore_params(_template_state(task, device, mesh))


def _restore_state(task: Task, mgr: CheckpointManager, device: str = "cuda",
                   mesh: Optional[Mesh] = None):
    """The latest checkpoint's state and exact data cursor: ``(state,
    start_epoch, skip_batches)``."""
    state, cursor = mgr.restore_with_cursor(_template_state(task, device,
                                                            mesh))
    return state, cursor["epoch"], cursor["batch_in_epoch"]


if __name__ == "__main__":
    raise SystemExit(main())
