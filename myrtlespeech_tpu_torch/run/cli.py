"""Command-line entry point: train (or evaluate) a config on its datasets.

Port of ``myrtlespeech_tpu/run/cli.py``:

    python -m myrtlespeech_tpu_torch.run.cli --config myrtlespeech_tpu_torch/configs/ctc_tiny_fake.py \\
        [--epochs N] [--log_dir DIR] [--checkpoint_dir DIR] [--resume] \\
        [--init_from DIR] [--eval_only] [--max_batches N] [--no_decode] \\
        [--batch_size N] [--device cuda]

``--config`` is a ``.json`` (``config/serde.py``) or a ``.py`` file that
defines the port's ``task_config``.  It runs ``fit`` on the card unless
``--device cpu`` and prints each epoch's reports as a JSON line, then the
last reports as one JSON object.  The JAX package's multi-process and
tensor-parallel flags (``--coordinator``, ``--num_processes``,
``--process_id``, ``--platform``, ``--mesh_model``) wait for ``ROADMAP.md``
Queue 1 item 7.
"""

from __future__ import annotations

import argparse
import json
import math

from myrtlespeech_tpu_torch.builders.build import (Task, build_dataset,
                                                   build_task)
from myrtlespeech_tpu_torch.config.serde import load
from myrtlespeech_tpu_torch.run import callbacks as C
from myrtlespeech_tpu_torch.run.checkpoint import (CheckpointCallback,
                                                   CheckpointManager)
from myrtlespeech_tpu_torch.run.train import TrainState, fit, init_state


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
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    args = p.parse_args(argv)

    cfg = load(args.config)
    steps_per_epoch = max(
        1, math.ceil(_dataset_len(cfg.train_dataset)
                     / cfg.train_config.batch_size))
    task = build_task(cfg, steps_per_epoch=steps_per_epoch)

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
                task, mgr, args.device)
            print(f"resumed from step {initial_state.step} "
                  f"(epoch {start_epoch}, batch {skip_batches})")
    if args.init_from and initial_state is None:
        initial_state = _warm_start(task, CheckpointManager(args.init_from),
                                    args.device)
        print(f"warm-started weights from {args.init_from}")
    if args.max_batches:
        cbs.append(C.StopEpochAfter(args.max_batches))

    handler = fit(task, epochs=args.epochs, callbacks=cbs,
                  batch_size=args.batch_size,
                  decode_eval=not args.no_decode,
                  initial_state=initial_state, start_epoch=start_epoch,
                  skip_batches=skip_batches, eval_only=args.eval_only,
                  device=args.device)
    print(json.dumps(handler.state.get("reports", {}), indent=2,
                     default=str))
    return 0


def _dataset_len(ds_cfg) -> int:
    return len(build_dataset(ds_cfg))


def _template_state(task: Task, device: str = "cuda") -> TrainState:
    """A fresh ``TrainState`` of the task's model on ``device``: the
    template a checkpoint is restored into."""
    return init_state(task, seed=task.cfg.train_config.seed, device=device)


def _warm_start(task: Task, mgr: CheckpointManager,
                device: str = "cuda") -> TrainState:
    """Weights-only init from another run's checkpoint (``--init_from``)."""
    return mgr.restore_params(_template_state(task, device))


def _restore_state(task: Task, mgr: CheckpointManager, device: str = "cuda"):
    """The latest checkpoint's state and exact data cursor: ``(state,
    start_epoch, skip_batches)``."""
    state, cursor = mgr.restore_with_cursor(_template_state(task, device))
    return state, cursor["epoch"], cursor["batch_in_epoch"]


if __name__ == "__main__":
    raise SystemExit(main())
