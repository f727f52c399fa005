"""Checkpoints and exact resume: the port of ``myrtlespeech_tpu/run/checkpoint.py``.

A checkpoint holds the whole ``TrainState`` and the loader's cursor:

- the model's ``state_dict`` (parameters and BatchNorm's running
  statistics), the optimizer's state (Adam's moments or SGD's momentum),
  the step, and the states of the two ``torch.Generator``s: SpecAugment's
  and the dropout masks' (with the latter's device type: see
  ``_restore_dropout_gen`` for a checkpoint without it, or from another
  device type);
- the cursor ``(epoch, batch_in_epoch)``: the loader's order is a pure
  function of ``(seed, epoch)``, so the cursor pins the exact continuation.

Each is one ``torch.save`` file, ``<dir>/ckpt_<step>.pt``, written to a
temporary file and renamed, so a crash never leaves half a checkpoint; the
newest ``max_to_keep`` are kept.  A run of several ranks writes it in the
one-process layout: every rank gathers its model group's shards of the
parameters and of the optimizer's moments (``parallel/sharding.py``), rank 0
alone writes, and every rank restores the whole file and takes its shard, so
a checkpoint moves between one process and any mesh.  The JAX package's
orbax directories do not load here.  The crossing between the packages is
the npz of trained weights (:func:`save_params_npz`,
:func:`load_params_npz`): '/'-joined Flax paths, every parameter in bf16
stored as uint16 under ``::bf16``.
"""

from __future__ import annotations

import os
import re
import time
import warnings
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.parallel import sharding
from myrtlespeech_tpu_torch.parallel.mesh import broadcast_host
from myrtlespeech_tpu_torch.run.callbacks import Callback, Stage
from myrtlespeech_tpu_torch.run.train import TrainState
from myrtlespeech_tpu_torch.weights import flat_from_params, params_from_npz

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Saves and restores ``TrainState`` with the loader cursor in
    ``directory``.  Saves are synchronous; ``last_save`` holds the last
    one's ``ms`` (host clock, the write included) and ``bytes``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.last_save: Optional[Dict[str, float]] = None
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self):
        """The saved steps, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: TrainState, *, epoch: int = 0,
             batch_in_epoch: int = 0) -> None:
        """Save ``state`` and the cursor at which a resumed run continues.
        Under a mesh every rank must call it; rank 0 writes."""
        t0 = time.perf_counter()
        model, optimizer = state.model.state_dict(), \
            state.optimizer.inner.state_dict()
        mesh = state.mesh
        if mesh is not None and mesh.model > 1:
            names = [n for n, _ in state.model.named_parameters()]
            model = sharding.gather_params(model, state.specs, mesh)
            optimizer = sharding.gather_optimizer_state(optimizer, names,
                                                        state.specs, mesh)
        nbytes = 0
        path = self._path(step)
        if mesh is None or mesh.rank == 0:
            payload = {
                "model": model,
                "optimizer": optimizer,
                "step": int(state.step),
                "gen": state.gen.get_state(),
                "dropout_gen": state.dropout_gen.get_state(),
                "dropout_gen_device": state.dropout_gen.device.type,
                "loader": {"epoch": int(epoch),
                           "batch_in_epoch": int(batch_in_epoch)},
            }
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            nbytes = os.path.getsize(path)
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        if mesh is not None and mesh.data_group is not None:
            # Every rank waits for the file and learns its size.
            nbytes = int(broadcast_host(nbytes))
        self.last_save = {"ms": 1e3 * (time.perf_counter() - t0),
                          "bytes": nbytes}

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for (the JAX package's
        orbax saves run in the background)."""

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]) -> dict:
        """The payload on the CPU: ``load_state_dict`` moves the model's
        and the optimizer's tensors to their parameters' device, and keeps
        Adam's step counts on the CPU, where a fresh Adam keeps them."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, target: TrainState,
                step: Optional[int] = None) -> TrainState:
        state, _ = self.restore_with_cursor(target, step)
        return state

    def restore_params(self, target: TrainState,
                       step: Optional[int] = None) -> TrainState:
        """Weights only (a warm start): the model's parameters and BatchNorm
        statistics from the checkpoint; ``target``'s fresh optimizer, step
        and generators are kept, so the run starts its own LR schedule."""
        target.model.load_state_dict(_model_shards(self._load(step)["model"],
                                                   target))
        return target

    def restore_with_cursor(self, target: TrainState,
                            step: Optional[int] = None
                            ) -> Tuple[TrainState, Dict[str, int]]:
        """Loads the checkpoint into ``target`` (a state of the same model,
        e.g. ``train.init_state``'s): ``(state, {"epoch", "batch_in_epoch"})``."""
        payload = self._load(step)
        target.model.load_state_dict(_model_shards(payload["model"], target))
        optimizer = payload["optimizer"]
        if target.specs is not None:
            optimizer = sharding.shard_optimizer_state(
                optimizer, [n for n, _ in target.model.named_parameters()],
                target.specs, target.mesh)
        target.optimizer.inner.load_state_dict(optimizer)
        target.step = payload["step"]
        target.gen.set_state(payload["gen"])
        _restore_dropout_gen(target.dropout_gen, payload)
        return target, dict(payload["loader"])


def _model_shards(model: Mapping[str, torch.Tensor], target: TrainState
                  ) -> Mapping[str, torch.Tensor]:
    """A checkpoint's (one-process) model state_dict as ``target``'s rank
    holds it."""
    if target.specs is None:
        return model
    return sharding.shard_params(model, target.specs, target.mesh)


def _restore_dropout_gen(gen: torch.Generator, payload: dict) -> None:
    """The dropout generator's saved state, where it was saved from a
    generator of ``gen``'s device type.  Else ``gen`` is reseeded from its
    own seed and the checkpoint's step, so that a resumed run still draws
    the same masks each time it is resumed:

    - a checkpoint written before the dropout generator was saved comes
      from a run that drew no mask (dropout raised then);
    - a CUDA generator's state (seed and offset) does not load into a CPU
      generator, nor the reverse, and the two draw different streams, so
      a run moved between the card and the CPU cannot continue the saved
      masks anyway (a warning says so)."""
    saved = payload.get("dropout_gen")
    device = payload.get("dropout_gen_device")
    if saved is not None and device == gen.device.type:
        gen.set_state(saved)
        return
    if saved is not None:
        warnings.warn(
            f"the checkpoint's dropout generator was on {device}, this "
            f"run's is on {gen.device.type}: reseeded from step "
            f"{payload['step']}, so the dropout masks from here on differ "
            f"from an uninterrupted run's")
    gen.manual_seed(gen.initial_seed() + int(payload["step"]))


def save_params_npz(path: str, model: torch.nn.Module) -> None:
    """The model's parameters (not its BatchNorm statistics, which the JAX
    package keeps apart) as the JAX package's ``save_params_npz`` writes
    them: keys '/'-joined Flax paths, values in bf16 (rounded to nearest
    even) stored as uint16 under ``<key>::bf16``."""
    flat = flat_from_params(dict(model.named_parameters()))
    out = {}
    for key, arr in flat.items():
        bits = torch.from_numpy(arr).to(torch.bfloat16).view(torch.int16)
        out[key + "::bf16"] = bits.numpy().view(np.uint16)
    np.savez_compressed(path, **out)


def load_params_npz(path: str, cfg: S.TaskConfig,
                    batch_stats: Optional[Mapping[str, np.ndarray]] = None
                    ) -> Dict[str, torch.Tensor]:
    """A ``save_params_npz`` file of either package as the state_dict of
    ``cfg``'s model (``weights.params_from_npz``)."""
    return params_from_npz(path, cfg, batch_stats)


class CheckpointCallback(Callback):
    """Saves a checkpoint every ``every_epochs`` epochs and at the end of
    training, with the cursor of the next batch to train: a train stage that
    stopped early (``StopEpochAfter``, a stop flag) resumes at its next
    batch.  The last save's ms and bytes go into the epoch's reports
    (``checkpoint_save_ms``, ``checkpoint_bytes``)."""

    def __init__(self, manager: CheckpointManager, every_epochs: int = 1):
        self.manager = manager
        self.every_epochs = every_epochs
        self._cursor = (0, 0)  # (epoch, batch_in_epoch) to resume at
        # The step last saved (or found at the start), which every rank of
        # a mesh knows alike: each save is a collective.
        self._saved: Optional[int] = None

    def on_train_begin(self, ts):
        self._saved = self.manager.latest_step()

    def on_stage_end(self, ts):
        if ts["stage"] is not Stage.TRAIN:
            return
        if ts.get("stop_epoch") or ts.get("stop_training"):
            self._cursor = (ts["epoch"], ts.get("batch_index", 0))
        else:
            self._cursor = (ts["epoch"] + 1, 0)

    def _save(self, ts, state) -> None:
        self.manager.save(int(state.step), state, epoch=self._cursor[0],
                          batch_in_epoch=self._cursor[1])
        self._saved = int(state.step)
        r = ts.setdefault("reports", {})
        r["checkpoint_save_ms"] = self.manager.last_save["ms"]
        r["checkpoint_bytes"] = self.manager.last_save["bytes"]

    def on_epoch_end(self, ts):
        state = ts.get("train_state")
        if state is not None and (ts["epoch"] + 1) % self.every_epochs == 0:
            self._save(ts, state)

    def on_train_end(self, ts):
        state = ts.get("train_state")
        if state is not None and self._saved != int(state.step):
            self._save(ts, state)
        self.manager.wait()
