"""Callbacks of the training loop: the port of ``myrtlespeech_tpu/run/callbacks.py``.

The same hooks, the same handler state and the same reports as the JAX
package's (fastai-style ``Callback``/``CallbackHandler``).  The train step
runs between ``on_batch_begin`` and ``on_batch_end``; its metrics are
tensors on the device, which a callback reads with ``float`` (a wait for the
step).

In a run of several ranks ``fit`` puts the rank's mesh in the handler's
state (``ts["mesh"]``).  ``ReportMeanBatchLoss`` and ``ReportDecoderWER``
then sum their statistics over the data group only (the ranks of one model
group saw the same rows: summing over every rank would count each shard
``model`` times), and every rank joins even with an empty shard.  The
callbacks that write (``LogReports``, ``CSVLogger``, ``TensorBoardLogger``,
``ProfilerCallback``: ``lead_only``) run on rank 0 alone.

The port adds to the JAX package's reports, none of them a scalar (so the
CSV and TensorBoard files keep the JAX package's columns):
``ThroughputMonitor`` also reports, per batch, the step's ms and the host's
wait for the batch (``{stage}_step_ms``, ``{stage}_wait_ms``, lists), and
``KernelLaunches`` the hand-written kernels' launches in each stage.
"""

from __future__ import annotations

import csv
import enum
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from myrtlespeech_tpu_torch.parallel.mesh import all_reduce_host


class Stage(enum.Enum):
    """Reference ``run/stage.py :: Stage``."""

    TRAIN = "train"
    EVAL = "eval"


def _scalar(v) -> Optional[float]:
    """``float(v)`` for a Python number or a one-element array or tensor,
    else None."""
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return None


class Callback:
    """Base callback; subclasses override any subset of hooks.

    ``ts`` is the handler's mutable state dict, threaded through all
    callbacks: step, epoch, stage, metrics, stop flags, reports...
    ``lead_only``: runs on rank 0 alone in a run of several ranks.
    """

    lead_only = False

    def on_train_begin(self, ts: Dict[str, Any]) -> None: ...
    def on_train_end(self, ts: Dict[str, Any]) -> None: ...
    def on_epoch_begin(self, ts: Dict[str, Any]) -> None: ...
    def on_epoch_end(self, ts: Dict[str, Any]) -> None: ...
    def on_stage_begin(self, ts: Dict[str, Any]) -> None: ...
    def on_stage_end(self, ts: Dict[str, Any]) -> None: ...
    def on_batch_begin(self, ts: Dict[str, Any]) -> None: ...
    def on_batch_end(self, ts: Dict[str, Any]) -> None: ...


class CallbackHandler:
    """Dispatches hooks; owns the shared training-state dict."""

    def __init__(self, callbacks: List[Callback]):
        self.callbacks = list(callbacks)
        self.state: Dict[str, Any] = {
            "step": 0, "epoch": 0, "stage": Stage.TRAIN,
            "stop_training": False, "stop_epoch": False, "metrics": {},
        }

    def _fire(self, hook: str) -> None:
        mesh = self.state.get("mesh")
        lead = mesh is None or mesh.rank == 0
        for cb in self.callbacks:
            if lead or not cb.lead_only:
                getattr(cb, hook)(self.state)

    def on_train_begin(self): self._fire("on_train_begin")
    def on_train_end(self): self._fire("on_train_end")

    def on_epoch_begin(self, epoch: int):
        self.state["epoch"] = epoch
        self.state["stop_epoch"] = False
        # A fresh report dict each epoch, so an epoch whose eval decoded
        # nothing does not re-log the previous epoch's WER.
        self.state["reports"] = {}
        self._fire("on_epoch_begin")

    def on_epoch_end(self): self._fire("on_epoch_end")

    def on_stage_begin(self, stage: Stage):
        self.state["stage"] = stage
        self.state["batch_index"] = 0
        # ``stop_epoch`` ends one stage.  The JAX package's handler leaves
        # it set after a train stage that stopped early, so its eval stage
        # then runs one batch (ROADMAP.md Queue 3).
        self.state["stop_epoch"] = False
        self._fire("on_stage_begin")

    def on_stage_end(self): self._fire("on_stage_end")

    def on_batch_begin(self, batch) -> None:
        self.state["batch"] = batch
        self._fire("on_batch_begin")

    def on_batch_end(self, metrics: Dict[str, Any]) -> None:
        self.state["metrics"] = metrics
        if self.state["stage"] is Stage.TRAIN:
            self.state["step"] += 1
        self.state["batch_index"] = self.state.get("batch_index", 0) + 1
        self._fire("on_batch_end")


class ReportMeanBatchLoss(Callback):
    """Running mean loss per stage, reported at stage end into
    ``ts['reports']['{stage}_mean_loss']``.  Each batch's loss (already
    masked to its real rows) is weighted by its real-row count, so the mean
    is the corpus's whatever the padded remainder chunks.  Under a mesh the
    ``(sum, weight)`` pair is summed over the data group (``texts`` holds
    the rank's real rows), every rank joining."""

    def on_stage_begin(self, ts):
        self._sum, self._n = 0.0, 0.0

    def on_batch_end(self, ts):
        loss = ts["metrics"].get("loss")
        if loss is None:
            return
        batch = ts.get("batch") or {}
        if "texts" in batch:
            w = float(len(batch["texts"]))
        elif "n_real" in batch:
            w = float(batch["n_real"])
        else:
            w = 1.0
        self._sum += float(loss) * w
        self._n += w

    def on_stage_end(self, ts):
        s, n = all_reduce_host([self._sum, self._n], _data_group(ts))
        ts.setdefault("reports", {})[
            f"{ts['stage'].value}_mean_loss"] = s / max(n, 1e-12)


def _data_group(ts):
    """The data group of the run's mesh, or None."""
    mesh = ts.get("mesh")
    return None if mesh is None else mesh.data_group


class ReportDecoderWER(Callback):
    """Accumulates the eval step's decoded transcripts and reports ``wer``
    and ``cer`` at the end of the EVAL stage (``decoding/wer.py``).  Under a
    mesh the edit and length counts are summed over the data group, every
    rank joining even with no transcript (a rank that skipped the sum
    would leave the others waiting)."""

    def __init__(self, alphabet, log_transcripts: int = 0):
        self.alphabet = alphabet
        self.log_transcripts = log_transcripts

    def on_stage_begin(self, ts):
        if ts["stage"] is Stage.EVAL:
            self.refs: List[str] = []
            self.hyps: List[str] = []

    def on_batch_end(self, ts):
        if ts["stage"] is not Stage.EVAL:
            return
        m = ts["metrics"]
        if "decoded_tokens" not in m:
            return
        toks = torch.as_tensor(m["decoded_tokens"]).cpu().numpy()
        lens = torch.as_tensor(m["decoded_lens"]).cpu().numpy()
        texts = ts["batch"].get("texts", [])
        n_real = int(ts["batch"].get("n_real", len(texts)))
        for i in range(min(n_real, len(texts))):
            self.refs.append(texts[i])
            self.hyps.append(self.alphabet.get_symbols(
                [t for t in toks[i, :lens[i]]]))

    def on_stage_end(self, ts):
        group = _data_group(ts)
        if ts["stage"] is not Stage.EVAL or (not self.refs and group is None):
            return
        from myrtlespeech_tpu_torch.decoding.wer import cer_counts, wer_counts
        wd, wt = wer_counts(self.refs, self.hyps)
        cd, ct = cer_counts(self.refs, self.hyps)
        wd, wt, cd, ct = all_reduce_host([wd, wt, cd, ct], group)
        if wt == 0 and ct == 0:
            return  # no rank decoded anything this stage
        r = ts.setdefault("reports", {})
        r["wer"] = wd / max(wt, 1)
        r["cer"] = cd / max(ct, 1)
        for i in range(min(self.log_transcripts, len(self.refs))):
            r[f"transcript_{i}"] = {"ref": self.refs[i],
                                    "hyp": self.hyps[i]}


class CSVLogger(Callback):
    """Per-batch metric rows in ``path`` (``step, epoch, stage`` and the
    step's scalar metrics), and each epoch's reports in a sibling
    ``*_epochs.csv``: the JAX package's files and columns."""

    lead_only = True

    def __init__(self, path: str):
        self.path = path
        self._file = None
        self._writer = None
        self._efile = None
        self._ewriter = None

    @property
    def epochs_path(self) -> str:
        base, ext = os.path.splitext(self.path)
        return f"{base}_epochs{ext or '.csv'}"

    def on_train_begin(self, ts):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._file = open(self.path, "w", newline="")
        self._writer = None
        # The epochs file is rewritten with the per-batch one.  On a resume
        # (start_epoch > 0) the rows of epochs the run will not replay are
        # kept, and written before the first new row, under the union of
        # their columns and its.
        start = int(ts.get("start_epoch", 0))
        prior = []
        if start > 0 and os.path.exists(self.epochs_path):
            with open(self.epochs_path, newline="") as f:
                for r in csv.DictReader(f):
                    try:
                        if int(float(r.get("epoch", ""))) < start:
                            prior.append(r)
                    except ValueError:
                        continue
        self._efile = open(self.epochs_path, "w", newline="")
        self._ewriter = None
        self._eprior = prior

    def on_batch_end(self, ts):
        row = {"step": ts["step"], "epoch": ts["epoch"],
               "stage": ts["stage"].value}
        for k, v in ts["metrics"].items():
            v = _scalar(v)
            if v is not None:
                row[k] = v
        if self._writer is None:
            self._writer = csv.DictWriter(self._file,
                                          fieldnames=list(row.keys()),
                                          extrasaction="ignore")
            self._writer.writeheader()
        self._writer.writerow(row)
        self._file.flush()

    def on_epoch_end(self, ts):
        reports = ts.get("reports")
        if not reports or self._efile is None:
            return
        row = {"epoch": ts["epoch"]}
        for k, v in reports.items():
            v = _scalar(v)
            if v is not None:
                row[k] = v
        if self._ewriter is None:
            fields = list(self._eprior[0].keys()) if self._eprior else []
            fields += [k for k in row if k not in fields]
            self._ewriter = csv.DictWriter(
                self._efile, fieldnames=fields,
                extrasaction="ignore", restval="")
            self._ewriter.writeheader()
            for r in self._eprior:
                self._ewriter.writerow(r)
            self._eprior = []
        self._ewriter.writerow(row)
        self._efile.flush()

    def on_train_end(self, ts):
        if self._file:
            self._file.close()
        if self._efile:
            if self._ewriter is None and self._eprior:
                # A resumed run that wrote no epoch row keeps the old rows.
                self._ewriter = csv.DictWriter(
                    self._efile, fieldnames=list(self._eprior[0].keys()),
                    extrasaction="ignore", restval="")
                self._ewriter.writeheader()
                for r in self._eprior:
                    self._ewriter.writerow(r)
            self._efile.close()
            self._efile = None


class TensorBoardLogger(Callback):
    """Train metrics and epoch reports as TensorBoard scalars (through
    ``tensorboardX``; does nothing where it is not installed)."""

    lead_only = True

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.writer = None

    def on_train_begin(self, ts):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self.writer = SummaryWriter(self.log_dir)

    def on_batch_end(self, ts):
        if self.writer is None or ts["stage"] is not Stage.TRAIN:
            return
        for k, v in ts["metrics"].items():
            v = _scalar(v)
            if v is not None:
                self.writer.add_scalar(f"train/{k}", v, ts["step"])

    def on_epoch_end(self, ts):
        if self.writer is None:
            return
        for k, v in ts.get("reports", {}).items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(f"report/{k}", v, ts["step"])

    def on_train_end(self, ts):
        if self.writer is not None:
            self.writer.close()


class StopEpochAfter(Callback):
    """Ends each stage after ``n_batches`` batches (smoke runs)."""

    def __init__(self, n_batches: int):
        self.n_batches = n_batches

    def on_batch_end(self, ts):
        if ts.get("batch_index", 0) >= self.n_batches:
            ts["stop_epoch"] = True


class LogReports(Callback):
    """Prints each epoch's scalar reports as one JSON line."""

    lead_only = True

    def on_epoch_end(self, ts):
        r = {k: v for k, v in ts.get("reports", {}).items()
             if isinstance(v, (int, float))}
        if r:
            print(json.dumps({"epoch": ts["epoch"], **r}), flush=True)


class ProfilerCallback(Callback):
    """``torch.profiler`` over the train steps ``[start_step, start_step +
    num_steps)``: one Chrome trace in ``log_dir``
    (``tensorboard_trace_handler``; ``utils/trace.py`` reads it), the CPU and,
    where there is one, the card.  ``wall_ms`` is the window's host time, the
    card synchronised at both ends."""

    lead_only = True

    def __init__(self, log_dir: str, start_step: int = 10,
                 num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.end_step = start_step + num_steps
        self._prof = None
        self.wall_ms: Optional[float] = None

    @staticmethod
    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def on_batch_begin(self, ts):
        if ts["stage"] is Stage.TRAIN and self._prof is None \
                and ts["step"] == self.start_step:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.log_dir))
            self._sync()
            self._t0 = time.perf_counter()
            self._prof.__enter__()

    def _stop(self):
        self._sync()
        self.wall_ms = 1e3 * (time.perf_counter() - self._t0)
        self._prof.__exit__(None, None, None)
        self._prof = None

    def on_batch_end(self, ts):
        if self._prof is not None and ts["step"] >= self.end_step:
            self._stop()

    def on_train_end(self, ts):
        if self._prof is not None:
            self._stop()


class ThroughputMonitor(Callback):
    """Audio-seconds a second of each stage, from the real rows' ``wav_lens``
    (``{stage}_audio_sec_per_sec``), and the stage's timings: each batch's
    step ms from ``on_batch_begin`` to the
    end of the step (the card synchronised; ``{stage}_step_ms``) and the
    host's ms between one batch's end and the next one's begin, the wait for
    the loader and the copy to the device (``{stage}_wait_ms``; the first
    from the stage's begin)."""

    def __init__(self, sample_rate: int = 16000):
        self.sample_rate = sample_rate

    def on_stage_begin(self, ts):
        self._audio_s = 0.0
        self._step_ms: List[float] = []
        self._wait_ms: List[float] = []
        self._t0 = self._t_end = time.perf_counter()

    def on_batch_begin(self, ts):
        self._t_begin = time.perf_counter()
        self._wait_ms.append(1e3 * (self._t_begin - self._t_end))

    def on_batch_end(self, ts):
        loss = ts["metrics"].get("loss")
        if isinstance(loss, torch.Tensor) and loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        self._t_end = time.perf_counter()
        self._step_ms.append(1e3 * (self._t_end - self._t_begin))
        batch = ts.get("batch")
        if batch is not None and "wav_lens" in batch:
            lens = np.asarray(batch["wav_lens"])
            # Real rows only: the remainder fill repeats the last utterance.
            # (This rank's real rows, under a mesh.)
            n_real = batch.get("n_real_local", batch.get("n_real"))
            if n_real is not None:
                lens = lens[:int(n_real)]
            self._audio_s += float(np.sum(lens)) / self.sample_rate

    def on_stage_end(self, ts):
        dt = time.perf_counter() - self._t0
        stage = ts["stage"].value
        r = ts.setdefault("reports", {})
        r[f"{stage}_audio_sec_per_sec"] = self._audio_s / max(dt, 1e-9)
        r[f"{stage}_step_ms"] = self._step_ms
        r[f"{stage}_wait_ms"] = self._wait_ms


class KernelLaunches(Callback):
    """The hand-written kernels' launches in each stage
    (``{stage}_launches``, ``run/train.py::kernel_launches``'s keys; all 0
    on the CPU, where every wrapper runs its plain version)."""

    def on_stage_begin(self, ts):
        from myrtlespeech_tpu_torch.run.train import kernel_launches
        self._before = kernel_launches()

    def on_stage_end(self, ts):
        from myrtlespeech_tpu_torch.run.train import kernel_launches
        after = kernel_launches()
        ts.setdefault("reports", {})[f"{ts['stage'].value}_launches"] = {
            k: after[k] - self._before[k] for k in after}
