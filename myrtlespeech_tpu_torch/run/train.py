"""Training entry point: the RNN-T train step and the eval loss.

Port of ``myrtlespeech_tpu/run/train.py``: ``TrainState``, ``init_state``,
``_forward``, ``_select_joint_path``, ``train_step_body``,
``make_train_step`` and the loss of ``eval_step_body``.  PyTorch runs
eagerly, so the step is a plain function that updates the state in place:

    preprocess (SpecAugment at train time) -> RNNT.encode -> RNNT.predict
    -> joint path -> lattice (K3, K4) -> backward -> clip, L2, Adam

Every LSTM layer runs K1 forward and K2 backward on the card.  The joint
path is chosen per batch (:func:`_select_joint_path`): the full joint and
blank/emit front when the memory planner projects that it fits; else the
joint tail in K5 and K6, which never builds the ``(B, T', U+1, .)``
tensors; or the T-chunked joint when a config forces it or the kernels do
not take the topology.

    python -m myrtlespeech_tpu_torch.run.train --config rnn_t_en --batch 32 --seconds 5 --labels 64 --steps 5
    python -m myrtlespeech_tpu_torch.run.train --config rnn_t_en --batch 128 --seconds 16.7 --labels 214 --steps 3

(the second is over the budget of an 80 GB card and trains through K5/K6).

runs a config of ``myrtlespeech_tpu_torch/configs`` with seeded random
weights on seeded noise and labels (as ``bench.py`` makes them) and prints
one JSON line per step.  It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from myrtlespeech_tpu_torch.builders.build import (Optimizer, Task,
                                                   build_task, init_params,
                                                   vocab_size)
from myrtlespeech_tpu_torch.models.rnn_t import RNNT
from myrtlespeech_tpu_torch.ops.cuda import (joint_kernel, lstm_kernel,
                                             rnnt_kernel)
from myrtlespeech_tpu_torch.run.infer import load_config, resolve_device
from myrtlespeech_tpu_torch.run.memory import plan_transducer_chunk

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer (its state), the step
    count from 0, and the generator that SpecAugment draws from."""

    model: RNNT
    optimizer: Optimizer
    step: int
    gen: torch.Generator


def init_state(task: Task, seed: int = 0,
               params: Optional[Mapping[str, torch.Tensor]] = None,
               device: str = "cuda") -> TrainState:
    """A model on ``device`` with seeded random weights (``params`` None) or
    the given state_dict (e.g. from ``weights.params_from_npz``), and a
    fresh optimizer."""
    dev = resolve_device(device)
    model = task.build_model()
    if params is None:
        init_params(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params)
    model.to(dev)
    return TrainState(model=model,
                      optimizer=task.build_optimizer(model.parameters()),
                      step=0, gen=torch.Generator().manual_seed(seed))


def to_device(batch: Mapping[str, Any], device) -> Batch:
    """Every array of ``batch`` as a tensor on ``device`` (other entries,
    such as ``texts``, are left out)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


def _batch_weights(batch: Batch) -> Optional[torch.Tensor]:
    """0/1 weights masking duplicated fill rows (``n_real`` of a loader's
    last chunk), or None."""
    n_real = batch.get("n_real")
    if n_real is None:
        return None
    B = batch["wav"].shape[0]
    return torch.arange(B, device=batch["wav"].device) < n_real


def _select_joint_path(task: Task, f: torch.Tensor, g: torch.Tensor,
                       backward: bool
                       ) -> Tuple[Optional[Callable], Optional[int]]:
    """The transducer joint+loss path for this batch's shapes:
    ``(fused_callable_or_None, chunk_or_None)``, with the JAX package's
    precedence (``myrtlespeech_tpu/run/train.py:130-203``):

    1. A config that sets ``fused_chunk_size`` gets the T-chunked path when
       training (a memory knob for the backward's activations); at eval the
       planner decides.
    2. When the memory planner (``run/memory.py``) projects the full joint
       over budget: the joint-tail path (K5, K6) when the topology fits the
       kernels and there is no train-time joint dropout, else the T-chunked
       path with the planner's chunk.
    3. Otherwise the full joint ``(None, None)``, the fastest when it fits.

    The card takes the joint-tail path where the JAX package's TPU does.
    The JAX package's TPU-only guards (its backend check, the kernel's VMEM
    estimate, the tensor-parallel guard) have no counterpart here.
    """
    if task.fused_loss is not None and backward:
        return task.fused_loss, None
    B, T, _ = f.shape
    U1 = g.shape[1]
    jc = task.cfg.speech_to_text.model.joint.fc
    h_eff = jc.num_hidden_layers * (jc.hidden_size or 0)
    chunk = plan_transducer_chunk(
        B, T, U1, h_eff, vocab_size(task.cfg.speech_to_text),
        hidden_bytes=task.dtype.itemsize, backward=backward, device=f.device)
    if chunk is None:
        return None, None
    if task.joint_tail_loss is not None and joint_kernel.joint_tail_supported(
            jc.activation.name.lower(), jc.num_hidden_layers, jc.dropout,
            backward):
        return task.joint_tail_loss, None
    return task.fused_loss_auto, chunk


def _forward(task: Task, model: RNNT, batch: Batch, train: bool,
             gen: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Tuple[Optional[torch.Tensor],
                                            torch.Tensor]]:
    """preprocess -> encode -> predict -> joint path -> mean loss; returns
    ``(loss, (logits, f_lens))``, ``logits`` None on a fused path."""
    feats, flens = task.preprocess(batch["wav"], batch["wav_lens"], train,
                                   gen)
    f, f_lens = model.encode(feats, flens, train)
    g = model.predict(batch["labels"], batch["label_lens"], train)
    fused, chunk = _select_joint_path(task, f, g, backward=train)
    if fused is not None:
        loss = fused(model, f, f_lens, g, batch["labels"],
                     batch["label_lens"], train, chunk_size=chunk,
                     weights=_batch_weights(batch))
        return loss, (None, f_lens)
    logits = model.joint(f, g, train)
    loss = task.loss_fn(logits, f_lens, batch["labels"], batch["label_lens"],
                        weights=_batch_weights(batch))
    return loss, (logits, f_lens)


def train_step_body(task: Task) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: one optimizer step
    on ``batch`` (tensors on the model's device).  Metrics are ``loss``,
    ``grad_norm`` (of the unclipped fp32 gradients) and ``lr =
    schedule(step)``; the first two stay on the device."""

    def train_step(state: TrainState, batch: Batch):
        state.optimizer.zero_grad()
        loss, _ = _forward(task, state.model, batch, True, state.gen)
        loss.backward()
        gnorm = state.optimizer.step(state.step)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "lr": task.lr_schedule(state.step)}
        state.step += 1
        return state, metrics

    return train_step


def make_train_step(task: Task) -> Callable:
    """The train step (eager: there is nothing to compile)."""
    return train_step_body(task)


def eval_step_body(task: Task) -> Callable:
    """``eval_step(state, batch) -> {"loss"}``: the eval-mode loss (no
    SpecAugment, no gradient), as the JAX package's eval step computes it."""

    def eval_step(state: TrainState, batch: Batch):
        with torch.no_grad():
            loss, _ = _forward(task, state.model, batch, False)
        return {"loss": loss}

    return eval_step


def example_batch(batch: int, seconds: float, labels: int, seed: int = 0,
                  sample_rate: int = 16000) -> Dict[str, np.ndarray]:
    """Seeded noise and labels as ``bench.py`` makes them: unit-variance
    noise at full length, labels uniform in ``[1, 27]``, all rows full."""
    samples = int(sample_rate * seconds)
    rng = np.random.default_rng(seed)
    return {
        "wav": rng.standard_normal((batch, samples)).astype(np.float32),
        "wav_lens": np.full((batch,), samples, np.int32),
        "labels": np.clip(rng.integers(1, 28, (batch, labels)), 1,
                          27).astype(np.int32),
        "label_lens": np.full((batch,), labels, np.int32),
    }


def text_batches(dataset, alphabet, batch: int, n: Optional[int] = None
                 ) -> List[Dict[str, np.ndarray]]:
    """The first ``n`` utterances of ``dataset`` (items ``(wav, text)``) as
    batches of ``batch``: waveforms zero-padded to the longest of the ``n``,
    labels ``alphabet.get_indices(text)`` zero-padded to the longest
    transcript, and both lengths; each batch also keeps its ``texts``."""
    n = len(dataset) if n is None else n
    items = [dataset[i] for i in range(n)]
    s_max = max(len(w) for w, _ in items)
    u_max = max(len(t) for _, t in items)
    out = []
    for i in range(0, n, batch):
        chunk = items[i:i + batch]
        wav = np.zeros((len(chunk), s_max), np.float32)
        labels = np.zeros((len(chunk), u_max), np.int32)
        for j, (w, text) in enumerate(chunk):
            wav[j, :len(w)] = w
            labels[j, :len(text)] = alphabet.get_indices(text)
        out.append({
            "wav": wav,
            "wav_lens": np.array([len(w) for w, _ in chunk], np.int32),
            "labels": labels,
            "label_lens": np.array([len(t) for _, t in chunk], np.int32),
            "texts": [t for _, t in chunk]})
    return out


def kernel_launches() -> Dict[str, int]:
    """The launch counters of the kernels on the train step's path."""
    return {"k1": lstm_kernel.lstm_fwd.launches,
            "k2": lstm_kernel.lstm_bwd.launches,
            "k3": rnnt_kernel.rnnt_lattice_fwd.launches,
            "k4": rnnt_kernel.rnnt_lattice_bwd.launches,
            "k5": joint_kernel.joint_tail_fwd.launches,
            "k6": joint_kernel.joint_tail_bwd.launches}


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="rnn_t_en")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--labels", type=int, default=64)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    task = build_task(load_config(args.config))
    state = init_state(task, seed=args.seed, device=args.device)
    dev = next(state.model.parameters()).device
    batch = to_device(example_batch(args.batch, args.seconds, args.labels,
                                    args.seed), dev)
    step = make_train_step(task)
    for _ in range(args.steps):
        before = kernel_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])  # waits for the step to finish
        ms = 1e3 * (time.perf_counter() - t0)
        after = kernel_launches()
        print(json.dumps({
            "config": args.config, "device": str(dev),
            "step": state.step - 1, "loss": loss,
            "grad_norm": float(metrics["grad_norm"]), "lr": metrics["lr"],
            "ms": ms, "audio_s_per_s": args.batch * args.seconds / (ms / 1e3),
            "launches": {k: after[k] - before[k] for k in after}}),
            flush=True)


if __name__ == "__main__":
    main()
