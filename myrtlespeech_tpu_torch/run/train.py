"""Training: the RNN-T and CTC train steps, the eval step and ``fit``.

Port of ``myrtlespeech_tpu/run/train.py``: ``TrainState``, ``init_state``,
``_forward``, ``_select_joint_path``, ``train_step_body``,
``make_train_step``, ``eval_step_body`` (the loss and the decode),
``make_eval_step`` and ``fit`` (epochs over the bucketed loader, the eval
stage, callbacks, exact resume; one card: the JAX package's mesh and
multi-process branches wait for ``ROADMAP.md`` Queue 1 item 7).  PyTorch
runs eagerly, so the step is a plain function that updates the state in
place:

    preprocess (SpecAugment at train time) -> RNNT.encode -> RNNT.predict
    -> joint path -> lattice (K3, K4) -> backward -> clip, L2, Adam

or, for a CTC model (DeepSpeech1, DeepSpeech2 or an encoder-decoder),

    preprocess -> DeepSpeech2 (conv block, BiLSTMs with masked BatchNorm,
    FC), DeepSpeech1 (3 FC, BiLSTM, FC; MFCC and context frames in the
    preprocess) or EncoderDecoder (VGG, conv block, RNN of any cell, FC)
    -> CTC lattice (K7, K8) -> backward -> clip, L2, SGD or Adam

Every LSTM layer runs K1 forward and K2 backward on the card; a GRU,
vanilla or hard-LSTM layer (in any model that lets a config put one) runs
its PyTorch recurrence (``ops/rnn.py``), forward and backward.  Every
BatchNorm (the masked ones and VGG's plain one) takes the batch's
statistics and moves its running ones in a train step, and uses the
running ones in the eval step.  The transducer's joint path is
chosen per batch (:func:`_select_joint_path`): the full joint and blank/emit
front when the memory planner projects that it fits; else the joint tail
in K5 and K6, which never builds the ``(B, T', U+1, .)`` tensors; or the
T-chunked joint when a config forces it or the kernels do not take the
topology.

    python -m myrtlespeech_tpu_torch.run.train --config rnn_t_en --batch 32 --seconds 5 --labels 64 --steps 5
    python -m myrtlespeech_tpu_torch.run.train --config rnn_t_en --batch 128 --seconds 16.7 --labels 214 --steps 3
    python -m myrtlespeech_tpu_torch.run.train --config deep_speech_2_en --batch 32 --seconds 16.7 --labels 214
    python -m myrtlespeech_tpu_torch.run.train --config deep_speech_1_en --batch 32 --seconds 16.7 --labels 214

(the second is over the budget of an 80 GB card and trains through K5/K6).

runs a config of ``myrtlespeech_tpu_torch/configs`` with seeded random
weights on seeded noise and labels (as ``bench.py`` makes them) and prints
one JSON line per step.  It runs on the card unless ``--device cpu``.  To
train a config on its datasets, use ``run/cli.py`` (``fit``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from myrtlespeech_tpu_torch.builders.build import (Optimizer, Task,
                                                   build_decoder, build_task,
                                                   init_params, vocab_size)
from myrtlespeech_tpu_torch.data.batch import BucketedLoader, PrefetchLoader
from myrtlespeech_tpu_torch.ops.cuda import (ctc_kernel, joint_kernel,
                                             lstm_kernel, rnnt_kernel)
from myrtlespeech_tpu_torch.run.callbacks import CallbackHandler, Stage
from myrtlespeech_tpu_torch.run.infer import load_config, resolve_device
from myrtlespeech_tpu_torch.run.memory import plan_transducer_chunk

Batch = Dict[str, torch.Tensor]


# Mixed into the seed of the dropout generator, so that on the CPU it does
# not replay SpecAugment's stream.
DROPOUT_SEED_MIX = 0x64726F70


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the optimizer
    (its state), the step count from 0, the CPU generator that SpecAugment
    draws from, and the generator on the model's device that the dropout
    masks are drawn from."""

    model: nn.Module
    optimizer: Optimizer
    step: int
    gen: torch.Generator
    dropout_gen: torch.Generator


def init_state(task: Task, seed: int = 0,
               params: Optional[Mapping[str, torch.Tensor]] = None,
               device: str = "cuda") -> TrainState:
    """A model on ``device`` with seeded random weights (``params`` None) or
    the given state_dict (e.g. from ``weights.params_from_npz``), a fresh
    optimizer, and both generators seeded from ``seed``."""
    dev = resolve_device(device)
    model = task.build_model()
    if params is None:
        init_params(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params)
    model.to(dev)
    return TrainState(
        model=model, optimizer=task.build_optimizer(model.parameters()),
        step=0, gen=torch.Generator().manual_seed(seed),
        dropout_gen=torch.Generator(device=dev).manual_seed(
            seed ^ DROPOUT_SEED_MIX))


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


def _forward(task: Task, model: nn.Module, batch: Batch, train: bool,
             gen: Optional[torch.Generator] = None,
             dropout_gen: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Tuple[Optional[torch.Tensor],
                                            torch.Tensor]]:
    """preprocess -> model -> loss.  Transducer: encode -> predict -> joint
    path; CTC: the model's logits into the CTC loss (BatchNorm moves its
    running statistics when ``train``).  At train time SpecAugment draws
    from ``gen`` and dropout from ``dropout_gen``.  Returns ``(loss,
    (logits, out_lens))``, ``logits`` None on a fused transducer path."""
    feats, flens = task.preprocess(batch["wav"], batch["wav_lens"], train,
                                   gen)
    if not task.transducer:
        logits, out_lens = model(feats, flens, train, dropout_gen)
        loss = task.loss_fn(logits, out_lens, batch["labels"],
                            batch["label_lens"],
                            weights=_batch_weights(batch))
        return loss, (logits, out_lens)
    f, f_lens = model.encode(feats, flens, train, dropout_gen)
    loss, logits = _transducer_loss(task, model, f, f_lens, batch, train,
                                    dropout_gen)
    return loss, (logits, f_lens)


def _transducer_loss(task: Task, model: nn.Module, f: torch.Tensor,
                     f_lens: torch.Tensor, batch: Batch, train: bool,
                     dropout_gen: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """predict -> joint path -> loss from the encoder's output: ``(loss,
    logits)``, ``logits`` None on a fused path."""
    g = model.predict(batch["labels"], batch["label_lens"], train,
                      dropout_gen)
    fused, chunk = _select_joint_path(task, f, g, backward=train)
    if fused is not None:
        loss = fused(model, f, f_lens, g, batch["labels"],
                     batch["label_lens"], train, chunk_size=chunk,
                     weights=_batch_weights(batch), gen=dropout_gen)
        return loss, None
    logits = model.joint(f, g, train, dropout_gen)
    loss = task.loss_fn(logits, f_lens, batch["labels"], batch["label_lens"],
                        weights=_batch_weights(batch))
    return loss, logits


def train_step_body(task: Task) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: one optimizer step
    on ``batch`` (tensors on the model's device).  Metrics are ``loss``,
    ``grad_norm`` (of the unclipped fp32 gradients) and ``lr =
    schedule(step)``; the first two stay on the device."""

    def train_step(state: TrainState, batch: Batch):
        state.optimizer.zero_grad()
        loss, _ = _forward(task, state.model, batch, True, state.gen,
                           state.dropout_gen)
        loss.backward()
        gnorm = state.optimizer.step(state.step)
        # In the JAX step's order (a jitted dict's keys come out sorted),
        # which sets the CSV log's columns.
        metrics = {"grad_norm": gnorm, "loss": loss.detach(),
                   "lr": task.lr_schedule(state.step)}
        state.step += 1
        return state, metrics

    return train_step


def make_train_step(task: Task) -> Callable:
    """The train step (eager: there is nothing to compile)."""
    return train_step_body(task)


def eval_step_body(task: Task, decode: bool = True,
                   max_output_len: int = 200) -> Callable:
    """``eval_step(state, batch) -> metrics``: the eval-mode loss (no
    SpecAugment, BatchNorm's running statistics, no gradient) and, with
    ``decode``, the config's decoder's ``decoded_tokens`` and
    ``decoded_lens``, as the JAX package's eval step computes them.  A
    transducer decodes the encoder output that its loss used (up to
    ``max_output_len`` symbols), a CTC model its logits.  Everything stays
    on the device."""

    def eval_step(state: TrainState, batch: Batch):
        with torch.no_grad():
            if task.transducer and decode:
                # The encoder runs once, for the loss and the decoder.
                feats, flens = task.preprocess(batch["wav"],
                                               batch["wav_lens"])
                f, f_lens = state.model.encode(feats, flens)
                loss, _ = _transducer_loss(task, state.model, f, f_lens,
                                           batch, False)
                decoder = build_decoder(task.cfg.speech_to_text,
                                        state.model)
                decoded = decoder(f, f_lens, max_output_len=max_output_len)
            else:
                loss, (logits, out_lens) = _forward(task, state.model, batch,
                                                    False)
                if decode:
                    decoded = task.decoder(logits, out_lens)
        metrics = {"loss": loss}
        if decode:
            metrics["decoded_tokens"], metrics["decoded_lens"] = decoded
        return metrics

    return eval_step


def make_eval_step(task: Task, decode: bool = True,
                   max_output_len: int = 200) -> Callable:
    """The eval step (eager: there is nothing to compile)."""
    return eval_step_body(task, decode, max_output_len)


def fit(task: Task, epochs: Optional[int] = None, callbacks=(),
        batch_size: Optional[int] = None, decode_eval: bool = True,
        seed: Optional[int] = None, loader_kwargs: Optional[dict] = None,
        eval_loader_kwargs: Optional[dict] = None,
        initial_state: Optional[TrainState] = None,
        start_epoch: int = 0, skip_batches: int = 0,
        eval_only: bool = False, device: str = "cuda") -> CallbackHandler:
    """Train ``task`` for ``epochs`` on its datasets, as the JAX package's
    ``fit`` (``myrtlespeech_tpu/run/train.py:333-594``) on one device.

    Each epoch: ``set_epoch`` on the train loader (a ``BucketedLoader``
    behind a ``PrefetchLoader``), the train steps, then the eval stage (the
    eval step with the config's decoder when ``decode_eval``) when the task
    has an eval dataset.  Batches go to ``device`` through ``to_device``.
    ``initial_state``/``start_epoch``/``skip_batches`` resume exactly: the
    loader's order is a pure function of ``(seed, epoch)``, the LR schedule
    keys off ``state.step`` and the SpecAugment and dropout generators are
    in the state.
    Without ``initial_state`` the model starts from ``init_state(task,
    seed)``.  ``eval_only`` runs one eval stage.

    Returns the callback handler; its ``state`` holds ``step``,
    ``batch_index``, ``train_state`` and ``reports`` (mean losses, WER,
    throughput).  A config with ``mesh_model > 1`` raises: tensor
    parallelism is ``ROADMAP.md`` Queue 1 item 7, and this never trains it
    on one card instead.
    """
    tc = task.cfg.train_config
    if tc.mesh_model > 1:
        raise NotImplementedError(
            f"mesh_model={tc.mesh_model}: tensor parallelism is not ported "
            "yet (ROADMAP.md Queue 1 item 7)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        # Float32 products in full float32, as build_transcriber sets them.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if tc.debug_nans:  # the counterpart of jax_debug_nans: NaNs raise
        torch.autograd.set_detect_anomaly(True)
    epochs = epochs if epochs is not None else tc.epochs
    batch_size = batch_size or tc.batch_size
    seed = seed if seed is not None else tc.seed
    lk = dict(loader_kwargs or {})
    prefetch = lk.pop("prefetch", 2)
    lk.setdefault("bucket_growth", tc.audio_bucket_growth)
    lk.setdefault("label_bucket", tc.label_bucket)
    lk.setdefault("num_workers", 4)  # sample-fetch threads
    train_loader = BucketedLoader(
        task.train_dataset, task.alphabet, batch_size,
        shuffle=tc.shuffle_batches_before_every_epoch, seed=seed, **lk)
    if prefetch:
        train_loader = PrefetchLoader(train_loader, prefetch)
    eval_loader = None
    if task.eval_dataset is not None:
        ek = dict(eval_loader_kwargs or lk)
        ek.pop("prefetch", None)
        # Eval packs batches sorted by duration (full batches, fewest
        # padding rows); explicit kwargs win.
        ek.setdefault("pack", True)
        eval_loader = BucketedLoader(task.eval_dataset, task.alphabet,
                                     batch_size, shuffle=False, **ek)
        if prefetch:
            eval_loader = PrefetchLoader(eval_loader, prefetch)

    handler = CallbackHandler(list(callbacks))
    train_step = make_train_step(task)
    eval_step = make_eval_step(task, decode=decode_eval)
    state = initial_state
    if state is None:
        state = init_state(task, seed=seed, device=str(dev))

    def run_eval():
        handler.on_stage_begin(Stage.EVAL)
        for batch in eval_loader:
            arrays = to_device(batch, dev)
            handler.on_batch_begin(batch)
            handler.on_batch_end(eval_step(state, arrays))
            if handler.state["stop_epoch"] or handler.state["stop_training"]:
                break
        handler.on_stage_end()

    if eval_only:
        if eval_loader is None:
            raise ValueError("eval_only requires an eval_dataset")
        handler.on_train_begin()
        run_eval()
        handler.on_train_end()
        handler.state["train_state"] = state
        return handler

    # Callbacks that keep per-epoch files (CSVLogger) need the resume
    # epoch, and the step count continues from the restored state.
    handler.state["start_epoch"] = start_epoch
    handler.state["step"] = int(state.step)
    handler.on_train_begin()
    for epoch in range(start_epoch, epochs):
        handler.on_epoch_begin(epoch)
        handler.on_stage_begin(Stage.TRAIN)
        skip = skip_batches if epoch == start_epoch else 0
        train_loader.set_epoch(epoch, skip)
        # Resumed mid-epoch: the batch cursor starts past the skipped
        # batches, so that StopEpochAfter and the saved cursor stay exact.
        handler.state["batch_index"] = skip
        for batch in train_loader:
            arrays = to_device(batch, dev)
            handler.on_batch_begin(batch)
            state, metrics = train_step(state, arrays)
            handler.on_batch_end(metrics)
            if handler.state["stop_epoch"] or handler.state["stop_training"]:
                break
        handler.state["train_state"] = state
        handler.on_stage_end()
        if eval_loader is not None:
            run_eval()
        handler.on_epoch_end()
        if handler.state["stop_training"]:
            break
    handler.on_train_end()
    handler.state["train_state"] = state
    return handler


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
            "k6": joint_kernel.joint_tail_bwd.launches,
            "k7": ctc_kernel.ctc_lattice_fwd.launches,
            "k8": ctc_kernel.ctc_lattice_bwd.launches}


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
