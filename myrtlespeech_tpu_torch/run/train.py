"""Training: the RNN-T and CTC train steps, the eval step and ``fit``.

Port of ``myrtlespeech_tpu/run/train.py``: ``TrainState``, ``init_state``,
``_forward``, ``_select_joint_path``, ``train_step_body``,
``make_train_step``, ``eval_step_body`` (the loss and the decode),
``make_eval_step`` and ``fit`` (epochs over the bucketed loader, the eval
stage, callbacks, exact resume, and the JAX package's mesh: data and tensor
parallelism over ``torch.distributed``, ``parallel/``).  PyTorch runs
eagerly, so the step is a plain function that updates the state in place:

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
import torch.distributed as dist
from torch import nn

from myrtlespeech_tpu_torch.builders.build import (Optimizer, Task,
                                                   build_decoder, build_task,
                                                   init_params, vocab_size)
from myrtlespeech_tpu_torch.data.batch import BucketedLoader, PrefetchLoader
from myrtlespeech_tpu_torch.ops.cuda import (ctc_kernel, joint_kernel,
                                             lstm_kernel, rnnt_kernel)
from myrtlespeech_tpu_torch.parallel.mesh import Mesh, make_mesh
from myrtlespeech_tpu_torch.parallel.sharding import (gather_params,
                                                      shard_model,
                                                      sharded_dim)
from myrtlespeech_tpu_torch.parallel.tensor import BatchShard
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
    masks are drawn from.

    In a run of several ranks, ``mesh`` is this rank's place in the
    ``(data, model)`` mesh and ``specs`` the parameters' layout
    (``parallel/sharding.py``): the model holds this rank's column shards,
    and the optimizer's moments follow them.  Both are None in a process
    without ``torch.distributed``."""

    model: nn.Module
    optimizer: Optimizer
    step: int
    gen: torch.Generator
    dropout_gen: torch.Generator
    mesh: Optional[Mesh] = None
    specs: Optional[Dict[str, tuple]] = None


def init_state(task: Task, seed: int = 0,
               params: Optional[Mapping[str, torch.Tensor]] = None,
               device: str = "cuda", mesh: Optional[Mesh] = None,
               tp_rnn_weights: bool = True) -> TrainState:
    """A model on ``device`` with seeded random weights (``params`` None) or
    the given state_dict (e.g. from ``weights.params_from_npz``), a fresh
    optimizer, and both generators seeded from ``seed``.

    With ``mesh`` the whole model is built, filled and then cut to this
    rank's shards (``sharding.shard_model``, ``tp_rnn_weights`` its RNN
    layout), so every rank holds the columns of one one-process model."""
    dev = resolve_device(device)
    model = task.build_model()
    if params is None:
        init_params(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params)
    specs = None if mesh is None else shard_model(model, mesh, tp_rnn_weights)
    model.to(dev)
    optimizer = task.build_optimizer(model.parameters())
    if mesh is not None and mesh.model > 1:
        optimizer.shard([sharded_dim(specs[n]) is not None
                         for n, _ in model.named_parameters()],
                        mesh.model_group)
    return TrainState(
        model=model, optimizer=optimizer,
        step=0, gen=torch.Generator().manual_seed(seed),
        dropout_gen=torch.Generator(device=dev).manual_seed(
            seed ^ DROPOUT_SEED_MIX), mesh=mesh, specs=specs)


def run_mesh(model: int = 1) -> Optional[Mesh]:
    """This run's mesh: ``model`` ranks a replica over the
    ``torch.distributed`` world (``parallel/mesh.py::make_mesh``; one rank
    too, where it is initialised), or None for one process without it at
    ``model=1``.  A world that ``model`` does not divide raises
    ``ValueError`` (one process at ``mesh_model=2`` among them)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() and model == 1:
        return None
    if world % model:
        raise ValueError(
            f"mesh_model={model} needs a multiple of {model} processes; "
            f"this run has {world} (run/cli.py --num_processes)")
    return make_mesh(model=model)


def eval_state(task: Task, state: TrainState) -> TrainState:
    """The state an eval stage runs on: under tensor parallelism the whole
    model, gathered from the shards once (every model rank must call it),
    which runs the one-process eval step on this rank's data shard; else
    ``state`` itself."""
    mesh = state.mesh
    if mesh is None or mesh.model == 1:
        return state
    full = gather_params(state.model.state_dict(), state.specs, mesh)
    model = task.build_model().to(next(iter(full.values())).device)
    model.load_state_dict(full)
    return dataclasses.replace(state, model=model, optimizer=None,
                               specs=None)


def to_device(batch: Mapping[str, Any], device) -> Batch:
    """Every array of ``batch`` as a tensor on ``device`` (other entries,
    such as ``texts``, are left out)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


def _row_offset(batch: Batch, mesh: Optional[Mesh]) -> int:
    """The global index of this rank's first row of the batch."""
    return 0 if mesh is None else mesh.data_index * batch["wav"].shape[0]


def _batch_weights(batch: Batch, offset: int = 0) -> Optional[torch.Tensor]:
    """0/1 weights masking duplicated fill rows (``n_real`` of a loader's
    last chunk, a global count), or None; ``offset`` is the global index of
    the batch's first row (a data-parallel rank's slice)."""
    n_real = batch.get("n_real")
    if n_real is None:
        return None
    B = batch["wav"].shape[0]
    return offset + torch.arange(B, device=batch["wav"].device) < n_real


def _global_share(task: Task, batch: Batch, mesh: Mesh):
    """The factor that turns this rank's loss (a mean over its real rows)
    into its share of the global batch's: ``sum(w * nll)`` over its rows
    over the global ``sum(w)``, so that the shares sum to the one-process
    loss.  A mean of the ranks' means would be wrong wherever a chunk's fill
    rows fall on some ranks only.  1 for a 'sum' reduction."""
    if task.cfg.speech_to_text.loss.reduction.value != "mean":
        return 1.0
    n_real = batch.get("n_real")
    if n_real is None:
        return 1.0 / mesh.data
    B = batch["wav"].shape[0]
    local = torch.clamp(n_real - _row_offset(batch, mesh), 0, B)
    return torch.clamp(local, min=1) / torch.clamp(n_real, min=1)


def reduce_gradients(params, loss: torch.Tensor, group) -> torch.Tensor:
    """Sum every gradient and ``loss`` over the data group in one flat
    bucket, after the backward (no overlap with it: the persistent K1/K2
    assume their whole grid resident, one block an SM, which NCCL kernels
    beside K2 would break); returns the summed loss."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([loss.detach().float().reshape(1)]
                     + [g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    i = 1
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return flat[0]


def _select_joint_path(task: Task, f: torch.Tensor, g: torch.Tensor,
                       backward: bool, model_size: int = 1
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
    Under tensor parallelism (``model_size > 1``, the model's shard count)
    the joint tail is off, as the JAX package's TP guard turns its kernel
    off, and the chunked path runs the sharded joint.  The JAX package's
    TPU-only guards (its backend check, the kernel's VMEM estimate) have no
    counterpart here.
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
    if task.joint_tail_loss is not None and model_size == 1 \
            and joint_kernel.joint_tail_supported(
                jc.activation.name.lower(), jc.num_hidden_layers, jc.dropout,
                backward):
        return task.joint_tail_loss, None
    return task.fused_loss_auto, chunk


def _forward(task: Task, model: nn.Module, batch: Batch, train: bool,
             gen: Optional[torch.Generator] = None,
             dropout_gen: Optional[torch.Generator] = None,
             mesh: Optional[Mesh] = None
             ) -> Tuple[torch.Tensor, Tuple[Optional[torch.Tensor],
                                            torch.Tensor]]:
    """preprocess -> model -> loss.  Transducer: encode -> predict -> joint
    path; CTC: the model's logits into the CTC loss (BatchNorm moves its
    running statistics when ``train``).  At train time SpecAugment draws
    from ``gen`` and dropout from ``dropout_gen``.  ``batch`` is this
    rank's rows under ``mesh``, its loss the mean over their real rows.
    Returns ``(loss, (logits, out_lens))``, ``logits`` None on a fused
    transducer path."""
    offset = _row_offset(batch, mesh)
    feats, flens = task.preprocess(batch["wav"], batch["wav_lens"], train,
                                   gen)
    if not task.transducer:
        logits, out_lens = model(feats, flens, train, dropout_gen)
        loss = task.loss_fn(logits, out_lens, batch["labels"],
                            batch["label_lens"],
                            weights=_batch_weights(batch, offset))
        return loss, (logits, out_lens)
    f, f_lens = model.encode(feats, flens, train, dropout_gen)
    loss, logits = _transducer_loss(task, model, f, f_lens, batch, train,
                                    dropout_gen, offset)
    return loss, (logits, f_lens)


def _transducer_loss(task: Task, model: nn.Module, f: torch.Tensor,
                     f_lens: torch.Tensor, batch: Batch, train: bool,
                     dropout_gen: Optional[torch.Generator] = None,
                     offset: int = 0
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """predict -> joint path -> loss from the encoder's output: ``(loss,
    logits)``, ``logits`` None on a fused path."""
    g = model.predict(batch["labels"], batch["label_lens"], train,
                      dropout_gen)
    model_mesh = getattr(model, "dist_mesh", None)
    fused, chunk = _select_joint_path(
        task, f, g, backward=train,
        model_size=1 if model_mesh is None else model_mesh.model)
    weights = _batch_weights(batch, offset)
    if fused is not None:
        loss = fused(model, f, f_lens, g, batch["labels"],
                     batch["label_lens"], train, chunk_size=chunk,
                     weights=weights, gen=dropout_gen)
        return loss, None
    logits = model.joint(f, g, train, dropout_gen)
    loss = task.loss_fn(logits, f_lens, batch["labels"], batch["label_lens"],
                        weights=weights)
    return loss, logits


def train_step_body(task: Task) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: one optimizer step
    on ``batch`` (tensors on the model's device).  Metrics are ``loss``,
    ``grad_norm`` (of the unclipped fp32 gradients) and ``lr =
    schedule(step)``; the first two stay on the device.

    Under data parallelism ``batch`` is this rank's rows of the global
    batch: its loss is its share of the global batch's weighted mean
    (:func:`_global_share`), the generators draw for the global batch
    (``BatchShard``), and the gradients and the loss are summed over the
    data group after the backward (:func:`reduce_gradients`), so every rank
    takes the one-process step of the global batch."""

    def train_step(state: TrainState, batch: Batch):
        mesh = state.mesh
        dp = mesh is not None and mesh.data > 1
        gen, dropout_gen = state.gen, state.dropout_gen
        if dp:
            gen, dropout_gen = BatchShard(gen, mesh), BatchShard(dropout_gen,
                                                                 mesh)
        state.optimizer.zero_grad()
        loss, _ = _forward(task, state.model, batch, True, gen, dropout_gen,
                           mesh)
        if dp:
            loss = loss * _global_share(task, batch, mesh)
        loss.backward()
        if dp:
            loss = reduce_gradients(state.optimizer.params, loss,
                                    mesh.data_group)
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
    on the device.  Under a mesh it runs on this rank's rows alone (the
    loss their mean; ``eval_state`` gives it a whole model under tensor
    parallelism): the callbacks sum the statistics over the data group."""

    def eval_step(state: TrainState, batch: Batch):
        with torch.no_grad():
            if task.transducer and decode:
                # The encoder runs once, for the loss and the decoder.
                feats, flens = task.preprocess(batch["wav"],
                                               batch["wav_lens"])
                f, f_lens = state.model.encode(feats, flens)
                loss, _ = _transducer_loss(
                    task, state.model, f, f_lens, batch, False,
                    offset=_row_offset(batch, state.mesh))
                decoder = build_decoder(task.cfg.speech_to_text,
                                        state.model)
                decoded = decoder(f, f_lens, max_output_len=max_output_len)
            else:
                loss, (logits, out_lens) = _forward(task, state.model, batch,
                                                    False, mesh=state.mesh)
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
        eval_only: bool = False, device: str = "cuda",
        mesh: Optional[Mesh] = None) -> CallbackHandler:
    """Train ``task`` for ``epochs`` on its datasets, as the JAX package's
    ``fit`` (``myrtlespeech_tpu/run/train.py:333-594``).

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

    Several processes (``torch.distributed`` initialised, e.g. by
    ``run/cli.py``) train one model over the ``(data, model)`` mesh
    (``mesh``, by default :func:`run_mesh` of the config's ``mesh_model``,
    or the initial state's): ``batch_size`` is the global batch, each data
    rank loads its rows of every global batch (the loader shards by the
    data index, so the ranks of one model group load the same rows), the
    model ranks hold column shards, and every rank takes the one-process
    step of the global batch.  Each eval stage runs the one-process eval step on the rank's rows, on a
    whole model gathered once a stage under tensor parallelism
    (:func:`eval_state`); the callbacks sum its statistics over the data
    group (``handler.state["mesh"]``).

    Returns the callback handler; its ``state`` holds ``step``,
    ``batch_index``, ``train_state`` and ``reports`` (mean losses, WER,
    throughput).
    """
    tc = task.cfg.train_config
    if mesh is None:
        mesh = initial_state.mesh if initial_state is not None \
            else run_mesh(tc.mesh_model)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # Float32 products in full float32, as build_transcriber sets them.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if tc.debug_nans:  # the counterpart of jax_debug_nans: NaNs raise
        torch.autograd.set_detect_anomaly(True)
    epochs = epochs if epochs is not None else tc.epochs
    batch_size = batch_size or tc.batch_size
    data = 1 if mesh is None else mesh.data
    if batch_size % data:
        raise ValueError(f"the global batch_size={batch_size} must be "
                         f"divisible by the {data} data ranks")
    seed = seed if seed is not None else tc.seed
    lk = dict(loader_kwargs or {})
    prefetch = lk.pop("prefetch", 2)
    lk.setdefault("bucket_growth", tc.audio_bucket_growth)
    lk.setdefault("label_bucket", tc.label_bucket)
    lk.setdefault("num_workers", 4)  # sample-fetch threads
    if data > 1:
        lk.setdefault("shard_id", mesh.data_index)
        lk.setdefault("num_shards", data)
    train_loader = BucketedLoader(
        task.train_dataset, task.alphabet, batch_size // data,
        shuffle=tc.shuffle_batches_before_every_epoch, seed=seed, **lk)
    if prefetch:
        train_loader = PrefetchLoader(train_loader, prefetch)
    eval_loader = None
    if task.eval_dataset is not None:
        ek = dict(eval_loader_kwargs or lk)
        ek.pop("prefetch", None)
        if data > 1:
            ek.setdefault("shard_id", mesh.data_index)
            ek.setdefault("num_shards", data)
        # Eval packs batches sorted by duration (full batches, fewest
        # padding rows); explicit kwargs win.
        ek.setdefault("pack", True)
        eval_loader = BucketedLoader(task.eval_dataset, task.alphabet,
                                     batch_size // data, shuffle=False, **ek)
        if prefetch:
            eval_loader = PrefetchLoader(eval_loader, prefetch)

    handler = CallbackHandler(list(callbacks))
    handler.state["mesh"] = mesh
    train_step = make_train_step(task)
    eval_step = make_eval_step(task, decode=decode_eval)
    state = initial_state
    if state is None:
        state = init_state(task, seed=seed, device=str(dev), mesh=mesh)

    def run_eval():
        handler.on_stage_begin(Stage.EVAL)
        es = eval_state(task, state)
        for batch in eval_loader:
            arrays = to_device(batch, dev)
            handler.on_batch_begin(batch)
            handler.on_batch_end(eval_step(es, arrays))
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
