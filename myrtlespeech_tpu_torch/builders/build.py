"""Builders: TaskConfig -> modules and callables for serving and training.

Port of ``myrtlespeech_tpu/builders/build.py`` for the RNN-T:
``vocab_size`` (``:58``), ``build_preprocess`` and ``preprocess_out_features``
(``:67-137``), ``build_model`` for RNN-T (``:188-202``),
the transducer ``build_loss`` (``:213-275``; its ``weighted_reduce`` lives
in ``ops/rnnt.py``), ``build_fused_transducer_loss`` (``:277-311``),
:func:`build_joint_tail_loss` (``build_pallas_joint_loss``, ``:314-372``),
``build_rnnt_decode_helpers`` and the greedy ``build_decoder``
(``:395-488``), ``build_lr_schedule`` and ``build_optimizer``
(``:510-563``), ``Task`` and ``build_task`` (without datasets, which the
run-loop slice adds), and :func:`init_params`, which fills a model with
seeded random weights drawn the way Flax's initialisers draw them.

Blank-index convention: the output vocabulary is
``max(len(alphabet), blank_index + 1)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.data.alphabet import Alphabet
from myrtlespeech_tpu_torch.decoding.rnnt_greedy import rnnt_greedy_decode
from myrtlespeech_tpu_torch.models.rnn_t import RNNT
from myrtlespeech_tpu_torch.ops import features as F
from myrtlespeech_tpu_torch.ops.cuda.joint_kernel import (
    joint_tail_blank_emit, joint_tail_supported)
from myrtlespeech_tpu_torch.ops.cuda.rnnt_kernel import (rnnt_lattice,
                                                         rnnt_loss_lattice)
from myrtlespeech_tpu_torch.ops.rnnt import rnnt_loss_fused, weighted_reduce
from myrtlespeech_tpu_torch.ops.specaugment import spec_augment


def vocab_size(cfg: S.SpeechToTextConfig) -> int:
    return max(len(cfg.alphabet), cfg.loss.blank_index + 1)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def build_preprocess(steps: Tuple[S.PreProcessStepConfig, ...]) -> Callable:
    """Build ``fn(wav, wav_lens, train=False, gen=None) -> (feats,
    frame_lens)``.

    TRAIN-stage steps are skipped at eval.  SpecAugment draws its masks from
    ``gen`` (a ``torch.Generator``), which a train-time call must pass.
    Steps of the CTC family (MFCC, context frames) raise
    ``NotImplementedError``.
    """

    def apply(wav: torch.Tensor, wav_lens: torch.Tensor, train: bool = False,
              gen: Optional[torch.Generator] = None):
        x, lens = wav, wav_lens
        is_features = False
        for step_cfg in steps:
            if step_cfg.stage is S.StageSelector.TRAIN and not train:
                continue
            if step_cfg.stage is S.StageSelector.EVAL and train:
                continue
            st = step_cfg.step
            if isinstance(st, S.MFCCConfig) and st.log_mel_only:
                n_fft = st.n_fft or _next_pow2(
                    int(st.win_length_ms * st.sample_rate / 1000))
                win = int(st.win_length_ms * st.sample_rate / 1000)
                hop = int(st.hop_length_ms * st.sample_rate / 1000)
                x, lens = F.log_mel_spectrogram(
                    x, lens, sample_rate=st.sample_rate, n_fft=n_fft,
                    win_length=win, hop_length=hop, n_mels=st.n_mels)
                is_features = True
            elif isinstance(st, S.StandardizeConfig):
                x = F.standardize(x, lens, eps=st.eps)
            elif isinstance(st, S.SpecAugmentConfig):
                if gen is None:
                    raise ValueError("SpecAugment needs a torch.Generator "
                                     "(gen=) to draw its masks")
                x = spec_augment(
                    gen, x, lens, feature_mask=st.feature_mask,
                    time_mask=st.time_mask,
                    n_feature_masks=st.n_feature_masks,
                    n_time_masks=st.n_time_masks,
                    time_mask_ratio=st.time_mask_ratio)
            else:
                raise NotImplementedError(
                    f"preprocess step {type(st).__name__} is not ported "
                    "yet: ROADMAP.md Queue 1, slice 3 (CTC family)")
        if not is_features:
            x = x[..., None]  # (B, S, 1) raw-sample "features"
        return x, lens

    return apply


def preprocess_out_features(steps: Tuple[S.PreProcessStepConfig, ...]) -> int:
    """Static feature dim produced by :func:`build_preprocess`."""
    f = 1
    for step_cfg in steps:
        st = step_cfg.step
        if isinstance(st, S.MFCCConfig):
            f = st.n_mels if st.log_mel_only else st.n_mfcc
        elif isinstance(st, S.ContextFramesConfig):
            f = f * (2 * st.n_context + 1)
    return f


def build_model(cfg: S.SpeechToTextConfig, dtype: torch.dtype,
                in_features: int) -> RNNT:
    if not isinstance(cfg.model, S.RNNTConfig):
        raise NotImplementedError(
            f"{type(cfg.model).__name__} is not ported yet: ROADMAP.md "
            "Queue 1, slice 3 (CTC family)")
    return RNNT(cfg.model, vocab_size=vocab_size(cfg),
                in_features=in_features, dtype=dtype)


def _orthogonal(shape, gen: torch.Generator) -> torch.Tensor:
    """Flax ``orthogonal()``: orthonormal rows (or columns) from a QR."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.T.contiguous() if rows < cols else q


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights, drawn as the JAX package's Flax initialisers
    draw them: Xavier-uniform ``w_ih``, orthogonal ``w_hh``, LeCun-normal
    dense kernels, unit-variance-over-fan-in embeddings; biases keep their
    construction values (zeros, plus any forget-gate bias)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("_w_ih"):
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
        elif leaf.endswith("_w_hh"):
            p.copy_(_orthogonal(tuple(p.shape), gen))
        elif leaf == "kernel":
            p.copy_(torch.randn(p.shape, generator=gen)
                    / math.sqrt(p.shape[0]))
        elif leaf == "embedding":
            p.copy_(torch.randn(p.shape, generator=gen)
                    / math.sqrt(p.shape[1]))


def random_params(cfg: S.TaskConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A state_dict of seeded random weights for ``cfg``'s model (CPU, fp32)."""
    stt = cfg.speech_to_text
    model = build_model(stt, torch.float32,
                        preprocess_out_features(stt.pre_process_steps))
    init_params(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


def build_rnnt_decode_helpers(model: RNNT):
    """``(predict_step, joint_fp_step, project_f, init_state_fn)``.

    The decoder runs in projected joint space: ``project_f`` maps the
    encoder output to the joint's first-layer space once per batch, and
    each joint evaluation inside the loop is one small product plus the
    tail.
    """
    return (model.predict_step, model.joint_from_fp, model.joint_project_f,
            model.init_state)


def build_decoder(cfg: S.SpeechToTextConfig, model: RNNT) -> Callable:
    """Build ``decode(f, f_lens, max_output_len=200) -> (tokens, lens)``.

    Greedy RNN-T only in this slice.
    """
    pc = cfg.post_process
    if not isinstance(pc, S.RNNTGreedyDecoderConfig):
        raise NotImplementedError(
            f"{type(pc).__name__} is not ported yet: ROADMAP.md Queue 1 "
            "(beam search: slice 2; CTC decoders: slice 3)")
    predict_step, joint_fp_step, project_f, init_state_fn = \
        build_rnnt_decode_helpers(model)

    def greedy(f, f_lens, max_output_len: int = 200):
        return rnnt_greedy_decode(
            project_f(f), f_lens, predict_step, joint_fp_step,
            init_state_fn(f.shape[0], f.device), blank_index=pc.blank_index,
            max_symbols_per_step=pc.max_symbols_per_step,
            max_output_len=max_output_len)

    return greedy


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def build_loss(cfg: S.SpeechToTextConfig) -> Callable:
    """``fn(logits, logit_lens, labels, label_lens, weights=None) -> loss``.

    The transducer loss runs the fused blank/emit front and the lattice in
    K3/K4 (``ops/cuda/rnnt_kernel.py::rnnt_loss_lattice``; their plain
    versions on the CPU).  The CTC loss is not ported yet.
    """
    lc = cfg.loss
    if not isinstance(lc, S.RNNTLossConfig):
        raise NotImplementedError(
            f"{type(lc).__name__} is not ported yet: ROADMAP.md Queue 1, "
            "slice 3 (CTC family)")
    red = lc.reduction.value

    def transducer(logits, logit_lens, labels, label_lens, weights=None):
        nll = rnnt_loss_lattice(logits, logit_lens, labels, label_lens,
                                blank_index=lc.blank_index)
        return weighted_reduce(nll, red, weights)

    return transducer


def build_fused_transducer_loss(cfg: S.SpeechToTextConfig,
                                force: bool = False) -> Optional[Callable]:
    """The T-chunked joint+loss (``ops/rnnt.py::rnnt_loss_fused``), or None
    when the config does not set ``RNNTLossConfig.fused_chunk_size`` (unless
    ``force``: the memory planner's fallback).

    Returns ``fused(model, f, f_lens, g, labels, label_lens, train=False,
    chunk_size=None, weights=None) -> loss``; the chunk defaults to the
    config's, else 32.
    """
    lc = cfg.loss
    if lc.fused_chunk_size is None and not force:
        return None
    default_chunk = lc.fused_chunk_size or 32
    red = lc.reduction.value

    def fused(model: RNNT, f, f_lens, g, labels, label_lens,
              train: bool = False, chunk_size: Optional[int] = None,
              weights=None):
        nll = rnnt_loss_fused(
            f, f_lens, g, labels, label_lens,
            lambda f_chunk: model.joint(f_chunk, g, train),
            blank_index=lc.blank_index, reduction="none",
            chunk_size=chunk_size or default_chunk)
        return weighted_reduce(nll, red, weights)

    return fused


def build_joint_tail_loss(cfg: S.SpeechToTextConfig, dtype: torch.dtype
                          ) -> Optional[Callable]:
    """The joint-tail transducer loss (the JAX package's
    ``build_pallas_joint_loss``): ``RNNT.joint_project`` (two small
    products), K5 and K6 for ``act(fp + gp) @ W2 + b2`` and the blank/emit
    front, then the lattice (K3, K4) and ``weighted_reduce``.  No ``(B, T,
    U+1, K)`` hidden or ``(B, T, U+1, V)`` logits tensor is built, forward
    or backward.

    Returns a callable with the signature of
    :func:`build_fused_transducer_loss`'s, or None when the joint's topology
    falls outside the kernels (not one hidden layer, another activation).
    The train-time dropout gate is the dispatcher's
    (``run/train.py::_select_joint_path``).
    """
    lc = cfg.loss
    jfc = cfg.model.joint.fc
    act = jfc.activation.name.lower()
    if not joint_tail_supported(act, jfc.num_hidden_layers, 0.0, False):
        return None
    red = lc.reduction.value
    mxu_dtype = str(dtype).rsplit(".", 1)[-1]

    def joint_tail(model: RNNT, f, f_lens, g, labels, label_lens,
                   train: bool = False, chunk_size: Optional[int] = None,
                   weights=None):
        del train, chunk_size  # no dropout in the kernels; nothing to chunk
        fp, gp = model.joint_project(f, g)
        dense = model.joint_net.rest.Dense_0
        lp_blank, lp_emit = joint_tail_blank_emit(
            fp, gp, dense.kernel, dense.bias, labels, lc.blank_index, act,
            20.0, mxu_dtype)
        ll = rnnt_lattice(lp_blank, lp_emit, f_lens, label_lens)
        return weighted_reduce(-ll, red, weights)

    return joint_tail


# ---------------------------------------------------------------------------
# Optimizer / schedule
# ---------------------------------------------------------------------------


def build_lr_schedule(cfg: S.TrainConfig, steps_per_epoch: int
                      ) -> Callable[[int], float]:
    """``schedule(step) -> lr``, step counted from 0, as the JAX package's
    optax schedules give it: constant, or cosine decay to ``eta_min``
    (``alpha = eta_min / base``); after ``lr_warmup_steps`` of linear warmup
    from 0 when set.  Step and exponential decay are not ported yet."""
    sc = cfg.lr_scheduler
    base = cfg.optimizer.learning_rate
    if sc is None or isinstance(sc, S.ConstantLRConfig):
        def inner(step: int) -> float:
            return base
    elif isinstance(sc, S.CosineAnnealingLRConfig):
        decay_steps = max(sc.t_max_epochs * steps_per_epoch, 1)
        alpha = sc.eta_min / base if base else 0.0

        def inner(step: int) -> float:
            cosine = 0.5 * (1 + math.cos(math.pi * min(step, decay_steps)
                                         / decay_steps))
            return base * ((1 - alpha) * cosine + alpha)
    else:
        raise NotImplementedError(
            f"{type(sc).__name__} is not ported yet: ROADMAP.md Queue 1, "
            "slice 2 (run loop)")
    warmup = cfg.lr_warmup_steps
    if warmup <= 0:
        return inner

    def schedule(step: int) -> float:
        if step < warmup:
            return base * step / warmup
        return inner(step - warmup)

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum(t^2))`` over all the tensors, in fp32, on their device."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """optax's ``chain(clip_by_global_norm, add_decayed_weights, adam)``
    over a model's parameters.

    :meth:`step` clips the gradients to optax's formula (``g / norm * max``
    when ``norm >= max``), then runs ``torch.optim.Adam``, whose
    ``weight_decay`` adds ``wd * p`` to the gradient before the update
    (coupled L2, optax's ``add_decayed_weights`` before Adam), with the
    learning rate ``schedule(step)``.  Nothing reads the gradients back
    to the host.
    """

    def __init__(self, params: List[torch.nn.Parameter],
                 inner: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 clip_norm: Optional[float]):
        self.params = params
        self.inner = inner
        self.schedule = schedule
        self.clip_norm = clip_norm

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, step: int) -> torch.Tensor:
        """Update the parameters from their gradients; returns the global
        norm of the unclipped gradients (fp32, on the device)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        if self.clip_norm is not None:
            keep = norm < self.clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        lr = self.schedule(step)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        return norm


def build_optimizer(cfg: S.TrainConfig, steps_per_epoch: int,
                    params: Iterable[torch.nn.Parameter]
                    ) -> Tuple[Optimizer, Callable[[int], float]]:
    """``(optimizer, schedule)`` for ``params``, as the JAX package's
    ``build_optimizer`` chains them."""
    sched = build_lr_schedule(cfg, steps_per_epoch)
    params = list(params)
    oc = cfg.optimizer
    if not isinstance(oc, S.AdamConfig):
        raise NotImplementedError(
            f"{type(oc).__name__} is not ported yet: ROADMAP.md Queue 1, "
            "slice 3 (CTC family)")
    inner = torch.optim.Adam(params, lr=0.0, betas=(oc.beta_1, oc.beta_2),
                             eps=oc.eps, weight_decay=oc.l2_weight_decay)
    return Optimizer(params, inner, sched, cfg.grad_clip_norm), sched


# ---------------------------------------------------------------------------
# Task bundle
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Task:
    """What the train and eval steps need from one TaskConfig (the JAX
    package's ``Task`` without datasets and decoder)."""

    cfg: S.TaskConfig
    alphabet: Alphabet
    dtype: torch.dtype
    in_features: int
    preprocess: Callable
    loss_fn: Callable
    lr_schedule: Callable[[int], float]
    steps_per_epoch: int
    # The T-chunked joint+loss when the config forces it
    # (``RNNTLossConfig.fused_chunk_size``), else None.
    fused_loss: Optional[Callable] = None
    # The same with a per-call chunk, for the memory planner.
    fused_loss_auto: Optional[Callable] = None
    # The joint-tail loss (K5, K6), None for a topology the kernels do not
    # take.
    joint_tail_loss: Optional[Callable] = None

    def build_model(self) -> RNNT:
        return build_model(self.cfg.speech_to_text, self.dtype,
                           self.in_features)

    def build_optimizer(self, params) -> Optimizer:
        return build_optimizer(self.cfg.train_config, self.steps_per_epoch,
                               params)[0]


def build_task(cfg: S.TaskConfig, steps_per_epoch: int = 1000,
               dtype: Optional[torch.dtype] = None) -> Task:
    stt = cfg.speech_to_text
    if not isinstance(stt.loss, S.RNNTLossConfig) \
            or not isinstance(stt.model, S.RNNTConfig):
        raise NotImplementedError(
            "only RNN-T tasks are ported yet: ROADMAP.md Queue 1, slice 3 "
            "(CTC family)")
    dtype = dtype or getattr(torch, cfg.train_config.compute_dtype)
    return Task(
        cfg=cfg, alphabet=Alphabet(stt.alphabet), dtype=dtype,
        in_features=preprocess_out_features(stt.pre_process_steps),
        preprocess=build_preprocess(stt.pre_process_steps),
        loss_fn=build_loss(stt),
        lr_schedule=build_lr_schedule(cfg.train_config, steps_per_epoch),
        steps_per_epoch=steps_per_epoch,
        fused_loss=build_fused_transducer_loss(stt),
        fused_loss_auto=build_fused_transducer_loss(stt, force=True),
        joint_tail_loss=build_joint_tail_loss(stt, dtype))
