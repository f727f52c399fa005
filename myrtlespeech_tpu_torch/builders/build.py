"""Builders: TaskConfig -> modules and callables for serving and training.

Port of ``myrtlespeech_tpu/builders/build.py`` for the RNN-T and
DeepSpeech2: ``vocab_size`` (``:58``), ``build_preprocess`` and
``preprocess_out_features`` (``:67-137``), ``validate_model_shapes`` for a
conv block and ``build_model`` for RNN-T and DeepSpeech2 (``:145-202``),
the CTC and transducer ``build_loss`` (``:213-275``; its
``weighted_reduce`` lives in ``ops/rnnt.py``),
``build_fused_transducer_loss`` (``:277-311``),
:func:`build_joint_tail_loss` (``build_pallas_joint_loss``, ``:314-372``),
``validate`` (``:374-387``), ``build_rnnt_decode_helpers`` and
``build_decoder`` for the CTC greedy and beam decoders (with their LMs) and
the RNN-T greedy and beam decoders (``:395-502``), ``build_lr_schedule`` and
``build_optimizer`` (``:510-563``), ``build_dataset`` (``:571-579``),
``Task`` and ``build_task``, and :func:`init_params`, which fills a model
with seeded random weights drawn the way Flax's initialisers draw them.
Unlike the JAX package's, ``build_task`` builds no dataset: a ``Task``
builds each at its first access (``fit`` and the CLI), so that the serve and
step paths run where a config's corpus is not on disk.

Blank-index convention: the output vocabulary is
``max(len(alphabet), blank_index + 1)``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.data.alphabet import Alphabet
from myrtlespeech_tpu_torch.data.dataset.fake import FakeSpeechToText
from myrtlespeech_tpu_torch.data.dataset.librispeech import LibriSpeech
from myrtlespeech_tpu_torch.data.dataset.synthetic import SyntheticSpeech
from myrtlespeech_tpu_torch.decoding.ctc_beam import (WordLMTensors,
                                                      ctc_beam_decode)
from myrtlespeech_tpu_torch.decoding.ctc_greedy import ctc_greedy_decode
from myrtlespeech_tpu_torch.decoding.lm import load_bigram_lm, load_word_lm
from myrtlespeech_tpu_torch.decoding.rnnt_beam import rnnt_beam_decode
from myrtlespeech_tpu_torch.decoding.rnnt_greedy import rnnt_greedy_decode
from myrtlespeech_tpu_torch.models.cnn import conv_block_out_features
from myrtlespeech_tpu_torch.models.deep_speech_2 import DeepSpeech2
from myrtlespeech_tpu_torch.models.rnn_t import RNNT
from myrtlespeech_tpu_torch.ops import features as F
from myrtlespeech_tpu_torch.ops.ctc import ctc_loss
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
                    "yet: ROADMAP.md Queue 1 item 5 (DeepSpeech1: MFCC, "
                    "context frames)")
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


def validate_model_shapes(model_cfg: S.ModelConfig, in_features: int) -> None:
    """Raise ``ValueError``, naming the layer, when a DeepSpeech2 conv block
    collapses the feature dim to 0 or below."""
    if not isinstance(model_cfg, S.DeepSpeech2Config):
        return
    for i in range(len(model_cfg.conv_block)):
        f = conv_block_out_features(model_cfg.conv_block[:i + 1], in_features)
        if f <= 0:
            c = model_cfg.conv_block[i]
            raise ValueError(
                f"DeepSpeech2 conv layer {i} collapses the feature dim to "
                f"{f // c.out_channels} (kernel_feature={c.kernel_feature}, "
                f"stride_feature={c.stride_feature}, "
                f"padding={c.padding.name}); with {in_features} input "
                "features every conv output dim must be > 0")


def build_model(cfg: S.SpeechToTextConfig, dtype: torch.dtype,
                in_features: int) -> nn.Module:
    m = cfg.model
    validate_model_shapes(m, in_features)
    if isinstance(m, S.RNNTConfig):
        return RNNT(m, vocab_size=vocab_size(cfg), in_features=in_features,
                    dtype=dtype)
    if isinstance(m, S.DeepSpeech2Config):
        return DeepSpeech2(m, out_features=vocab_size(cfg),
                           in_features=in_features, dtype=dtype)
    raise NotImplementedError(
        f"{type(m).__name__} is not ported yet: ROADMAP.md Queue 1 item 5 "
        "(DeepSpeech1) or item 6 (VGG, encoder-decoder)")


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
    draw them: Xavier-uniform ``w_ih`` and lookahead weights, orthogonal
    ``w_hh``, LeCun-normal dense and conv kernels (fan-in ``in`` of ``(in,
    out)``, ``kt * kf * in`` of a conv's ``(kt, kf, in, out)``),
    unit-variance-over-fan-in embeddings; biases and BatchNorm scales keep
    their construction values (zeros, ones, plus any forget-gate bias)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("_w_ih") or leaf == "weight":
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
        elif leaf.endswith("_w_hh"):
            p.copy_(_orthogonal(tuple(p.shape), gen))
        elif leaf == "kernel":
            p.copy_(torch.randn(p.shape, generator=gen)
                    / math.sqrt(math.prod(p.shape[:-1])))
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


def is_transducer(cfg: S.SpeechToTextConfig) -> bool:
    return isinstance(cfg.model, S.RNNTConfig)


def validate(cfg: S.SpeechToTextConfig) -> None:
    """Cross-field checks the reference's builders enforce."""
    transducer_model = is_transducer(cfg)
    transducer_loss = isinstance(cfg.loss, S.RNNTLossConfig)
    if transducer_model != transducer_loss:
        raise ValueError("RNNT model requires rnn_t_loss and vice versa")
    transducer_decoder = isinstance(
        cfg.post_process,
        (S.RNNTGreedyDecoderConfig, S.RNNTBeamDecoderConfig))
    if transducer_model != transducer_decoder:
        raise ValueError("model family and decoder family must match")
    if cfg.post_process.blank_index != cfg.loss.blank_index:
        raise ValueError("decoder and loss blank_index must agree")


def build_decoder(cfg: S.SpeechToTextConfig,
                  model: Optional[RNNT] = None) -> Callable:
    """Build ``decode(...) -> (tokens, lens)`` on the inputs' device.

    A CTC decoder takes ``(logits, logit_lens)``; its LM tables are loaded
    here and copied to a device once, at its first call there.  The greedy
    RNN-T decoder takes ``(f, f_lens, max_output_len=200)`` (the encoder's
    output) and drives ``model``'s prediction and joint nets; the RNN-T
    beam decoder takes the same and also ``tally`` (see
    :func:`~myrtlespeech_tpu_torch.decoding.rnnt_beam.rnnt_beam_decode`).
    Both run in projected joint space, the beam's prediction net at
    ``B * beam_width`` rows.
    """
    pc = cfg.post_process
    if isinstance(pc, S.CTCGreedyDecoderConfig):
        return functools.partial(ctc_greedy_decode,
                                 blank_index=pc.blank_index)
    if isinstance(pc, S.CTCBeamDecoderConfig):
        lm_bigram = None
        if pc.lm_bigram_path is not None:
            lm_bigram = torch.as_tensor(load_bigram_lm(
                pc.lm_bigram_path, vocab_size=vocab_size(cfg)))
        word_lm = None
        if pc.word_lm_path is not None:
            if pc.separator_index is None:
                raise ValueError(
                    "word_lm_path requires separator_index (the word "
                    "boundary symbol the LM scores on)")
            word_lm = WordLMTensors.from_word_lm(
                load_word_lm(pc.word_lm_path))
        on_device = {}  # device -> (lm_bigram, word_lm) there

        def beam(logits, logit_lens):
            dev = logits.device
            if dev not in on_device:
                on_device[dev] = (
                    None if lm_bigram is None else lm_bigram.to(dev),
                    None if word_lm is None else word_lm.to(dev))
            bigram, words = on_device[dev]
            return ctc_beam_decode(
                logits, logit_lens, blank_index=pc.blank_index,
                beam_width=pc.beam_width,
                prune_threshold=pc.prune_threshold,
                word_count_beta=pc.word_count_beta,
                separator_index=pc.separator_index,
                lm_alpha=pc.lm_alpha if bigram is not None else None,
                lm_bigram=bigram,
                word_lm_alpha=(pc.word_lm_alpha if words is not None
                               else None),
                word_lm=words, expand_topk=pc.expand_topk)

        return beam
    predict_step, joint_fp_step, project_f, init_state_fn = \
        build_rnnt_decode_helpers(model)
    if isinstance(pc, S.RNNTGreedyDecoderConfig):
        def greedy(f, f_lens, max_output_len: int = 200):
            return rnnt_greedy_decode(
                project_f(f), f_lens, predict_step, joint_fp_step,
                init_state_fn(f.shape[0], f.device),
                blank_index=pc.blank_index,
                max_symbols_per_step=pc.max_symbols_per_step,
                max_output_len=max_output_len)

        return greedy
    if isinstance(pc, S.RNNTBeamDecoderConfig):
        def beam(f, f_lens, max_output_len: int = 200, tally=None):
            return rnnt_beam_decode(
                project_f(f), f_lens, predict_step, joint_fp_step,
                init_state_fn(f.shape[0] * pc.beam_width, f.device),
                blank_index=pc.blank_index, beam_width=pc.beam_width,
                length_norm=pc.length_norm,
                max_symbols_per_step=pc.max_symbols_per_step,
                max_output_len=max_output_len, expand_topk=pc.expand_topk,
                speculative_frames=pc.speculative_frames, tally=tally)

        return beam
    raise ValueError(f"unknown decoder config {type(pc)}")


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def build_loss(cfg: S.SpeechToTextConfig) -> Callable:
    """``fn(logits, logit_lens, labels, label_lens, weights=None) -> loss``.

    The CTC loss runs the lattice in K7/K8 (``ops/ctc.py::ctc_loss``,
    per example, then torch's CTC 'mean'); the transducer loss runs the
    fused blank/emit front and the lattice in K3/K4
    (``ops/cuda/rnnt_kernel.py::rnnt_loss_lattice``).  Both take their plain
    versions on the CPU.
    """
    lc = cfg.loss
    red = lc.reduction.value
    if isinstance(lc, S.CTCLossConfig):
        def ctc(logits, logit_lens, labels, label_lens, weights=None):
            nll = ctc_loss(logits, logit_lens, labels, label_lens,
                           blank_index=lc.blank_index, reduction="none")
            return weighted_reduce(nll, red, weights, label_lens,
                                   ctc_mean=True)

        return ctc

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
    chunk_size=None, weights=None, gen=None) -> loss``; the chunk defaults
    to the config's, else 32.  The joint's dropout masks are drawn from
    ``gen`` once a call, at one chunk's shape, outside the chunks'
    recomputation: every chunk, and its recomputation in backward, reuses
    them (the JAX package's chunks reuse one dropout key likewise).
    """
    lc = cfg.loss
    if lc.fused_chunk_size is None and not force:
        return None
    default_chunk = lc.fused_chunk_size or 32
    red = lc.reduction.value

    def fused(model: RNNT, f, f_lens, g, labels, label_lens,
              train: bool = False, chunk_size: Optional[int] = None,
              weights=None, gen: Optional[torch.Generator] = None):
        chunk = chunk_size or default_chunk
        B, T, _ = f.shape
        masks = model.joint_net.dropout_masks((B, min(chunk, T), g.shape[1]),
                                              train, gen)
        nll = rnnt_loss_fused(
            f, f_lens, g, labels, label_lens,
            lambda f_chunk: model.joint(f_chunk, g, train, masks=masks),
            blank_index=lc.blank_index, reduction="none", chunk_size=chunk)
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
                   weights=None, gen: Optional[torch.Generator] = None):
        # No dropout in the kernels; nothing to chunk.
        del train, chunk_size, gen
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
    optax schedules give it: constant; step decay ``base * gamma ** floor(step
    / (step_size_epochs * steps_per_epoch))``; exponential decay, the same a
    transition per epoch; or cosine decay to ``eta_min`` (``alpha = eta_min /
    base``).  After ``lr_warmup_steps`` of linear warmup from 0 when set, the
    decay starts from its own step 0."""
    sc = cfg.lr_scheduler
    base = cfg.optimizer.learning_rate
    if sc is None or isinstance(sc, S.ConstantLRConfig):
        def inner(step: int) -> float:
            return base
    elif isinstance(sc, (S.StepLRConfig, S.ExponentialLRConfig)):
        transition = steps_per_epoch * (
            sc.step_size_epochs if isinstance(sc, S.StepLRConfig) else 1)
        gamma = sc.gamma

        def inner(step: int) -> float:
            if transition <= 0:  # optax's exponential_decay: constant
                return base
            return base * gamma ** (step // transition)
    elif isinstance(sc, S.CosineAnnealingLRConfig):
        decay_steps = max(sc.t_max_epochs * steps_per_epoch, 1)
        alpha = sc.eta_min / base if base else 0.0

        def inner(step: int) -> float:
            cosine = 0.5 * (1 + math.cos(math.pi * min(step, decay_steps)
                                         / decay_steps))
            return base * ((1 - alpha) * cosine + alpha)
    else:
        raise ValueError(f"unknown lr scheduler {type(sc)}")
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
    """optax's ``chain(clip_by_global_norm, add_decayed_weights, adam or
    sgd)`` over a model's parameters.

    :meth:`step` clips the gradients to optax's formula (``g / norm * max``
    when ``norm >= max``), then runs the inner ``torch.optim.Adam`` or
    ``torch.optim.SGD``, whose ``weight_decay`` adds ``wd * p`` to the
    gradient before the update (coupled L2, optax's ``add_decayed_weights``
    before the optimizer), with the learning rate ``schedule(step)``.
    Nothing reads the gradients back to the host.
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
    if isinstance(oc, S.SGDConfig):
        # optax's trace (v = g + momentum * v, nesterov: g + momentum * v)
        # then -lr * v: torch's SGD with dampening 0.
        inner = torch.optim.SGD(params, lr=0.0, momentum=oc.momentum,
                                dampening=0.0, nesterov=oc.nesterov,
                                weight_decay=oc.l2_weight_decay)
    elif isinstance(oc, S.AdamConfig):
        inner = torch.optim.Adam(params, lr=0.0,
                                 betas=(oc.beta_1, oc.beta_2), eps=oc.eps,
                                 weight_decay=oc.l2_weight_decay)
    else:
        raise ValueError(f"unknown optimizer {type(oc)}")
    return Optimizer(params, inner, sched, cfg.grad_clip_norm), sched


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


def build_dataset(cfg: S.DatasetConfig):
    """The map-style dataset of ``cfg``: items ``(waveform, transcript)``."""
    if isinstance(cfg, S.FakeSpeechToTextConfig):
        return FakeSpeechToText(cfg)
    if isinstance(cfg, S.LibriSpeechConfig):
        return LibriSpeech(cfg)
    if isinstance(cfg, S.SyntheticSpeechConfig):
        return SyntheticSpeech(cfg)
    raise ValueError(f"unknown dataset config {type(cfg)}")


# ---------------------------------------------------------------------------
# Task bundle
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Task:
    """What the train and eval steps and ``fit`` need from one TaskConfig.
    The transducer's fused losses are None for a CTC task.  The datasets are
    built at their first access (LibriSpeech raises when its directory is
    missing); assigning one replaces it.

    ``decoder`` is a CTC task's decoder, ``(logits, logit_lens) ->
    (tokens, lens)``, and None for a transducer, whose decoder drives the
    model: ``build_decoder(cfg.speech_to_text, model)`` builds it."""

    cfg: S.TaskConfig
    alphabet: Alphabet
    dtype: torch.dtype
    in_features: int
    preprocess: Callable
    loss_fn: Callable
    lr_schedule: Callable[[int], float]
    steps_per_epoch: int
    decoder: Optional[Callable]
    # The T-chunked joint+loss when the config forces it
    # (``RNNTLossConfig.fused_chunk_size``), else None.
    fused_loss: Optional[Callable] = None
    # The same with a per-call chunk, for the memory planner.
    fused_loss_auto: Optional[Callable] = None
    # The joint-tail loss (K5, K6), None for a topology the kernels do not
    # take.
    joint_tail_loss: Optional[Callable] = None

    @property
    def transducer(self) -> bool:
        return is_transducer(self.cfg.speech_to_text)

    def build_model(self) -> nn.Module:
        return build_model(self.cfg.speech_to_text, self.dtype,
                           self.in_features)

    def build_optimizer(self, params) -> Optimizer:
        return build_optimizer(self.cfg.train_config, self.steps_per_epoch,
                               params)[0]

    @functools.cached_property
    def train_dataset(self):
        return build_dataset(self.cfg.train_dataset)

    @functools.cached_property
    def eval_dataset(self):
        if self.cfg.eval_dataset is None:
            return None
        return build_dataset(self.cfg.eval_dataset)


def build_task(cfg: S.TaskConfig, steps_per_epoch: int = 1000,
               dtype: Optional[torch.dtype] = None) -> Task:
    stt = cfg.speech_to_text
    validate(stt)
    dtype = dtype or getattr(torch, cfg.train_config.compute_dtype)
    transducer = is_transducer(stt)
    task = Task(
        cfg=cfg, alphabet=Alphabet(stt.alphabet), dtype=dtype,
        in_features=preprocess_out_features(stt.pre_process_steps),
        preprocess=build_preprocess(stt.pre_process_steps),
        loss_fn=build_loss(stt),
        lr_schedule=build_lr_schedule(cfg.train_config, steps_per_epoch),
        steps_per_epoch=steps_per_epoch,
        decoder=None if transducer else build_decoder(stt))
    if transducer:
        task.fused_loss = build_fused_transducer_loss(stt)
        task.fused_loss_auto = build_fused_transducer_loss(stt, force=True)
        task.joint_tail_loss = build_joint_tail_loss(stt, dtype)
    return task
