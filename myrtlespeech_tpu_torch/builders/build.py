"""Builders: TaskConfig -> serving modules and callables.

Port of ``myrtlespeech_tpu/builders/build.py`` for the serving slice:
``vocab_size`` (``:58``), ``build_preprocess`` and ``preprocess_out_features``
(``:67-137``), ``build_model`` for RNN-T (``:188-202``),
``build_rnnt_decode_helpers`` and the greedy ``build_decoder``
(``:395-488``), and :func:`init_params`, which fills a model with seeded
random weights drawn the way Flax's initialisers draw them.

Blank-index convention: the output vocabulary is
``max(len(alphabet), blank_index + 1)``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.decoding.rnnt_greedy import rnnt_greedy_decode
from myrtlespeech_tpu_torch.models.rnn_t import RNNT
from myrtlespeech_tpu_torch.ops import features as F


def vocab_size(cfg: S.SpeechToTextConfig) -> int:
    return max(len(cfg.alphabet), cfg.loss.blank_index + 1)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def build_preprocess(steps: Tuple[S.PreProcessStepConfig, ...]) -> Callable:
    """Build ``fn(wav, wav_lens, train=False) -> (feats, frame_lens)``.

    TRAIN-stage steps are skipped at eval.  Steps outside the serving slice
    raise ``NotImplementedError``.
    """

    def apply(wav: torch.Tensor, wav_lens: torch.Tensor, train: bool = False):
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
                raise NotImplementedError(
                    "SpecAugment at train time is not ported yet: "
                    "ROADMAP.md Queue 1, slice 2 (training)")
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
