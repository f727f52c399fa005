"""RNN-T (transducer) loss: port of ``myrtlespeech_tpu/ops/rnnt.py``.

- :func:`blank_emit_from_logits`: the fused front, ``log_softmax`` over V
  reduced at once to the two lattice inputs, with the single-pass
  hand-written backward of ``_blank_emit_direct_bwd`` (``:90-101``).  It is
  plain PyTorch: the JAX package writes it in XLA, not as a Pallas kernel.
- :func:`weighted_reduce`: the one loss reduction of the port (``none``,
  ``sum`` or ``mean``, with optional per-example weights).
- :func:`rnnt_log_likelihood_from_blank_emit` and :func:`rnnt_loss`: the
  plain lattice recursion (a time loop, each row solved by the Hillis-Steele
  scan in the log semiring), differentiated by autograd.  The training path
  runs the lattice through K3 and K4 instead
  (``ops/cuda/rnnt_kernel.py::rnnt_loss_lattice``); this one is kept for the
  tests.
- :func:`rnnt_loss_fused`: the joint and the front run one T-chunk at a
  time, each chunk recomputed in backward, then the lattice (K3, K4).

fp32 throughout the lattice, whatever the logits' dtype; -1e30 stands for
-inf.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from myrtlespeech_tpu_torch.ops.cuda.rnnt_kernel import (NEG_INF, linrec_scan,
                                                         rnnt_lattice)


class BlankEmitFunction(torch.autograd.Function):
    """``(logits (B, T, U+1, V), lab (B, U+1), blank_index) -> (lp_blank,
    lp_emit)``, each ``(B, T, U+1)`` fp32: ``log_softmax(logits)`` at the
    blank and at ``lab[b, u]``, without keeping the log-softmax tensor.

    Backward, in one pass over the logits:
    ``dx = gb * onehot(blank) + ge * onehot(lab) - (gb + ge) * softmax(x)``,
    returned in the logits' dtype.
    """

    @staticmethod
    def forward(ctx, logits, lab, blank_index):
        x = logits.float()
        m = x.amax(dim=-1)
        lse = m + torch.log(torch.exp(x - m[..., None]).sum(dim=-1))
        xb = x[..., blank_index]
        B, T, U1, _ = x.shape
        idx = lab.long()[:, None, :, None].expand(B, T, U1, 1)
        xe = torch.gather(x, -1, idx)[..., 0]
        ctx.save_for_backward(logits, lab, lse)
        ctx.blank_index = blank_index
        return xb - lse, xe - lse

    @staticmethod
    def backward(ctx, gb, ge):
        logits, lab, lse = ctx.saved_tensors
        x = logits.float()
        B, T, U1, V = x.shape
        softmax = torch.exp(x - lse[..., None])
        onehots = torch.zeros_like(x)
        onehots[..., ctx.blank_index] = gb
        idx = lab.long()[:, None, :, None].expand(B, T, U1, 1)
        onehots.scatter_add_(-1, idx, ge[..., None])
        dx = onehots - (gb + ge)[..., None] * softmax
        return dx.to(logits.dtype), None, None


def blank_emit_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                           blank_index: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blank/emit log-probs ``(B, T, U+1)`` fp32 from raw joint logits
    ``(B, T, U+1, V)`` and ``labels (B, U)`` (the last column of ``lp_emit``
    is unused: the lattice masks it by ``label_lens``)."""
    B = logits.shape[0]
    lab = torch.cat([labels.to(torch.int32),
                     torch.zeros((B, 1), dtype=torch.int32,
                                 device=labels.device)], dim=1)
    return BlankEmitFunction.apply(logits, lab, blank_index)


def rnnt_log_likelihood_from_blank_emit(lp_blank: torch.Tensor,
                                        lp_emit: torch.Tensor,
                                        logit_lens: torch.Tensor,
                                        label_lens: torch.Tensor
                                        ) -> torch.Tensor:
    """The plain transducer lattice recursion: ``(B,)`` fp32
    log-likelihoods from ``lp_blank, lp_emit (B, T, U+1)`` fp32.

        alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                                alpha[t,  u-1] + emit[t,  u-1])

    with the state held past each ``logit_len`` and the terminal
    ``alpha[T_b-1, U_b] + blank[T_b-1, U_b]`` taken per example.
    """
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    lp_blank, lp_emit = lp_blank.float(), lp_emit.float()
    logit_lens = logit_lens.to(dev, torch.long)
    label_lens = label_lens.to(dev, torch.long)
    emit_ok = torch.arange(U1, device=dev)[None, :] < label_lens[:, None]
    lp_emit = torch.where(emit_ok[:, None, :], lp_emit, NEG_INF)

    e0 = lp_emit[:, 0]
    alpha = torch.cat([torch.zeros((B, 1), device=dev),
                       torch.cumsum(e0[:, :-1], dim=1)], dim=1)
    alpha = torch.clamp(alpha, min=NEG_INF)
    neg = torch.full((B, 1), NEG_INF, device=dev)
    for t in range(1, T):
        a = alpha + lp_blank[:, t - 1]
        c = torch.cat([neg, lp_emit[:, t, :-1]], dim=1)
        new = linrec_scan(a, c)
        alpha = torch.where((t < logit_lens)[:, None], new, alpha)

    a_final = torch.gather(alpha, 1, label_lens[:, None])[:, 0]
    last_t = torch.clamp(logit_lens - 1, min=0)
    blank_last = torch.gather(
        lp_blank, 1, last_t[:, None, None].expand(B, 1, U1))[:, 0]
    b_final = torch.gather(blank_last, 1, label_lens[:, None])[:, 0]
    return torch.clamp(a_final + b_final, min=NEG_INF)


def weighted_reduce(nll: torch.Tensor, reduction: str,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Loss reduction (``builders/build.py::weighted_reduce`` of the JAX
    package) with optional 0/1 per-example ``weights (B,)``, which mask
    duplicated fill rows out of the batch statistic; transducer 'mean' is the
    plain batch mean (warp-transducer semantics)."""
    if reduction == "none":
        return nll
    if reduction not in ("sum", "mean"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if weights is None:
        return nll.sum() if reduction == "sum" else nll.mean()
    w = weights.to(nll.dtype)
    if reduction == "sum":
        return (nll * w).sum()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def rnnt_loss(logits: torch.Tensor, logit_lens: torch.Tensor,
              labels: torch.Tensor, label_lens: torch.Tensor,
              blank_index: int = 0, reduction: str = "mean") -> torch.Tensor:
    """Transducer loss from raw joint logits ``(B, T, U+1, V)`` through the
    plain lattice.  'mean' averages per-example losses over the batch
    (warp-transducer semantics, no division by label length)."""
    lp_blank, lp_emit = blank_emit_from_logits(logits, labels, blank_index)
    nll = -rnnt_log_likelihood_from_blank_emit(lp_blank, lp_emit, logit_lens,
                                               label_lens)
    return weighted_reduce(nll, reduction)


def rnnt_loss_fused(f: torch.Tensor, f_lens: torch.Tensor, g: torch.Tensor,
                    labels: torch.Tensor, label_lens: torch.Tensor,
                    joint_apply: Callable[[torch.Tensor], torch.Tensor], *,
                    blank_index: int = 0, reduction: str = "mean",
                    chunk_size: int = 32) -> torch.Tensor:
    """Transducer loss fused with the joint network, chunked over T (port of
    ``myrtlespeech_tpu/ops/rnnt.py:232-279``).

    The joint runs one T-chunk at a time; each chunk reduces at once to its
    part of the two ``(B, T, U+1)`` lattice inputs, and its activations are
    recomputed in backward (``torch.utils.checkpoint``), so the full ``(B,
    T, U+1, H_joint)`` hidden and ``(B, T, U+1, V)`` logits never exist at
    once.  T is padded to a multiple of the chunk and the padding cut before
    the lattice, which runs K3 and K4 on the card (their plain versions on
    the CPU).

    ``f (B, T, H_enc)``, ``g (B, U+1, H_pred)``; ``joint_apply(f_chunk (B,
    tc, H_enc)) -> logits (B, tc, U+1, V)``.  Returns the reduced loss, as
    :func:`rnnt_loss`.
    """
    B, T, _ = f.shape
    tc = min(chunk_size, T)
    pad = (-T) % tc
    f_pad = torch.nn.functional.pad(f, (0, 0, 0, pad))

    def chunk_fn(f_chunk):
        return blank_emit_from_logits(joint_apply(f_chunk), labels,
                                      blank_index)

    parts = [checkpoint(chunk_fn, f_pad[:, i:i + tc], use_reentrant=False)
             for i in range(0, T + pad, tc)]
    lp_blank = torch.cat([p[0] for p in parts], dim=1)[:, :T]
    lp_emit = torch.cat([p[1] for p in parts], dim=1)[:, :T]
    nll = -rnnt_lattice(lp_blank, lp_emit, f_lens, label_lens)
    return weighted_reduce(nll, reduction)
