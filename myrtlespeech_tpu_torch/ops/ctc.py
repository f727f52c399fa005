"""CTC loss (port of ``myrtlespeech_tpu/ops/ctc.py``).

The port has one CTC lattice: K7 and K8 (``ops/cuda/ctc_kernel.py``) on the
card, their plain versions on the CPU.  :func:`ctc_loss` is the JAX
package's ``ctc_loss`` on top of it: ``log_softmax`` inside, the blank
anywhere in the vocabulary, zero-length targets allowed, and torch's
reductions ('mean' divides each example's loss by its target length, at
least 1, before the batch mean).
"""

from __future__ import annotations

import torch

from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel
from myrtlespeech_tpu_torch.ops.rnnt import weighted_reduce


def extended_labels(labels: torch.Tensor, blank_index: int) -> torch.Tensor:
    """Interleave blanks: labels ``(B, U)`` -> ``(B, 2U+1)``, blank at every
    even position (``_extended_labels``)."""
    B, U = labels.shape
    ext = torch.full((B, 2 * U + 1), blank_index, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def ctc_loss(logits: torch.Tensor, logit_lens: torch.Tensor,
             labels: torch.Tensor, label_lens: torch.Tensor,
             blank_index: int = 0, reduction: str = "mean") -> torch.Tensor:
    """CTC loss of raw logits ``(B, T, V)`` for ``labels (B, U)``: 'none'
    gives the per-example negative log-likelihoods ``(B,)``, 'sum' their
    sum, 'mean' torch's CTC mean."""
    nll = ctc_kernel.ctc_loss_lattice(logits, logit_lens, labels, label_lens,
                                      blank_index)
    return weighted_reduce(nll, reduction, None, label_lens, ctc_mean=True)
