"""Batched CTC greedy decoding on the logits' device.

Port of ``myrtlespeech_tpu/decoding/ctc_greedy.py``: argmax over the
vocabulary, a keep-mask (``!= blank``, ``!= previous``, ``t < len``) and a
compaction of the kept symbols by cumulative sum.  The whole batch decodes
in a handful of tensor operations, with no host loop and no copy to the
host.
"""

from __future__ import annotations

import torch


def ctc_greedy_decode(logits: torch.Tensor, logit_lens: torch.Tensor,
                      blank_index: int = 0):
    """Decode ``(B, T, V)`` logits (or log-probs: argmax is invariant).

    Returns ``(tokens (B, T) int32, token_lens (B,) int32)``: row ``b``
    holds the decoded symbols left-aligned, padded with 0.
    """
    B, T, _ = logits.shape
    a = logits.argmax(-1).to(torch.int32)  # the first maximum, as JAX's
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32,
                                 device=a.device), a[:, :-1]], dim=1)
    valid = torch.arange(T, device=a.device)[None, :] \
        < logit_lens.to(a.device)[:, None]
    keep = (a != blank_index) & (a != prev) & valid
    # JAX scatters the dropped symbols out of range (mode="drop"); here they
    # land in an extra last column, which is cut off.
    pos = torch.where(keep, keep.cumsum(1) - 1, T)
    out = torch.zeros((B, T + 1), dtype=torch.int32, device=a.device)
    out.scatter_(1, pos, a)
    return out[:, :T], keep.sum(1, dtype=torch.int32)
