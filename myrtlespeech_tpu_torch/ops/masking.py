"""Sequence-length bookkeeping (port of ``myrtlespeech_tpu/ops/masking.py``).

Every batched sequence tensor is a padded dense tensor with an integer
``lengths`` tensor beside it: activations are batch-major ``(B, T, ...)``,
``lengths[b]`` counts the valid leading frames of row ``b``, and frames at
``t >= lengths[b]`` are padding that must not influence results.
"""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_len: int,
                  dtype: torch.dtype = torch.bool) -> torch.Tensor:
    """``(B,) -> (B, max_len)`` mask; True where ``t < lengths[b]``."""
    t = torch.arange(max_len, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def mask_sequence(x: torch.Tensor, lengths: torch.Tensor, time_axis: int = 1,
                  value: float = 0.0) -> torch.Tensor:
    """Fill padded positions of ``x`` (dim 0 is B) along ``time_axis``."""
    T = x.shape[time_axis]
    shape = [1] * x.ndim
    shape[0] = x.shape[0]
    shape[time_axis] = T
    mask = sequence_mask(lengths, T).reshape(shape)
    return torch.where(mask, x, torch.full((), value, dtype=x.dtype,
                                           device=x.device))


def time_reduction_out_lens(lengths, factor: int):
    """Output lengths after stacking ``factor`` consecutive frames (ceil)."""
    return (lengths + factor - 1) // factor
