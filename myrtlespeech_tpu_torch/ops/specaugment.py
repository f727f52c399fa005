"""SpecAugment (Park et al. 2019): port of ``myrtlespeech_tpu/ops/specaugment.py``.

Split in two so that the random draws and the mask arithmetic can be held
against the JAX package separately (``torch.Generator`` and ``jax.random``
give different numbers from the same seed):

- :func:`draw_spec_augment` draws each row's mask widths and starts from an
  explicit ``torch.Generator``, with the JAX package's distributions: a
  feature mask is ``[0, feature_mask]`` wide and starts in
  ``[0, F - width)``; a time mask is ``randint % (cap + 1)`` wide, with
  ``cap = min(time_mask, int(time_mask_ratio * frame_len))``, and starts at
  ``randint % max(frame_len - width, 1)``.
- :func:`apply_spec_augment` zeroes the masked feature columns and frames
  (the arithmetic of ``_mask_axis`` and ``spec_augment``, ``:15-64``).

The raw integers are drawn on the CPU generator and moved to the features'
device, where the per-row arithmetic runs, so the draw needs no copy of
``frame_lens`` back to the host.  Under data parallelism the generator comes
wrapped in a ``parallel/tensor.py::BatchShard``: :func:`spec_augment` then
gathers the global batch's ``frame_lens``, draws for the global batch and
keeps this rank's rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from myrtlespeech_tpu_torch.parallel.tensor import BatchShard


class SpecAugmentDraws(NamedTuple):
    f_starts: torch.Tensor  # (B, n_feature_masks) int64
    f_widths: torch.Tensor
    t_starts: torch.Tensor  # (B, n_time_masks) int64
    t_widths: torch.Tensor


def _raw(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randint(0, 2 ** 30, shape, generator=gen).to(device)


def draw_spec_augment(gen: torch.Generator, frame_lens: torch.Tensor,
                      n_features: int, *, feature_mask: int = 27,
                      time_mask: int = 100, n_feature_masks: int = 2,
                      n_time_masks: int = 2, time_mask_ratio: float = 1.0
                      ) -> SpecAugmentDraws:
    """Widths and starts of every mask for a batch with ``frame_lens (B,)``
    valid frames and ``n_features`` feature columns."""
    B = frame_lens.shape[0]
    dev = frame_lens.device
    lens = frame_lens.to(torch.int64)
    f_widths = _raw(gen, (B, n_feature_masks), dev) % (feature_mask + 1)
    f_starts = _raw(gen, (B, n_feature_masks), dev) \
        % torch.clamp(n_features - f_widths, min=1)
    cap = torch.clamp((time_mask_ratio * lens.float()).to(torch.int64),
                      max=time_mask)
    t_widths = _raw(gen, (B, n_time_masks), dev) % (cap[:, None] + 1)
    t_starts = _raw(gen, (B, n_time_masks), dev) \
        % torch.clamp(lens[:, None] - t_widths, min=1)
    return SpecAugmentDraws(f_starts, f_widths, t_starts, t_widths)


def _keep(starts: torch.Tensor, widths: torch.Tensor, length: int
          ) -> torch.Tensor:
    """``(B, length)`` bool: outside every ``[start, start + width)``."""
    pos = torch.arange(length, device=starts.device)[None, None, :]
    inside = (pos >= starts[:, :, None]) \
        & (pos < (starts + widths)[:, :, None])
    return ~inside.any(dim=1)


def apply_spec_augment(feats: torch.Tensor, draws: SpecAugmentDraws
                       ) -> torch.Tensor:
    """``feats (B, T, F)`` with the drawn feature columns and frames zeroed."""
    B, T, F = feats.shape
    keep_f = _keep(draws.f_starts, draws.f_widths, F)
    keep_t = _keep(draws.t_starts, draws.t_widths, T)
    out = feats * keep_f[:, None, :].to(feats.dtype)
    return out * keep_t[:, :, None].to(feats.dtype)


def spec_augment(gen, feats: torch.Tensor, frame_lens: torch.Tensor,
                 **kwargs) -> torch.Tensor:
    """Draw and apply: the port of ``spec_augment``; ``gen`` a
    ``torch.Generator`` or a ``BatchShard``, ``kwargs`` as
    :func:`draw_spec_augment`."""
    if not isinstance(gen, BatchShard):
        return apply_spec_augment(
            feats, draw_spec_augment(gen, frame_lens, feats.shape[2],
                                     **kwargs))
    draws = draw_spec_augment(gen.gen, gen.gather_rows(frame_lens),
                              feats.shape[2], **kwargs)
    return apply_spec_augment(feats,
                              SpecAugmentDraws(*map(gen.rows, draws)))
