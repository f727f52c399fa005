"""Length-masked batch normalisation (port of ``models/normalization.py``).

BatchNorm over the features of a padded ``(B, T, F)`` batch whose
statistics count valid frames only (``t < lengths[b]``).  The variance is
the biased one (divided by the count), the running statistics follow
Flax's momentum (``ra = 0.9 ra + 0.1 batch``), and the arithmetic is fp32,
cast to the compute dtype at the end.  ``torch.nn.BatchNorm1d`` would count
the padded frames and keep an unbiased running variance, so it is not used.

``scale`` and ``bias`` are parameters; ``mean`` and ``var`` are buffers,
named as the JAX package's ``batch_stats`` leaves.  Under data parallelism
the masked sums and the count are summed over the data group
(``parallel/tensor.py::sum_over_data``), so the statistics are the global
batch's, as GSPMD computes them, and the running ones move alike on every
rank.
"""

from __future__ import annotations

import torch
from torch import nn

from myrtlespeech_tpu_torch.ops.masking import sequence_mask
from myrtlespeech_tpu_torch.parallel.tensor import sum_over_data


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """``x (B, T, F)``: normalised with this batch's statistics over its
        valid frames at train time (which also moves the running ones), with
        the running statistics otherwise."""
        xf = x.float()
        if train:
            m = sequence_mask(lengths.to(x.device), x.shape[1],
                              torch.float32)[:, :, None]
            sums = sum_over_data(self, torch.cat([(xf * m).sum(dim=(0, 1)),
                                                  m.sum()[None]]))
            n = torch.clamp(sums[-1], min=1.0)
            mean = sums[:-1] / n
            var = sum_over_data(self, (((xf - mean) * m) ** 2).sum(
                dim=(0, 1))) / n
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1.0 - self.momentum)
                                                   * mean)
                self.var.mul_(self.momentum).add_((1.0 - self.momentum)
                                                  * var)
        else:
            mean, var = self.mean, self.var
        out = (xf - mean) * (var + self.eps) ** -0.5 * self.scale + self.bias
        return out.to(self.dtype)
