"""VGG-style conv front end (port of ``models/vgg.py``).

torchvision's cfgs A and B, built from 3x3 stride-1 SAME convolutions (each
with an optional BatchNorm, then ReLU) and 2x2 stride-2 VALID max-pools
between blocks; ``use_output_from_block`` keeps the first blocks.  Features
``(B, T, F)`` are an image with time first; the output is ``(B, T', F' *
C)`` with C fastest, as Flax flattens ``(B, T', F', C)``, and the lengths,
halved (floor) by each pool.  Each convolution's input is masked past each
sequence's length, and so is the output.

The convolutions and pools are ``torch.nn.functional.conv2d`` and
``max_pool2d`` (cuDNN on the card): the JAX package computes them with XLA,
outside any Pallas kernel.  The image runs NCHW inside; a conv's kernel
keeps Flax's ``(3, 3, in, out)`` layout, so that the weight bridge stays a
rename.  The BatchNorm is Flax's plain ``nn.BatchNorm`` (:class:`BatchNorm`),
not the masked one: statistics over every ``B * T * F`` position, padding
included.  Submodules carry Flax's names, ``Conv_{i}`` and ``BatchNorm_{i}``,
numbered by kind.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from myrtlespeech_tpu_torch.config.schema import (Conv2dConfig, PaddingMode,
                                                  VGGCfg, VGGConfig)
from myrtlespeech_tpu_torch.models.cnn import Conv
from myrtlespeech_tpu_torch.ops import masking
from myrtlespeech_tpu_torch.parallel.tensor import sum_over_data

# torchvision cfgs: ints = conv out-channels, "M" = 2x2 max-pool.
_CFGS = {
    VGGCfg.A: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M",
               512, 512, "M"),
    VGGCfg.B: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
               512, 512, "M"),
}


def _truncate(cfg: Tuple[Union[int, str], ...], n_blocks: int):
    """The items of ``cfg`` up to and with the ``n_blocks``-th pool."""
    out, blocks = [], 0
    for item in cfg:
        out.append(item)
        if item == "M":
            blocks += 1
            if blocks == n_blocks:
                return tuple(out)
    return tuple(out)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the channels of an NCHW image.

    At train time the statistics are the batch's, over every position of
    ``(B, H, W)``, in fp32: the mean and the biased variance ``E[x^2] -
    E[x]^2`` clipped at 0 (Flax's fast variance); they move the running
    ones by ``ra = 0.99 ra + 0.01 batch``.  Otherwise the running ones
    normalise.  ``(x - mean) * rsqrt(var + eps) * scale + bias`` runs in
    fp32 and is cast to the compute dtype.  ``torch.nn.BatchNorm2d`` keeps
    an unbiased running variance, so it is not used.  Under data
    parallelism both sums are summed over the data group, so the statistics
    are the global batch's.
    """

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            mesh = getattr(self, "dist_mesh", None)
            if mesh is None or mesh.data == 1:
                mean = xf.mean(dim=(0, 2, 3))
                mean2 = (xf * xf).mean(dim=(0, 2, 3))
            else:
                n = xf.numel() // xf.shape[1] * mesh.data
                mean, mean2 = (sum_over_data(self, torch.stack(
                    [xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))]))
                    / n).unbind(0)
            var = torch.maximum(mean2 - mean * mean, mean.new_zeros(()))
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1.0 - self.momentum)
                                                   * mean)
                self.var.mul_(self.momentum).add_((1.0 - self.momentum)
                                                  * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


def _conv_cfg(out_channels: int) -> Conv2dConfig:
    """A 3x3 SAME stride-1 convolution with a bias (Flax ``nn.Conv``'s
    default)."""
    return Conv2dConfig(out_channels=out_channels, kernel_time=3,
                        kernel_feature=3, stride_time=1, stride_feature=1,
                        padding=PaddingMode.SAME, bias=True)


class VGG(nn.Module):
    """``(B, T, F), lengths -> (B, T', F' * C), lengths``."""

    def __init__(self, cfg: VGGConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.layers = _truncate(_CFGS[cfg.vgg_cfg], cfg.use_output_from_block)
        c_in, i = 1, 0
        for item in self.layers:
            if item == "M":
                continue
            self.add_module(f"Conv_{i}", Conv(_conv_cfg(item), c_in, dtype))
            if cfg.batch_norm:
                self.add_module(f"BatchNorm_{i}", BatchNorm(item, dtype=dtype))
            c_in, i = item, i + 1

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False):
        y = x[:, None, :, :]  # (B, 1, T, F)
        i = 0
        for item in self.layers:
            if item == "M":
                y = nn.functional.max_pool2d(y, 2, 2)
                lengths = lengths // 2
                continue
            y = masking.mask_sequence(y, lengths, time_axis=2)
            y = getattr(self, f"Conv_{i}").nchw(y)
            if self.cfg.batch_norm:
                y = getattr(self, f"BatchNorm_{i}")(y, train)
            y = torch.maximum(y, y.new_zeros(()))
            i += 1
        y = masking.mask_sequence(y, lengths, time_axis=2)
        B, C, T, F = y.shape
        return y.permute(0, 2, 3, 1).reshape(B, T, F * C), lengths


def vgg_output_size(cfg: VGGConfig, in_features: int) -> int:
    """Static output feature size of :class:`VGG` for ``in_features`` mels."""
    layers = _truncate(_CFGS[cfg.vgg_cfg], cfg.use_output_from_block)
    f, c = in_features, 1
    for item in layers:
        if item == "M":
            f = f // 2
        else:
            c = item
    return f * c
