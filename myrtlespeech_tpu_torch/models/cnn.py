"""Length-masked 2-D convolutions, the DeepSpeech2 front end (port of
``models/cnn.py``).

Features enter as ``(B, T, F)`` and are viewed as an image ``(B, T, F, C)``
with time first and channels last, as in the JAX package.  Each layer masks
its input, convolves, takes the output lengths from conv arithmetic
(clamped at 0), applies the masked BatchNorm over the flattened ``(B, T,
F * C)``, then the activation, and masks again.

The convolution is ``torch.nn.functional.conv2d`` (cuDNN on the card): the
JAX package computes it with XLA's ``nn.Conv``, outside any Pallas kernel,
as a library product like ``x @ W_ih``.  Its kernel parameter keeps Flax's
``(kt, kf, in, out)`` layout and is permuted to ``(out, in, kt, kf)`` at the
call, so that the weight bridge stays a rename.  Under tensor parallelism a
sharded kernel convolves column-parallel over the output channels
(``parallel/tensor.py``).  The image runs NCHW inside
the call and is permuted back to ``(B, T, F, C)`` before any flatten: Flax
flattens with C fastest, and the BatchNorm's ``(F * C,)`` parameters and the
first LSTM's ``w_ih`` rows follow that order.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from myrtlespeech_tpu_torch.config.schema import Conv2dConfig, PaddingMode
from myrtlespeech_tpu_torch.models.activations import apply_activation
from myrtlespeech_tpu_torch.models.normalization import MaskedBatchNorm
from myrtlespeech_tpu_torch.ops import masking
from myrtlespeech_tpu_torch.parallel.tensor import columns, shard_mesh


def _pad_amount(mode: PaddingMode, kernel: int) -> int:
    return masking.same_padding(kernel) if mode is PaddingMode.SAME else 0


def _out_size(cfg: Conv2dConfig, T: int, F: int) -> Tuple[int, int]:
    pad_t = _pad_amount(cfg.padding, cfg.kernel_time)
    pad_f = _pad_amount(cfg.padding, cfg.kernel_feature)
    return (masking.conv_out_size(T, cfg.kernel_time, cfg.stride_time, pad_t),
            masking.conv_out_size(F, cfg.kernel_feature, cfg.stride_feature,
                                  pad_f))


class Conv(nn.Module):
    """Flax ``nn.Conv``'s parameters: ``kernel (kt, kf, in, out)`` and
    ``bias (out,)``; the product runs in the compute dtype."""

    def __init__(self, cfg: Conv2dConfig, in_channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stride = (cfg.stride_time, cfg.stride_feature)
        self.padding = (_pad_amount(cfg.padding, cfg.kernel_time),
                        _pad_amount(cfg.padding, cfg.kernel_feature))
        self.kernel = nn.Parameter(torch.empty(
            cfg.kernel_time, cfg.kernel_feature, in_channels,
            cfg.out_channels))
        self.bias = nn.Parameter(torch.zeros(cfg.out_channels)) \
            if cfg.bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, F, C_in) -> (B, T', F', C_out)``."""
        return self.nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def nchw(self, x: torch.Tensor) -> torch.Tensor:
        """The same on an NCHW image: ``(B, C_in, T, F) -> (B, C_out, T',
        F')``."""
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if shard_mesh(self, "kernel") is None:
            return nn.functional.conv2d(x.to(self.dtype), w, b,
                                        stride=self.stride,
                                        padding=self.padding)
        # Column-parallel over the output channels; the replicated bias
        # after the gather.
        y = columns(self, "kernel", lambda x_, w_: nn.functional.conv2d(
            x_, w_, None, stride=self.stride, padding=self.padding),
            x.to(self.dtype), w, dim=1)
        return y if b is None else y + b[:, None, None]


class MaskedConv2d(nn.Module):
    """One masked conv layer on ``(B, T, F, C)`` with BatchNorm and the
    activation."""

    def __init__(self, cfg: Conv2dConfig, in_features: int, in_channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.Conv_0 = Conv(cfg, in_channels, dtype)
        _, out_f = _out_size(cfg, 1, in_features)
        if out_f <= 0:
            raise ValueError(
                f"MaskedConv2d collapses the feature dim {in_features} -> "
                f"{out_f} (kernel_feature={cfg.kernel_feature}, "
                f"stride_feature={cfg.stride_feature}, "
                f"padding={cfg.padding.name}); it must stay > 0")
        if cfg.batch_norm:
            self.MaskedBatchNorm_0 = MaskedBatchNorm(
                out_f * cfg.out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False):
        c = self.cfg
        out_t, out_f = _out_size(c, x.shape[1], x.shape[2])
        if out_f <= 0 or out_t <= 0:
            raise ValueError(
                f"MaskedConv2d collapses input (T={x.shape[1]}, "
                f"F={x.shape[2]}) to (T={out_t}, F={out_f}) with "
                f"kernel=({c.kernel_time},{c.kernel_feature}) "
                f"stride=({c.stride_time},{c.stride_feature}) "
                f"padding={c.padding.name}; every output dim must be > 0")
        x = masking.mask_sequence(x, lengths, time_axis=1)
        y = self.Conv_0(x)
        out_lens = torch.clamp(masking.conv_out_size(
            lengths, c.kernel_time, c.stride_time, self.Conv_0.padding[0]),
            min=0)
        if c.batch_norm:
            B, T, F, C = y.shape
            y = self.MaskedBatchNorm_0(y.reshape(B, T, F * C), out_lens,
                                       train).reshape(B, T, F, C)
        y = apply_activation(c.activation, y)
        return masking.mask_sequence(y, out_lens, time_axis=1), out_lens


class ConvBlock(nn.Module):
    """Stack of masked 2-D convs: ``(B, T, F) -> (B, T', F' * C)``, with the
    lengths."""

    def __init__(self, layers: Tuple[Conv2dConfig, ...], in_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        f, c = in_features, 1
        for i, cfg in enumerate(layers):
            self.add_module(f"MaskedConv2d_{i}",
                            MaskedConv2d(cfg, f, c, dtype))
            f, c = _out_size(cfg, 1, f)[1], cfg.out_channels

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False):
        y = x[..., None]  # (B, T, F, 1)
        for layer in self.children():
            y, lengths = layer(y, lengths, train)
        B, T, F, C = y.shape
        return y.reshape(B, T, F * C), lengths


def conv_block_out_features(layers: Tuple[Conv2dConfig, ...],
                            in_features: int) -> int:
    """Feature width of :class:`ConvBlock`'s output."""
    f, c = in_features, 1
    for cfg in layers:
        f, c = _out_size(cfg, 1, f)[1], cfg.out_channels
    return f * c
