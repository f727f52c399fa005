"""Generic CTC encoder-decoder (port of ``models/encoder_decoder.py``).

``Encoder_0``: an optional VGG front end (``VGG_0``), then an optional
masked conv block over the VGG-flattened width (``ConvBlock_0``), then an
optional RNN stack of any cell (``RNN_0``).  ``FullyConnected_0``: the
per-frame MLP to logits ``(B, T', V)``.  The submodules carry Flax's names,
so the JAX package's parameters and ``batch_stats`` map one to one
(``weights.py``).  ``train`` selects the BatchNorm statistics (the batch's,
moving the running ones, or the running ones) and turns on dropout, its
masks drawn from ``gen`` (``ops/dropout.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from myrtlespeech_tpu_torch.config.schema import EncoderDecoderConfig
from myrtlespeech_tpu_torch.models.cnn import (ConvBlock,
                                                conv_block_out_features)
from myrtlespeech_tpu_torch.models.fully_connected import FullyConnected
from myrtlespeech_tpu_torch.models.rnn import RNN
from myrtlespeech_tpu_torch.models.vgg import VGG, vgg_output_size


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderDecoderConfig, in_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        e = cfg.encoder
        f = in_features
        if e.vgg is not None:
            self.VGG_0 = VGG(e.vgg, dtype)
            f = vgg_output_size(e.vgg, f)
        if e.conv_block:
            self.ConvBlock_0 = ConvBlock(e.conv_block, f, dtype)
            f = conv_block_out_features(e.conv_block, f)
        if e.rnn is not None:
            self.RNN_0 = RNN(e.rnn, f, dtype)
            f = e.rnn.hidden_size * (2 if e.rnn.bidirectional else 1)
        self.out_features = f

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False, gen: Optional[torch.Generator] = None):
        y = x
        if hasattr(self, "VGG_0"):
            y, lengths = self.VGG_0(y, lengths, train)
        if hasattr(self, "ConvBlock_0"):
            y, lengths = self.ConvBlock_0(y, lengths, train)
        if hasattr(self, "RNN_0"):
            y, lengths, _ = self.RNN_0(y, lengths, train, gen=gen)
        return y, lengths


class EncoderDecoder(nn.Module):
    def __init__(self, cfg: EncoderDecoderConfig, out_features: int,
                 in_features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.Encoder_0 = Encoder(cfg, in_features, dtype)
        self.FullyConnected_0 = FullyConnected(
            cfg.decoder, self.Encoder_0.out_features, out_features, dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False, gen: Optional[torch.Generator] = None):
        """``x (B, T, F)`` features, ``lengths (B,)`` -> ``(logits (B, T',
        V), lengths (B,))``."""
        y, lengths = self.Encoder_0(x, lengths, train, gen)
        return self.FullyConnected_0(y, train, gen), lengths
