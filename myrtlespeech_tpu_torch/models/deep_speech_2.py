"""DeepSpeech2 acoustic model (port of ``models/deep_speech_2.py``).

masked 2-D conv front end (``ConvBlock_0``) -> stacked (bi)LSTM with masked
BatchNorm between layers (``RNN_0``; K1 forward and K2 backward on the
card) -> optional lookahead, unidirectional only (``Lookahead_0``) ->
per-frame MLP (``FullyConnected_0``) -> logits ``(B, T', V)``.

The submodules carry the Flax names, so the JAX package's parameters and
``batch_stats`` map one to one (``weights.py``).  ``train`` selects the
BatchNorm statistics: the batch's (moving the running ones) at train time,
the running ones otherwise.  At train time the MLP (and the RNN stack,
where its config sets one) drops out at its configured rate, the masks
drawn from the ``gen`` passed in (``ops/dropout.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from myrtlespeech_tpu_torch.config.schema import DeepSpeech2Config
from myrtlespeech_tpu_torch.models.cnn import (ConvBlock,
                                                conv_block_out_features)
from myrtlespeech_tpu_torch.models.fully_connected import FullyConnected
from myrtlespeech_tpu_torch.models.lookahead import Lookahead
from myrtlespeech_tpu_torch.models.rnn import RNN


class DeepSpeech2(nn.Module):
    def __init__(self, cfg: DeepSpeech2Config, out_features: int,
                 in_features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.lookahead is not None and cfg.rnn.bidirectional:
            raise ValueError("lookahead requires unidirectional rnn")
        self.cfg = cfg
        self.dtype = dtype
        self.ConvBlock_0 = ConvBlock(cfg.conv_block, in_features, dtype)
        self.RNN_0 = RNN(cfg.rnn, conv_block_out_features(cfg.conv_block,
                                                          in_features), dtype)
        width = cfg.rnn.hidden_size * (2 if cfg.rnn.bidirectional else 1)
        if cfg.lookahead is not None:
            self.Lookahead_0 = Lookahead(cfg.lookahead.context, width, dtype)
        self.FullyConnected_0 = FullyConnected(cfg.fully_connected, width,
                                               out_features, dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False, gen: Optional[torch.Generator] = None):
        """``x (B, T, F)`` features, ``lengths (B,)`` -> ``(logits (B, T',
        V), lengths (B,))``."""
        y, lengths = self.ConvBlock_0(x, lengths, train)
        y, lengths, _ = self.RNN_0(y, lengths, train, gen=gen)
        if self.cfg.lookahead is not None:
            y = self.Lookahead_0(y, lengths)
        return self.FullyConnected_0(y, train, gen), lengths
