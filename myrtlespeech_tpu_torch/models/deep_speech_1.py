"""DeepSpeech1 acoustic model (port of ``models/deep_speech_1.py``).

Context-stacked features ``(B, T, F * (2n + 1))`` -> 3 per-frame dense
layers (``Dense_0``-``Dense_2``), each a clipped ReLU ``clamp(y, 0,
relu_clip)`` in the compute dtype and dropout -> one bidirectional LSTM of
``n_hidden`` units (``RNN_0``; K1 forward and K2 backward on the card, the
concatenation of both directions, ``2 * n_hidden`` wide) -> one dense layer
with clipped ReLU and dropout (``Dense_3``) -> logits ``(B, T, V)``
(``Dense_4``).  No layer strides in time, so the logits keep every frame.

The submodules carry the Flax names, so the JAX package's parameters map
one to one (``weights.py``).  At train time dropout at ``drop_prob``
follows each of the four hidden dense layers, its masks drawn from the
``gen`` passed in (``ops/dropout.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from myrtlespeech_tpu_torch.config.schema import (DeepSpeech1Config,
                                                  RNNConfig, RNNType)
from myrtlespeech_tpu_torch.models.fully_connected import Dense
from myrtlespeech_tpu_torch.models.rnn import RNN
from myrtlespeech_tpu_torch.ops.dropout import dropout


class DeepSpeech1(nn.Module):
    def __init__(self, cfg: DeepSpeech1Config, out_features: int,
                 in_features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        H = cfg.n_hidden
        self.Dense_0 = Dense(in_features, H, dtype)
        self.Dense_1 = Dense(H, H, dtype)
        self.Dense_2 = Dense(H, H, dtype)
        self.RNN_0 = RNN(RNNConfig(rnn_type=RNNType.LSTM, hidden_size=H,
                                   num_layers=1, bidirectional=True,
                                   forget_gate_bias=cfg.forget_gate_bias),
                         H, dtype)
        self.Dense_3 = Dense(2 * H, H, dtype)
        self.Dense_4 = Dense(H, out_features, dtype)

    def _hidden(self, layer: Dense, y: torch.Tensor, train: bool,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        y = torch.clamp(layer(y), 0.0, self.cfg.relu_clip)
        return dropout(y, self.cfg.drop_prob, train, gen)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False, gen: Optional[torch.Generator] = None):
        """``x (B, T, F)`` features, ``lengths (B,)`` -> ``(logits (B, T,
        V), lengths (B,))``."""
        y = x.to(self.dtype)
        for layer in (self.Dense_0, self.Dense_1, self.Dense_2):
            y = self._hidden(layer, y, train, gen)
        y, lengths, _ = self.RNN_0(y, lengths, train, gen=gen)
        y = self._hidden(self.Dense_3, y, train, gen)
        return self.Dense_4(y), lengths
