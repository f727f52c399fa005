"""Per-timestep MLP (port of ``models/fully_connected.py``).

``num_hidden_layers`` hidden layers with the configured activation, then a
final layer to ``out_features`` with none; at train time, dropout at
``cfg.dropout`` after each hidden activation (``ops/dropout.py``).
Parameters are fp32 and keep Flax's layout and names: ``Dense_{i}.kernel
(in, out)`` and ``Dense_{i}.bias``; products run in the compute dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from myrtlespeech_tpu_torch.config.schema import FullyConnectedConfig
from myrtlespeech_tpu_torch.models.activations import apply_activation
from myrtlespeech_tpu_torch.ops.dropout import dropout


class Dense(nn.Module):
    """``y = x @ kernel + bias`` in the compute dtype (Flax ``nn.Dense``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype) \
            + self.bias.to(self.dtype)


class FullyConnected(nn.Module):
    def __init__(self, cfg: FullyConnectedConfig, in_features: int,
                 out_features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        widths = [in_features] + [cfg.hidden_size] * cfg.num_hidden_layers \
            + [out_features]
        for i in range(len(widths) - 1):
            self.add_module(f"Dense_{i}",
                            Dense(widths[i], widths[i + 1], dtype))

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None,
                masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """``x (..., in)`` -> ``(..., out)``.  ``masks``: one keep mask a
        hidden layer, drawn beforehand; else each is drawn from ``gen``."""
        y = x.to(self.dtype)
        layers = list(self.children())
        for i, layer in enumerate(layers[:-1]):
            y = apply_activation(self.cfg.activation, layer(y))
            y = dropout(y, self.cfg.dropout, train, gen,
                        None if masks is None else masks[i])
        return layers[-1](y)
