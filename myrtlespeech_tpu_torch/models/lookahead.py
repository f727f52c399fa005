"""Lookahead layer for a unidirectional DeepSpeech2 (port of
``models/lookahead.py``).

Each output frame is a per-feature combination of the current and the next
``context`` frames, ``y[t, f] = sum_{i=0..context} w[i, f] * x[t + i, f]``,
summed in fp32 over shifted slices; frames past each length are masked to 0
first, so they add nothing.  ``weight (context + 1, F)`` keeps Flax's name.
"""

from __future__ import annotations

import torch
from torch import nn

from myrtlespeech_tpu_torch.ops import masking


class Lookahead(nn.Module):
    def __init__(self, context: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.context = context
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(context + 1, features))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        x = masking.mask_sequence(x, lengths, time_axis=1)
        padded = nn.functional.pad(x.float(), (0, 0, 0, self.context))
        y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for i in range(self.context + 1):
            y = y + padded[:, i:i + T, :] * self.weight[i]
        return y.to(self.dtype)
