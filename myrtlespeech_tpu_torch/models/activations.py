"""Activations of ``activation.proto`` (port of ``models/activations.py``).

HARDTANH is the DS-style clipped ReLU ``min(max(x, 0), 20)``.
"""

from __future__ import annotations

import torch

from myrtlespeech_tpu_torch.config.schema import Activation


def apply_activation(act: Activation, x: torch.Tensor,
                     clip: float = 20.0) -> torch.Tensor:
    if act is Activation.IDENTITY:
        return x
    if act is Activation.RELU:
        return torch.relu(x)
    if act is Activation.HARDTANH:
        return torch.clamp(x, 0.0, clip)
    raise ValueError(f"unknown activation {act}")
