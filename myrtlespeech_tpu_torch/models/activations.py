"""Activations of ``activation.proto`` (port of ``models/activations.py``).

HARDTANH is the DS-style clipped ReLU ``min(max(x, 0), 20)``.  Both are
written with ``torch.maximum``/``torch.minimum``, whose gradient at a tie is
split in half, as ``jnp.maximum``'s is: at ``x == 0`` (the prediction net's
zero start state gives exact zeros) ``torch.relu`` would pass none of it.
"""

from __future__ import annotations

import torch

from myrtlespeech_tpu_torch.config.schema import Activation


def apply_activation(act: Activation, x: torch.Tensor,
                     clip: float = 20.0) -> torch.Tensor:
    if act is Activation.IDENTITY:
        return x
    zero = x.new_zeros(())
    if act is Activation.RELU:
        return torch.maximum(x, zero)
    if act is Activation.HARDTANH:
        return torch.minimum(torch.maximum(x, zero), zero + clip)
    raise ValueError(f"unknown activation {act}")
