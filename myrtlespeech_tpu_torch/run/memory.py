"""Device-memory planner for the transducer joint path: the port's copy of
``myrtlespeech_tpu/run/memory.py``.

The full-joint RNN-T training step holds ``(B, T', U+1, H_joint)`` hidden
activations and ``(B, T', U+1, V)`` logits (plus their backward
transients): the transducer's memory hot spot.  Before a step the planner
projects that footprint from the batch's shapes and, if it exceeds a
fraction of the card's memory, names the largest T-chunk whose footprint
fits, for the T-chunked fused joint+loss.

The decision is per batch shape, deterministic, and overridable, as in the
JAX package (``myrtlespeech_tpu/run/memory.py:96-102``):

- ``MYRTLE_DISABLE_MEM_PLANNER=1``: always the full joint.
- ``MYRTLE_JOINT_MEM_FRACTION``: the fraction of the memory the joint may
  claim (default 0.45).
- ``MYRTLE_HBM_BYTES``: the memory size to plan for (tests, other cards).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

_LOG = logging.getLogger(__name__)

# Fraction of the device's memory the joint activations may claim; the rest
# holds parameters, optimizer state, the LSTMs' saved tensors and scratch.
DEFAULT_FRACTION = 0.45

# Bytes per joint lattice cell, as multiples of element counts:
#   hidden (B,T',U+1,H_j): forward residual (compute dtype) + backward
#   transient + the pre-activation kept for the ReLU/tanh backward.
_HIDDEN_COPIES = 3
#   logits (B,T',U+1,V): fp32 cast for the loss + d(logits) + one transient.
_LOGIT_COPIES = 3


def hbm_bytes_limit(device=None) -> Optional[int]:
    """The device's memory in bytes, or None when unknown (a CPU device).

    ``MYRTLE_HBM_BYTES`` overrides; otherwise a CUDA device's
    ``total_memory``.
    """
    env = os.environ.get("MYRTLE_HBM_BYTES")
    if env:
        return int(env)
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def joint_activation_bytes(B: int, T: int, U1: int, H_joint: int, V: int,
                           hidden_bytes: int = 2,
                           backward: bool = True) -> int:
    """Projected peak bytes of the full-joint path's big activations."""
    cells = B * T * U1
    h_copies = _HIDDEN_COPIES if backward else 1
    v_copies = _LOGIT_COPIES if backward else 2
    return cells * (h_copies * H_joint * hidden_bytes + v_copies * V * 4)


def plan_transducer_chunk(B: int, T: int, U1: int, H_joint: int, V: int,
                          hidden_bytes: int = 2, backward: bool = True,
                          device=None) -> Optional[int]:
    """None when the full joint fits the budget, else a T-chunk size for the
    fused path: the largest multiple of 8 whose projected footprint fits,
    clamped to [8, T]."""
    if os.environ.get("MYRTLE_DISABLE_MEM_PLANNER"):
        return None
    limit = hbm_bytes_limit(device)
    if limit is None:
        return None
    budget = int(limit * float(
        os.environ.get("MYRTLE_JOINT_MEM_FRACTION", DEFAULT_FRACTION)))
    need = joint_activation_bytes(B, T, U1, H_joint, V, hidden_bytes,
                                  backward)
    if need <= budget:
        return None
    per_frame = max(1, need // T)
    chunk = max(8, (budget // per_frame) // 8 * 8)
    chunk = min(chunk, T)
    _LOG.info(
        "memory planner: full joint (B=%d, T'=%d, U+1=%d, H_j=%d, V=%d) "
        "projects %.2f GB > %.2f GB budget; fused joint+loss with "
        "chunk=%d", B, T, U1, H_joint, V, need / 2**30, budget / 2**30,
        chunk)
    return chunk
