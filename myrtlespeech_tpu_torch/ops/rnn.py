"""LSTM over a padded, time-major batch (port of ``myrtlespeech_tpu/ops/rnn.py``).

- The input projection ``x @ W_ih`` for all time steps is one large matmul
  in the compute dtype, outside the recurrence.
- The recurrence itself is ``ops/cuda/lstm_kernel.py::LSTMFunction``: K1
  forward and K2 backward, each the CUDA kernel for a CUDA tensor and its
  plain version for a CPU tensor, so that a gradient reaches ``w_hh``, the
  bias and everything below the layer on every device.
- Variable lengths are handled by masking, not packing: padded steps run,
  but the state is frozen on them, so the final state is the state at
  ``t = len - 1``, and outputs there are zero.
- The backward direction is a length-aware reverse plus the same scan.

Gate order is ``i, f, g, o``, as in the JAX package and in torch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from myrtlespeech_tpu_torch.ops.cuda.lstm_kernel import LSTMFunction
from myrtlespeech_tpu_torch.ops.masking import sequence_mask


class LSTMState(NamedTuple):
    h: torch.Tensor  # (B, H) fp32
    c: torch.Tensor  # (B, H) fp32


def reverse_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Length-aware reverse of a time-major ``(T, B, ...)`` tensor.

    For each row ``b`` the first ``lengths[b]`` steps are reversed and the
    padding stays at the end (TF ``reverse_sequence``).
    """
    T, B = x.shape[:2]
    t = torch.arange(T, device=x.device)[:, None]
    lens = lengths.to(device=x.device, dtype=t.dtype)[None, :]
    src = torch.where(t < lens, lens - 1 - t, t)  # (T, B)
    src = src.reshape((T, B) + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, 0, src)


def lstm_scan(x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
              w_hh: torch.Tensor, b: Optional[torch.Tensor],
              h0c0: Optional[LSTMState] = None, reverse: bool = False,
              compute_dtype: torch.dtype = torch.bfloat16
              ) -> Tuple[torch.Tensor, LSTMState]:
    """Run an LSTM over a time-major padded batch.

    ``x (T, B, F)``, ``lengths (B,)``, ``w_ih (F, 4H)``, ``w_hh (H, 4H)``,
    ``b (4H,)`` or None; ``h0c0`` fp32, zeros if None.  Returns outputs
    ``(T, B, H)`` in the compute dtype (zero past each length) and the final
    fp32 state.
    """
    T, B, F = x.shape
    H = w_hh.shape[0]
    dev = x.device
    if h0c0 is None:
        h0c0 = LSTMState(h=torch.zeros((B, H), device=dev),
                         c=torch.zeros((B, H), device=dev))
    if reverse:
        x = reverse_sequences(x, lengths)
    x_proj = (x.reshape(T * B, F).to(compute_dtype)
              @ w_ih.to(compute_dtype)).reshape(T, B, 4 * H)
    valid = sequence_mask(lengths.to(dev), T, torch.float32).t().contiguous()
    ys, hT, cT = LSTMFunction.apply(
        x_proj, valid, w_hh, h0c0.h.float().contiguous(),
        h0c0.c.float().contiguous(), None if b is None else b.float())
    if reverse:
        ys = reverse_sequences(ys, lengths)
    return ys.to(compute_dtype), LSTMState(h=hT, c=cT)
