"""Recurrences over a padded, time-major batch (port of
``myrtlespeech_tpu/ops/rnn.py``): the LSTM, the hard LSTM, the GRU and the
vanilla tanh RNN.

- The input projection ``x @ W_ih`` for all time steps is one large matmul
  in the compute dtype, outside the recurrence.
- The LSTM's recurrence is ``ops/cuda/lstm_kernel.py::LSTMFunction``: K1
  forward and K2 backward, each the CUDA kernel for a CUDA tensor and its
  plain version for a CPU tensor, so that a gradient reaches ``w_hh``, the
  bias and everything below the layer on every device.
- The hard LSTM's, the GRU's and the vanilla RNN's recurrences are PyTorch
  loops over time on every device, step for step as the JAX package's
  ``lax.scan`` loops (which reach no Pallas kernel), with autograd through
  them.  Their input projection stays fp32, and each product ``h @ W_hh``
  rounds both operands to the compute dtype and multiplies in fp32, as
  ``preferred_element_type=float32`` does.
- Under tensor parallelism (``mesh``) ``w_ih`` is this rank's column shard
  and the input projection runs column-parallel
  (``parallel/tensor.py::column_parallel``); ``w_hh`` and the biases come in
  whole, gathered by the caller (``models/rnn.py``).
- Variable lengths are handled by masking, not packing: padded steps run,
  but the state is frozen on them, so the final state is the state at
  ``t = len - 1``, and outputs there are zero.
- The backward direction is a length-aware reverse plus the same scan.

Gate order is ``i, f, g, o`` for the LSTMs and ``r, z, n`` for the GRU, as
in the JAX package and in torch.  The hard LSTM's gates clip with
``minimum(maximum(.))``, not ``torch.clamp``: at a clip bound, where the hard
gates often put the cell (``i = g = 1``, ``f = 0`` gives ``c = 1``), a tie
splits the gradient in half as ``jnp.clip`` does, where ``clamp`` passes it
whole.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from myrtlespeech_tpu_torch.ops.cuda.lstm_kernel import LSTMFunction
from myrtlespeech_tpu_torch.ops.masking import sequence_mask
from myrtlespeech_tpu_torch.parallel.mesh import Mesh
from myrtlespeech_tpu_torch.parallel.tensor import column_parallel


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


def _matmul(x: torch.Tensor, w: torch.Tensor, mesh: Optional[Mesh]
            ) -> torch.Tensor:
    """``x @ w``, column-parallel over ``mesh``'s model group when given."""
    if mesh is None:
        return x @ w
    return column_parallel(torch.matmul, x, w, mesh)


def lstm_scan(x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
              w_hh: torch.Tensor, b: Optional[torch.Tensor],
              h0c0: Optional[LSTMState] = None, reverse: bool = False,
              compute_dtype: torch.dtype = torch.bfloat16,
              mesh: Optional[Mesh] = None
              ) -> Tuple[torch.Tensor, LSTMState]:
    """Run an LSTM over a time-major padded batch.

    ``x (T, B, F)``, ``lengths (B,)``, ``w_ih (F, 4H)``, ``w_hh (H, 4H)``,
    ``b (4H,)`` or None; ``h0c0`` fp32, zeros if None.  Returns outputs
    ``(T, B, H)`` in the compute dtype (zero past each length) and the final
    fp32 state.  With ``mesh``, ``w_ih`` is this rank's column shard.
    """
    T, B, F = x.shape
    H = w_hh.shape[0]
    dev = x.device
    if h0c0 is None:
        h0c0 = LSTMState(h=torch.zeros((B, H), device=dev),
                         c=torch.zeros((B, H), device=dev))
    if reverse:
        x = reverse_sequences(x, lengths)
    x_proj = _matmul(x.reshape(T * B, F).to(compute_dtype),
                     w_ih.to(compute_dtype), mesh).reshape(T, B, 4 * H)
    valid = sequence_mask(lengths.to(dev), T, torch.float32).t().contiguous()
    ys, hT, cT = LSTMFunction.apply(
        x_proj, valid, w_hh, h0c0.h.float().contiguous(),
        h0c0.c.float().contiguous(), None if b is None else b.float())
    if reverse:
        ys = reverse_sequences(ys, lengths)
    return ys.to(compute_dtype), LSTMState(h=hT, c=cT)


def _project(x: torch.Tensor, w_ih: torch.Tensor,
             compute_dtype: torch.dtype, mesh: Optional[Mesh] = None
             ) -> torch.Tensor:
    """``x (T, B, F) @ w_ih (F, G)`` as one product over all steps, both
    operands rounded to the compute dtype, the product fp32: ``(T, B, G)``
    (column-parallel over ``mesh``)."""
    T, B, F = x.shape
    return _matmul(x.reshape(T * B, F).to(compute_dtype).float(),
                   w_ih.to(compute_dtype).float(), mesh).reshape(T, B, -1)


def _hidden(h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
            compute_dtype: torch.dtype) -> torch.Tensor:
    """``h @ w (+ bias)``: ``h`` rounded to the compute dtype (``w`` is
    already), the product and the sum fp32."""
    hc = h.to(compute_dtype).float()
    return hc @ w if bias is None else torch.addmm(bias, hc, w)


def _recur(inputs, lengths: torch.Tensor, state, step, reverse: bool,
           compute_dtype: torch.dtype):
    """Run ``state = step(x_t, state)`` over time, ``x_t`` the step's slices
    of ``inputs`` (a tuple of ``(T, B, .)`` tensors) and ``state`` an ``h``
    or an ``LSTMState``, frozen on padded steps.  Returns ``(ys (T, B, H)``
    in the compute dtype, each step's new ``h`` and 0 past each length,
    the final state)``.

    The loop slices the inputs with ``unbind`` and gathers the outputs with
    one ``stack``, so that autograd builds one gradient tensor for each,
    not one a step."""
    T = inputs[0].shape[0]
    valid = sequence_mask(lengths.to(inputs[0].device), T).t()[:, :, None]
    hs = []
    for x_t, m in zip(zip(*(x.unbind(0) for x in inputs)), valid.unbind(0)):
        new = step(x_t, state)
        if isinstance(new, LSTMState):
            hs.append(new.h)
            state = LSTMState(*(torch.where(m, n, o)
                                for n, o in zip(new, state)))
        else:
            hs.append(new)
            state = torch.where(m, new, state)
    ys = torch.where(valid, torch.stack(hs), 0.0)
    if reverse:
        ys = reverse_sequences(ys, lengths)
    return ys.to(compute_dtype), state


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``clip(0.2 x + 0.5, 0, 1)`` as ``minimum(maximum(.))``: a tie at a
    bound splits the gradient as ``jnp.clip`` does."""
    y = 0.2 * x + 0.5
    return torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_ones(()))


def hard_tanh(x: torch.Tensor) -> torch.Tensor:
    """``clip(x, -1, 1)`` as ``minimum(maximum(.))`` (see
    :func:`hard_sigmoid`)."""
    return torch.minimum(torch.maximum(x, x.new_full((), -1.0)),
                         x.new_ones(()))


def hard_lstm_scan(x: torch.Tensor, lengths: torch.Tensor,
                   w_ih: torch.Tensor, w_hh: torch.Tensor,
                   b: Optional[torch.Tensor],
                   h0c0: Optional[LSTMState] = None, reverse: bool = False,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   mesh: Optional[Mesh] = None
                   ) -> Tuple[torch.Tensor, LSTMState]:
    """The hard LSTM (JAX ``lstm_scan(hard=True)``): the LSTM's step with
    :func:`hard_sigmoid` and :func:`hard_tanh`, the bias added inside the
    step.  Arguments and results as :func:`lstm_scan`'s."""
    T, B, _ = x.shape
    H = w_hh.shape[0]
    dev = x.device
    if h0c0 is None:
        h0c0 = LSTMState(h=torch.zeros((B, H), device=dev),
                         c=torch.zeros((B, H), device=dev))
    if reverse:
        x = reverse_sequences(x, lengths)
    x_proj = _project(x, w_ih, compute_dtype, mesh)
    w = w_hh.to(compute_dtype).float()
    bias = None if b is None else b.float()

    def step(x_t, state):
        gates = x_t[0] + _hidden(state.h, w, bias, compute_dtype)
        # The gates' clips are elementwise: each over all 4H columns, then
        # the columns each gate takes.
        i, f, _, o = hard_sigmoid(gates).chunk(4, dim=1)
        g = hard_tanh(gates).chunk(4, dim=1)[2]
        c = f * state.c + i * g
        return LSTMState(h=o * hard_tanh(c), c=c)

    return _recur((x_proj,), lengths,
                  LSTMState(h=h0c0.h.float(), c=h0c0.c.float()), step,
                  reverse, compute_dtype)


def gru_scan(x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
             w_hh: torch.Tensor, b_ih: Optional[torch.Tensor],
             b_hh: Optional[torch.Tensor], h0: Optional[torch.Tensor] = None,
             reverse: bool = False,
             compute_dtype: torch.dtype = torch.bfloat16,
             mesh: Optional[Mesh] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU, gate order ``r, z, n`` (JAX ``gru_scan``): ``w_ih (F, 3H)``,
    ``w_hh (H, 3H)``, ``b_ih`` added to the fp32 input projection, ``b_hh``
    to ``h @ w_hh``, so that the n gate sees ``r * (h W_hn + b_hn)``.
    Returns outputs ``(T, B, H)`` in the compute dtype and the final ``h
    (B, H)`` fp32."""
    T, B, _ = x.shape
    H = w_hh.shape[0]
    if h0 is None:
        h0 = torch.zeros((B, H), device=x.device)
    if reverse:
        x = reverse_sequences(x, lengths)
    x_proj = _project(x, w_ih, compute_dtype, mesh)
    if b_ih is not None:
        x_proj = x_proj + b_ih.float()
    w = w_hh.to(compute_dtype).float()
    bias = None if b_hh is None else b_hh.float()

    def step(x_t, h):
        x_rz, x_n = x_t
        h_rz, h_n = _hidden(h, w, bias, compute_dtype).split([2 * H, H],
                                                             dim=1)
        r, z = torch.sigmoid(x_rz + h_rz).split(H, dim=1)
        n = torch.tanh(x_n + r * h_n)
        return (1.0 - z) * n + z * h

    return _recur(x_proj.split([2 * H, H], dim=2), lengths, h0.float(),
                  step, reverse, compute_dtype)


def rnn_scan(x: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
             w_hh: torch.Tensor, b: Optional[torch.Tensor],
             h0: Optional[torch.Tensor] = None, reverse: bool = False,
             compute_dtype: torch.dtype = torch.bfloat16,
             mesh: Optional[Mesh] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vanilla tanh RNN (JAX ``rnn_scan``): ``h = tanh(x W_ih + b + h
    W_hh)``, the bias added to the fp32 input projection.  Returns as
    :func:`gru_scan`."""
    T, B, _ = x.shape
    H = w_hh.shape[0]
    if h0 is None:
        h0 = torch.zeros((B, H), device=x.device)
    if reverse:
        x = reverse_sequences(x, lengths)
    x_proj = _project(x, w_ih, compute_dtype, mesh)
    if b is not None:
        x_proj = x_proj + b.float()
    w = w_hh.to(compute_dtype).float()

    def step(x_t, h):
        return torch.tanh(_hidden(h, w, x_t[0], compute_dtype))

    return _recur((x_proj,), lengths, h0.float(), step, reverse,
                  compute_dtype)
