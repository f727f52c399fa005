"""Batched RNN-T greedy decoding (port of ``decoding/rnnt_greedy.py``).

The whole batch decodes together: each iteration evaluates the joint for
every row at its current ``(t, g)``, then each row either emits (appends the
symbol and advances its prediction net) or advances time.  Rows are masked
independently.  ``max_symbols_per_step`` bounds consecutive emissions per
frame, as in the reference.

The JAX package runs this as one ``lax.while_loop`` on the device.  Here it
is a Python loop whose condition ``any(t < f_lens)`` reads one flag from the
device every iteration; CUDA graphs for the loop body are later work.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def tree_map(fn, *trees):
    """``fn`` over the tensors of nested lists, tuples and named tuples."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    return type(t)(tree_map(fn, *xs) for xs in zip(*trees))


def _select(emit: torch.Tensor, new, old):
    """Per-row select over a (nested list / tuple of) tensors: ``emit (B,)``
    picks ``new`` for row b, and a tensor whose leading dim is ``k * B``
    holds row b's k rows at ``b * k`` onwards."""
    B = emit.shape[0]

    def pick(n, o):
        # One broadcast ``where`` for B rows; the greedy loop is host-bound,
        # so k * B rows alone pay for the split and the join.
        if n.shape[0] == B:
            return torch.where(emit.reshape((B,) + (1,) * (n.dim() - 1)),
                               n, o)
        n, o = n.unflatten(0, (B, -1)), o.unflatten(0, (B, -1))
        m = emit.reshape((B,) + (1,) * (n.dim() - 1))
        return torch.where(m, n, o).flatten(0, 1)

    return tree_map(pick, new, old)


def rnnt_greedy_decode(
    f: torch.Tensor,  # (B, T, H) encoder output (or its joint projection)
    f_lens: torch.Tensor,  # (B,)
    predict_step: Callable,  # (token (B,), state) -> (g (B, H_pred), state)
    joint_step: Callable,  # (f_t (B, H), g (B, H_pred)) -> (B, V) logits
    init_state,
    *,
    blank_index: int,
    max_symbols_per_step: int = 30,
    max_output_len: int = 200,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy transducer decode of a whole batch.

    Returns ``(tokens (B, max_output_len) int32, token_lens (B,) int32)``.
    """
    B, T, _ = f.shape
    U = max_output_len
    dev = f.device
    f_lens = f_lens.to(device=dev, dtype=torch.int32)
    rows = torch.arange(B, device=dev)

    g, state = predict_step(torch.full((B,), -1, dtype=torch.int64,
                                       device=dev), init_state)
    t = torch.zeros((B,), dtype=torch.int32, device=dev)
    emitted = torch.zeros_like(t)
    out_len = torch.zeros_like(t)
    # Column U takes the writes of rows that do not emit (the JAX package
    # drops an out-of-range scatter instead); it is cut off at the end.
    out = torch.zeros((B, U + 1), dtype=torch.int32, device=dev)

    while bool((t < f_lens).any()):
        t_safe = torch.clamp(t, max=T - 1)
        logits = joint_step(f[rows, t_safe.long()], g)
        k = torch.argmax(logits, dim=-1)

        active = t < f_lens
        emit = active & (k != blank_index) \
            & (emitted < max_symbols_per_step) & (out_len < U)

        pos = torch.where(emit, out_len, U).long()
        out[rows, pos] = k.to(torch.int32)
        out_len = out_len + emit.to(torch.int32)

        new_g, new_state = predict_step(k, state)
        g = _select(emit, new_g, g)
        state = _select(emit, new_state, state)

        t = t + (active & ~emit).to(torch.int32)
        emitted = torch.where(emit, emitted + 1, 0)
    return out[:, :U], out_len
