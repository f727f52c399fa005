"""Train-time dropout, as Flax's ``nn.Dropout`` computes it.

Every dropout site of the port calls :func:`dropout`: between stacked RNN
layers (``models/rnn.py``), after each hidden activation of a fully
connected stack (``models/fully_connected.py``: DeepSpeech2's MLP and the
RNN-T joint's tail; DeepSpeech1's four hidden dense layers,
``models/deep_speech_1.py``) and, per token, on the prediction net's
embeddings (``models/rnn_t.py``).  With ``keep = bernoulli(1 - rate)`` drawn at the
mask's shape and broadcast over the input,

    dropout(x) = where(keep, x / keep_prob, 0)

in the input's dtype: ``keep_prob`` is first rounded to that dtype and the
input divided by it, as JAX divides a bf16 array by a Python float (a
multiply by the reciprocal rounds otherwise in bf16).  Rate 0 and eval
return the input itself; rate 1 gives zeros (with a zero gradient).

Masks are drawn by :func:`draw_keep` from a ``torch.Generator`` on the
input's device (the train state's ``dropout_gen``, which checkpoints save),
never from the global RNG streams.  A test replaces ``draw_keep`` to feed a
mask of its own.  Under data parallelism the generator comes wrapped in a
``parallel/tensor.py::BatchShard``: :func:`draw_rows` then draws the global
batch's mask and keeps this rank's rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from myrtlespeech_tpu_torch.parallel.tensor import BatchShard


def draw_keep(shape: Sequence[int], keep_prob: float,
              gen: Optional[torch.Generator]) -> torch.Tensor:
    """A bool mask of ``shape`` on ``gen``'s device, each entry True with
    probability ``keep_prob``."""
    if gen is None:
        raise ValueError("train-time dropout needs a torch.Generator "
                         "(gen=) to draw its masks")
    return torch.rand(tuple(shape), generator=gen,
                      device=gen.device) < keep_prob


def draw_rows(shape: Sequence[int], keep_prob: float, gen,
              batch_dim: int = 0) -> torch.Tensor:
    """:func:`draw_keep`'s mask of ``shape`` whose ``batch_dim`` runs over
    this rank's rows: from a ``BatchShard``, the global batch's mask cut to
    them; from a generator, the mask itself."""
    if not isinstance(gen, BatchShard):
        return draw_keep(shape, keep_prob, gen)
    return gen.rows(draw_keep(gen.global_shape(shape, batch_dim), keep_prob,
                              gen.gen), batch_dim)


def dropout(x: torch.Tensor, rate: float, train: bool,
            gen: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None,
            shape: Optional[Sequence[int]] = None,
            batch_dim: int = 0) -> torch.Tensor:
    """``x`` with entries dropped at ``rate`` and the rest scaled by
    ``1 / (1 - rate)`` when ``train``.

    ``keep`` is a mask drawn beforehand (it broadcasts over ``x``); without
    it one is drawn from ``gen`` at ``shape`` (default ``x.shape``; e.g.
    ``(B, U, 1)`` drops whole vectors), ``batch_dim`` its batch dimension.
    """
    if rate == 0.0 or not train:
        return x
    if rate == 1.0:
        # Not x / 0 under a mask: its gradient would be 0 / 0.
        return torch.where(torch.zeros((), dtype=torch.bool,
                                       device=x.device), x, 0.0)
    keep_prob = 1.0 - rate
    if keep is None:
        keep = draw_rows(x.shape if shape is None else shape, keep_prob, gen,
                         batch_dim)
    # keep_prob rounded to x's dtype, as JAX rounds a weak Python float.
    scale = float(torch.tensor(keep_prob, dtype=x.dtype))
    return torch.where(keep, x / scale, 0.0)
