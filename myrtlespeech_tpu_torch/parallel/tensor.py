"""The collectives of tensor and data parallelism, as autograd functions.

The JAX package has no counterpart file: GSPMD inserts these collectives
from its sharding annotations (``myrtlespeech_tpu/parallel/sharding.py``).
Here they are written out, Megatron-style, over a :class:`~.mesh.Mesh`'s
groups.  Activations stay replicated along ``model``, as the JAX package's
layout keeps them (``sharding.py:7-10``):

- :func:`column_parallel`: each model rank multiplies the replicated input
  by its column shard of a weight and the outputs are all-gathered along
  their last (or channel) dimension.  Backward, a rank takes its columns of
  the replicated output gradient for its weight gradient, and the input
  gradient is all-reduced over the model group.  Dense kernels, the convs,
  the embedding, the RNN-T's factored joint and the RNNs' input projections
  go through it (``models/``, ``ops/rnn.py``).
- :func:`gather_columns`: a recurrent weight ``w_hh`` and its bias ``_b``
  are all-gathered once a layer call, so that K1/K2 (or a cell's PyTorch
  loop) run the recurrence on the whole matrix on every model rank;
  backward returns this rank's columns of the weight gradient, which every
  model rank computes alike.  Tensor parallelism thus splits the storage
  and the non-recurrent products, not the recurrence.
- :func:`sum_over_data`: a sum over the data group whose gradient is summed
  over it too (BatchNorm's statistics of the global batch).
- :class:`BatchShard`: a generator that draws for the global batch, of which
  this rank keeps its rows (SpecAugment and dropout), so that every rank's
  generator stays in lockstep with a one-process run's.

A module takes part when ``sharding.shard_model`` has marked it:
``dist_mesh`` (its rank's mesh) and ``dist_shards`` (the names of its
parameters that are column shards).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from myrtlespeech_tpu_torch.parallel.mesh import Mesh

_HALF = (torch.bfloat16, torch.float16)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group`` (half types summed in fp32,
    then rounded back)."""
    out = t.float() if t.dtype in _HALF else t.clone()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` of ``group``, concatenated along ``dim`` in rank
    order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _GatherColumns(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice of the gradient
    backward."""

    @staticmethod
    def forward(ctx, t, dim, group, index):
        ctx.dim, ctx.index, ctx.n = dim, index, t.shape[dim]
        return all_gather_cat(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(),
                None, None, None)


class _SumOverGroup(torch.autograd.Function):
    """All-reduce forward and backward: the adjoint of a sum of the ranks'
    values that every rank then uses."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def gather_columns(t: torch.Tensor, mesh: Mesh, dim: int = -1
                   ) -> torch.Tensor:
    """The model ranks' column shards of ``t`` as one tensor (a rank's
    slice of the gradient backward)."""
    return _GatherColumns.apply(t, dim % t.dim(), mesh.model_group,
                                mesh.model_index)


def column_parallel(fn: Callable, x: torch.Tensor, w: torch.Tensor,
                    mesh: Mesh, dim: int = -1) -> torch.Tensor:
    """``fn(x, w)`` for the whole weight, from this rank's column shard
    ``w``: ``fn(x, w_shard)`` gathered along the output's ``dim``."""
    y = fn(_CopyToModel.apply(x, mesh.model_group), w)
    return gather_columns(y, mesh, dim)


def shard_mesh(module: nn.Module, name: str) -> Optional[Mesh]:
    """The module's mesh where its parameter ``name`` is a column shard,
    else None."""
    if name in getattr(module, "dist_shards", ()):
        return module.dist_mesh
    return None


def columns(module: nn.Module, name: str, fn: Callable, x: torch.Tensor,
            w: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``fn(x, w)``, ``w`` taken from the module's parameter ``name``:
    :func:`column_parallel` where that parameter is a column shard."""
    mesh = shard_mesh(module, name)
    if mesh is None:
        return fn(x, w)
    return column_parallel(fn, x, w, mesh, dim)


def full_columns(module: nn.Module, name: str, w: torch.Tensor
                 ) -> torch.Tensor:
    """``w`` (from the module's parameter ``name``) whole: gathered where
    the parameter is a column shard."""
    mesh = shard_mesh(module, name)
    return w if mesh is None else gather_columns(w, mesh)


def sum_over_data(module: nn.Module, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the module's data group (with a summed gradient),
    or ``t`` itself outside data parallelism."""
    mesh = getattr(module, "dist_mesh", None)
    if mesh is None or mesh.data == 1:
        return t
    return _SumOverGroup.apply(t, mesh.data_group)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """A ``torch.Generator`` that draws for the global batch, of which this
    rank holds rows ``[data_index * n, (data_index + 1) * n)``: every rank
    draws the whole batch's numbers from the same generator state and keeps
    its rows, so the generators stay in lockstep with a one-process run's
    and the model ranks' replicated activations see the same draws."""

    gen: torch.Generator
    mesh: Mesh

    def global_shape(self, shape, batch_dim: int = 0) -> list:
        full = list(shape)
        full[batch_dim] *= self.mesh.data
        return full

    def rows(self, t: torch.Tensor, batch_dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``t``, drawn for the global batch."""
        n = t.shape[batch_dim] // self.mesh.data
        return t.narrow(batch_dim, self.mesh.data_index * n, n)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch's ``t`` (rows along dim 0) from every data
        rank's."""
        return all_gather_cat(t, 0, self.mesh.data_group)
