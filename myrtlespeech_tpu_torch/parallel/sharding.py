"""Which parameters shard over ``model``, and moving state between the
one-process layout and a rank's shards (port of
``myrtlespeech_tpu/parallel/sharding.py``).

:func:`param_pspecs` is the JAX package's rule over the port's parameter
names (Flax's paths with ``.`` for ``/``, ``weights.py``): every leaf of two
or more dimensions whose name ends in ``w_ih``, ``w_hh``, ``kernel`` or
``embedding`` shards its last dimension over ``model`` (conv kernels too: the
JAX package's regex shards them), a 1-D leaf ending in ``_b`` (an RNN's gate
bias) shards, and everything else replicates: a Dense or conv ``bias``, a
GRU's ``_b_hh``, the lookahead weight, BatchNorm.  A leaf whose dimension does
not divide by the model size replicates (the joint's last layer to V=29).
``tp_rnn_weights=False`` replicates the recurrent leaves, so that only the
joint, FC and embedding matrices shard.  A spec is a tuple like the JAX
package's ``PartitionSpec``: ``(None, "model")`` or ``()``.

:func:`shard_model` replaces a whole model's sharded parameters with this
rank's column shards and marks its modules for ``parallel/tensor.py``;
:func:`shard_params` and :func:`gather_params` move a state_dict between the
layouts, :func:`shard_optimizer_state` and :func:`gather_optimizer_state` the
optimizer's, whose moments follow their parameters' shards by position (the
counterpart of ``state_shardings``' tree-structure match).  Checkpoints and
the eval stage use them (``run/checkpoint.py``, ``run/train.py``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

from myrtlespeech_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from myrtlespeech_tpu_torch.parallel.tensor import all_gather_cat

# Names whose LAST dim shards over the model axis.
_COL_SHARDED = re.compile(r"(w_ih|w_hh|kernel|embedding)$")
# 1-D parameters that pair with column-sharded matrices (gate biases).
_BIAS_SHARDED = re.compile(r"(_b)$")
# The recurrent weights: replicated with ``tp_rnn_weights=False``.
_RNN_PARAM = re.compile(r"(w_ih|w_hh|_b)$")


def _spec_for(name: str, ndim: int, tp_rnn_weights: bool) -> tuple:
    if ndim == 0:
        return ()
    last = name.rsplit(".", 1)[-1]
    if not tp_rnn_weights and _RNN_PARAM.search(last):
        return ()
    if ndim >= 2 and _COL_SHARDED.search(last):
        return (None,) * (ndim - 1) + (MODEL_AXIS,)
    if ndim == 1 and _BIAS_SHARDED.search(last):
        return (MODEL_AXIS,)
    return ()


def param_pspecs(params: Mapping[str, torch.Tensor], model_size: int = 1,
                 tp_rnn_weights: bool = True) -> Dict[str, tuple]:
    """The spec of each parameter of ``params`` (name -> tensor, or
    anything with a ``shape``), replicated where the sharded dimension does
    not divide by ``model_size``."""
    specs = {}
    for name, p in params.items():
        shape = tuple(p.shape)
        spec = _spec_for(name, len(shape), tp_rnn_weights)
        if any(axis == MODEL_AXIS and shape[d] % model_size
               for d, axis in enumerate(spec)):
            spec = ()
        specs[name] = spec
    return specs


def sharded_dim(spec: tuple) -> Optional[int]:
    """The dimension a spec shards over ``model``, or None."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return t.chunk(mesh.model, dim)[mesh.model_index].clone()


def shard_model(model: nn.Module, mesh: Mesh,
                tp_rnn_weights: bool = True) -> Dict[str, tuple]:
    """Replace each sharded parameter of ``model`` (built whole) with this
    rank's columns, mark every module with ``dist_mesh`` and the sharding
    modules with ``dist_shards``; returns the specs.  Build the optimizer
    after this: the parameters are new objects."""
    params = dict(model.named_parameters())
    if mesh.model == 1:  # nothing to split
        specs = {name: () for name in params}
    else:
        specs = param_pspecs(params, mesh.model, tp_rnn_weights)
    for name, spec in specs.items():
        dim = sharded_dim(spec)
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        setattr(module, leaf, nn.Parameter(
            _shard(getattr(module, leaf).detach(), dim, mesh)))
        module.dist_shards = getattr(module, "dist_shards",
                                     frozenset()) | {leaf}
    for module in model.modules():
        module.dist_mesh = mesh
    return specs


def shard_params(full: Mapping[str, torch.Tensor], specs: Mapping[str, tuple],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A one-process state_dict as this rank's: sharded parameters cut to
    its columns; buffers and replicated parameters as they are."""
    out = {}
    for name, t in full.items():
        dim = sharded_dim(specs.get(name, ()))
        out[name] = t if dim is None else _shard(t, dim, mesh)
    return out


def gather_params(local: Mapping[str, torch.Tensor],
                  specs: Mapping[str, tuple], mesh: Mesh
                  ) -> Dict[str, torch.Tensor]:
    """A rank's state_dict in the one-process layout: every shard gathered
    over the model group.  Every rank of the group must call it."""
    out = {}
    for name, t in local.items():
        dim = sharded_dim(specs.get(name, ()))
        out[name] = t if dim is None else all_gather_cat(
            t.detach(), dim, mesh.model_group)
    return out


def _map_moments(state_dict: dict, names: List[str],
                 specs: Mapping[str, tuple], fn) -> dict:
    """``state_dict`` (``torch.optim``'s) with ``fn(tensor, dim)`` applied
    to every per-parameter tensor (Adam's moments, SGD's momentum) of a
    sharded parameter, matched to it by position; step counts and the
    param groups as they are."""
    state = {}
    for idx, st in state_dict["state"].items():
        dim = sharded_dim(specs.get(names[idx], ()))
        state[idx] = {k: fn(v, dim) if dim is not None and torch.is_tensor(v)
                      and v.dim() > dim else v for k, v in st.items()}
    return {"state": state, "param_groups": state_dict["param_groups"]}


def shard_optimizer_state(state_dict: dict, names: List[str],
                          specs: Mapping[str, tuple], mesh: Mesh) -> dict:
    """A one-process optimizer state_dict as this rank's (``names``: the
    model's parameter names in ``parameters()`` order)."""
    return _map_moments(state_dict, names, specs,
                        lambda t, dim: _shard(t, dim, mesh))


def gather_optimizer_state(state_dict: dict, names: List[str],
                           specs: Mapping[str, tuple], mesh: Mesh) -> dict:
    """A rank's optimizer state_dict in the one-process layout.  Every rank
    of the model group must call it."""
    return _map_moments(state_dict, names, specs,
                        lambda t, dim: all_gather_cat(t, dim,
                                                      mesh.model_group))
