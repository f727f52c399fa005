"""The ``(data, model)`` mesh of ranks (port of
``myrtlespeech_tpu/parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` over its devices and lets
GSPMD insert the collectives.  Here each process drives one card (or the
CPU) and is one rank of a ``torch.distributed`` world, laid out as the JAX
package lays out its devices (``np.asarray(devices).reshape(data, model)``):

    rank = data_index * model + model_index

The ranks that share a data index hold one replica of the model, split
column-wise over them (tensor parallelism, the model group); the ranks that
share a model index hold the same shard of it and see different rows of the
global batch (data parallelism, the data group).

    python -m myrtlespeech_tpu_torch.run.cli --config C --num_processes 2 \\
        --process_id 0 --coordinator localhost:29500 --mesh_model 2
    torchrun --nproc_per_node 2 -m myrtlespeech_tpu_torch.run.cli --config C

(the second reads ``torchrun``'s environment).
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Seconds a collective may wait for the other ranks before it fails: a
# rank that skips a collective must fail the run, not hang it.
DEFAULT_TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's place in the ``(data, model)`` mesh.

    ``data_group`` (the ``data`` ranks of this model index) and
    ``model_group`` (the ``model`` ranks of this data index) exist wherever
    ``torch.distributed`` is initialised, of one rank too (the callbacks'
    sums and the checkpoints' waits run over them).  The train step takes
    the data-parallel path where ``data > 1`` and tensor parallelism where
    ``model > 1``; a group of one rank costs it no collective.  Without
    ``torch.distributed`` both are None and the run is the one-process
    path."""

    data: int
    model: int
    rank: int
    data_index: int
    model_index: int
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def world(self) -> int:
        return self.data * self.model


def rank_layout(data: int, model: int) -> np.ndarray:
    """The ranks as a ``(data, model)`` array, as the JAX package lays its
    devices out: row ``d`` is a data index's model group, column ``m`` a
    model index's data group."""
    return np.arange(data * model).reshape(data, model)


def make_mesh(data: Optional[int] = None, model: int = 1,
              world: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """This rank's :class:`Mesh` in a ``data x model`` layout of ``world``
    ranks (default: the ``torch.distributed`` world, or one rank when it is
    not initialised).  ``data=None`` takes ``world // model``.

    Every rank must call it, with the same arguments and at the same point:
    ``torch.distributed.new_group`` creates each group on every rank, in one
    order.  A layout that does not divide the world raises ``ValueError``.
    """
    initialized = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if initialized else 1
    if rank is None:
        rank = dist.get_rank() if initialized else 0
    if model < 1 or world % model != 0:
        raise ValueError(f"{world} ranks not divisible by model={model}")
    data = data if data is not None else world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if world > 1 and not initialized:
        raise RuntimeError(f"a mesh of {world} ranks needs torch.distributed "
                           "initialised (initialize_distributed)")
    layout = rank_layout(data, model)
    data_index, model_index = divmod(rank, model)
    data_group = model_group = None
    if initialized:
        # Every rank creates every group, data groups first.
        for m in range(model):
            g = dist.new_group(layout[:, m].tolist())
            if m == model_index:
                data_group = g
        for d in range(data):
            g = dist.new_group(layout[d].tolist())
            if d == data_index:
                model_group = g
    return Mesh(data=data, model=model, rank=rank, data_index=data_index,
                model_index=model_index, data_group=data_group,
                model_group=model_group)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "gloo",
                           timeout: float = DEFAULT_TIMEOUT_S,
                           device: Optional[torch.device] = None) -> bool:
    """``torch.distributed.init_process_group`` for a run of
    ``num_processes`` ranks (one too, given a ``coordinator``); a no-op
    (False) for one process without one.

    ``coordinator`` is ``host:port`` (rank 0 listens there), or an init URL
    (``tcp://``, ``file://``, ``env://``).  Each collective fails after
    ``timeout`` seconds.  With ``backend="nccl"`` every rank must drive a
    card of its own (``device``): two ranks on one card raise here, on
    every rank, before any collective runs."""
    if not coordinator:
        if num_processes and num_processes > 1:
            raise ValueError("a run of several processes needs a "
                             "coordinator address (host:port)")
        return False
    if not num_processes or process_id is None \
            or not 0 <= process_id < num_processes:
        raise ValueError(f"--coordinator needs --num_processes and a "
                         f"--process_id in [0, {num_processes})")
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    if backend == "nccl":
        _check_one_rank_a_card(device)
    return True


def _check_one_rank_a_card(device: Optional[torch.device]) -> None:
    """Raise on every rank when two NCCL ranks drive one card: NCCL does not
    take it, and the run must not go on some other way.  The ranks compare
    ``(host, card)`` over a gloo group, which needs no card."""
    if device is None or device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device a rank, not "
                         f"{device}")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (socket.gethostname(), index),
                           group=dist.new_group(backend="gloo"))
    if len(set(seen)) != len(seen):
        raise RuntimeError(
            f"nccl: several ranks drive one card ({seen}); give each rank "
            "its own card, or use --dist_backend gloo to share one")


def collective_device(group: Optional[dist.ProcessGroup]) -> torch.device:
    """Where a small tensor for a collective over ``group`` must lie: the
    current card under NCCL, else the CPU."""
    if group is not None and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_host(values, group: Optional[dist.ProcessGroup]) -> list:
    """The sums over ``group``'s ranks of a list of Python numbers (float64;
    the values themselves where ``group`` is None, in one process).  Every
    rank of the group must call it."""
    if group is None:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64,
                     device=collective_device(group))
    dist.all_reduce(t, group=group)
    return t.cpu().tolist()


def broadcast_host(value: float, src: int = 0) -> float:
    """Rank ``src``'s Python number on every rank of the world (a wait for
    ``src``)."""
    t = torch.tensor([value], dtype=torch.float64,
                     device=collective_device(dist.group.WORLD))
    dist.broadcast(t, src)
    return t.item()
