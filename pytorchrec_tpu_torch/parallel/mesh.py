"""The ``(data, model)`` mesh on ``torch.distributed`` (port of
``pytorchrec_tpu/parallel/mesh.py``).

JAX's mesh is a grid of devices inside one program; here each device is one
process (a rank), and the mesh is the two sets of process groups a rank
takes part in. Rank ``r`` of a world of ``data * model`` sits at
``(r // model, r % model)``, as ``np.asarray(devices).reshape(data, model)``
places device ``r`` in the JAX mesh: a model group is a run of ``model``
consecutive ranks, a data group the ranks ``model`` apart. The data axis
splits each batch (dense data parallelism: gradients averaged over the data
group); the model axis splits the embedding tables' rows
(``parallel/sharding.py``), whose lookups are summed over the model group
(``parallel/embedding_engine.py``).

``initialize_distributed`` starts the process group: NCCL on the card, gloo
where the caller passes ``device="cpu"`` (or ``backend="gloo"``: gloo also
carries CUDA tensors, so two ranks can share one card, ``device="cuda:0"``,
where NCCL refuses two ranks on one device). ``make_mesh`` builds every group
on every rank, in one order, so no rank waits on a group another rank never
creates, and runs one collective on each group at once, so that each group's
communicator exists before a CUDA graph captures a step that uses it.

Unlike the JAX mesh, which may take fewer devices than there are, the mesh
covers the whole world: ``data * model`` is the world size.

The exchanges of ``parallel/embedding_engine.py`` name an axis as JAX's
collectives do: ``"data"``, ``"model"``, or ``("data", "model")``, the
whole grid flattened, whose index is the rank (``axis_size``,
``axis_index``, ``psum``, ``all_gather``, ``all_to_all``). Every rank of the
axis's group must reach each collective, in one order.

A model names a mesh axis as JAX's models do inside ``shard_map`` (the
two-tower model's ``global_negatives_axis``): ``bound(mesh)`` makes the mesh
reachable by axis name for the code it wraps (the sharded trainer wraps its
forward passes in it), and ``bound_mesh(axis)`` returns it there and raises
``NameError`` elsewhere, as JAX's unbound axis name does. ``all_gather_grad``
is ``jax.lax.all_gather(..., tiled=True)`` with its transpose: forward the
gather in index order, backward ``reduce_scatter_tensor`` (a sum) over the
same group, so each slice's owner gets the cotangents of every rank that
read it.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from pytorchrec_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _rank_device(device) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` unless ``device`` says
    otherwise (``"cpu"``). The local rank is ``LOCAL_RANK`` where a launcher
    set it, else the rank modulo the cards."""
    if device is not None:
        device = resolve_device(device)
        if device.type == "cpu" or device.index is not None:
            return device
    resolve_device("cuda")  # no card: raises
    local = os.environ.get("LOCAL_RANK")
    rank = dist.get_rank() if dist.is_initialized() else 0
    index = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def initialize_distributed(device=None, **kwargs) -> None:
    """Start the default process group (``init_process_group(**kwargs)``:
    ``init_method``, ``world_size``, ``rank``, ``timeout``, ...) with NCCL on
    the card or gloo for ``device="cpu"``; nothing when a group exists."""
    if dist.is_initialized():
        return
    kwargs.setdefault("backend", "gloo" if resolve_device(device).type == "cpu" else "nccl")
    dist.init_process_group(**kwargs)
    if kwargs["backend"] == "nccl":
        torch.cuda.set_device(_rank_device(device))


@dataclass
class Mesh:
    """This rank's place in the ``(data, model)`` grid, its two process
    groups and its device."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None
    backend: str = "gloo"

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    # -- collectives over a named axis (JAX's axis names); every rank of the
    # axis's group reaches each, in one order --

    def _axis(self, axis) -> Tuple[Any, int, int]:
        """(process group, size, this rank's index) of ``axis``: ``"data"``,
        ``"model"`` or ``("data", "model")`` (the world, index = rank)."""
        if axis == DATA_AXIS:
            return self.data_group, self.data, self.data_index
        if axis == MODEL_AXIS:
            return self.model_group, self.model, self.model_index
        if tuple(axis) == (DATA_AXIS, MODEL_AXIS):
            return dist.group.WORLD, self.world, self.rank
        raise ValueError(f"unknown mesh axis {axis!r}")

    def axis_size(self, axis) -> int:
        """``jax.lax.axis_size``: the ranks along ``axis``."""
        return self._axis(axis)[1]

    def axis_index(self, axis) -> int:
        """``jax.lax.axis_index``: this rank's place along ``axis``."""
        return self._axis(axis)[2]

    def psum(self, tensor: torch.Tensor, axis) -> torch.Tensor:
        """``tensor`` summed over ``axis``, in place."""
        dist.all_reduce(tensor, group=self._axis(axis)[0])
        return tensor

    def all_gather(self, tensor: torch.Tensor, axis) -> torch.Tensor:
        """``jax.lax.all_gather(..., tiled=True)``: the tensors along
        ``axis`` concatenated on dim 0, in index order (over the data axis, a
        batch's slices back in batch order; over the model axis, a table's
        row shards back in row order)."""
        group, size, _ = self._axis(axis)
        parts = [torch.empty_like(tensor) for _ in range(size)]
        dist.all_gather(parts, tensor.contiguous(), group=group)
        return torch.cat(parts)

    def all_to_all(self, tensor: torch.Tensor, axis) -> torch.Tensor:
        """``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)``
        over ``axis``: ``tensor [n, ...]`` (n = the axis's size) sends its
        row j to index j; row i of the result came from index i (source
        first)."""
        group, size, _ = self._axis(axis)
        if tensor.shape[0] != size:
            raise ValueError(f"all_to_all over {axis!r} of {size} ranks, given "
                             f"{tuple(tensor.shape)}")
        out = torch.empty_like(tensor, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, tensor.contiguous(), group=group)
        return out

    def barrier(self) -> None:
        """Every rank of the world reaches this point."""
        if self.device.type == "cuda" and self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


_BOUND: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar("bound_mesh",
                                                                         default=None)


@contextlib.contextmanager
def bound(mesh: Mesh) -> Iterator[Mesh]:
    """Inside: ``mesh``'s axes are reachable by name (``bound_mesh``), as
    inside JAX's ``shard_map`` over it."""
    token = _BOUND.set(mesh)
    try:
        yield mesh
    finally:
        _BOUND.reset(token)


def bound_mesh(axis) -> Mesh:
    """The mesh ``bound`` made reachable, which must have ``axis``; outside
    one, ``NameError`` (JAX's unbound axis name)."""
    mesh = _BOUND.get()
    if mesh is None:
        raise NameError(f"unbound axis name: {axis} (a model that names a mesh axis runs inside "
                        "a sharded trainer's forward, parallel.mesh.bound)")
    mesh._axis(axis)  # an axis the mesh does not have raises
    return mesh


class _AllGather(torch.autograd.Function):
    """``Mesh.all_gather`` over ``axis`` forward; the cotangent summed over
    the axis and scattered back to each slice's owner backward."""

    @staticmethod
    def forward(ctx, tensor: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_gather(tensor, axis)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        group, size, _ = ctx.mesh._axis(ctx.axis)
        out = grad.new_empty((grad.shape[0] // size, *grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad.contiguous(), group=group)
        return out, None, None


def all_gather_grad(tensor: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """``jax.lax.all_gather(tensor, axis, tiled=True)`` under autograd: the
    tensors along ``axis`` concatenated on dim 0 in index order; backward,
    each rank's slice of the summed cotangent (``psum_scatter``)."""
    return _AllGather.apply(tensor, mesh, axis)


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """The ``(data, model)`` mesh of this rank over the initialised world
    (``initialize_distributed`` first). ``data=None`` takes every rank the
    model axis leaves. ``device`` is ``"cpu"`` for a gloo world; by default
    the rank's card (``"cuda:0"`` for ranks sharing a card over gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("initialize_distributed() first: the mesh is made of its ranks")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        if world % model:
            raise ValueError(f"model={model} does not divide the world of {world} ranks")
        data = world // model
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks; the world has "
                         f"{world}")
    device = _rank_device(device)
    backend = dist.get_backend()
    if device.type == "cpu" and backend != "gloo":
        raise ValueError(f"device {device} on a {backend} world")
    mesh = Mesh(data=data, model=model, rank=rank, device=device, backend=backend)
    for i in range(data):  # runs of consecutive ranks
        ranks = [i * model + j for j in range(model)]
        group = dist.new_group(ranks)
        if rank in ranks:
            mesh.model_group = group
    for j in range(model):  # ranks model apart
        ranks = [i * model + j for i in range(data)]
        group = dist.new_group(ranks)
        if rank in ranks:
            mesh.data_group = group
    probe = torch.zeros((1,), device=device)
    mesh.psum(probe, MODEL_AXIS)
    mesh.psum(probe, DATA_AXIS)
    return mesh


@dataclass(frozen=True)
class DataSharding:
    """Batch arrays split along dim 0 over the data axis: data index ``i``
    of ``d`` keeps rows ``[i * B / d, (i + 1) * B / d)``."""

    size: int
    index: int

    def rows(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"a batch of {n} rows does not split over {self.size} data ranks")
        step = n // self.size
        return slice(self.index * step, (self.index + 1) * step)

    def local(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This data index's rows of every array of ``batch``."""
        out = {}
        for key, value in batch.items():
            out[key] = value[self.rows(len(value))]
        return out


@dataclass(frozen=True)
class Replicated:
    """A tensor every rank holds whole."""


def data_sharding(mesh: Mesh) -> DataSharding:
    """Batch arrays: leading dim split over the data axis."""
    return DataSharding(mesh.data, mesh.data_index)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated()

