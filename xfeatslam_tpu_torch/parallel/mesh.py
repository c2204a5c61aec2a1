"""A (data, model) mesh over the ranks of ``torch.distributed``.

Counterpart of ``xfeatslam_tpu/parallel/mesh.py``. JAX lays its devices out
as ``np.array(devices).reshape(data, model)``; here rank r sits at
(r // model, r % model), data-major the same way. The batch is split over
"data"; the wide layers' output features are split over "model"
(``parallel/train.py``).

The mesh never starts a process group: the caller does (``torchrun``, a
test), with NCCL for CUDA and gloo for the CPU. Without one, or with
``n_devices=1``, the mesh is this process alone and has no collective.
Its device is CUDA, the card of the rank's ``LOCAL_RANK``, unless the
caller asks for the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device


def all_gather(x, group, n: int, dim: int = 0):
    """The ``n`` ranks' ``x`` of ``group`` concatenated along ``dim``, in
    group rank order (``x`` itself when ``n`` is 1). Bool tensors travel as
    uint8. A feature dim other than 0 travels last, which a channels-last
    NCHW tensor already holds contiguous."""
    if n == 1:
        return x
    pos = 0 if dim == 0 else -1
    send = x.movedim(dim, pos).contiguous()
    if send.dtype == torch.bool:
        send = send.to(torch.uint8)
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, pos).to(x.dtype).movedim(pos, dim)


def all_sum(x, group, n: int):
    """``x`` summed over the ``n`` ranks of ``group``, as a new tensor
    (``x`` itself when ``n`` is 1)."""
    if n == 1:
        return x
    x = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class Mesh:
    """The (data, model) layout of the process group's ranks, and this
    rank's place in it. ``shape`` is {"data": d, "model": m}; ``coords``
    this rank's (data, model) coordinates; ``data_group`` the ranks that
    share this rank's model coordinate (they split the batch),
    ``model_group`` the ranks that share its data coordinate (they split the
    wide layers). A group's rank is the coordinate along its axis."""

    def __init__(self, data: int, model: int, rank: int, device,
                 data_group=None, model_group=None):
        self.shape = {"data": data, "model": model}
        self.size = data * model
        self.rank = rank
        self.coords = (rank // model, rank % model)
        self.device = device
        self.data_group = data_group
        self.model_group = model_group

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}"
                f", rank={self.rank}, device={self.device})")

    def shard_batch(self, x):
        """This rank's rows of a batch that every rank holds whole."""
        return data_sharding(self).local(x)

    def gather_batch(self, x):
        """The whole batch on every rank, from each rank's rows."""
        return data_sharding(self).full(x)

    def data_sum(self, x):
        """``x`` summed over the data axis (no gradient)."""
        return all_sum(x, self.data_group, self.shape["data"])


def make_mesh(n_devices: Optional[int] = None, data_axis: Optional[int] = None,
              device=None) -> Mesh:
    """The (data, model) mesh over the initialized process group's ranks.

    ``n_devices`` is the world size (the default) or 1: a process cannot
    take part of the ranks. With 1, or with no process group, the mesh is
    this process alone. The model axis is 2 when n >= 4 is even, else 1,
    unless ``data_axis`` says otherwise (XFeat's widest conv has 128
    channels, so throughput comes from the data axis). Every rank must call
    it: it makes the axes' process groups."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    n = world if n_devices is None else n_devices
    if n == 1:
        return Mesh(1, 1, 0, dev)
    if n != world:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{world} ranks; a mesh takes all of them or one")
    if data_axis is None:
        data_axis = n // (2 if n % 2 == 0 and n >= 4 else 1)
    if n % data_axis:
        raise ValueError(f"data axis {data_axis} does not divide {n} ranks")
    model = n // data_axis
    rank = dist.get_rank()
    # every rank makes every group, in the same order
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data_axis)])
        if rank % model == m:
            data_group = g
    for d in range(data_axis):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return Mesh(data_axis, model, rank, dev, data_group, model_group)


@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: split in equal parts along dim 0
    over ``axis`` ("data" or "model"), part i on coordinate i, or whole on
    every rank (``axis`` None)."""

    mesh: Mesh
    axis: Optional[str] = None

    def _axis(self):
        if self.axis is None:
            return 1, 0, None
        i = 0 if self.axis == "data" else 1
        group = self.mesh.data_group if i == 0 else self.mesh.model_group
        return self.mesh.shape[self.axis], self.mesh.coords[i], group

    def local(self, x):
        """This rank's part of the whole tensor ``x``."""
        n, i, _ = self._axis()
        size = x.shape[0]
        if size % n:
            raise ValueError(f"dim 0 of size {size} does not split "
                             f"over the {n} ranks of the {self.axis} axis")
        c = size // n
        return x.narrow(0, i * c, c)

    def full(self, x):
        """The whole tensor from this rank's part (a collective over the
        axis)."""
        n, _, group = self._axis()
        return all_gather(x, group, n)


def data_sharding(mesh: Mesh) -> Sharding:
    """A batch split over "data"."""
    return Sharding(mesh, "data")


def replicated(mesh: Mesh) -> Sharding:
    """A tensor whole on every rank."""
    return Sharding(mesh)


class _ToModel(torch.autograd.Function):
    """In front of a layer split over "model": the input as it is, its
    gradient summed over the model ranks (each rank's part of the layer
    gives part of it)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group, ctx.n), None, None


class _FromModel(torch.autograd.Function):
    """Behind a layer split over "model": the model ranks' output features
    gathered along ``dim``; backward, this rank's part of the gradient."""

    @staticmethod
    def forward(ctx, y, group, n, i, dim):
        ctx.i, ctx.c, ctx.dim = i, y.shape[dim], dim
        return all_gather(y, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.i * ctx.c, ctx.c), None, None, None, None


class ModelSplit:
    """A conv or linear layer that holds only this rank's part of its output
    features (dim 0 of its weight and bias) on a mesh's "model" axis.
    ``enter`` takes the layer's input and ``leave`` its output, whose
    features are at ``dim`` (1 for NCHW convs, -1 for linears): forward the
    whole output on every model rank, backward each rank's part (the
    Megatron column-parallel pair)."""

    def __init__(self, mesh: Mesh, dim: int):
        self.group, self.n = mesh.model_group, mesh.shape["model"]
        self.i, self.dim = mesh.coords[1], dim

    def enter(self, x):
        return _ToModel.apply(x, self.group, self.n)

    def leave(self, y):
        return _FromModel.apply(y, self.group, self.n, self.i, self.dim)

    def gather(self, part):
        """A parameter (or its gradient) whole from this rank's part, no
        gradient (a collective over the model ranks)."""
        return all_gather(part.detach(), self.group, self.n)
