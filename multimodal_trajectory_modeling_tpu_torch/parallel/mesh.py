"""Process-group meshes for data-parallel and restart-parallel training.

Counterpart of ``multimodal_trajectory_modeling_tpu/parallel/mesh.py``.
The JAX package's 1-D ``"data"`` mesh is, here, an initialized
``torch.distributed`` process group: every rank runs the same (SPMD)
trainer on the global arrays, takes its contiguous block of the
trajectory axis, and reduces the additive statistics with collectives.
The natural parallel axes of this model family:

- ``data``: trajectories; the E step is embarrassingly parallel, the M
  step all-reduces additive sufficient statistics;
- ``start`` / ``restart``: independent EM restarts, no communication.

The backend is the caller's, through the group it initializes and passes
in: NCCL takes one card a rank; several ranks on one card need gloo, which
all-reduces and broadcasts CUDA tensors but gathers only host tensors
(:func:`all_gather` says where it copies).  Nothing here switches backend
or device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "all_gather",
    "all_reduce",
    "data_sharding",
    "make_mesh",
    "replicated",
    "shard_trajectories",
]


@dataclass(frozen=True)
class Mesh:
    """A mesh over the ranks of ``group``: its ``axis_names`` and
    ``shape`` (row-major over the ranks), this rank's ``rank`` and the
    ``size`` of the group, and for each axis the subgroup of the ranks
    that differ only along it, with this rank's index on it
    (``axes[name] = (group, index, size)``)."""

    group: object
    rank: int
    size: int
    axis_names: tuple
    shape: tuple
    axes: dict = field(repr=False)

    def axis(self, name: str):
        """``(group, index, size)`` of axis ``name``."""
        if name not in self.axes:
            raise ValueError(f"the mesh has no axis {name!r}: {self.axis_names}")
        return self.axes[name]


def make_mesh(
    n_devices: int = None,
    axis_names: tuple = ("data",),
    *,
    shape: tuple = None,
    group=None,
) -> Mesh:
    """A mesh over the initialized process group ``group`` (default the
    world).  One axis name: a 1-D mesh of all its ranks (``n_devices``,
    if given, must be the group's size).  Several names: ``shape`` gives
    the mesh's extent on each, row-major over the ranks; every rank must
    call this together, since each axis's subgroups are created with
    ``dist.new_group`` (the 2-D restart × data mesh)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices}, but the group has {size} ranks")
    axis_names = tuple(axis_names)
    if len(axis_names) == 1:
        return Mesh(group, rank, size, axis_names, (size,), {axis_names[0]: (group, rank, size)})
    if shape is None or len(shape) != len(axis_names) or math.prod(shape) != size:
        raise ValueError(f"shape {shape} does not lay {axis_names} over {size} ranks")
    ranks = torch.arange(size).reshape(shape)
    members = dist.get_process_group_ranks(group)
    coords = [int(c) for c in (ranks == rank).nonzero()[0]]
    axes = {}
    for a, name in enumerate(axis_names):
        lines = ranks.movedim(a, -1).reshape(-1, shape[a])
        mine = None
        for line in lines.tolist():  # every rank creates every subgroup, in order
            sub = dist.new_group([members[r] for r in line])
            if rank in line:
                mine = sub
        axes[name] = (mine, coords[a], shape[a])
    return Mesh(group, rank, size, axis_names, tuple(shape), axes)


def _block(n: int, size: int, index: int, what: str) -> slice:
    """This rank's contiguous block of an axis of length ``n`` split over
    ``size`` ranks; raises where ``shard_map`` would (``n`` not divisible)."""
    if n % size:
        raise ValueError(f"{what} of length {n} does not divide over {size} ranks")
    b = n // size
    return slice(index * b, (index + 1) * b)


def data_sharding(mesh: Mesh, rank: int, data_axis: int, name: str = "data"):
    """The layout ``P(None, .., name, .., None)`` for arrays of ``rank``
    dimensions: a function that returns this rank's contiguous block of
    axis ``data_axis`` (a view), everything else whole."""
    _group, index, size = mesh.axis(name)

    def shard(a):
        if a.ndim != rank:
            raise ValueError(f"expected {rank} dimensions, got {a.ndim}")
        idx = [slice(None)] * rank
        idx[data_axis] = _block(a.shape[data_axis], size, index, f"axis {data_axis}")
        return a[tuple(idx)]

    return shard


def replicated(mesh: Mesh):
    """The layout ``P()``: every rank holds the whole array."""
    return lambda a: a


def shard_trajectories(mesh: Mesh, z, x, v, patterns, pattern_id):
    """This rank's block of the packed training set: ``z``/``x`` (T, n, ·)
    along axis 1, ``v`` (n, D) and ``pattern_id`` (n,) along axis 0,
    ``patterns`` whole."""
    return (
        data_sharding(mesh, 3, 1)(z),
        data_sharding(mesh, 3, 1)(x),
        data_sharding(mesh, 2, 0)(v),
        replicated(mesh)(patterns),
        data_sharding(mesh, 1, 0)(pattern_id),
    )


def all_reduce(t: torch.Tensor, mesh: Mesh, name: str = "data", op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``lax.psum`` (or ``pmax`` with ``op=MAX``) over axis ``name``: a
    reduced copy of ``t`` on every rank of the axis, on ``t``'s device
    (gloo and NCCL both reduce CUDA tensors)."""
    group, _index, size = mesh.axis(name)
    out = t.clone()
    if size > 1:
        dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, mesh: Mesh, name: str = "data", dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along axis ``name``, concatenated on ``dim`` in
    rank order (equal shapes on every rank), on ``t``'s device.  Under
    gloo a CUDA tensor is copied to the host for the gather and back (gloo
    gathers host tensors only); under NCCL it is gathered on the card."""
    group, _index, size = mesh.axis(name)
    if size == 1:
        return t.clone()
    src = t.contiguous()
    if src.device.type == "cuda" and dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)
