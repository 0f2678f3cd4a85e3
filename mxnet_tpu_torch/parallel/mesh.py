"""Device meshes over the ranks of a process group.

Counterpart: ``mxnet_tpu/parallel/mesh.py`` (:32-53).  A JAX mesh lays
the devices one controller sees on named axes.  The port runs one
process per device (``mxnet_tpu_torch.dist``), so a mesh names a
``torch.distributed`` process group laid out row-major over the axes,
as ``make_mesh((2, 2), ("dp", "sp"))`` lays devices: rank
``d * n_sp + s`` sits at ``(d, s)``.  ``devices`` lists each rank's
device, ``rank`` is this process's rank, :meth:`Mesh.axis_index` its
index on an axis, and :meth:`Mesh.axis_group` the subgroup of the ranks
that differ from it only on that axis (the collectives of one axis run
there).  Build it on every rank, after ``dist.initialize()``: a mesh of
more than one axis makes one subgroup per axis line with
``dist.new_group``, on every rank and in the same order, the lines a
rank is not on included.  A mesh over the process group runs the
collective path at any size, one rank included; a one-device mesh
without a group runs none.

A mesh never collapses onto fewer ranks than asked for: a shape larger
than the group raises (the JAX package's collapse of a context list
belongs to ``parallel.dp.DataParallelRunner``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as _np
import torch
import torch.distributed as _tdist

from .. import dist as _dist

__all__ = ["Mesh", "make_mesh", "data_parallel_mesh",
           "current_device_count"]


class Mesh:
    """Named axes over the ranks of a process group.

    ``devices`` (an object array of the mesh's shape: each rank's
    device), ``axis_names``, ``shape`` (axis name -> size), ``size``,
    ``collective`` (True over a process group: ``group`` None is the
    default group), ``rank`` (this process's rank) and ``device`` (its
    device).  ``axis_groups`` maps an axis to this rank's subgroup on
    it (None: the whole group, as on a mesh of one axis)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 collective: bool = False, group=None, rank: int = 0,
                 hosts: Optional[Sequence[str]] = None,
                 axis_groups: Optional[dict] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.collective = bool(collective)
        self.group = group
        self.rank = int(rank)
        self.hosts = list(hosts) if hosts is not None \
            else [None] * devices.size
        self.axis_groups = dict(axis_groups or {})

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self):
        return self.devices.flat[self.rank]

    def _check_axis(self, name: str) -> None:
        if name not in self.shape:
            raise ValueError("mesh %r has no axis %r" % (self, name))

    def axis_size(self, name: str) -> int:
        """The size of axis ``name`` (1 for an axis the mesh lacks)."""
        return int(self.shape.get(name, 1))

    def axis_index(self, name: str) -> int:
        """This rank's index on axis ``name`` (``lax.axis_index``)."""
        self._check_axis(name)
        coords = _np.unravel_index(self.rank, self.devices.shape)
        return int(coords[self.axis_names.index(name)])

    def axis_ranks(self, name: str) -> list:
        """The ranks of this rank's line along axis ``name``, in axis
        order (global ranks)."""
        self._check_axis(name)
        coords = list(_np.unravel_index(self.rank, self.devices.shape))
        a = self.axis_names.index(name)
        out = []
        for i in range(self.devices.shape[a]):
            coords[a] = i
            out.append(int(_np.ravel_multi_index(coords,
                                                 self.devices.shape)))
        return out

    def axis_group(self, name: str):
        """The process group of this rank's line along axis ``name``
        (None, the default group, where the axis spans every rank)."""
        self._check_axis(name)
        return self.axis_groups.get(name, self.group)

    def __repr__(self):
        return "Mesh(%s, rank=%d)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()), self.rank)


def current_device_count() -> int:
    """The devices a mesh can span: the ranks of the process group (one
    per process), or this process's one device without a group."""
    return _dist.num_processes()


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("dp",), devices=None):
    """A mesh of ``shape`` over the process group's ranks.  ``shape=None``
    puts every rank on one axis.  More ranks than the group has raise; a
    mesh of one device outside a one-rank group is this process's device
    alone (no collectives)."""
    world = _dist.num_processes()
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(tuple(axis_names)):
        raise ValueError("mesh shape %s and axis names %s differ in rank"
                         % (shape, tuple(axis_names)))
    total = int(_np.prod(shape))
    if total > world:
        raise ValueError(
            "mesh shape %s needs %d ranks; the process group has %d (one "
            "process per device: start them with python -m "
            "mxnet_tpu_torch.dist -n %d, then dist.initialize())"
            % (shape, total, world, total))
    if devices is not None and len(devices) < total:
        raise ValueError("mesh shape %s needs %d devices, %d given"
                         % (shape, total, len(devices)))
    if total == 1 and not (world == 1 and _tdist.is_initialized()):
        arr = _np.empty(1, dtype=object)
        arr[0] = list(devices)[0] if devices is not None else \
            _dist._info.get("device") or torch.device(
                "cuda" if torch.cuda.is_available() else "cpu")
        return Mesh(arr.reshape(shape), axis_names)
    if total != world:
        raise ValueError(
            "a mesh over %d of the process group's %d ranks is not "
            "supported: start %d processes" % (total, world, total))
    arr = _np.empty(total, dtype=object)
    for i, d in enumerate(list(devices)[:total] if devices is not None
                          else _dist.global_devices()):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names, collective=True,
                rank=_tdist.get_rank(), hosts=_dist.hosts(),
                axis_groups=_axis_groups(shape, tuple(axis_names),
                                         _tdist.get_rank()))


def _axis_groups(shape, axis_names, rank) -> dict:
    """This rank's subgroup on each axis shorter than the mesh: every
    line of every axis is made with ``dist.new_group`` on every rank, in
    the same order (axes in order, lines in row-major order of the
    other coordinates), since ``new_group`` is a collective of the
    whole group."""
    out = {}
    if len(shape) < 2:
        return out
    ids = _np.arange(int(_np.prod(shape))).reshape(shape)
    for a, name in enumerate(axis_names):
        if shape[a] == ids.size:
            continue                 # the whole group
        lines = _np.moveaxis(ids, a, -1).reshape(-1, shape[a])
        for line in lines:
            g = _tdist.new_group([int(r) for r in line])
            if rank in line:
                out[name] = g
    return out


def data_parallel_mesh(num_devices: Optional[int] = None):
    """A ``dp`` mesh over ``num_devices`` ranks (default: all)."""
    n = num_devices if num_devices is not None else _dist.num_processes()
    return make_mesh((int(n),), ("dp",))
