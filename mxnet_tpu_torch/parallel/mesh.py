"""Device meshes over the ranks of a process group.

Counterpart: ``mxnet_tpu/parallel/mesh.py`` (:1-59).  A JAX mesh lays
the devices one controller sees on named axes.  The port runs one
process per device (``mxnet_tpu_torch.dist``), so a mesh names a
``torch.distributed`` process group: its ``dp`` axis is the group's
ranks, ``devices`` lists each rank's device, and ``rank`` is this
process's index on the axis.  Build it on every rank, after
``dist.initialize()``.  A mesh over the process group runs the dp path
at any size, one rank included (its collectives run on one rank); a
one-device mesh without a group runs none.

A mesh never collapses onto fewer ranks than asked for: a shape larger
than the group raises (the JAX package's collapse belongs to
``DataParallelRunner``, ROADMAP A6b).
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
    default group), ``rank`` (this process's index) and ``device`` (its
    device)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 collective: bool = False, group=None, rank: int = 0,
                 hosts: Optional[Sequence[str]] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.collective = bool(collective)
        self.group = group
        self.rank = int(rank)
        self.hosts = list(hosts) if hosts is not None \
            else [None] * devices.size

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self):
        return self.devices.flat[self.rank]

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
                rank=_tdist.get_rank(), hosts=_dist.hosts())


def data_parallel_mesh(num_devices: Optional[int] = None):
    """A ``dp`` mesh over ``num_devices`` ranks (default: all)."""
    n = num_devices if num_devices is not None else _dist.num_processes()
    return make_mesh((int(n),), ("dp",))
