"""Tensor parallelism: parameters sharded over the non-dp axes of a mesh.

Counterpart: the ``param_spec_fn`` of ``mxnet_tpu/parallel/dp.py``
(:411-413, :486-497, :527-536, :851-855).  There ``param_spec_fn(name,
shape)`` returns a ``PartitionSpec`` (or None: replicated) for every
parameter, GSPMD inserts the collectives, and the step is the unsharded
step.  The port runs one process per device, so the collectives are
explicit, over the process subgroup of each mesh axis
(``parallel.mesh.Mesh.axis_group``):

  * **column-parallel** ``FullyConnected`` / ``Convolution`` (a weight
    sharded on dimension 0, its output features or channels, over one
    axis; ``num_group`` 1 and a channels-first layout for the
    convolution): each rank computes its slice of the output with the
    cuBLAS GEMM / cuDNN convolution, and the slices are all-gathered.
    The gather's backward is the rank's slice of the output gradient
    (everything downstream is replicated on every rank of the axis);
    the input gradient, a partial sum on each rank, is all-reduced.  A
    bias sharded the same way is added to the slice; any other bias
    after the gather;
  * **row-parallel** ``FullyConnected`` (a weight sharded on dimension
    1, its input features): the rank takes its slice of the input
    features, computes a partial product, and the outputs are
    all-reduced; the bias is added after;
  * **every other sharded parameter** (any dimension, any axes, several
    dimensions, an axis tuple such as ``P(("a", "b"))``, a weight whose
    consumer is another op, aux states) is **gathered on use**: the full
    value is all-gathered in the forward, and its backward takes the
    rank's slice of the gradient.

A spec entry names a non-dp axis of the mesh, a tuple of them, or None;
a spec naming ``dp``, an axis the mesh lacks, an axis twice, more
dimensions than the parameter has, or a dimension its axes do not
divide raises ``MXNetError`` and says why.  Axes of size 1 shard
nothing.

Between steps a rank holds only its shard of each sharded parameter
(:class:`ShardedArray`, the parameter's cell).  Reading the cell
(``Parameter.data()``, ``asnumpy``, ``save_parameters``, a checkpoint)
gives the global value, as the JAX package's global array does: the read
all-gathers over the parameter's axes, so it is a collective that every
rank of those axes makes, and the value stays cached until the next
step.  Writing the cell (``set_data``, ``load_parameters``) stores a
global value that the next step slices again.

On gloo every verb here (all-gather, all-reduce) takes CUDA tensors, as
NCCL does, so nothing is staged through host memory.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as _np
import torch

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["PartitionSpec", "P", "Layout", "layout_for", "ShardedArray",
           "shard_parameter", "sharded_scope", "FAULTS"]

#: planted faults for the numerics checks (names in here switch a
#: collective off): ``"input_grad_not_reduced"`` skips the all-reduce of
#: a column-parallel layer's input gradient
FAULTS: set = set()


class PartitionSpec(tuple):
    """The sharding of a parameter's dimensions over mesh axes, as
    ``jax.sharding.PartitionSpec``: one entry a dimension, each None
    (replicated), an axis name, or a tuple of axis names (the dimension
    split over their product, the first axis major); missing trailing
    entries are None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec


# ---------------------------------------------------------------------------
# collectives over one axis, differentiable
# ---------------------------------------------------------------------------
class _Axis:
    """One mesh axis as this rank sees it: its size, this rank's index
    on it and its process group."""

    __slots__ = ("name", "n", "index", "group")

    def __init__(self, mesh, name: str):
        self.name = name
        self.n = mesh.axis_size(name)
        self.index = mesh.axis_index(name)
        self.group = mesh.axis_group(name)


def _all_gather(t: torch.Tensor, dim: int, axis: _Axis) -> torch.Tensor:
    """The ranks' tensors of ``axis`` concatenated along ``dim``, in axis
    order."""
    import torch.distributed as dist

    moved = t.movedim(dim, 0).contiguous()
    full = moved.new_empty((moved.shape[0] * axis.n,) + moved.shape[1:])
    dist.all_gather_into_tensor(full, moved, group=axis.group)
    return full.movedim(0, dim)


def _slice(t: torch.Tensor, dim: int, axis: _Axis) -> torch.Tensor:
    w = t.shape[dim] // axis.n
    return t.narrow(dim, axis.index * w, w)


def _all_reduce(t: torch.Tensor, axis: _Axis) -> torch.Tensor:
    import torch.distributed as dist

    out = t.contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    return out


class _Gather(torch.autograd.Function):
    """Forward: all-gather along ``dim``; backward: this rank's slice of
    the (replicated) gradient."""

    @staticmethod
    def forward(ctx, t, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(t, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.axis).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    """Forward: this rank's slice along ``dim``; backward: all-gather of
    the slices' gradients."""

    @staticmethod
    def forward(ctx, t, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _slice(t, dim, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.axis), None, None


class _ReduceGrad(torch.autograd.Function):
    """Forward: the identity; backward: the all-reduce of the gradient
    (each rank holds a partial sum of it)."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if "input_grad_not_reduced" in FAULTS:
            return g, None
        return _all_reduce(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    """Forward: the all-reduce of partial sums; backward: the identity
    (the gradient is replicated)."""

    @staticmethod
    def forward(ctx, t, axis):
        return _all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------------
# a parameter's layout: specs resolved against the mesh
# ---------------------------------------------------------------------------
class Layout:
    """How one parameter lies over the mesh: ``shape`` (global),
    ``dims`` ((dimension, (axis, ...)) for each sharded dimension) and
    ``mode``: ``"column"`` / ``"row"`` / ``"bias"`` where a layer may
    split its compute on it, else ``"gather"``."""

    def __init__(self, name: str, shape: Tuple[int, ...], dims, mesh):
        self.name = name
        self.shape = tuple(shape)
        self.dims = list(dims)
        self.axes = {a: _Axis(mesh, a) for _, axes in self.dims
                     for a in axes}
        one = len(self.dims) == 1 and len(self.dims[0][1]) == 1
        dim = self.dims[0][0] if one else None
        nd = len(self.shape)
        if one and dim == 0 and nd == 1:
            self.mode = "bias"
        elif one and dim == 0 and nd in (2, 3, 4, 5):
            self.mode = "column"
        elif one and dim == 1 and nd == 2:
            self.mode = "row"
        else:
            self.mode = "gather"
        self.axis = self.axes[self.dims[0][1][0]] if one else None

    def __repr__(self):
        return "Layout(%s %s %s)" % (self.name, self.shape, self.dims)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a global value (a view)."""
        for d, axes in self.dims:
            for a in axes:               # major axis first
                full = _slice(full, d, self.axes[a])
        return full

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The global value from the ranks' shards, differentiable: its
        gradient is this rank's slice."""
        for d, axes in self.dims:
            for a in reversed(axes):     # minor axis first
                shard = _Gather.apply(shard, d, self.axes[a])
        return shard


def _entry_axes(entry, who) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    if isinstance(entry, (tuple, list)) and entry and \
            all(isinstance(a, str) for a in entry):
        return tuple(entry)
    raise MXNetError("%s: a spec entry is None, an axis name or a tuple "
                     "of axis names, not %r" % (who, entry))


def layout_for(name: str, shape, spec, mesh) -> Optional[Layout]:
    """``spec`` (``param_spec_fn``'s answer) resolved against ``mesh``:
    None for a replicated parameter, else its :class:`Layout`.  A spec
    the mesh cannot hold raises ``MXNetError`` and says why."""
    if spec is None:
        return None
    who = "param_spec_fn(%r, %s) = %r" % (name, tuple(shape), spec)
    if not isinstance(spec, (tuple, list)):
        raise MXNetError("%s: a spec is a PartitionSpec (a tuple), or "
                         "None for a replicated parameter" % who)
    shape = tuple(int(s) for s in shape)
    if len(spec) > len(shape):
        raise MXNetError("%s: the spec has %d entries, the parameter %d "
                         "dimensions" % (who, len(spec), len(shape)))
    have = dict(mesh.shape) if mesh is not None else {}
    seen, dims = set(), []
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry, who)
        for a in axes:
            if a == "dp":
                raise MXNetError(
                    "%s: parameters shard over the non-dp axes only; the "
                    "dp axis splits the batch (ZeRO-1 shards momenta over "
                    "it: zero_stage=1 on a dp mesh)" % who)
            if a not in have:
                raise MXNetError("%s: the mesh has no axis %r (its axes: "
                                 "%s)" % (who, a, sorted(have)))
            if a in seen:
                raise MXNetError("%s: axis %r shards two dimensions"
                                 % (who, a))
            seen.add(a)
        dims.append((d, axes))
    for d, axes in dims:
        n = int(_np.prod([have[a] for a in axes])) if axes else 1
        if shape[d] % n:
            raise MXNetError("%s: dimension %d of size %d does not divide "
                             "over %s of %d ranks"
                             % (who, d, shape[d], "x".join(axes), n))
    dims = [(d, tuple(a for a in axes if have[a] > 1)) for d, axes in dims]
    dims = [(d, axes) for d, axes in dims if axes]
    if not dims:
        return None
    return Layout(name, shape, dims, mesh)


# ---------------------------------------------------------------------------
# the parameter cell that holds a shard
# ---------------------------------------------------------------------------
_SLOT = NDArray._data          # the base class's storage descriptor


class ShardedArray(NDArray):
    """A parameter's cell under tensor parallelism: this rank's shard of
    the value, read as the global value.

    ``_shard`` is this rank's shard; the base class's storage slot holds
    the global value only after a read (an all-gather over the
    parameter's axes: a collective of every rank on them) or a write
    (``dirty``: the next step slices it again), and during a step the
    tensor the forward sees (:meth:`live`)."""

    __slots__ = ("_shard", "_layout", "_dirty")

    def __init__(self, shard: torch.Tensor, layout: Layout, ctx):
        _SLOT.__set__(self, None)
        self._ctx = ctx
        self._grad = None
        self._grad_req = "null"
        self._shard = shard
        self._layout = layout
        self._dirty = False

    @property
    def _data(self):
        full = _SLOT.__get__(self)
        if full is None:
            with torch.no_grad():
                full = self._layout.gather(self._shard)
            _SLOT.__set__(self, full)
        return full

    @_data.setter
    def _data(self, t):
        _SLOT.__set__(self, t)
        self._dirty = True

    @property
    def shape(self):
        return self._layout.shape

    @property
    def size(self) -> int:
        return int(_np.prod(self._layout.shape))

    @property
    def ndim(self) -> int:
        return len(self._layout.shape)

    @property
    def dtype(self):
        t = _SLOT.__get__(self)
        t = self._shard if t is None else t
        if t.dtype == torch.bfloat16:
            return torch.bfloat16
        from ..base import np_dtype

        return np_dtype(t.dtype)

    @property
    def shard(self) -> torch.Tensor:
        """This rank's shard (settled: a global value written since the
        last step is sliced first)."""
        if self._dirty:
            self._shard = self._layout.local(
                _SLOT.__get__(self).detach()).clone()
            self._dirty = False
        return self._shard

    def live(self, t: torch.Tensor) -> None:
        """The tensor the step's forward reads from this cell."""
        _SLOT.__set__(self, t)
        self._dirty = False

    def settle(self, shard: torch.Tensor) -> None:
        """After a step: ``shard`` is the new value; no global copy is
        kept."""
        self._shard = shard
        _SLOT.__set__(self, None)
        self._dirty = False

    def drop_global(self) -> None:
        """Free the cached global value (after settling a write)."""
        self.shard
        _SLOT.__set__(self, None)


def shard_parameter(param, layout: Layout) -> ShardedArray:
    """Give ``param`` a :class:`ShardedArray` cell holding this rank's
    shard of its current (global) value."""
    cell = param._data
    if isinstance(cell, ShardedArray):
        cell.drop_global()
        return cell
    full = cell._data.detach()
    out = ShardedArray(layout.local(full).clone(), layout, cell._ctx)
    param._data = out
    return out


# ---------------------------------------------------------------------------
# the step's forward: layers split their compute on marked shards
# ---------------------------------------------------------------------------
def _mark(t: torch.Tensor, layout: Layout) -> torch.Tensor:
    t._mx_tp = layout
    return t


def _mark_of(t):
    return getattr(t, "_mx_tp", None)


def _bias_shape(y, fdim):
    shape = [1] * y.ndim
    shape[fdim] = -1
    return shape


def _split(fn, raw, marks, fdim: int, row: bool):
    """One column- or row-parallel layer: ``fn`` is the op body, ``raw``
    its inputs (data, weight[, bias]), the weight a marked shard."""
    kw = getattr(fn, "keywords", {}) or {}
    lay = marks[1]
    axis = lay.axis
    x, w = raw[0], raw[1]
    b = raw[2] if len(raw) > 2 and not kw.get("no_bias", False) else None
    bmark = marks[2] if b is not None else None
    local_b = None
    if b is not None and not row and bmark is not None and \
            bmark.mode == "bias" and bmark.axis.name == axis.name:
        local_b = b
    if row:
        if kw.get("flatten", True):
            x = x.reshape(x.shape[0], -1)
        y = _Reduce.apply(fn(_Scatter.apply(x, x.ndim - 1, axis), w), axis)
    else:
        part = fn(_ReduceGrad.apply(x, axis), w, *(
            (local_b,) if local_b is not None else ()))
        y = _Gather.apply(part, fdim % part.ndim, axis)
    if b is not None and local_b is None:
        full_b = bmark.gather(b) if bmark is not None else b
        y = y + full_b.reshape(_bias_shape(y, fdim % y.ndim))
    return y


def dispatch(op, fn, raw):
    """The op hook of a tensor-parallel step (``ndarray.invoke``): None
    where no input is a marked shard, else a thunk computing the op —
    split where the layer allows it, else with every marked input
    gathered."""
    marks = [_mark_of(t) for t in raw]
    if not any(m is not None for m in marks):
        return None
    kw = getattr(fn, "keywords", {}) or {}
    wmark = marks[1] if len(marks) > 1 else None
    if wmark is not None and marks[0] is None:
        if op.name == "FullyConnected" and wmark.mode in ("column", "row"):
            return lambda: _split(fn, raw, marks, -1, wmark.mode == "row")
        if op.name == "Convolution" and wmark.mode == "column" and \
                int(kw.get("num_group", 1)) == 1 and \
                kw.get("layout") in (None, "NCW", "NCHW", "NCDHW"):
            return lambda: _split(fn, raw, marks, 1, False)
    full = [m.gather(t) if m is not None else t
            for t, m in zip(raw, marks)]
    return lambda: fn(*full)


class sharded_scope:
    """The forward and backward of a tensor-parallel step run inside:
    ``ndarray.invoke`` routes ops with a marked input through
    :func:`dispatch`."""

    def __enter__(self):
        from ..ndarray import ndarray as _nd

        _nd._OP_HOOKS.append(dispatch)
        return self

    def __exit__(self, *exc):
        from ..ndarray import ndarray as _nd

        _nd._OP_HOOKS.remove(dispatch)
        return False


def live_value(cell: ShardedArray, leaf: torch.Tensor) -> torch.Tensor:
    """What the forward reads from a sharded cell: the marked shard where
    a layer may split its compute on it, else the gathered global value
    (differentiable to ``leaf``)."""
    lay = cell._layout
    t = _mark(leaf, lay) if lay.mode != "gather" else lay.gather(leaf)
    cell.live(t)
    return t
