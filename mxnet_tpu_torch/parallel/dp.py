"""The fused train step, on one device or data-parallel over a dp mesh.

Counterpart: ``mxnet_tpu/parallel/dp.py``: ``shard_batch`` / ``replicate``
(:98, :108), the ZeRO-1 helpers (:132-330) and ``FusedTrainStep``
(:397-1173).  The JAX package compiles forward, loss, backward, the
gradient exchange and the update into one XLA program over a mesh; the
port runs the same step eagerly on torch (cuDNN convolutions and cuBLAS
GEMMs on the card), one process per device (``mxnet_tpu_torch.dist``),
with its semantics:

  * the first call settles deferred shapes with one float32 forward
    under ``autograd.pause()`` (inference mode: BatchNorm's running
    statistics do not move), then ``block.cast(dtype)`` casts every
    parameter, running statistics included; on a dp mesh rank 0 then
    broadcasts every parameter once;
  * every rank receives the GLOBAL batch, as the JAX step does, and
    trains on its rows ``[r*B/n, (r+1)*B/n)`` (``shard_batch``'s
    placement); the batch is cast to the compute dtype inside the step;
    the loss is the batch mean of the loss block, averaged over ranks;
  * inside the step BatchNorm's moments and SoftmaxOutput's
    normalisations are the global batch's
    (``ops.nn.cross_device_batch_stats``, sync BN);
  * gradients are taken over the parameters with a gradient (not the
    aux ones); on a mesh each reverse-layer-order bucket
    (``parallel.buckets``) is all-reduced from the backward pass as soon
    as its last gradient is written, then scaled by ``1/n``
    (``bucket_bytes=0``: one all-reduce over all gradients after
    backward, the monolithic reduction);
  * the update is ONE fused SGD-momentum per dtype group over a flat
    concatenation of the parameters (``optimizer.fused_sgd_mom_grouped``),
    or the per-key loop with ``fused_update=False``, bitwise equal;
    weight decay applies to every non-aux parameter; momenta start at
    zeros in the parameter dtype.  ``zero_stage=1`` (ZeRO-1, on the
    bucketed path) reduce-scatters each bucket instead, updates this
    rank's shard of the momenta and parameters and all-gathers the
    parameters: each rank holds 1/n of the momenta;
  * ``accum_steps`` (``MXNET_GRAD_ACCUM_STEPS``) splits this rank's
    batch into A microbatches: forward and backward per microbatch
    (BatchNorm's moving statistics move once per microbatch, in order,
    and random ops draw afresh each time), the gradients summed and
    scaled by ``1/A``, then ONE exchange and ONE update.  On a mesh the
    bucket hooks are armed for the last microbatch's backward only, so
    the earlier ones accumulate without a collective (DDP's
    ``no_sync``); sync BN still reduces each microbatch's moments;
  * the remat policy (``MXNET_REMAT_POLICY=stage|conv_block``) and the
    mirror (``MXNET_BACKWARD_DO_MIRROR``) apply to every microbatch's
    forward and backward (``remat.py``): the block runs as a block
    trace, and its forward and loss are the mirror's boundary.

Tensor parallelism (``param_spec_fn``, ``parallel.tensor``): on a mesh
with axes beside ``dp`` (``make_mesh((d, m), ("dp", "mp"))``), or with
a spec function that shards any parameter, every rank builds the same
step and holds its shard of each sharded parameter and of its momentum;
layers split their compute over the spec's axis or gather the parameter
on use (``parallel/tensor.py`` says which).  As in the JAX package the
step then keeps the monolithic reduction (no buckets: ``zero_stage=1``
warns and the momenta take the parameters' layout), gradients and sync
BN's moments are reduced over the dp axis only, and the step is the
unsharded step at the global batch.  ``run_steps``, ``accum_steps`` and
the remat policies run unchanged.  Sequence parallelism (an ``sp``
axis) is ``TransformerTrainStep``'s.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as _np
import torch

from .. import autograd, env as _env
from .. import profiler as _profiler
from .. import traceview as _traceview
from ..base import MXNetError, torch_dtype
from ..context import current_context
from ..ndarray import NDArray
from .. import optimizer as _opt
from . import buckets as _buckets
from .mesh import Mesh

__all__ = ["FusedTrainStep", "DataParallelRunner", "shard_batch",
           "replicate", "as_mesh",
           "zero1_stage", "zero1_bucket_elems", "zero1_momentum_buffers",
           "zero1_restage_flats", "zero1_flats_to_tree",
           "zero1_tree_to_flats", "zero1_bucketed_update",
           "momenta_bytes_per_device"]

_log = logging.getLogger(__name__)


def _mesh_size(mesh) -> int:
    devices = getattr(mesh, "devices", mesh)
    if isinstance(devices, (list, tuple)):
        return len(devices)
    size = getattr(devices, "size", None)
    return int(size) if size is not None else 1


def as_mesh(mesh, who: str, exc=MXNetError, axes=("dp",)
            ) -> Optional[Mesh]:
    """The mesh a train step runs over: None for one device (a mesh of
    one device outside a process group).  ``axes`` are the axes the step
    takes (``FusedTrainStep``: dp; ``TransformerTrainStep``: dp and sp).
    A mesh with another axis of more than one device, or a device list
    of more than one device that is not a ``parallel.mesh.Mesh``, raises
    ``exc``."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        n = _mesh_size(mesh)
        if n > 1:
            raise exc(
                "%s: a mesh of %d devices is a dp mesh over %d processes, "
                "one per device: call dist.initialize() on every rank, "
                "then parallel.mesh.data_parallel_mesh(%d)" % (who, n, n, n))
        return None
    extra = {a: s for a, s in mesh.shape.items() if a not in axes and s > 1}
    if extra:
        raise exc("%s: mesh axes %s are not taken here (it runs over %s)"
                  % (who, extra, "/".join(axes)))
    if "dp" not in mesh.axis_names:
        raise exc("%s: the mesh needs a 'dp' axis (got %s)"
                  % (who, mesh.axis_names))
    return mesh if mesh.size > 1 or mesh.collective else None


def shard_batch(arr, mesh, seq_axis: Optional[str] = None):
    """This rank's block of a global batch (an NDArray or a tensor): the
    rows ``[d*B/n, (d+1)*B/n)`` at its index d on the mesh's ``dp`` axis
    of n ranks, and with ``seq_axis`` the columns ``[s*T/m, (s+1)*T/m)``
    at its index s on that axis of m ranks (``P("dp", "sp")``); the
    batch itself on one device.  A batch that does not divide raises."""
    if mesh is None or mesh.size == 1:
        return arr
    t = arr._data if isinstance(arr, NDArray) else arr
    for dim, axis in ((0, "dp"), (1, seq_axis)):
        n = mesh.axis_size(axis) if axis in mesh.shape else 1
        if n == 1:
            continue
        size = int(t.shape[dim])
        if size % n:
            raise ValueError("the global batch's %d %s do not divide over "
                             "the mesh's %d %s ranks"
                             % (size, ("rows", "positions")[dim], n, axis))
        i, w = mesh.axis_index(axis), size // n
        t = t.narrow(dim, i * w, w)
    return NDArray.from_raw(t, arr.context) \
        if isinstance(arr, NDArray) else t


def replicate(arr, mesh):
    """Give every rank of the mesh rank 0's value of ``arr`` (an NDArray
    or a tensor, written in place); returns ``arr``."""
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        t = arr._data if isinstance(arr, NDArray) else arr
        with torch.no_grad():
            dist.broadcast(t.detach(), src=0, group=mesh.group)
    return arr


# ---------------------------------------------------------------------------
# ZeRO-1 (mxnet_tpu/parallel/dp.py:132-330): optimizer-state sharding over
# the dp axis.  Each bucket's gradient arrives by reduce-scatter (this
# rank receives its 1/n shard of the sum), the momentum + parameter
# update runs on the shard, and the updated parameter shards are
# all-gathered.  A rank holds only its shard of the momenta; the global
# flat buffers (padded to a multiple of n) exist in checkpoints.
# ---------------------------------------------------------------------------
def zero1_stage(override=None) -> int:
    """The selected ZeRO stage: explicit argument wins, else
    ``MXNET_ZERO_STAGE`` (0 = replicated, 1 = sharded momenta)."""
    stage = override if override is not None \
        else _env.get_int("MXNET_ZERO_STAGE")
    if stage not in (0, 1):
        raise ValueError("MXNET_ZERO_STAGE=%r: only stages 0 "
                         "(replicated) and 1 (sharded optimizer "
                         "state) exist" % (stage,))
    return int(stage)


def zero1_bucket_elems(plan) -> list:
    """True (unpadded) element count of each bucket's flat buffer — the
    invariant the elastic restage re-slices by."""
    return [int(b.nbytes) // _buckets.itemsize(b.dtype) for b in plan]


def _padded(elems: int, n: int) -> int:
    return elems + (-elems) % max(int(n), 1)


def zero1_momentum_buffers(plan, n: int, device=None) -> list:
    """This rank's zero momentum shards, one per bucket: ``1/n`` of the
    bucket's flat buffer padded to a multiple of ``n``."""
    return [torch.zeros(_padded(e, n) // n, device=device,
                        dtype=torch_dtype(b.dtype))
            for e, b in zip(zero1_bucket_elems(plan), plan)]


def _host_tensor(x) -> torch.Tensor:
    """A checkpointed array (numpy, or a bf16 tensor from the port's
    unpickler) as a flat CPU tensor in its own dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().reshape(-1)
    from ..convert import _to_tensor

    return _to_tensor(_np.asarray(x)).reshape(-1)


def zero1_restage_flats(flats, plan, n_new: int) -> list:
    """Re-slice checkpointed GLOBAL flat momentum buffers for an
    ``n_new``-way dp axis (on the host): trim each to its bucket's true
    element count (the old padding holds zeros by construction) and
    re-pad to a multiple of ``n_new``.  The identity when the dp size is
    unchanged.  A bucket count or layout other than the plan's raises:
    restage re-slices, it cannot re-bucket."""
    if len(flats) != len(plan):
        raise ValueError(
            "checkpoint has %d momentum buckets, this plan has %d — "
            "bucket caps changed between runs; pin bucket_bytes to "
            "resume" % (len(flats), len(plan)))
    out = []
    for bi, (flat, elems) in enumerate(zip(flats,
                                           zero1_bucket_elems(plan))):
        flat = _host_tensor(flat)
        if flat.numel() < elems:
            raise ValueError(
                "momentum bucket %d holds %d elements, plan needs %d — "
                "the bucket LAYOUT changed (not just the dp size); "
                "elastic restage only re-slices identical bucket plans"
                % (bi, flat.numel(), elems))
        flat = flat[:elems]
        pad = _padded(elems, n_new) - elems
        out.append(torch.cat([flat, flat.new_zeros(pad)]) if pad
                   else flat.clone())
    return out


def zero1_flats_to_tree(flats, plan, shapes) -> Dict:
    """Stage-1 flat momenta → ``{key: tensor}`` (the replicated side of
    the restage).  ``shapes`` maps key → shape."""
    if len(flats) != len(plan):
        raise ValueError("checkpoint has %d momentum buckets, this plan "
                         "has %d" % (len(flats), len(plan)))
    out = {}
    for flat, bucket in zip(flats, plan):
        missing = [k for k in bucket.keys if k not in shapes]
        if missing:
            raise KeyError("restage: bucket keys %s not in the live "
                           "param tree" % missing[:4])
        flat, off = _host_tensor(flat), 0
        for k in bucket.keys:
            sz = int(_np.prod(shapes[k], dtype=_np.int64))
            out[k] = flat[off:off + sz].reshape(tuple(shapes[k]))
            off += sz
    return out


def zero1_tree_to_flats(tree, plan, n: int) -> list:
    """``{key: momentum}`` → stage-1 GLOBAL flat buffers padded for an
    ``n``-way dp axis, in the update's packing order."""
    flats = []
    for bucket in plan:
        missing = [k for k in bucket.keys if k not in tree]
        if missing:
            raise KeyError("restage: checkpoint momenta missing keys %s"
                           % missing[:4])
        flat = torch.cat([_host_tensor(tree[k]) for k in bucket.keys])
        pad = _padded(flat.numel(), n) - flat.numel()
        flats.append(torch.cat([flat, flat.new_zeros(pad)]) if pad
                     else flat)
    return flats


def zero1_bucketed_update(grads, params, mom_shards, plan, mesh, *, lr,
                          momentum, wd, mean_n=None, flats=None,
                          scattered=None, sp_axis=None):
    """One ZeRO-1 step over the bucket plan on this rank.

    ``grads`` / ``params``: ``{key: tensor}`` (this rank's UNreduced
    gradients; the replicated parameters); ``mom_shards``: this rank's
    momentum shard per bucket.  Per bucket, in plan order: flat concat
    (or ``flats[i]``), padded to a multiple of n (the mesh's dp size) →
    with ``sp_axis`` an all-reduce over that axis (its ranks hold
    partial gradients of one replica) → reduce-scatter over dp (or
    ``scattered[i]``, already reduced) → multiply by ``1/mean_n`` → the
    fused update of this rank's shard → all-gather of the parameter
    shards over dp (issued asynchronously, so bucket k's gather overlaps
    bucket k+1's update).  Returns ``({key: new param}, [new momentum
    shards])``."""
    import torch.distributed as dist

    n, r = mesh.axis_size("dp"), mesh.axis_index("dp")
    group = mesh.axis_group("dp")
    mean_n = n if mean_n is None else int(mean_n)
    gathers, new_moms = [], []
    for bi, bucket in enumerate(plan):
        if scattered is not None:
            gsh = scattered[bi]
        else:
            flat_g = flats[bi] if flats is not None else \
                _buckets.pack_flats(grads, [bucket])[0]
            pad = (-flat_g.numel()) % n
            if pad:
                flat_g = torch.cat([flat_g, flat_g.new_zeros(pad)])
            if sp_axis is not None:
                dist.all_reduce(flat_g, group=mesh.axis_group(sp_axis))
            gsh = flat_g.new_empty(flat_g.numel() // n)
            dist.reduce_scatter_tensor(gsh, flat_g, group=group)
        if mean_n > 1:
            _buckets.scale_(gsh, mean_n)
        flat_w = _opt.pack_flat([params[k] for k in bucket.keys])
        size = flat_w.numel()
        shard = gsh.numel()
        lo, hi = r * shard, min((r + 1) * shard, size)
        wsh = flat_w[lo:hi]
        if hi - lo < shard:          # this rank's shard reaches the pad
            wsh = torch.cat([wsh, flat_w.new_zeros(shard - max(hi - lo,
                                                               0))])
        w_new, m_new = _opt.fused_sgd_mom_flat(wsh, gsh, mom_shards[bi],
                                               lr, momentum, wd)
        new_moms.append(m_new)
        full = w_new.new_empty(shard * n)
        gathers.append((bucket, size, full, dist.all_gather_into_tensor(
            full, w_new.contiguous(), group=group, async_op=True)))
    out = {}
    for bucket, size, full, work in gathers:
        work.wait()
        out.update(_buckets.unpack(full[:size], bucket.keys, params))
    return out, new_moms


def momenta_bytes_per_device(moms) -> int:
    """Largest per-device total of the momenta tensors' bytes (a dict or
    a list of tensors) held by this process: replicated state counts in
    full, a ZeRO-1 rank its shards."""
    vals = moms.values() if isinstance(moms, dict) else moms
    per_device = {}
    for m in vals:
        key = str(m.device)
        per_device[key] = per_device.get(key, 0) + \
            m.numel() * m.element_size()
    return max(per_device.values()) if per_device else 0


class DataParallelRunner:
    """The data-parallel side of a ``Module`` over a context list
    (counterpart: ``mxnet_tpu/parallel/dp.py:353-394``; ref:
    executor_group.py decide_slices).

    Under a process group of as many ranks as contexts, each rank binds
    its executor to its own device (``dist.device()``: two ranks may
    share one card over gloo) for its rows of the global batch, and the
    step keeps the JAX package's global-batch numerics: inside
    :meth:`batch_stats` BatchNorm's moments and SoftmaxOutput's
    normalisations are the global batch's (``ops.nn``'s sync path),
    :meth:`reduce_grads` sums each gradient over the ranks (the
    gradient of the global batch: with ``normalization="null"`` a sum,
    as the one-device ``Module`` at the global batch has it), and
    :meth:`gather` returns the global batch's outputs.  Parameters and
    aux states start from rank 0's (:meth:`broadcast`).

    Without a process group (or in a one-rank group) a list of more
    than one context collapses onto this process's device, with the JAX
    package's warning: the same math on one device.  A list that does
    not match a multi-rank group raises."""

    def __init__(self, contexts, bucket_bytes: Optional[int] = None):
        from .. import dist
        from ..context import Context
        from .mesh import data_parallel_mesh

        n, world = len(contexts), dist.num_processes()
        if world > 1:
            if n != world:
                raise ValueError(
                    "Module over %d contexts on a process group of %d "
                    "ranks: one context a rank (start %d processes)"
                    % (n, world, n))
            self.mesh = data_parallel_mesh()
            dev = dist.device()
            self.context = Context("cpu") if dev.type == "cpu" \
                else Context("gpu", dev.index or 0)
        else:
            _log.warning("requested %d devices, runtime has %d - "
                         "collapsing (parallelism reduced)", n, world)
            self.mesh = None
            self.context = Context(contexts[0])
        self._cap = bucket_bytes
        self._plans: Dict = {}

    @property
    def num_ranks(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    def local_shape(self, shape) -> tuple:
        """The per-rank shape of a global batch input."""
        n, b = self.num_ranks, int(shape[0])
        if b % n:
            raise ValueError("the global batch of %d rows does not divide "
                             "over the %d ranks" % (b, n))
        return (b // n,) + tuple(shape[1:])

    def local(self, arr):
        """This rank's rows of a global batch (an NDArray or a tensor)."""
        return shard_batch(arr, self.mesh)

    def batch_stats(self):
        """The context of a forward: batch statistics and loss
        normalisations over the global batch."""
        import contextlib

        from ..ops import nn as nn_ops

        if self.mesh is None:
            return contextlib.nullcontext()
        return nn_ops.cross_device_batch_stats("dp", self.mesh)

    def reduce_grads(self, grad_dict, names) -> None:
        """Sum the gradients ``grad_dict[name]`` over the ranks, bucket by
        bucket (``parallel.buckets``), written back into their cells."""
        if self.mesh is None:
            return
        live = {k: grad_dict[k]._data for k in names
                if grad_dict.get(k) is not None}
        key = tuple((k, tuple(v.shape), str(v.dtype))
                    for k, v in live.items())
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = _buckets.plan_for_arrays(
                live, self._cap)
            from .. import diagnostics as _diag

            _diag.set_bucket_plan(_buckets.plan_meta(plan, self._cap),
                                  owner=id(self))
        out = _buckets.bucketed_reduce(live, plan, self.mesh, mean=False,
                                       impl="psum")
        _buckets.stamp_profiler(plan, impl="psum", store_type="tpu")
        for k, v in out.items():
            grad_dict[k]._data = v

    def gather(self, outputs):
        """The global batch's outputs from every rank's rows, in rank
        order (NDArrays)."""
        if self.mesh is None:
            return outputs
        import torch.distributed as dist

        out = []
        for o in outputs:
            t = o._data.contiguous()
            full = t.new_empty((t.shape[0] * self.mesh.size,) +
                               tuple(t.shape[1:]))
            dist.all_gather_into_tensor(full, t, group=self.mesh.group)
            out.append(NDArray.from_raw(full, o.context))
        return out

    def broadcast(self, cells) -> None:
        """Every rank takes rank 0's value of each cell (NDArrays)."""
        for c in cells:
            replicate(c, self.mesh)


class FusedTrainStep:
    """Forward + loss + backward + gradient exchange + SGD-momentum
    update, on one device or over a dp mesh (one process per device).

    Parameters
    ----------
    block : an initialised gluon HybridBlock
    loss_fn : a gluon Loss block
    mesh : None (one device) or a ``parallel.mesh`` mesh with a ``dp``
        axis (and tensor-parallel axes beside it); every rank builds the
        same step and feeds it the same global batches
    param_spec_fn : ``fn(name, shape)`` -> a ``parallel.tensor.P`` over
        the mesh's non-dp axes, or None (replicated), for every
        parameter (tensor parallelism)
    learning_rate, momentum, weight_decay : the SGD-momentum update
    dtype : compute and parameter dtype (``block.cast`` at build); None
        keeps float32
    bucket_bytes : the gradient bucket cap (None:
        ``MXNET_KVSTORE_BUCKET_BYTES``; 0: the monolithic reduction)
    fused_update : one update per dtype group (True) or per key (False)
    zero_stage : None (``MXNET_ZERO_STAGE``), 0 or 1 (ZeRO-1, on the
        bucketed path; elsewhere it warns and stays replicated)
    accum_steps : None (``MXNET_GRAD_ACCUM_STEPS``) or the number of
        microbatches a step's batch is split into

    The step runs on the device the block's parameters were initialised
    on, or the current context where the block has none yet (the card
    by default: it raises where there is none and names ``mx.cpu()``).
    """

    def __init__(self, block, loss_fn, mesh=None, learning_rate=0.05,
                 momentum=0.9, weight_decay=0.0, param_spec_fn=None,
                 dtype=None, bucket_bytes=None, fused_update=True,
                 zero_stage=None, accum_steps=None):
        self._spec_fn = param_spec_fn
        self._spec_mesh = mesh if isinstance(mesh, Mesh) else None
        self.mesh = as_mesh(mesh, "FusedTrainStep", axes=tuple(
            getattr(mesh, "axis_names", ("dp",))))
        # the tensor-parallel step: a mesh with an axis beside dp
        self._tp = self.mesh is not None and \
            tuple(self.mesh.axis_names) != ("dp",)
        ctxs = [c for p in block.collect_params().values()
                for c in p.list_ctx()]
        self._ctx = ctxs[0] if ctxs else current_context()
        self._device = self._ctx.torch_device()
        self._block = block
        self._loss_fn = loss_fn
        self._lr = learning_rate
        self._momentum = momentum
        self._wd = weight_decay
        self._dtype = dtype
        self._bucket_bytes = bucket_bytes
        self._fused_update = bool(fused_update)
        self._zero_stage = zero_stage
        self._accum_steps = accum_steps
        self._bucketed = False
        self._zero1 = False
        self._tuning = None
        self._built = False

    @property
    def bucketed(self) -> bool:
        """True once built on the bucketed (overlapped) dp path."""
        return self._built and self._bucketed

    @property
    def zero1(self) -> bool:
        """True once built with ZeRO-1 sharded optimizer state."""
        return self._built and self._zero1

    def _build(self, sample: NDArray) -> None:
        """Settle deferred shapes with one float32 forward that moves no
        running statistic, cast, broadcast rank 0's parameters, plan the
        buckets and list the parameter cells; read the accumulation and
        remat knobs (build time, as the JAX package)."""
        from ..gluon.block import CachedOp
        from .. import remat as _remat

        self._grad_accum = _remat.grad_accum_steps(self._accum_steps)
        _remat.remat_policy()      # an unknown policy raises here

        with autograd.pause():
            settle = sample if sample._data.dtype == torch.float32 \
                else sample.astype("float32")
            self._block(settle)
        if self._dtype is not None:
            self._block.cast(self._dtype)
        cached = CachedOp(self._block)
        self._cells = [p for (_, _, p) in cached._param_cells]
        aux = set(cached._aux_positions)
        self._diff = [i for i in range(len(self._cells)) if i not in aux]
        self._compute_dtype = torch_dtype(self._dtype or "float32")
        mesh = self.mesh
        stage = zero1_stage(self._zero_stage)
        if mesh is not None:
            # every schedule name runs the backend's all-reduce; an
            # unknown one raises here
            _buckets.impl_name()
            for p in self._cells:
                replicate(p.data(), mesh)
        self._layouts = self._shard_params()
        if mesh is not None:
            cap = self._bucket_bytes if self._bucket_bytes is not None \
                else _buckets.bucket_cap_bytes()
            entries = [(i, tuple(self._value(i).shape),
                        _buckets.dtype_name(self._cells[i].data().dtype))
                       for i in self._diff]
            # tensor parallel: the monolithic reduction over dp, as the
            # JAX package (its gradients are not pure dp replicas)
            self._bucketed = cap != 0 and not self._tp
            if self._bucketed:
                # a tuned plan (MXNET_AUTOTUNE_PLAN / _DIR) moves only
                # the bucket boundaries; an explicit bucket_bytes pins
                # the cap and bypasses it
                self._plan, self._tuning = _buckets.plan_with_tuning(
                    entries, self._bucket_bytes)
            else:
                # monolithic: one all-reduce per dtype run, after backward
                self._plan = _buckets.partition(entries, 1 << 62)
            self._zero1 = stage == 1 and self._bucketed
            if not self._tp:
                self._reducer = _buckets.OverlappedReduce(
                    self._plan, mesh, scatter=self._zero1,
                    overlap=self._bucketed)
        if stage == 1 and not self._zero1:
            _log.warning("MXNET_ZERO_STAGE=1 requested but this step is "
                         "not on the bucketed multi-device dp path — "
                         "momenta stay replicated")
        if self._zero1:
            self._moms = zero1_momentum_buffers(self._plan, mesh.size,
                                                self._device)
        else:
            self._moms = [torch.zeros_like(self._value(i).detach())
                          for i in range(len(self._cells))]
        from .. import diagnostics as _diag

        # the plan traceview matches this step's collectives against; a
        # monolithic rebuild clears only its own stale plan
        self._plan_meta = _buckets.plan_meta(
            self._plan, self._tuning["cap_bytes"] if self._tuning
            else self._bucket_bytes, tuning=self._tuning) \
            if self._bucketed else None
        _diag.set_bucket_plan(self._plan_meta, owner=id(self))
        # recompile tracking and the auditor's work list, under the JAX
        # package's site names
        self._site_meta = {
            "compute_dtype": _buckets.dtype_name(self._compute_dtype),
            "bucket_plan": self._plan_meta,
            "remat_policy": _remat.remat_policy(),
            "grad_accum_steps": self._grad_accum,
            "n_ranks": mesh.size if mesh is not None else 1}
        self._step_call = _diag.instrument_jit(
            "FusedTrainStep.step", self._step, meta=self._site_meta)
        self._multi_call = _diag.instrument_jit(
            "FusedTrainStep.multi_step", self._run_multi,
            meta=self._site_meta)
        self._same_calls: Dict[int, object] = {}
        self._built = True

    def _shard_params(self) -> Dict[int, object]:
        """``param_spec_fn``'s layouts, ``{cell index: Layout}``; each
        sharded parameter's cell then holds this rank's shard."""
        if self._spec_fn is None:
            return {}
        from . import tensor as _tensor

        out = {}
        for i, p in enumerate(self._cells):
            shape = tuple(p.data().shape)
            lay = _tensor.layout_for(p.name, shape,
                                     self._spec_fn(p.name, shape),
                                     self._spec_mesh)
            if lay is not None:
                _tensor.shard_parameter(p, lay)
                out[i] = lay
        return out

    def _value(self, i: int) -> torch.Tensor:
        """Cell ``i``'s tensor on this rank: its shard where sharded."""
        if i in self._layouts:
            from . import tensor as _tensor

            return _tensor.shard_parameter(self._cells[i],
                                           self._layouts[i]).shard
        return self._cells[i].data()._data

    def param_bytes_per_rank(self) -> Optional[int]:
        """Parameter bytes resident on this rank (a sharded parameter
        counts its shard)."""
        if not self._built:
            return None
        return sum(self._value(i).numel() * self._value(i).element_size()
                   for i in range(len(self._cells)))

    def optimizer_state_bytes_per_rank(self) -> Optional[int]:
        """Momenta bytes resident on this rank's device, from the live
        tensors (ZeRO-1: ~1/n of replicated)."""
        if not self._built:
            return None
        return momenta_bytes_per_device(self._moms)

    def bucket_accounting(self):
        """Per-bucket rows ({bucket, n_grads, bytes, dtype}); None on one
        device or the monolithic path."""
        if not self.bucketed:
            return None
        return _buckets.accounting(self._plan)

    def grad_entries(self) -> List[tuple]:
        """``(key, shape, dtype)`` of every gradient the exchange
        carries, in layer order: what ``buckets.partition`` and a
        tuned plan's fingerprint see (empty before the build)."""
        if not self._built:
            return []
        return [(i, tuple(self._value(i).shape),
                 _buckets.dtype_name(self._value(i).dtype))
                for i in self._diff]

    def bucket_tuning(self):
        """The autotune meta the plan was built under (the caps and the
        plan file); None under the env default or off the bucketed
        path."""
        return self._tuning if self.bucketed else None

    def bucket_plan_meta(self):
        """``buckets.plan_meta`` of this step's plan (None off the
        bucketed path)."""
        return self._plan_meta if self.bucketed else None

    def _as_tensor(self, x) -> torch.Tensor:
        t = x._data.detach() if isinstance(x, NDArray) else \
            torch.as_tensor(_np.asarray(x))
        return t.to(self._device)

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor."""
        return shard_batch(t, self.mesh)

    def _update(self, params, grads):
        """The replicated SGD-momentum update of the diff cells."""
        lr, mom_c, wd = self._lr, self._momentum, self._wd
        if self._fused_update:
            return _opt.fused_sgd_mom_grouped(
                self._diff, params, grads, self._moms, lr, mom_c, wd)
        new_p, new_m = {}, {}
        for i in self._diff:
            g = grads[i] + wd * params[i]
            m = mom_c * self._moms[i] - lr * g
            new_p[i], new_m[i] = params[i] + m, m
        return new_p, new_m

    def _forward(self, x: torch.Tensor, y: torch.Tensor):
        """The recorded training forward and loss of one (micro)batch as
        a block trace and the mirror's boundary: (the batch-mean loss,
        the logits)."""
        from .. import remat as _remat

        ctx = self._ctx

        def fwd(x, y):
            with _remat.block_trace(), autograd.record(train_mode=True):
                out = self._block(NDArray.from_raw(x, ctx))
                loss = self._loss_fn(out, NDArray.from_raw(y, ctx))
            return loss._data.mean(), out._data

        with _traceview.annotation("mxnet-fwd"):
            return _remat.maybe_checkpoint(fwd)(x, y)

    def _microbatches(self, data: torch.Tensor, label: torch.Tensor):
        """This rank's batch in ``accum_steps`` equal slices."""
        a, b = self._grad_accum, int(data.shape[0])
        if b % a:
            raise ValueError("MXNET_GRAD_ACCUM_STEPS=%d does not divide "
                             "the per-device batch %d" % (a, b))
        mb = b // a
        return [(data[k * mb:(k + 1) * mb], label[k * mb:(k + 1) * mb])
                for k in range(a)]

    def _step(self, data: torch.Tensor, label: torch.Tensor):
        """One step on the global batch (tensors on the device); returns
        (loss averaged over ranks, this rank's logits)."""
        data, label = self._local(data), self._local(label)
        if data.dtype != self._compute_dtype:
            data = data.to(self._compute_dtype)
        micro = self._microbatches(data, label)
        if self._tp:
            return self._tp_step(micro)
        params = [p.data()._data for p in self._cells]
        if self.mesh is None:
            new_p, loss, out = self._one_device_step(params, micro)
        else:
            new_p, loss, out = self._dp_step(params, micro)
        with torch.no_grad():
            for i in self._diff:
                self._cells[i].data()._set_data(new_p[i].detach())
        if self._bucketed:
            # per-bucket comms spans + byte counters: the issue schedule
            _buckets.stamp_profiler(self._plan)
        return loss, out

    @staticmethod
    def _mean_of(losses, outs):
        """The loss (mean of the microbatch means) and the logits
        (concatenated) of an accumulation window."""
        if len(losses) == 1:
            return losses[0], outs[0]
        return torch.stack(losses).mean(), torch.cat(outs)

    def _one_device_step(self, params, micro):
        """Forward and backward per microbatch, the gradients summed and
        scaled by ``1/A``, then the update."""
        diff = [params[i] for i in self._diff]
        acc, losses, outs = None, [], []
        for x, y in micro:
            loss, out = self._forward(x, y)
            with _traceview.annotation("mxnet-bwd"):
                got = torch.autograd.grad(loss, diff, allow_unused=True)
            got = [torch.zeros_like(p) if g is None else g
                   for p, g in zip(diff, got)]
            acc = got if acc is None else [a + g for a, g in zip(acc, got)]
            losses.append(loss.detach())
            outs.append(out.detach())
        a = len(micro)
        if a > 1:
            acc = [g * torch.tensor(1.0 / a, dtype=g.dtype) for g in acc]
        grads = dict(zip(self._diff, acc))
        with torch.no_grad(), _traceview.annotation("mxnet-opt"):
            new_p, new_m = self._update(params, grads)
            for i in self._diff:
                self._moms[i] = new_m[i]
        loss, out = self._mean_of(losses, outs)
        return new_p, loss, out

    def _arms(self, k: int) -> bool:
        """Whether microbatch ``k``'s backward runs with the bucket hooks
        armed: the last one's only."""
        return k == self._grad_accum - 1

    def _dp_step(self, params, micro):
        """Forward and backward per microbatch with the bucket
        collectives issued from the last one's backward, then the
        update; every batch statistic is the global batch's."""
        import torch.distributed as dist

        from ..ops import nn as nn_ops

        mesh, red = self.mesh, self._reducer
        by_key = {i: params[i] for i in self._diff}
        losses, outs = [], []
        try:
            with nn_ops.cross_device_batch_stats("dp", mesh):
                for k, (x, y) in enumerate(micro):
                    if self._arms(k):
                        red.arm(by_key, prescale=len(micro))
                    loss, out = self._forward(x, y)
                    with _traceview.annotation("mxnet-bwd"):
                        loss.backward()
                    losses.append(loss.detach())
                    outs.append(out.detach())
            with _traceview.annotation("mxnet-bwd"):
                flats = red.finish()
        finally:
            red.disarm()
            for p in by_key.values():
                p.grad = None
        n = mesh.size
        with torch.no_grad(), _traceview.annotation("mxnet-opt"):
            if self._zero1:
                new_p, self._moms = zero1_bucketed_update(
                    None, by_key, self._moms, self._plan, mesh,
                    lr=self._lr, momentum=self._momentum, wd=self._wd,
                    scattered=flats)
            else:
                grads = {}
                for b, flat in zip(self._plan, flats):
                    grads.update(_buckets.unpack(
                        _buckets.scale_(flat, n), b.keys, by_key))
                new_p, new_m = self._update(params, grads)
                for i in self._diff:
                    self._moms[i] = new_m[i]
            loss, out = self._mean_of(losses, outs)
            # the loss averaged over ranks (the reference's pmean)
            loss = loss.clone()
            dist.all_reduce(loss, group=mesh.group)
            loss = loss / n
        return new_p, loss, out

    def _tp_step(self, micro):
        """The tensor-parallel step: forward and backward per microbatch
        with the sharded parameters read through ``parallel.tensor``
        (this rank's shard, or the gathered value), the gradients summed
        and scaled by ``1/A``, averaged over the dp axis in one
        all-reduce per dtype, then the update of the shards and the
        replicated parameters; every batch statistic is the global
        batch's (over dp: the other axes' ranks hold the same rows)."""
        import torch.distributed as dist

        from ..ops import nn as nn_ops
        from . import tensor as _tensor

        mesh, lays = self.mesh, self._layouts
        cells = {i: _tensor.shard_parameter(self._cells[i], lay)
                 for i, lay in lays.items()}
        diff_set = set(self._diff)
        params = []
        for i, p in enumerate(self._cells):
            if i in lays:
                t = cells[i].shard.detach()
                params.append(t.requires_grad_() if i in diff_set else t)
            else:
                params.append(p.data()._data)
        diff = [params[i] for i in self._diff]
        acc, losses, outs = None, [], []
        with _tensor.sharded_scope(), \
                nn_ops.cross_device_batch_stats("dp", mesh):
            for x, y in micro:
                for i, cell in cells.items():
                    if i not in diff_set:    # aux: the newest value
                        params[i] = cell.shard.detach()
                    _tensor.live_value(cell, params[i])
                loss, out = self._forward(x, y)
                with _traceview.annotation("mxnet-bwd"):
                    got = torch.autograd.grad(loss, diff,
                                              allow_unused=True)
                got = [torch.zeros_like(p) if g is None else g
                       for p, g in zip(diff, got)]
                acc = got if acc is None else \
                    [a + g for a, g in zip(acc, got)]
                losses.append(loss.detach())
                outs.append(out.detach())
        a = len(micro)
        if a > 1:
            acc = [g * torch.tensor(1.0 / a, dtype=g.dtype) for g in acc]
        grads = dict(zip(self._diff, acc))
        n_dp = mesh.axis_size("dp")
        with torch.no_grad(), _traceview.annotation("mxnet-opt"):
            if n_dp > 1:
                red = _buckets.bucketed_reduce(grads, self._plan, mesh,
                                               mean=True, axis="dp")
                if "shard_grad_not_reduced" in _tensor.FAULTS:
                    k = next(i for i in self._diff if i in lays)
                    red[k] = grads[k]
                grads = red
            new_p, new_m = self._update(params, grads)
            for i in self._diff:
                self._moms[i] = new_m[i]
            loss, out = self._mean_of(losses, outs)
            if n_dp > 1:
                loss = loss.clone()
                dist.all_reduce(loss, group=mesh.axis_group("dp"))
                loss = loss / n_dp
        for i, p in enumerate(self._cells):
            if i in cells:
                cells[i].settle(new_p[i].detach() if i in diff_set
                                else cells[i].shard.detach())
            elif i in diff_set:
                p.data()._set_data(new_p[i].detach())
        return loss, out

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every dp rank's rows of ``t``, in rank order (the global
        batch's logits)."""
        if self.mesh is None:
            return t
        import torch.distributed as dist

        n = self.mesh.axis_size("dp")
        t = t.contiguous()
        full = t.new_empty((t.shape[0] * n,) + t.shape[1:])
        dist.all_gather_into_tensor(full, t,
                                    group=self.mesh.axis_group("dp"))
        return full

    def _run_multi(self, data, label) -> List[torch.Tensor]:
        """One step per leading index of ``data`` / ``label``; the
        losses."""
        return [self._step(x, y)[0] for x, y in zip(data, label)]

    def _run_same(self, data, label, k: int) -> List[torch.Tensor]:
        """``k`` steps of one batch; the losses."""
        return [self._step(data, label)[0] for _ in range(int(k))]

    def audit_state(self) -> Dict[str, torch.Tensor]:
        """The parameter and optimizer-state tensors a step updates (the
        auditor's donation check compares their storage across one)."""
        out = {"param:%s" % self._cells[i].name: self._value(i)
               for i in self._diff}
        out.update(("momentum:%d" % i, m) for i, m in enumerate(self._moms)
                   if isinstance(m, torch.Tensor))
        return out

    def run_steps(self, data, label, steps=None) -> NDArray:
        """Run K optimizer steps.  ``data`` / ``label`` carry a leading K
        dim (one global batch per step), or, with ``steps``, are one
        batch used for every step.  Returns the per-step losses, shape
        (K,)."""
        d, lab = self._as_tensor(data), self._as_tensor(label)
        k = int(d.shape[0]) if steps is None else int(steps)
        if not self._built:
            self._build(NDArray.from_raw(
                self._local(d[0] if steps is None else d), self._ctx))
        if steps is None:
            run, args = self._multi_call, (d, lab)
        else:
            run = self._same_calls.get(k)
            if run is None:
                from .. import diagnostics as _diag

                # k in the name: each K is its own site, whose first
                # call is expected, not churn
                run = self._same_calls[k] = _diag.instrument_jit(
                    "FusedTrainStep.multi_step_same[k=%d]" % k,
                    self._run_same, meta=self._site_meta)
            args = (d, lab, k)
        prof = _profiler.is_running()
        if prof:
            t0 = _profiler._now_us()
        with _traceview.step_window("FusedTrainStep", k=k,
                                    device=self._device) as tvw:
            losses: List[torch.Tensor] = run(*args)
            if tvw is not None:
                tvw.block()
        if prof:
            # the span is the K steps' device wall time
            _profiler.sync_device(losses)
            _profiler.record_span("FusedTrainStep.run_steps[k=%d]" % k,
                                  t0, _profiler._now_us() - t0,
                                  cat="step")
        return NDArray.from_raw(torch.stack(losses), self._ctx)

    def __call__(self, data, label):
        """One optimizer step; returns ``(loss, logits)`` NDArrays (the
        global batch's logits on a mesh)."""
        d, lab = self._as_tensor(data), self._as_tensor(label)
        if not self._built:
            self._build(NDArray.from_raw(self._local(d), self._ctx))
        with _traceview.step_window("FusedTrainStep",
                                    device=self._device) as tvw:
            loss, logits = self._step_call(d, lab)
            if tvw is not None:
                tvw.block()
        return (NDArray.from_raw(loss, self._ctx),
                NDArray.from_raw(self._gather_rows(logits), self._ctx))
