"""Gradient buckets: the reverse-layer-order plan and its all-reduce.

Counterpart: ``mxnet_tpu/parallel/buckets.py`` (:53-430).  The gradient
tree is partitioned into reverse-layer-order, size-capped,
dtype-homogeneous buckets (the JAX package's plan exactly, so that
checkpoints cross-load); each bucket is one flat concat and ONE
all-reduce over the mesh's process group, in the bucket's own dtype:
the sum first, then a multiply by ``1/n`` in that dtype, as the
reference's ``psum`` then scale (``ReduceOp.AVG`` would round
otherwise).  :class:`OverlappedReduce` issues each bucket's collective
from the backward pass, as soon as the bucket's last gradient is
written (``register_post_accumulate_grad_hook``), so the reductions of
the deepest layers ride under the rest of backward: the NCCL-DDP
schedule the reference reaches through XLA's scheduler.

``MXNET_KVSTORE_BUCKET_IMPL=ring|hierarchical`` name XLA-side schedules
in the JAX package.  On NCCL the algorithm is NCCL's own (it picks ring
or tree per message), so the port accepts the three names and runs the
backend's all-reduce for each.  ``MXNET_KVSTORE_BUCKET_CHAIN`` is
reported only: a process group runs its collectives in issue order.
Each bucket's pack and collective run under the ``mxbkt%03d`` trace
scope (a ``traceview.annotation``): the channel by which a device
trace tells a bucket's all-reduce from sync BatchNorm's, which run the
same NCCL kernel.  :func:`stamp_profiler` stamps one comms span per
bucket and the cumulative byte counters (the issue schedule) while the
profiler runs.  Tuned caps (``MXNET_AUTOTUNE_PLAN`` / ``_DIR``, the
port's ``autotune`` package) set the first, middle and last caps of
:func:`partition` through :func:`plan_with_tuning`; they move only the
bucket boundaries, and :func:`plan_meta` records them under
``autotune``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, \
    Tuple

import torch

from .. import env as _env
from .. import traceview as _traceview

__all__ = ["DEFAULT_BUCKET_BYTES", "Bucket", "bucket_cap_bytes",
           "chain_enabled", "impl_name", "dtype_name", "itemsize",
           "partition", "plan_with_tuning", "plan_for_arrays",
           "host_local_count", "pack_flats", "scale_", "unpack",
           "bucketed_reduce", "OverlappedReduce", "accounting",
           "plan_meta", "stamp_profiler"]

DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024
_IMPLS = ("psum", "ring", "hierarchical")
_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
             "int64": 8, "int32": 4, "int8": 1, "uint8": 1}


class Bucket(NamedTuple):
    """One reduction unit: ``keys`` in issue order, homogeneous dtype."""
    keys: Tuple
    nbytes: int
    dtype: str


def bucket_cap_bytes() -> int:
    """The size cap, ``MXNET_KVSTORE_BUCKET_BYTES`` (default 4 MiB; 0
    asks for the monolithic reduction)."""
    return _env.get_int("MXNET_KVSTORE_BUCKET_BYTES")


def chain_enabled() -> bool:
    """``MXNET_KVSTORE_BUCKET_CHAIN`` (reported in ``plan_meta``)."""
    return _env.get_bool("MXNET_KVSTORE_BUCKET_CHAIN")


def impl_name() -> str:
    """``MXNET_KVSTORE_BUCKET_IMPL``: 'psum', 'ring' or 'hierarchical';
    each runs the process group's own all-reduce here.  Another name
    raises."""
    name = _env.get_str("MXNET_KVSTORE_BUCKET_IMPL")
    if name not in _IMPLS:
        raise ValueError("MXNET_KVSTORE_BUCKET_IMPL=%r: one of %s"
                         % (name, ", ".join(_IMPLS)))
    return name


def dtype_name(dtype) -> str:
    """``'float32'`` for ``torch.float32``, a numpy dtype or a string."""
    return str(dtype).replace("torch.", "")


def itemsize(dtype) -> int:
    name = dtype_name(dtype)
    if name not in _ITEMSIZE:
        raise ValueError("no bucket item size for dtype %r" % (name,))
    return _ITEMSIZE[name]


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * itemsize(dtype)


def partition(entries: Sequence[Tuple], cap_bytes: Optional[int] = None,
              *, first_cap_bytes: Optional[int] = None,
              last_cap_bytes: Optional[int] = None) -> List[Bucket]:
    """Partition ``entries`` — ``(key, shape, dtype)`` in layer order —
    into reverse-layer-order buckets, the JAX package's greedy fill: a
    bucket closes when the next gradient would exceed its cap or change
    dtype; a gradient larger than the cap gets a bucket of its own.

    The tuned plans' asymmetry, as the JAX package has it:
    ``first_cap_bytes`` caps bucket 0 on its own (a small first bucket
    puts the first collective on the wire early in backward);
    ``last_cap_bytes`` (> cap) folds trailing buckets together (the
    tail's collectives issue after backward, so fewer launches cost no
    overlap).  Folding never touches bucket 0 and never mixes dtypes."""
    if cap_bytes is None:
        cap_bytes = bucket_cap_bytes()
    cap = max(int(cap_bytes), 1)
    first_cap = cap if first_cap_bytes is None \
        else max(int(first_cap_bytes), 1)
    buckets: List[Bucket] = []
    cur_keys: List = []
    cur_bytes = 0
    cur_dtype: Optional[str] = None

    def flush():
        nonlocal cur_keys, cur_bytes, cur_dtype
        if cur_keys:
            buckets.append(Bucket(tuple(cur_keys), cur_bytes, cur_dtype))
        cur_keys, cur_bytes, cur_dtype = [], 0, None

    for key, shape, dtype in reversed(list(entries)):
        nb = _nbytes(shape, dtype)
        dt = dtype_name(dtype)
        active = first_cap if not buckets else cap
        if cur_keys and (cur_dtype != dt or cur_bytes + nb > active):
            flush()
        cur_keys.append(key)
        cur_bytes += nb
        cur_dtype = dt
    flush()
    if last_cap_bytes is not None and int(last_cap_bytes) > cap:
        lcap = int(last_cap_bytes)
        while len(buckets) > 2 and \
                buckets[-2].dtype == buckets[-1].dtype and \
                buckets[-2].nbytes + buckets[-1].nbytes <= lcap:
            tail = buckets.pop()
            prev = buckets.pop()
            buckets.append(Bucket(prev.keys + tail.keys,
                                  prev.nbytes + tail.nbytes, prev.dtype))
    return buckets


def plan_with_tuning(entries: Sequence[Tuple],
                     cap_bytes: Optional[int] = None
                     ) -> Tuple[List[Bucket], Optional[Dict]]:
    """``(plan, tuning_meta)``: the partition under the tuned caps when
    a tuned plan applies (``MXNET_AUTOTUNE_PLAN``, or a fingerprint
    match in ``MXNET_AUTOTUNE_DIR``: ``autotune.plan.resolve_caps``),
    else under ``MXNET_KVSTORE_BUCKET_BYTES`` with ``tuning_meta``
    None.  An explicit ``cap_bytes`` bypasses tuning: a caller pinning
    a cap means it."""
    if cap_bytes is not None:
        return partition(entries, cap_bytes), None
    entry_list = list(entries)
    total = sum(_nbytes(shape, dtype) for _k, shape, dtype in entry_list)
    from ..autotune import plan as _aplan  # lazy: no import cycle

    caps, _path = _aplan.resolve_caps(total_bytes=total,
                                      n_grads=len(entry_list))
    if caps is None:
        return partition(entry_list, None), None
    plan = partition(entry_list, caps["cap_bytes"],
                     first_cap_bytes=caps.get("first_cap_bytes"),
                     last_cap_bytes=caps.get("last_cap_bytes"))
    return plan, dict(caps)


def plan_for_arrays(named: Mapping, cap_bytes: Optional[int] = None
                    ) -> List[Bucket]:
    """Partition a ``{key: tensor}`` mapping (insertion order = layer
    order)."""
    return partition([(k, tuple(v.shape), dtype_name(v.dtype))
                      for k, v in named.items()], cap_bytes)


def host_local_count(mesh) -> Optional[int]:
    """Ranks per host along the mesh, when every host's ranks are
    contiguous and equally many (the layout the JAX package's
    hierarchical schedule assumes); None for one rank, ragged hosts or
    interleaved placement."""
    hosts = list(getattr(mesh, "hosts", None) or ())
    n = len(hosts)
    if n < 2 or None in hosts:
        return None
    local = 1
    while local < n and hosts[local] == hosts[0]:
        local += 1
    if n % local:
        return None
    blocks = []
    for h in range(n // local):
        block = hosts[h * local:(h + 1) * local]
        if len(set(block)) != 1:
            return None
        blocks.append(block[0])
    return local if len(set(blocks)) == len(blocks) else None


def _flat_copy(tensors) -> torch.Tensor:
    """One new flat buffer holding ``tensors`` in order (never a view:
    the collectives below write into it)."""
    if len(tensors) == 1:
        return tensors[0].reshape(-1).clone()
    return torch.cat([t.reshape(-1) for t in tensors])


def pack_flats(grads: Mapping, plan: Sequence[Bucket]) -> List:
    """``grads`` (``{key: tensor}``) packed into one flat buffer per
    bucket, in plan order: the layout the all-reduce and ZeRO-1's
    reduce-scatter consume."""
    return [_flat_copy([grads[k] for k in b.keys]) for b in plan]


def scale_(flat: torch.Tensor, n: int) -> torch.Tensor:
    """``flat *= 1/n`` with ``1/n`` rounded to the buffer's dtype first,
    as the reference's ``red * jnp.asarray(1/n, dtype)``."""
    return flat.mul_(torch.tensor(1.0 / n, dtype=flat.dtype))


def unpack(flat: torch.Tensor, keys, like: Mapping) -> Dict:
    """Views of ``flat`` in the shapes of ``like[key]``, in ``keys``
    order."""
    out, off = {}, 0
    for k in keys:
        sz = like[k].numel()
        out[k] = flat[off:off + sz].view(like[k].shape)
        off += sz
    return out


def _axis_group(mesh, axis: Optional[str]):
    """``(n, process group)`` of a mesh axis, or of the whole mesh."""
    if axis is None:
        return mesh.size, mesh.group
    return mesh.axis_size(axis), mesh.axis_group(axis)


def bucketed_reduce(grads: Mapping, plan: Sequence[Bucket], mesh, *,
                    mean: bool = False, impl: Optional[str] = None,
                    flats: Optional[Sequence] = None,
                    axis: Optional[str] = None) -> Dict:
    """Reduce ``grads`` (``{key: this rank's tensor}``) bucket by bucket
    over the mesh's process group (or the subgroup of its ``axis``);
    returns ``{key: reduced tensor}``.  One flat concat and one
    all-reduce (sum) per bucket, in plan order; ``mean`` then multiplies
    by ``1/n``.  ``flats`` (pre-packed buffers, :func:`pack_flats`) skip
    the concat and are reduced in place; ``grads`` then supplies the
    shapes."""
    import torch.distributed as dist

    if impl is None:
        impl = impl_name()
    elif impl not in _IMPLS:
        raise ValueError("bucket impl %r: one of %s" % (impl, _IMPLS))
    n, group = _axis_group(mesh, axis)
    out: Dict = {}
    for i, bucket in enumerate(plan):
        with _traceview.annotation("mxbkt%03d" % i):
            flat = flats[i] if flats is not None else \
                _flat_copy([grads[k] for k in bucket.keys])
            if n > 1:
                dist.all_reduce(flat, group=group)
                if mean:
                    scale_(flat, n)
        out.update(unpack(flat, bucket.keys, grads))
    return out


class OverlappedReduce:
    """The bucketed exchange driven by the backward pass.

    ``arm(params)`` hooks every gradient leaf of the plan
    (``register_post_accumulate_grad_hook``); when the last gradient of
    a bucket is written, the bucket is packed (the ``.grad`` tensors are
    released) and its collective is issued with ``async_op=True``:
    an all-reduce, or with ``scatter=True`` ZeRO-1's reduce-scatter of
    the buffer padded to a multiple of ``n``.  ``finish()`` issues the
    buckets backward never completed (parameters that took no gradient
    reduce zeros), in plan order, waits for every handle and returns
    one reduced flat (or this rank's shard) per bucket in plan order.
    The update therefore does not depend on the order in which the
    buckets land.  Every rank runs the same graph, so every rank issues
    the same collectives in the same order.  ``overlap=False`` issues
    them all after backward (the monolithic reduction).

    The collectives run over the whole mesh, or over the subgroup of
    ``axis``; ``pre_axis`` first all-reduces each bucket over that
    axis's subgroup (sequence parallelism: the sp ranks of a replica sum
    their partial gradients, then dp all-reduces, or under ZeRO-1
    reduce-scatters: the same sums in the same order either way, so the
    two agree bit for bit).  The pre-reduction is async too: the
    bucket's collective over ``axis`` is chained to it when the next
    bucket lands (or in ``finish()``), on a side stream for CUDA
    tensors so that backward's stream never waits for it.  A one-rank
    ``axis`` issues no second collective."""

    def __init__(self, plan: Sequence[Bucket], mesh, *,
                 scatter: bool = False, overlap: bool = True,
                 axis: Optional[str] = None,
                 pre_axis: Optional[str] = None):
        self.plan = list(plan)
        self.mesh = mesh
        self.scatter = bool(scatter)
        self.overlap = bool(overlap)
        self._n, self._group = _axis_group(mesh, axis)
        # a 1-tuple: the group itself may be None, the default group
        self._pre = None if pre_axis is None else \
            (_axis_group(mesh, pre_axis)[1],)
        self._where = {k: i for i, b in enumerate(self.plan)
                       for k in b.keys}
        self._chain: List = []     # pre-reduced buckets awaiting axis's
        self._side = None          # the chain's CUDA stream
        self._handles: list = []
        self.issue_order: List[int] = []

    def arm(self, params: Mapping, prescale: int = 1) -> None:
        """Hook ``params`` (``{key: leaf tensor}``) for one backward.
        Arm it for the LAST backward of an accumulation window only:
        the earlier ones sum into ``.grad`` without a collective, and
        this backward's hooks see the sum.  ``prescale`` > 1 multiplies
        each packed bucket by ``1/prescale`` before its collective (the
        accumulated sum's mean over the microbatches)."""
        self._params = params
        self._prescale = int(prescale)
        self._grads: Dict = {}
        self._left = [len(b.keys) for b in self.plan]
        self._work: List = [None] * len(self.plan)
        self.issue_order = []
        self.disarm()
        if self.overlap:
            for k, p in params.items():
                if k in self._where:
                    self._handles.append(p.register_post_accumulate_grad_hook(
                        lambda t, k=k: self._ready(k, t)))

    def disarm(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def _ready(self, key, tensor) -> None:
        self._grads[key] = tensor.grad
        tensor.grad = None
        i = self._where[key]
        self._left[i] -= 1
        if self._left[i] == 0:
            self._issue(i)

    def _issue(self, i: int) -> None:
        with _traceview.annotation("mxbkt%03d" % i):
            self._issue_scoped(i)

    def _issue_scoped(self, i: int) -> None:
        import torch.distributed as dist

        b = self.plan[i]
        flat = _flat_copy([
            self._grads[k] if self._grads.get(k) is not None
            else torch.zeros_like(self._params[k]) for k in b.keys])
        for k in b.keys:
            self._grads.pop(k, None)
        if self._prescale > 1:
            scale_(flat, self._prescale)
        n = self._n
        if self.scatter:
            pad = (-flat.numel()) % n
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
        # the shard is allocated on backward's stream, which reads it
        shard = flat.new_empty(flat.numel() // n) if self.scatter and \
            n > 1 else flat
        self.issue_order.append(i)
        if self._pre is None:
            self._work[i] = self._post(flat, shard, None)
            return
        self._drain()
        pre = dist.all_reduce(flat, group=self._pre[0], async_op=True)
        if n == 1:
            self._work[i] = (shard, [pre])
        else:
            self._chain.append((i, flat, shard, pre))

    def _post(self, flat, shard, pre):
        """``axis``'s collective of one bucket, after ``pre`` (the
        bucket's pre-reduction, or None); ``(result, [handles])``."""
        import torch.distributed as dist

        works = [] if pre is None else [pre]
        if pre is not None:
            pre.wait()
        if self._n == 1:
            return shard, works
        if self.scatter:
            works.append(dist.reduce_scatter_tensor(
                shard, flat, group=self._group, async_op=True))
        else:
            works.append(dist.all_reduce(flat, group=self._group,
                                         async_op=True))
        return shard, works

    def _drain(self) -> None:
        """Chain ``axis``'s collective to every pre-reduced bucket, in
        issue order.  On CUDA the wait and the issue run on a side
        stream: the collective waits for the pre-reduction there, and
        backward's stream runs on."""
        chain, self._chain = self._chain, []
        for i, flat, shard, pre in chain:
            with _traceview.annotation("mxbkt%03d" % i):
                if flat.is_cuda:
                    if self._side is None:
                        self._side = torch.cuda.Stream(device=flat.device)
                    with torch.cuda.stream(self._side):
                        self._work[i] = self._post(flat, shard, pre)
                else:
                    self._work[i] = self._post(flat, shard, pre)

    def finish(self) -> List[torch.Tensor]:
        """Issue what backward left, wait for everything; the reduced
        flats (sums, not yet scaled) in plan order."""
        self.disarm()
        if not self.overlap:
            for k, p in self._params.items():
                if k in self._where:
                    self._grads[k] = p.grad
                    p.grad = None
        for i in range(len(self.plan)):
            if self._work[i] is None and i not in self.issue_order:
                self._issue(i)
        self._drain()
        out = []
        for flat, works in self._work:
            for work in works:
                work.wait()
            out.append(flat)
        self._params = None
        self._work = []
        return out


def accounting(plan: Sequence[Bucket]) -> List[Dict]:
    """Per-bucket rows: index, gradient count, bytes, dtype."""
    return [{"bucket": i, "n_grads": len(b.keys), "bytes": int(b.nbytes),
             "dtype": b.dtype} for i, b in enumerate(plan)]


def plan_meta(plan: Optional[Sequence[Bucket]],
              cap_bytes: Optional[int] = None,
              tuning: Optional[Dict] = None) -> Dict:
    """The self-describing summary of a plan, in the JAX package's
    format: bucket count, bytes, cap, the schedule's name and chaining,
    per-bucket rows, and with ``tuning`` (:func:`plan_with_tuning`'s
    meta) the ``autotune`` block naming the caps and the plan file they
    came from.  It rides into the traceview summary."""
    plan = list(plan or ())
    out = {
        "n_buckets": len(plan),
        "total_bytes": sum(int(b.nbytes) for b in plan),
        "cap_bytes": bucket_cap_bytes() if cap_bytes is None
        else int(cap_bytes),
        "impl": impl_name(),
        "chained": chain_enabled(),
        "buckets": accounting(plan),
    }
    if tuning is not None:
        out["autotune"] = {
            "plan_path": tuning.get("plan_path"),
            "cap_bytes": tuning.get("cap_bytes"),
            "first_cap_bytes": tuning.get("first_cap_bytes"),
            "last_cap_bytes": tuning.get("last_cap_bytes"),
            "score": tuning.get("score"),
        }
    return out


def stamp_profiler(plan: Sequence[Bucket], *, impl: Optional[str] = None,
                   store_type: str = "tpu") -> None:
    """One comms span per bucket and the cumulative byte counters
    through the profiler, at dispatch time: the issue schedule (bucket
    order, payload bytes); the device trace (traceview) holds the
    collectives themselves.  The ``mxnet_kvstore_bytes_total
    {op=bucket_reduce}`` counter is fed whether or not the profiler
    runs.  Never raises."""
    try:
        from .. import diagnostics as _diag
        from .. import profiler as _profiler

        if impl is None:
            impl = impl_name()
        _diag.feed_kvstore_bytes("bucket_reduce",
                                 sum(int(b.nbytes) for b in plan))
        if not _profiler.is_running():
            return
        total = 0
        for i, b in enumerate(plan):
            with _profiler.span("KVStore::AllReduceBucket", cat="comms",
                                args={"bucket": i,
                                      "bytes": int(b.nbytes),
                                      "n_grads": len(b.keys),
                                      "impl": impl, "type": store_type,
                                      "in_graph": True}):
                pass
            total += int(b.nbytes)
        _profiler.record_bytes("kvstore:bucket_allreduce_bytes", total)
        _profiler.record_bytes("kvstore:bucket_allreduce_count", len(plan))
    except Exception:
        pass
