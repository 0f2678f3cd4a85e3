"""Step auditor: checks over the op log of one train step.

Counterpart: ``mxnet_tpu/analysis/auditor.py``.  The JAX package audits
the jaxpr of a compiled step; an eager PyTorch step has no program to
trace, so the port audits what one step actually dispatched.  The
op log (:func:`record_op_log`) is recorded by a
``torch.utils._python_dispatch.TorchDispatchMode`` around one call of
the step: every aten op in dispatch order — the backward's ops too,
which autograd's device thread runs under the same mode — with its
input and output shapes, dtypes, devices and bytes, and the ``c10d::``
collectives among them.  It runs on the step's own device (the step
trains: each audited call is one more optimizer step).  Alongside it:
the bytes of the tensors the step allocated that are alive at once
(:func:`peak_live_bytes`, from when each output's storage is freed; on
the card also the allocator's peak), and the checkpoint regions
``remat.checkpoint`` entered.

The checks keep the JAX package's names, ``Finding`` fingerprints and
``AuditReport`` format; what each reads here:

  * **collective-uniformity** — two logs of the same step must hold the
    same collective sequence (op, shape, dtype, bytes), and on a
    bucketed build the plan's bucket reduces must appear in it in plan
    order (:func:`check_bucket_plan`; skipped at one rank, where no
    bucket collective is issued);
  * **dtype** — ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` /
    ``convolution`` (and its backward) with a float32/64 input inside a
    step declared bfloat16 (or float16);
  * **host-sync** — ``_local_scalar_dense`` (``.item()``), ``nonzero``
    and copies from the card to the host inside the step;
  * **donation** — the eager counterpart of an undonated buffer: a
    parameter or optimizer-state tensor that the step replaces with a
    new one instead of updating it in place (its storage address moves
    across the call), so old and new are held at once; reported with
    the bytes held twice;
  * **remat-effectiveness** — a declared policy must enter checkpoint
    regions, and against the no-remat twin's log lower the peak of live
    bytes (:func:`count_remat_eqns`, :func:`peak_live_bytes`);
  * **sparse-gradients** — a dense full-vocabulary
    ``embedding_dense_backward`` (or scatter into a vocab-row buffer)
    where a row-sparse gradient was asked for;
  * **decode-buckets** — pure logic over a serving plan.

:func:`audit_step` audits any ``(fn, specs)``; :func:`audit_recorded_steps`
every step ``diagnostics.recorded_steps()`` holds (``FusedTrainStep``,
``TransformerTrainStep``, ``Module.bulk_fit``); a baseline file
suppresses accepted findings by fingerprint.  An audit whose op log is
empty raises.
"""
from __future__ import annotations

import json
import os
import weakref
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                    NamedTuple, Optional, Sequence, Tuple)

__all__ = [
    "Finding", "AuditReport", "OpRecord", "OpLog", "record_op_log",
    "iter_eqns", "collective_signature",
    "check_collective_uniformity", "check_bucket_plan", "check_donation",
    "check_dtype", "check_host_sync", "check_remat_effectiveness",
    "check_decode_buckets", "check_sparse_gradients",
    "count_remat_eqns", "peak_live_bytes", "state_storage",
    "audit_step", "audit_recorded_steps", "audit_decode_buckets",
    "load_baseline", "apply_baseline",
    "DEFAULT_BASELINE", "COLLECTIVE_PREFIXES", "MATMUL_OPS",
    "HOST_SYNC_OPS",
]

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "baseline.json")

#: op-name prefixes of the collectives ``torch.distributed`` dispatches
COLLECTIVE_PREFIXES = ("c10d.", "_c10d_functional.")
#: collectives that move no payload
_NOT_TRAFFIC = ("barrier", "monitored_barrier")
#: ops that wait for the card and read a value back to the host
HOST_SYNC_OPS = frozenset({"aten._local_scalar_dense", "aten.nonzero",
                           "aten.item"})
#: the tensor-core work whose dtype decides throughput
MATMUL_OPS = frozenset({"aten.mm", "aten.addmm", "aten.bmm",
                        "aten.baddbmm", "aten.convolution",
                        "aten.convolution_backward",
                        "aten._convolution", "aten.cudnn_convolution"})
#: the ops a gather's backward scatters into a table-sized buffer with
SCATTER_OPS = frozenset({"aten.embedding_dense_backward",
                         "aten.index_add", "aten.index_add_",
                         "aten.index_put", "aten.index_put_",
                         "aten.scatter_add", "aten.scatter_add_",
                         "aten._index_put_impl_"})
WIDE_DTYPES = ("float32", "float64")
NARROW_DTYPES = ("bfloat16", "float16")


class Finding(NamedTuple):
    """One defect the auditor claims about one site."""
    check: str      # collective-uniformity | donation | dtype | host-sync
    severity: str   # 'error' (wrong results/hang) | 'perf' (wasted HW)
    site: str       # step name, e.g. 'FusedTrainStep.step'
    message: str
    details: Dict[str, Any]

    def fingerprint(self) -> str:
        """Stable suppression key: check + site + the details the
        baseline author pinned (never live shapes)."""
        key = self.details.get("fingerprint_key", "")
        return "%s:%s:%s" % (self.check, self.site, key)

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self._asdict())
        d["fingerprint"] = self.fingerprint()
        return d


# ---------------------------------------------------------------------------
# the op log
# ---------------------------------------------------------------------------
class OpRecord(NamedTuple):
    """One dispatched op: its overload-less name (``aten.mm``), and per
    tensor input / output ``(shape, dtype, device, nbytes)``."""
    op: str
    inputs: Tuple
    outputs: Tuple


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _meta(t) -> Tuple:
    shape = tuple(int(d) for d in t.shape)
    n = 1
    for d in shape:
        n *= d
    return (shape, _dtype_name(t.dtype), str(t.device),
            n * t.element_size())


def _tensors(x) -> Iterator:
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _storage_ptr(t) -> Optional[int]:
    try:
        return int(t.untyped_storage().data_ptr())
    except Exception:
        return None


class OpLog:
    """The ops of one step, in dispatch order, with the allocation
    bookkeeping: ``records`` (:class:`OpRecord`), ``peak_live_bytes``
    (the most bytes of step-allocated storages alive at once),
    ``device_peak_bytes`` (the card's allocator peak over the call,
    None on the CPU) and ``remat_regions`` (checkpoint regions
    entered)."""

    def __init__(self):
        self.records: List[OpRecord] = []
        self.peak_live_bytes = 0
        self.device_peak_bytes: Optional[int] = None
        self.remat_regions = 0
        self._live: Dict[int, List[int]] = {}
        self._live_bytes = 0

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    # -- allocation bookkeeping (called from the dispatch mode) --------
    def _track(self, out, inputs) -> None:
        in_ptrs = {_storage_ptr(t) for t in inputs}
        for t in _tensors(out):
            if t._is_view():
                continue
            ptr = _storage_ptr(t)
            if ptr is None or ptr == 0 or ptr in in_ptrs:
                continue
            ent = self._live.get(ptr)
            if ent is None:
                nbytes = int(t.untyped_storage().nbytes())
                ent = self._live[ptr] = [nbytes, 0]
                self._live_bytes += nbytes
                self.peak_live_bytes = max(self.peak_live_bytes,
                                           self._live_bytes)
            ent[1] += 1
            weakref.finalize(t, self._release, ptr)

    def _release(self, ptr: int) -> None:
        ent = self._live.get(ptr)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] <= 0:
            self._live_bytes -= ent[0]
            del self._live[ptr]


def _mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Recorder(TorchDispatchMode):
        def __init__(self, log: OpLog):
            super().__init__()
            self.log = log

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            try:
                name = str(func.overloadpacket) if hasattr(
                    func, "overloadpacket") else str(func)
                ins = list(_tensors(args)) + list(_tensors(kwargs))
                self.log.records.append(OpRecord(
                    name, tuple(_meta(t) for t in ins),
                    tuple(_meta(t) for t in _tensors(out))))
                self.log._track(out, ins)
            except Exception:
                pass    # the log never fails the step it watches
            return out

    return _Recorder


def record_op_log(fn: Callable, *args, **kwargs) -> Tuple[Any, OpLog]:
    """Run ``fn(*args, **kwargs)`` once under the recording dispatch
    mode; returns ``(its result, the OpLog)``.  The caller's outputs
    are released before the live bytes are read, so what stays live is
    what the step keeps."""
    import torch

    from .. import remat as _remat

    log = OpLog()
    devs = {t.device for t in _tensors((args, kwargs))
            if t.device.type == "cuda"}
    for d in devs:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    base = {d: torch.cuda.memory_allocated(d) for d in devs}
    regions0 = _remat.regions_entered()
    with _mode_class()(log):
        out = fn(*args, **kwargs)
    log.remat_regions = _remat.regions_entered() - regions0
    if devs:
        for d in devs:
            torch.cuda.synchronize(d)
        log.device_peak_bytes = max(
            torch.cuda.max_memory_allocated(d) - base[d] for d in devs)
    return out, log


def iter_eqns(log: OpLog) -> Iterator[OpRecord]:
    """The log's records in dispatch order (the JAX package walks its
    jaxpr's eqns here)."""
    return iter(log.records)


def _is_collective(op: str) -> bool:
    return op.startswith(COLLECTIVE_PREFIXES) and \
        not any(op.split(".", 1)[1].startswith(b) for b in _NOT_TRAFFIC)


# ---------------------------------------------------------------------------
# check 1: collective uniformity
# ---------------------------------------------------------------------------
def collective_signature(log: OpLog) -> List[Dict[str, Any]]:
    """The ordered collective schedule of one step: per ``c10d::``
    collective its op, first tensor's shape and dtype, and the bytes of
    its tensor inputs.  Two ranks (or two calls) issuing different
    schedules will desync."""
    rows = []
    for r in log.records:
        if not _is_collective(r.op):
            continue
        first = r.inputs[0] if r.inputs else ((), "?", "?", 0)
        rows.append({"prim": r.op, "axes": None, "shape": first[0],
                     "dtype": first[1],
                     "nbytes": sum(m[3] for m in r.inputs)})
    return rows


def check_collective_uniformity(traces: Mapping[str, OpLog], site: str
                                ) -> List[Finding]:
    """``traces``: {label: op log} of the SAME step (two calls, or two
    ranks); every one must hold the same collective schedule."""
    sigs = {label: collective_signature(lg) for label, lg in
            traces.items()}
    labels = sorted(sigs)
    if len(labels) < 2:
        return []
    ref_label = labels[0]
    ref = sigs[ref_label]
    findings: List[Finding] = []
    for label in labels[1:]:
        got = sigs[label]
        if got == ref:
            continue
        div = next((i for i, (a, b) in enumerate(zip(ref, got))
                    if a != b), min(len(ref), len(got)))
        findings.append(Finding(
            "collective-uniformity", "error", site,
            "collective schedule differs between traces %r (%d colls) "
            "and %r (%d colls), first divergence at collective #%d — "
            "ranks issuing these schedules WILL desync"
            % (ref_label, len(ref), label, len(got), div),
            {"fingerprint_key": "trace-divergence",
             "divergence_index": div,
             "ref": ref[div] if div < len(ref) else None,
             "got": got[div] if div < len(got) else None}))
    return findings


def check_bucket_plan(log: OpLog, plan_meta: Optional[Mapping], site: str,
                      n_ranks: Optional[int] = None) -> List[Finding]:
    """On a bucketed build the plan's bucket payloads must appear among
    the step's collectives as a subsequence, in plan order.  Skipped at
    one rank (the exchange issues no collective there)."""
    if not plan_meta or not plan_meta.get("buckets"):
        return []
    if n_ranks is not None and int(n_ranks) <= 1:
        return []
    want = [int(b["bytes"]) for b in plan_meta["buckets"]]
    got = [r["nbytes"] for r in collective_signature(log)
           if len(r["shape"]) <= 1]
    it = iter(got)
    missing = [w for w in want if not any(g == w for g in it)]
    if not missing:
        return []
    return [Finding(
        "collective-uniformity", "error", site,
        "declared bucket plan (%d buckets) is not embedded in the step's "
        "collective schedule in issue order: %d bucket reduction(s) "
        "missing or reordered (first missing payload: %d bytes)"
        % (len(want), len(missing), missing[0]),
        {"fingerprint_key": "bucket-plan-mismatch",
         "plan_bytes": want, "traced_collective_bytes": got,
         "missing": missing})]


# ---------------------------------------------------------------------------
# check 2: donation (state replaced instead of updated in place)
# ---------------------------------------------------------------------------
DONATION_MIN_BYTES = 1 << 20  # ignore scalars and small buffers


def state_storage(state: Mapping[str, Any]) -> Dict[str, Tuple[int, int,
                                                               str, str]]:
    """``{name: (storage address, bytes, shape, dtype)}`` of a step's
    state tensors (``audit_state()``)."""
    out = {}
    for k, t in state.items():
        for x in _tensors(t):
            m = _meta(x)
            out[k] = (_storage_ptr(x), m[3], str(m[0]), m[1])
            break
    return out


def check_donation(before: Mapping[str, Tuple], after: Mapping[str, Tuple],
                   site: str, min_bytes: int = DONATION_MIN_BYTES
                   ) -> Tuple[List[Finding], Dict[str, int]]:
    """``before`` / ``after``: :func:`state_storage` around one call.  A
    state tensor whose storage moved was replaced, not updated in place:
    old and new are held at once.  One finding a site with the bytes
    held twice and the largest offenders; the summary counts both."""
    kept = replaced = 0
    offenders: List[Tuple[int, str, str]] = []
    for k, (ptr, nb, shape, dtype) in before.items():
        now = after.get(k)
        if now is None:
            continue
        if now[0] == ptr:
            kept += nb
            continue
        replaced += nb
        if nb >= min_bytes:
            offenders.append((nb, shape, dtype))
    summary = {"donated_bytes": kept, "undonated_bytes": replaced,
               "undonated_large_bytes": sum(o[0] for o in offenders),
               "n_undonated_large": len(offenders)}
    if not offenders:
        return [], summary
    offenders.sort(reverse=True)
    wasted = summary["undonated_large_bytes"]
    return [Finding(
        "donation", "perf", site,
        "%d state tensor(s) totalling %.1f MiB are replaced by new tensors "
        "each step instead of updated in place — the step holds old and "
        "new at once; top offenders: %s"
        % (len(offenders), wasted / 2**20,
           ", ".join("%s %s (%.1f MiB)" % (s, d, nb / 2**20)
                     for nb, s, d in offenders[:4])),
        {"fingerprint_key": "undonated-large-args",
         "wasted_bytes": wasted,
         "offenders": [{"nbytes": nb, "shape": s, "dtype": d}
                       for nb, s, d in offenders[:16]]})], summary


# ---------------------------------------------------------------------------
# check 3: dtype (wide matmuls in a declared-narrow step)
# ---------------------------------------------------------------------------
def check_dtype(log: OpLog, site: str, compute_dtype: str = "bfloat16"
                ) -> List[Finding]:
    """In a step declared to compute in ``compute_dtype`` (bfloat16 or
    float16), matmul-family ops with a float32/float64 input are silent
    upcasts: right results at a fraction of the tensor cores' rate."""
    if compute_dtype is None or \
            _dtype_name(compute_dtype) not in NARROW_DTYPES:
        return []
    wide: List[Dict[str, Any]] = []
    n_mm = 0
    for r in log.records:
        if r.op not in MATMUL_OPS:
            continue
        n_mm += 1
        dts = [m[1] for m in r.inputs]
        if any(d in WIDE_DTYPES for d in dts):
            wide.append({"prim": r.op, "dtypes": dts,
                         "shapes": [m[0] for m in r.inputs]})
    if not wide:
        return []
    return [Finding(
        "dtype", "perf", site,
        "%d of %d matmul op(s) (mm/addmm/bmm/convolution) compute in "
        "f32/f64 inside a declared-%s step — a silent upcast (first: %s "
        "over %s)" % (len(wide), n_mm, _dtype_name(compute_dtype),
                      wide[0]["prim"], wide[0]["dtypes"]),
        {"fingerprint_key": "wide-mxu-eqns",
         "n_wide": len(wide), "n_mxu": n_mm, "examples": wide[:8]})]


# ---------------------------------------------------------------------------
# check 4: host syncs inside the step
# ---------------------------------------------------------------------------
def _to_host(r: OpRecord) -> bool:
    return any(m[2] != "cpu" for m in r.inputs) and bool(r.outputs) and \
        all(m[2] == "cpu" for m in r.outputs) and \
        r.op in ("aten._to_copy", "aten.copy_", "aten.to", "aten._copy_from")


def check_host_sync(log: OpLog, site: str) -> List[Finding]:
    """One finding per kind of host round trip in the step:
    ``_local_scalar_dense`` / ``item`` (a value read back), ``nonzero``
    (a data-dependent shape), a copy from the card to the host."""
    counts: Dict[str, int] = {}
    for r in log.records:
        name = r.op if r.op in HOST_SYNC_OPS else \
            ("copy-to-host" if _to_host(r) else None)
        if name is not None:
            counts[name] = counts.get(name, 0) + 1
    return [Finding(
        "host-sync", "error", site,
        "%r inside the step, %d time(s): a device->host round trip each, "
        "serializing the card against the host" % (name, n),
        {"fingerprint_key": "host-sync:%s" % name, "prim": name,
         "count": n}) for name, n in sorted(counts.items())]


# ---------------------------------------------------------------------------
# check 5: remat effectiveness
# ---------------------------------------------------------------------------
def count_remat_eqns(log: OpLog) -> int:
    """Checkpoint regions the step entered (``remat.checkpoint`` calls)."""
    return int(log.remat_regions)


def peak_live_bytes(log: OpLog) -> int:
    """The most bytes of storages the step allocated that were alive at
    once (activations kept for backward are what a remat policy
    drops)."""
    return int(log.peak_live_bytes)


def check_remat_effectiveness(log: OpLog, site: str,
                              remat_policy: Optional[str],
                              twin_log: Optional[OpLog] = None
                              ) -> List[Finding]:
    """A declared remat policy must change the step: it must enter
    checkpoint regions (none means the policy matched nothing), and
    against the no-remat ``twin_log`` it must lower the peak of live
    bytes."""
    if not remat_policy or remat_policy == "none":
        return []
    findings: List[Finding] = []
    n_remat = count_remat_eqns(log)
    if n_remat == 0:
        findings.append(Finding(
            "remat-effectiveness", "error", site,
            "remat policy %r is declared but the step entered no "
            "checkpoint region — the policy matched nothing and every "
            "activation is still kept for backward" % remat_policy,
            {"fingerprint_key": "no-op-remat:%s" % remat_policy,
             "remat_policy": remat_policy, "n_remat_eqns": 0}))
        return findings
    if twin_log is not None:
        peak, twin_peak = peak_live_bytes(log), peak_live_bytes(twin_log)
        if peak >= twin_peak:
            findings.append(Finding(
                "remat-effectiveness", "error", site,
                "remat policy %r enters %d checkpoint region(s) but the "
                "peak of live bytes did not drop vs the no-remat twin "
                "(%d >= %d)" % (remat_policy, n_remat, peak, twin_peak),
                {"fingerprint_key": "ineffective-remat:%s" % remat_policy,
                 "remat_policy": remat_policy, "n_remat_eqns": n_remat,
                 "peak_live_bytes": peak,
                 "twin_peak_live_bytes": twin_peak}))
    return findings


# ---------------------------------------------------------------------------
# check 6: sparse gradients
# ---------------------------------------------------------------------------
def check_sparse_gradients(log: OpLog, site: str, vocab: int,
                           embed_dim: Optional[int] = None
                           ) -> List[Finding]:
    """A step declared row-sparse over a ``(vocab, dim)`` table must not
    build a vocab-row gradient: ``embedding_dense_backward`` (or a
    scatter) whose output has ``vocab`` rows (and ``embed_dim``
    columns, when given) is the dense gradient of the whole table."""
    if not vocab or int(vocab) <= 0:
        return []
    vocab = int(vocab)
    hits: List[Dict[str, Any]] = []
    for r in log.records:
        if r.op not in SCATTER_OPS or not r.outputs:
            continue
        shape, dtype, _dev, nbytes = r.outputs[0]
        if len(shape) < 1 or int(shape[0]) != vocab:
            continue
        if embed_dim is not None and \
                (len(shape) < 2 or int(shape[1]) != int(embed_dim)):
            continue
        hits.append({"prim": r.op, "shape": shape, "dtype": dtype,
                     "nbytes": nbytes})
    if not hits:
        return []
    wasted = sum(h["nbytes"] for h in hits)
    return [Finding(
        "sparse-gradients", "perf", site,
        "%d op(s) materialize a full (vocab=%d, ...) gradient buffer "
        "(%.1f MiB) inside a step declared row-sparse — the gather's "
        "backward runs over the whole table instead of the batch's "
        "unique rows (first: %s -> %s %s)"
        % (len(hits), vocab, wasted / 2**20, hits[0]["prim"],
           hits[0]["shape"], hits[0]["dtype"]),
        {"fingerprint_key": "dense-vocab-scatter:%d" % vocab,
         "vocab": vocab, "embed_dim": embed_dim,
         "n_dense_scatters": len(hits), "wasted_bytes": wasted,
         "examples": hits[:8]})]


# ---------------------------------------------------------------------------
# check 7: decode buckets (pure)
# ---------------------------------------------------------------------------
def check_decode_buckets(plan: Sequence[Sequence[int]],
                         observed: Sequence[Sequence[int]],
                         site: str,
                         compile_counts: Optional[Mapping[str, int]]
                         = None) -> List[Finding]:
    """Every ``(batch, cache_len)`` a decode step ran at must be a cell
    of its declared plan, and the compile count must not exceed the
    plan's size (each cell once at warm-up); with one counter a cell,
    a cell counted more than once is flagged too."""
    findings: List[Finding] = []
    plan_cells = {tuple(int(v) for v in c) for c in plan}
    for shape in observed:
        cell = tuple(int(v) for v in shape)
        if cell not in plan_cells:
            findings.append(Finding(
                "decode-buckets", "error", site,
                "decode step compiled at (batch=%d, cache_len=%d), not a "
                "cell of its declared %d-cell plan — an undeclared shape IS "
                "a steady-state recompile" % (cell[0], cell[1],
                                            len(plan_cells)),
                {"shape": list(cell),
                 "plan": sorted(list(c) for c in plan_cells),
                 "fingerprint_key": "shape:%dx%d" % cell}))
    if compile_counts:
        total = sum(int(c) for c in compile_counts.values())
        if total > len(plan_cells):
            findings.append(Finding(
                "decode-buckets", "error", site,
                "%d decode compiles recorded for a %d-cell plan — warmup "
                "compiles each cell exactly once, so the excess happened "
                "under traffic (steady-state recompiles)"
                % (total, len(plan_cells)),
                {"compiles": total, "plan_cells": len(plan_cells),
                 "counts": dict(compile_counts),
                 "fingerprint_key": "total:%d" % total}))
        if len(compile_counts) > 1:
            for name, c in sorted(compile_counts.items()):
                if int(c) > 1:
                    findings.append(Finding(
                        "decode-buckets", "error", site,
                        "plan cell %r compiled %d times — a cell compiles "
                        "once at warmup; every further compile is a "
                        "steady-state recompile" % (name, int(c)),
                        {"name": name, "count": int(c),
                         "fingerprint_key": "cell:" + name}))
    return findings


# ---------------------------------------------------------------------------
# audit entry points
# ---------------------------------------------------------------------------
class AuditReport:
    """Findings + per-site meta for one audit run; JSON-serializable."""

    def __init__(self):
        self.findings: List[Finding] = []
        self.suppressed: List[Finding] = []
        self.sites: Dict[str, Dict[str, Any]] = {}

    @property
    def n_findings(self) -> int:
        return len(self.findings)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "n_findings": len(self.findings),
            "n_suppressed": len(self.suppressed),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.fingerprint() for f in self.suppressed],
            "sites": self.sites,
        }

    def write_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=str)
        return path

    def summary(self) -> str:
        lines = ["%d finding(s), %d suppressed by baseline, %d site(s)"
                 % (len(self.findings), len(self.suppressed),
                    len(self.sites))]
        for f in self.findings:
            lines.append("  [%s] %s @ %s: %s"
                         % (f.severity, f.check, f.site, f.message))
        return "\n".join(lines)


def load_baseline(path: Optional[str] = None) -> set:
    """Committed suppression fingerprints (accepted findings)."""
    path = path or DEFAULT_BASELINE
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return set()
    fps = data.get("fingerprints", [])
    return {e["fingerprint"] if isinstance(e, dict) else e for e in fps}


def apply_baseline(findings: Iterable[Finding], baseline: set
                   ) -> Tuple[List[Finding], List[Finding]]:
    new, suppressed = [], []
    for f in findings:
        (suppressed if f.fingerprint() in baseline else new).append(f)
    return new, suppressed


def _materialize(specs):
    from ..diagnostics import TensorSpec

    def make(x):
        if isinstance(x, TensorSpec):
            return x.materialize()
        if isinstance(x, (list, tuple)):
            return type(x)(make(y) for y in x) if type(x) in (list, tuple) \
                else tuple(make(y) for y in x)
        if isinstance(x, dict):
            return {k: make(v) for k, v in x.items()}
        return x

    return tuple(make(s) for s in specs)


def audit_step(fn, specs: Sequence, *, site: str,
               plan_meta: Optional[Mapping] = None,
               compute_dtype: Optional[str] = None,
               remat_policy: Optional[str] = None,
               n_traces: int = 2,
               donation_min_bytes: int = DONATION_MIN_BYTES,
               state_fn: Optional[Callable[[], Mapping]] = None,
               n_ranks: Optional[int] = None
               ) -> Tuple[List[Finding], Dict[str, Any]]:
    """Run every check on one step.

    ``fn`` is the step callable (or diagnostics' instrumented wrapper),
    ``specs`` its arguments, each tensor as a
    ``diagnostics.TensorSpec`` (materialized as zeros on its device) or
    a tensor.  The step runs ``n_traces`` times (>= 2), each under the
    recording mode: the logs feed the uniformity check, the first the
    rest.  ``state_fn`` (the step's ``audit_state``; found on a bound
    method's owner by default) arms the donation check; ``n_ranks`` of
    1 skips the bucket-plan check.  Raises when a log is empty."""
    fn = getattr(fn, "_ref", None) and fn._ref() or fn
    if state_fn is None:
        state_fn = getattr(getattr(fn, "__self__", None), "audit_state",
                           None)
    findings: List[Finding] = []
    traces: Dict[str, OpLog] = {}
    before = after = None
    for i in range(max(2, n_traces)):
        args = _materialize(specs)
        if i == 0 and state_fn is not None:
            before = state_storage(state_fn())
        out, log = record_op_log(fn, *args)
        if i == 0 and state_fn is not None:
            after = state_storage(state_fn())
        del out
        if not len(log):
            raise RuntimeError("audit of %r: the step dispatched no op — "
                               "nothing to audit" % site)
        traces["trace%d" % i] = log
    log = traces["trace0"]

    findings += check_collective_uniformity(traces, site)
    findings += check_bucket_plan(log, plan_meta, site, n_ranks=n_ranks)
    findings += check_host_sync(log, site)
    if compute_dtype is not None:
        findings += check_dtype(log, site, compute_dtype)
    findings += check_remat_effectiveness(log, site, remat_policy)

    meta: Dict[str, Any] = {
        "n_eqns": len(log),
        "n_collectives": len(collective_signature(log)),
        "n_remat_eqns": count_remat_eqns(log),
        "peak_live_bytes": peak_live_bytes(log),
        "device_peak_bytes": log.device_peak_bytes,
    }
    if before is not None:
        don, summary = check_donation(before, after, site,
                                      min_bytes=donation_min_bytes)
        findings += don
        meta["donation"] = summary
    return findings, meta


def audit_decode_buckets(names: Optional[Sequence[str]] = None,
                         baseline: Optional[set] = None
                         ) -> AuditReport:
    """Audit every recorded step whose meta says ``kind:
    generate_decode`` (the decode shapes from its specs, its compile
    count from ``recompile_stats()``) against its declared plan."""
    from .. import diagnostics as _diag

    if baseline is None:
        baseline = load_baseline()
    report = AuditReport()
    recorded = _diag.recorded_steps()
    stats = _diag.recompile_stats()
    by_model: Dict[str, Dict[str, Any]] = {}
    for name in sorted(recorded):
        if names is not None and name not in names:
            continue
        _fn, specs, step_meta = recorded[name]
        step_meta = step_meta or {}
        if step_meta.get("kind") != "generate_decode":
            continue
        model = str(step_meta.get("model", name))
        ent = by_model.setdefault(model, {
            "plan": [tuple(int(v) for v in c)
                     for c in step_meta.get("decode_plan", [])],
            "observed": [], "counts": {}})
        bt = int(step_meta.get("block_tokens", 1))
        try:
            tables = specs[4]
            ent["observed"].append(
                (int(tables.shape[0]), int(tables.shape[1]) * bt))
        except Exception:
            pass
        ent["counts"][name] = int(stats.get(name, {}).get("count", 0))
    for model in sorted(by_model):
        ent = by_model[model]
        site = "generate_decode:%s" % model
        findings = check_decode_buckets(
            ent["plan"], ent["observed"], site,
            compile_counts=ent["counts"])
        new, supp = apply_baseline(findings, baseline)
        report.findings += new
        report.suppressed += supp
        report.sites[site] = {
            "plan_cells": len(ent["plan"]),
            "observed": [list(o) for o in ent["observed"]],
            "compiles": sum(ent["counts"].values()),
        }
    return report


def audit_recorded_steps(names: Optional[Sequence[str]] = None,
                         baseline: Optional[set] = None,
                         compute_dtype: Optional[str] = None,
                         donation_min_bytes: int = DONATION_MIN_BYTES,
                         n_traces: int = 2) -> AuditReport:
    """Audit every step ``diagnostics.recorded_steps()`` holds (run your
    step once, then audit it).  Each audited step trains ``n_traces``
    more steps.  A site whose audit fails is reported with its error."""
    from .. import diagnostics as _diag

    if baseline is None:
        baseline = load_baseline()
    report = AuditReport()
    recorded = _diag.recorded_steps()
    for name in sorted(recorded):
        if names is not None and name not in names:
            continue
        fn, specs, step_meta = recorded[name]
        step_meta = step_meta or {}
        dtype = step_meta.get("compute_dtype", compute_dtype)
        try:
            findings, meta = audit_step(
                fn, specs, site=name,
                # the plan THIS step was built against
                plan_meta=step_meta.get("bucket_plan"),
                compute_dtype=dtype,
                remat_policy=step_meta.get("remat_policy"),
                donation_min_bytes=donation_min_bytes,
                n_ranks=step_meta.get("n_ranks"), n_traces=n_traces)
        except Exception as exc:
            report.sites[name] = {"audit_error": repr(exc)}
            continue
        new, supp = apply_baseline(findings, baseline)
        report.findings += new
        report.suppressed += supp
        meta["findings_by_check"] = _by_check(findings)
        report.sites[name] = meta
    return report


def _by_check(findings: Iterable[Finding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.check] = out.get(f.check, 0) + 1
    return out
