"""Per-rank-sharded, digest-verified checkpoints in the JAX package's
on-disk layout, so a directory written by either package loads in the
other.

Counterpart: ``mxnet_tpu/checkpoint.py``.  The layout is the same:
``step_{N:08d}/rank{K}.ckpt`` (a pickled payload dict: format version,
step, epoch, params, aux params, optimizer states, ...), a
``rank{K}.meta.json`` sidecar holding the shard's sha256 and byte
count, and a ``MANIFEST.json`` folded from the sidecars once every
rank's shard landed.  Writes are atomic (``.tmp`` + ``os.replace``);
a step is complete only when every rank's shard exists; loads verify
the digests (``MXNET_CKPT_VERIFY``), name the exact corrupt shard, and
— when asked for the newest step — fall back to the newest verified
one.  The retention janitor (``MXNET_CKPT_KEEP``) and the reader pins
that fence it are the JAX package's.

bfloat16: numpy has no bfloat16, so the JAX package pickles
``ml_dtypes.bfloat16`` arrays, and the machine with the card may have
no ``ml_dtypes``.  The port reads such a shard without it (the
unpickler maps the bf16 dtype to its 16-bit pattern and returns a
``torch.bfloat16`` tensor) and writes a bf16 tensor as exactly the
pickle the JAX package writes for an ``ml_dtypes.bfloat16`` array, so
the JAX package reads it back as bf16.  Every other array loads as
numpy.

Elastic resume across world sizes is the JAX package's: a step written
by W ranks loads on a W'-rank fleet (rank r reads source shard r % W),
the payload's ``elastic`` entry records the reshard, and
``scale_resume_skip`` re-divides the global sample position.  The world
size counts processes in both packages: one per host in the JAX
package, one per device in the port, whose ranks each train on their
rows of the global batch and record that per-rank batch size, so the
sample position agrees both ways.

The random state: a port shard carries the port's (``rng_state``:
the seed and every ``torch.Generator``'s state, bit for bit) under its
own key ``rng_torch``, and ``rng: None`` where the JAX package keeps
its key, so the JAX package reads a port shard unchanged (its
``set_rng_state`` ignores an empty state).  A JAX shard carries no torch
state: resuming from it in the port warns that the random stream
restarts.

Writes are asynchronous by default (``MXNET_CKPT_ASYNC``, as in the
JAX package): ``save()`` takes the snapshot synchronously — the
parameters, the aux states, the optimizer-state bytes and the random
state all reach host memory before it returns, because the port's
optimizers and ``FusedTrainStep`` update the parameters in place — and
the ``mx-ckpt-writer`` daemon thread then pickles, digests, fsyncs,
renames, assembles the manifest and runs retention, touching no CUDA
tensor.  ``wait(timeout)`` drains it; a writer error is raised by
``wait()`` or by the next ``save()``.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import itertools
import json
import logging
import os
import pickle
import queue
import re
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "FORMAT_VERSION", "MANIFEST_VERSION", "MANIFEST_NAME",
    "CheckpointCorrupt", "CheckpointManager", "save_checkpoint",
    "load_checkpoint", "latest_step", "list_steps", "step_dir",
    "shard_path", "manifest_path", "read_manifest", "missing_ranks",
    "verify_step", "verify_dir", "scale_resume_skip", "main",
    "rng_state", "set_rng_state", "restore_rng",
]

_log = logging.getLogger(__name__)

FORMAT_VERSION = 1
MANIFEST_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
#: janitor tombstone: present while a step is being deleted
TOMBSTONE_NAME = ".deleting"
#: reader pin prefix: a fresh pin blocks the janitor from deleting the
#: step a concurrent load/verify is reading
_PIN_PREFIX = ".reading-"
#: pins older than this are debris from a crashed reader
PIN_STALE_S = 120.0

_STEP_RE = re.compile(r"^step_(\d+)$")
_pin_ids = itertools.count(1)


class CheckpointCorrupt(RuntimeError):
    """A shard's bytes do not match its manifest digest.  The message
    names the exact shard(s)."""


class _StepVanished(Exception):
    """Internal: the step was garbage-collected while being read."""


def _rank_info() -> Tuple[int, int]:
    from . import diagnostics as _diag

    return _diag._rank_info()


def _generation() -> int:
    from . import env as _env

    return int(_env.get_int("MXNET_ELASTIC_GENERATION") or 0)


# ---------------------------------------------------------------------------
# bf16 through pickle, without ml_dtypes
# ---------------------------------------------------------------------------
# numpy's own pickle of an ml_dtypes.bfloat16 array: ndarray
# _reconstruct, then BUILD (version, shape, dtype, fortran, raw bytes)
# with dtype = numpy.dtype(ml_dtypes.bfloat16, False, True) + BUILD of
# this dtype state (little-endian, 2-byte items, 2-byte alignment)
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)
_reconstruct = np.zeros(1).__reduce__()[0]
_frombuffer = np.zeros(1).__reduce_ex__(5)[0]


class _GlobalRef:
    """A module attribute named in the pickle stream without importing
    the module here (``ml_dtypes.bfloat16``)."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name


class _Bf16Dtype:
    """Stands for numpy's ``dtype(ml_dtypes.bfloat16)`` in a pickle:
    written as that dtype, and what the reader makes of it."""

    def __setstate__(self, state):
        pass


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, taught two things: a ``torch.bfloat16``
    tensor pickles as numpy pickles an ``ml_dtypes.bfloat16`` array,
    and a :class:`_GlobalRef` as a global lookup."""

    dispatch = dict(pickle._Pickler.dispatch)

    def _save_global_ref(self, obj):
        self.save(obj.module)
        self.save(obj.name)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)

    dispatch[_GlobalRef] = _save_global_ref

    def reducer_override(self, obj):
        if isinstance(obj, _Bf16Dtype):
            return (np.dtype, (_GlobalRef("ml_dtypes", "bfloat16"),
                               False, True), _BF16_DTYPE_STATE)
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu().contiguous()
            if t.dtype != torch.bfloat16:
                return (np.asarray, (t.numpy(),))
            raw = t.view(torch.int16).numpy().astype("<i2").tobytes()
            return (_reconstruct, (np.ndarray, (0,), b"b"),
                    (1, tuple(t.shape), _Bf16Dtype(), False, raw))
        return NotImplemented


class _ArrayStub:
    """What ``ndarray`` reconstruction yields while unpickling: its
    BUILD state decides between a numpy array and, for the bf16 dtype,
    a ``torch.bfloat16`` tensor (swapped in after the load)."""

    value: Any = None

    def __setstate__(self, state):
        shape, dtype, raw = state[1], state[2], state[-1]
        if isinstance(dtype, _Bf16Dtype):
            bits = np.frombuffer(raw, dtype="<i2").reshape(shape).copy()
            self.value = torch.from_numpy(bits).view(torch.bfloat16)
        else:
            arr = _reconstruct(np.ndarray, (0,), b"b")
            arr.__setstate__(state)
            self.value = arr


def _np_dtype(obj, align=False, copy=False):
    if obj is _Bf16Marker:
        return _Bf16Dtype()
    return np.dtype(obj, align, copy)


class _Bf16Marker:
    """``ml_dtypes.bfloat16`` as the unpickler resolves it."""


def _np_reconstruct(cls, shape, typecode):
    if cls is np.ndarray:
        return _ArrayStub()
    return _reconstruct(cls, shape, typecode)


def _np_frombuffer(buf, dtype, shape, order):
    if isinstance(dtype, _Bf16Dtype):
        bits = np.frombuffer(buf, dtype="<i2").reshape(shape, order=order)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return _frombuffer(buf, dtype, shape, order)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _Bf16Marker
        if (module, name) == ("numpy", "dtype"):
            return _np_dtype
        if module in ("numpy._core.multiarray", "numpy.core.multiarray") \
                and name == "_reconstruct":
            return _np_reconstruct
        if module in ("numpy._core.numeric", "numpy.core.numeric") \
                and name == "_frombuffer":
            return _np_frombuffer
        return super().find_class(module, name)


def _swap_stubs(obj):
    if isinstance(obj, _ArrayStub):
        return obj.value
    if isinstance(obj, dict):
        return {k: _swap_stubs(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_swap_stubs(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_swap_stubs(v) for v in obj)
    return obj


def _dumps_payload(payload) -> bytes:
    """Pickle a checkpoint payload: ``torch.bfloat16`` tensors as the
    JAX package's ``ml_dtypes.bfloat16`` arrays, other tensors as
    numpy arrays."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(payload)
    return buf.getvalue()


class _DigestingWriter:
    """A file's ``write`` that also folds every byte into a sha256 and a
    byte count: a payload pickled through it is hashed as it is written,
    with no in-memory copy of the whole pickle (large array buffers go
    straight from their memory to the file)."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()
        self.nbytes = 0

    def write(self, data) -> int:
        self.sha.update(data)
        self.nbytes += memoryview(data).nbytes
        return self._f.write(data)


def _loads_payload(data: bytes):
    """Unpickle a checkpoint payload written by either package;
    bfloat16 arrays come back as ``torch.bfloat16`` tensors."""
    return _swap_stubs(_Unpickler(io.BytesIO(data)).load())


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------
def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, "step_%08d" % int(step))


def shard_path(directory: str, step: int, rank: int) -> str:
    return os.path.join(step_dir(directory, step), "rank%d.ckpt" % rank)


def _sidecar_path(directory: str, step: int, rank: int) -> str:
    return os.path.join(step_dir(directory, step),
                        "rank%d.meta.json" % rank)


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(step_dir(directory, step), MANIFEST_NAME)


def _tombstone_path(directory: str, step: int) -> str:
    return os.path.join(step_dir(directory, step), TOMBSTONE_NAME)


def list_steps(directory: str) -> List[int]:
    """Step numbers with a directory present (complete or not)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match, names)
                  if m)


def read_manifest(directory: str, step: int) -> Optional[dict]:
    """The step's MANIFEST.json, or None when it was never assembled."""
    try:
        with open(manifest_path(directory, step)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _tombstoned(directory: str, step: int) -> bool:
    return os.path.exists(_tombstone_path(directory, step))


def _fresh_pins(d: str) -> List[str]:
    out = []
    now = time.time()
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for n in names:
        if not n.startswith(_PIN_PREFIX):
            continue
        try:
            if now - os.path.getmtime(os.path.join(d, n)) < PIN_STALE_S:
                out.append(n)
        except OSError:
            pass
    return out


@contextlib.contextmanager
def _read_pin(directory: str, step: int):
    """Pin the step against the janitor while a reader verifies/loads
    it; yields a refresh callable for long hashes."""
    path = os.path.join(step_dir(directory, step), "%s%d-%d"
                        % (_PIN_PREFIX, os.getpid(), next(_pin_ids)))
    made = False
    try:
        with open(path, "w"):
            made = True
    except OSError:
        pass

    def refresh() -> None:
        if made:
            try:
                os.utime(path)
            except OSError:
                pass

    try:
        yield refresh
    finally:
        if made:
            try:
                os.unlink(path)
            except OSError:
                pass


def _is_complete(directory: str, step: int, num_ranks: int) -> bool:
    if _tombstoned(directory, step):
        return False
    man = read_manifest(directory, step)
    if man is not None:
        return all(
            os.path.exists(os.path.join(step_dir(directory, step),
                                        info["path"]))
            for info in man.get("shards", {}).values())
    return all(os.path.exists(shard_path(directory, step, r))
               for r in range(num_ranks))


def missing_ranks(directory: str, step: int, num_ranks: int) -> List[int]:
    """Which ranks' shards are absent from ``step``."""
    man = read_manifest(directory, step)
    if man is not None:
        num_ranks = int(man.get("num_ranks", num_ranks))
    return [r for r in range(num_ranks)
            if not os.path.exists(shard_path(directory, step, r))]


def _incomplete_detail(directory: str, num_ranks: int) -> str:
    steps = list_steps(directory)
    if not steps:
        return "no step_* directories exist"
    newest = steps[-1]
    missing = missing_ranks(directory, newest, num_ranks)
    present = [r for r in range(num_ranks) if r not in missing]
    return ("newest step %d is missing shard(s) for rank(s) %s of %d "
            "(present: %s)" % (newest, missing, num_ranks, present))


def latest_step(directory: str,
                num_ranks: Optional[int] = None) -> Optional[int]:
    """The newest step every expected rank finished writing (None when
    the directory holds no complete checkpoint).  Re-walks when it
    raced the retention janitor, as the JAX package does."""
    if num_ranks is None:
        num_ranks = max(_rank_info()[1], 1)
    prev_snapshot = None
    for _attempt in range(8):
        steps = list_steps(directory)
        saw_tombstone = False
        for step in reversed(steps):
            if _is_complete(directory, step, num_ranks):
                return step
            if _tombstoned(directory, step):
                saw_tombstone = True
        snapshot = (tuple(steps), saw_tombstone)
        if not saw_tombstone and snapshot == prev_snapshot:
            return None
        prev_snapshot = snapshot
        time.sleep(0.0005)
    return None


# ---------------------------------------------------------------------------
# integrity: digests, manifest assembly, verification
# ---------------------------------------------------------------------------
def _dtype_name(v) -> Optional[str]:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return str(getattr(v, "dtype", "")) or None


def _tree_spec(tree: Dict[str, Any]) -> Dict[str, dict]:
    return {k: {"shape": list(getattr(v, "shape", ()) or ()),
                "dtype": _dtype_name(v)}
            for k, v in (tree or {}).items()}


def _try_assemble_manifest(directory: str, step: int, num_ranks: int,
                           force: bool = False) -> Optional[str]:
    """Once every rank's shard + sidecar landed, fold them into the
    step's MANIFEST.json (atomic write).  ``force`` re-assembles over
    an existing manifest (a shard legitimately re-written)."""
    if not force and os.path.exists(manifest_path(directory, step)):
        return None
    shards: Dict[str, dict] = {}
    tree: Dict[str, Any] = {}
    generation = 0
    for r in range(num_ranks):
        if not os.path.exists(shard_path(directory, step, r)):
            return None
        try:
            with open(_sidecar_path(directory, step, r)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        shards[str(r)] = {"path": "rank%d.ckpt" % r,
                          "bytes": int(meta["bytes"]),
                          "sha256": meta["sha256"]}
        if meta.get("param_fps"):
            shards[str(r)]["param_fps"] = meta["param_fps"]
        if meta.get("tree"):
            tree = meta["tree"]
        generation = max(generation, int(meta.get("generation", 0)))
    manifest = {
        "manifest_version": MANIFEST_VERSION,
        "format_version": FORMAT_VERSION,
        "step": int(step),
        "num_ranks": int(num_ranks),
        "generation": generation,
        "shards": shards,
        "tree": tree,
    }
    path = manifest_path(directory, step)
    tmp = path + ".tmp.%d" % os.getpid()
    try:
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path)
    except OSError:
        return None
    return path


def verify_step(directory: str, step: int,
                num_ranks: Optional[int] = None,
                digest_ranks: Optional[List[int]] = None,
                on_shard=None) -> dict:
    """Audit one step against its manifest.  Returns ``{step,
    has_manifest, complete, verified, shards: {rank: {ok, error}},
    corrupt: [shard names]}``; ``verified`` is None without a manifest.
    ``digest_ranks`` limits the sha256 pass to those ranks (the rest get
    the existence + byte-count check)."""
    nr = max(_rank_info()[1], 1) if num_ranks is None else int(num_ranks)
    man = read_manifest(directory, step)
    rep: Dict[str, Any] = {"step": int(step),
                           "has_manifest": man is not None,
                           "complete": False, "verified": None,
                           "shards": {}, "corrupt": []}
    if _tombstoned(directory, step):
        rep["error"] = "tombstoned (mid-deletion)"
        return rep
    if man is None:
        rep["complete"] = all(os.path.exists(shard_path(directory, step, r))
                              for r in range(nr))
        return rep
    d = step_dir(directory, step)
    want_digest = None if digest_ranks is None \
        else {int(r) for r in digest_ranks}
    all_exist = all_ok = True
    for r, info in sorted(man.get("shards", {}).items(),
                          key=lambda kv: int(kv[0])):
        path = os.path.join(d, info["path"])
        entry: Dict[str, Any] = {"ok": False}
        rep["shards"][r] = entry
        try:
            size = os.path.getsize(path)
        except OSError:
            entry["error"] = "missing"
            all_exist = all_ok = False
            continue
        if size != int(info["bytes"]):
            entry["error"] = ("truncated: %d bytes on disk, manifest "
                              "says %d" % (size, info["bytes"]))
            all_ok = False
            rep["corrupt"].append(info["path"])
            continue
        if want_digest is not None and int(r) not in want_digest:
            entry["ok"] = True
            continue
        h = hashlib.sha256()
        try:
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
        except OSError:
            entry["error"] = "unreadable"
            all_exist = all_ok = False
            continue
        if on_shard is not None:
            on_shard()
        digest = h.hexdigest()
        if digest != info["sha256"]:
            entry["error"] = ("sha256 mismatch: disk %s.. != manifest "
                              "%s.." % (digest[:12], info["sha256"][:12]))
            all_ok = False
            rep["corrupt"].append(info["path"])
        else:
            entry["ok"] = True
    rep["complete"] = all_exist
    rep["verified"] = all_ok and all_exist
    return rep


def verify_dir(directory: str, num_ranks: Optional[int] = None) -> dict:
    """Audit every step under ``directory`` (the ``--verify`` CLI).
    ``ok`` is False when any step holds a corrupt shard."""
    steps = []
    n_corrupt = n_verified = n_legacy = 0
    for s in list_steps(directory):
        rep = verify_step(directory, s, num_ranks=num_ranks)
        steps.append(rep)
        if rep["corrupt"]:
            n_corrupt += 1
        elif rep["verified"]:
            n_verified += 1
        elif rep["complete"] and not rep["has_manifest"]:
            n_legacy += 1
    return {
        "directory": directory,
        "n_steps": len(steps),
        "n_verified": n_verified,
        "n_corrupt": n_corrupt,
        "n_unverifiable_legacy": n_legacy,
        "ok": n_corrupt == 0,
        "steps": steps,
    }


def _verify_wanted(verify: Optional[bool]) -> bool:
    if verify is not None:
        return bool(verify)
    from . import env as _env

    return _env.get_bool("MXNET_CKPT_VERIFY")


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------
def rng_state() -> dict:
    """The port's random state (``random.get_state``) with numpy
    arrays, so it pickles without torch."""
    from . import random as _random

    st = _random.get_state()
    return {"seed": st["seed"],
            "generators": {d: g.numpy() for d, g
                           in st["generators"].items()}}


def set_rng_state(state: Optional[dict]) -> None:
    """Restore a :func:`rng_state` snapshot; ``None`` leaves the random
    state as it is."""
    if not state:
        return
    from . import random as _random

    _random.set_state(state)


def restore_rng(payload: dict, where: str = "checkpoint") -> None:
    """Resume the random stream of a loaded shard: the port's state
    where it carries one, else a warning that the stream restarts (a
    JAX shard carries a JAX key, which draws nothing here)."""
    state = payload.get("rng_torch")
    if state:
        set_rng_state(state)
        return
    _log.warning(
        "%s (step %s) carries no torch random state (%s): the random "
        "stream restarts from the current seed", where,
        payload.get("step"),
        "written by the JAX package" if payload.get("rng") else
        "none was saved")


def _snapshot_params(params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Params (torch tensors, port NDArrays or numpy) -> host values,
    synchronously: numpy arrays, except bf16, which stays a CPU
    ``torch.bfloat16`` tensor (numpy has no bf16; the pickler writes it
    as the JAX package's bf16)."""
    from .ndarray import NDArray

    out = {}
    for k, v in (params or {}).items():
        if isinstance(v, NDArray):
            v = v._data
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            out[k] = v.clone() if v.dtype == torch.bfloat16 else \
                v.numpy().copy()
        else:
            out[k] = np.array(v)
    return out


class CheckpointManager:
    """Writes (and garbage-collects) one rank's shard stream under a
    shared checkpoint directory, on the ``mx-ckpt-writer`` thread
    unless ``async_write`` (default ``MXNET_CKPT_ASYNC``) is off."""

    def __init__(self, directory: str, keep: Optional[int] = None,
                 async_write: Optional[bool] = None,
                 rank: Optional[int] = None,
                 num_ranks: Optional[int] = None):
        from . import env as _env

        self.directory = directory
        r, n = _rank_info()
        self.rank = r if rank is None else int(rank)
        self.num_ranks = max(n if num_ranks is None else int(num_ranks), 1)
        self.keep = _env.get_int("MXNET_CKPT_KEEP") if keep is None \
            else int(keep)
        self.async_write = _env.get_bool("MXNET_CKPT_ASYNC") \
            if async_write is None else bool(async_write)
        self._q: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, *, params=None, aux_params=None,
             optimizer_states: Optional[bytes] = None,
             epoch: int = 0, nbatch: int = 0,
             iterator_state: Optional[dict] = None,
             extra: Optional[dict] = None,
             blocking: Optional[bool] = None) -> str:
        """Snapshot now, write now (``blocking``) or on the writer
        thread.  Returns the shard path that exists once the write
        lands.  An error of an earlier asynchronous write is raised
        here."""
        self._raise_writer_error()
        payload = {
            "format_version": FORMAT_VERSION,
            "step": int(step), "epoch": int(epoch), "nbatch": int(nbatch),
            "generation": _generation(),
            "rank": self.rank, "num_ranks": self.num_ranks,
            "params": _snapshot_params(params),
            "aux_params": _snapshot_params(aux_params),
            "optimizer_states": optimizer_states,
            # the JAX package's key stays empty: it reads this shard
            "rng": None,
            "rng_torch": rng_state(),
            "iterator": dict(iterator_state) if iterator_state else None,
            "extra": dict(extra) if extra else None,
        }
        path = shard_path(self.directory, step, self.rank)
        sync = not self.async_write if blocking is None else blocking
        if sync:
            self._write(int(step), payload, path)
        else:
            self._ensure_writer()
            self._q.put((int(step), payload, path))
        return path

    def _ensure_writer(self) -> None:
        with self._lock:
            if self._writer is None or not self._writer.is_alive():
                self._writer = threading.Thread(
                    target=self._writer_loop, name="mx-ckpt-writer",
                    daemon=True)
                self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            step, payload, path = self._q.get()
            try:
                self._write(step, payload, path)
            except BaseException as e:  # raised by wait()/next save
                with self._lock:
                    self._errors.append(e)
            finally:
                self._q.task_done()

    def _raise_writer_error(self) -> None:
        with self._lock:
            if self._errors:
                raise self._errors.pop(0)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the queued writes landed (``Queue.join`` has no
        timeout, so this polls).  Raises the first writer error, if
        any.  Returns False when ``timeout`` expired with writes
        pending."""
        t0 = time.monotonic()
        while self._writer is not None and self._writer.is_alive() \
                and self._q.unfinished_tasks:
            if timeout is not None and time.monotonic() - t0 > timeout:
                return False
            time.sleep(0.01)
        self._raise_writer_error()
        return True

    def _write(self, step: int, payload: dict, path: str) -> None:
        # one retry: a peer rank's janitor may rmdir this step between
        # the makedirs and the replace
        for attempt in (0, 1):
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    # the pickle streams into the file and the digest:
                    # the digest is of the bytes as they are written,
                    # before they reach the disk; the array buffers are
                    # never copied whole under the interpreter lock (a
                    # writer thread holding it would stall the steps)
                    out = _DigestingWriter(f)
                    _Pickler(out, protocol=pickle.HIGHEST_PROTOCOL).dump(
                        payload)
                    f.flush()
                    os.fsync(f.fileno())
                digest = out.sha.hexdigest()
                sidecar = {
                    "rank": self.rank, "step": int(step),
                    "num_ranks": self.num_ranks,
                    "generation": int(payload.get("generation", 0)),
                    "bytes": out.nbytes, "sha256": digest,
                    "format_version": FORMAT_VERSION,
                    "param_fps": None,
                    "tree": {"params": _tree_spec(payload.get("params")),
                             "aux_params": _tree_spec(
                                 payload.get("aux_params"))},
                }
                os.replace(tmp, path)
                sc = _sidecar_path(self.directory, step, self.rank)
                with open(sc + ".tmp", "w") as f:
                    json.dump(sidecar, f)
                os.replace(sc + ".tmp", sc)
                break
            except FileNotFoundError:
                if attempt:
                    raise
        man = read_manifest(self.directory, step)
        stale = bool(
            man is not None
            and man.get("shards", {}).get(str(self.rank), {})
            .get("sha256") not in (None, digest))
        _try_assemble_manifest(self.directory, step, self.num_ranks,
                               force=stale)
        self._gc(keep_at_least=step)

    def _gc(self, keep_at_least: int) -> None:
        """Drop the oldest complete steps beyond the retention window,
        and incomplete steps older than the newest complete one (rank
        0 only)."""
        if self.keep <= 0 or self.rank != 0:
            return
        steps = list_steps(self.directory)
        complete = [s for s in steps
                    if _is_complete(self.directory, s, self.num_ranks)]
        for s in complete[:-self.keep]:
            if s < keep_at_least:
                self._rm_step(s)
        if complete:
            newest = complete[-1]
            for s in steps:
                if s < newest and s not in complete:
                    self._rm_step(s)

    def _rm_step(self, step: int) -> bool:
        """Delete one step behind the reader barrier: pins first, the
        tombstone, pins again, shards, the manifest, the tombstone
        last."""
        d = step_dir(self.directory, step)
        if not os.path.isdir(d):
            return True
        if _fresh_pins(d):
            return False
        tomb = _tombstone_path(self.directory, step)
        try:
            with open(tomb, "w"):
                pass
        except OSError:
            return False
        if _fresh_pins(d):
            try:
                os.unlink(tomb)
            except OSError:
                pass
            return False
        try:
            names = os.listdir(d)
        except OSError:
            return True
        for name in sorted(names,
                           key=lambda n: (n == MANIFEST_NAME)
                           + 2 * (n == TOMBSTONE_NAME)):
            try:
                os.unlink(os.path.join(d, name))
            except OSError:
                pass
        try:
            os.rmdir(d)
        except OSError:
            pass
        return True


def save_checkpoint(directory: str, step: int, **kw) -> str:
    """One-shot blocking save of this rank's shard (see
    :meth:`CheckpointManager.save` for the keyword surface)."""
    kw.setdefault("blocking", True)
    return CheckpointManager(directory).save(step, **kw)


# ---------------------------------------------------------------------------
# load: verified, fallback-aware
# ---------------------------------------------------------------------------
def _split_step_dir(directory: str) -> Tuple[str, Optional[int]]:
    norm = os.path.normpath(directory)
    m = _STEP_RE.match(os.path.basename(norm))
    if m:
        return os.path.dirname(norm), int(m.group(1))
    return directory, None


def _incomplete_error(directory, step, missing, writer_ranks):
    present = [r for r in range(writer_ranks) if r not in missing]
    return FileNotFoundError(
        "checkpoint step %d under %r is incomplete: missing shard(s) "
        "for rank(s) %s of %d (present: %s) — every rank must finish "
        "writing before the step is loadable"
        % (step, directory, missing, writer_ranks, present))


def _load_shard(directory: str, step: int, rank: int, nr: int,
                verify: bool, explicit: bool) -> dict:
    with _read_pin(directory, step) as refresh_pin:
        if _tombstoned(directory, step):
            raise _StepVanished(step)
        man = read_manifest(directory, step)
        writer_ranks = int(man["num_ranks"]) if man is not None else nr
        # elastic: a W'-rank fleet reads source shard r % W
        src = rank if writer_ranks == nr else rank % writer_ranks
        if verify and man is not None:
            rep = verify_step(directory, step,
                              digest_ranks=[src] if explicit else None,
                              on_shard=refresh_pin)
            if not rep["verified"]:
                if _tombstoned(directory, step) or \
                        read_manifest(directory, step) is None:
                    raise _StepVanished(step)
                if rep["corrupt"]:
                    details = "; ".join(
                        "%s: %s" % (info.get("error"),
                                    os.path.join(
                                        step_dir(directory, step),
                                        man["shards"][r]["path"]))
                        for r, info in sorted(rep["shards"].items())
                        if info.get("error"))
                    raise CheckpointCorrupt(
                        "checkpoint step %d under %r FAILED integrity "
                        "verification — corrupt shard(s): %s (%s).  "
                        "Set MXNET_CKPT_VERIFY=0 to load anyway at "
                        "your own risk."
                        % (step, directory, ", ".join(rep["corrupt"]),
                           details))
                raise _incomplete_error(
                    directory, step,
                    sorted(int(r) for r, info in rep["shards"].items()
                           if info.get("error") in ("missing",
                                                    "unreadable")),
                    writer_ranks)
        path = shard_path(directory, step, src)
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            if _tombstoned(directory, step) or \
                    not os.path.isdir(step_dir(directory, step)):
                raise _StepVanished(step)
            raise _incomplete_error(
                directory, step,
                missing_ranks(directory, step, writer_ranks) or [src],
                writer_ranks)
        with f:
            payload = _loads_payload(f.read())
    version = payload.get("format_version")
    if version is None or version > FORMAT_VERSION:
        raise ValueError(
            "checkpoint %s has format_version %r; this build reads <= %d"
            % (path, version, FORMAT_VERSION))
    if writer_ranks != nr:
        it = payload.get("iterator") or {}
        payload["elastic"] = {
            "from_num_ranks": writer_ranks, "to_num_ranks": nr,
            "rank": rank, "source_rank": src,
            "orig_nbatch": int(payload.get("nbatch", 0)),
            "orig_cursor": it.get("cursor"),
            "orig_batch_size": it.get("batch_size"),
        }
        _log.warning(
            "ELASTIC RESUME: checkpoint step %d under %r was written by "
            "%d rank(s); resuming rank %d of %d from source shard %d — "
            "iterator position scales by %d/%d (exact resume is bitwise "
            "only when the world size matches)",
            step, directory, writer_ranks, rank, nr, src, writer_ranks, nr)
    return payload


def load_checkpoint(directory: str, step: Optional[int] = None,
                    rank: Optional[int] = None,
                    num_ranks: Optional[int] = None,
                    verify: Optional[bool] = None) -> dict:
    """Load one rank's shard of the given (default: newest verified)
    step.  Digests are checked against MANIFEST.json (``verify``,
    default ``MXNET_CKPT_VERIFY``).  A step written by W ranks loads on
    a W'-rank fleet from source shard ``rank % W`` (the payload's
    ``elastic`` entry records it).  An explicit ``step`` (or a
    ``directory`` naming a ``step_NNNNNNNN`` dir) fails fast on
    corruption; ``step=None`` falls back past corrupt steps to the
    newest verified one.  Raises FileNotFoundError when nothing is
    loadable (naming the missing ranks), ValueError on a format from
    the future, CheckpointCorrupt on failed digests."""
    directory, dir_step = _split_step_dir(directory)
    if step is None:
        step = dir_step
    if rank is None:
        rank = _rank_info()[0]
    nr = max(_rank_info()[1], 1) if num_ranks is None else int(num_ranks)
    want_verify = _verify_wanted(verify)

    if step is not None:
        try:
            return _load_shard(directory, int(step), rank, nr,
                               want_verify, explicit=True)
        except _StepVanished:
            raise FileNotFoundError(
                "checkpoint step %d under %r does not exist (never "
                "written, or garbage-collected by the retention "
                "janitor); steps present: %s"
                % (step, directory, list_steps(directory)))

    corrupt_msgs: List[str] = []
    for s in reversed(list_steps(directory)):
        if not _is_complete(directory, s, nr):
            continue
        try:
            return _load_shard(directory, s, rank, nr, want_verify,
                               explicit=False)
        except _StepVanished:
            continue
        except CheckpointCorrupt as e:
            corrupt_msgs.append(str(e))
            _log.warning(
                "checkpoint step %d under %r failed verification — "
                "falling back to the newest VERIFIED step (%s)",
                s, directory, e)
            continue
        except FileNotFoundError:
            continue
    if corrupt_msgs:
        raise CheckpointCorrupt(
            "no verified checkpoint under %r: every complete step "
            "failed integrity verification.  Newest failure: %s"
            % (directory, corrupt_msgs[0]))
    raise FileNotFoundError(
        "no complete checkpoint under %r (a step is complete "
        "only when every rank's shard exists): %s"
        % (directory, _incomplete_detail(directory, nr)))


def scale_resume_skip(payload: dict,
                      new_batch_size: Optional[int]) -> int:
    """The per-rank batches to skip on an elastic resume (ref
    ``scale_resume_skip`` :985): the global sample position (per-rank
    batches x per-rank batch size x world size) is invariant, re-divided
    by this fleet's per-rank batch x world size; pure world-size
    scaling when the writer recorded no batch size."""
    el = payload.get("elastic")
    if not el:
        return int(payload.get("nbatch", 0))
    w_old = max(int(el["from_num_ranks"]), 1)
    w_new = max(int(el["to_num_ranks"]), 1)
    nbatch = int(el.get("orig_nbatch", payload.get("nbatch", 0)))
    b_old = el.get("orig_batch_size")
    if b_old and new_batch_size:
        global_samples = nbatch * int(b_old) * w_old
        return global_samples // (int(new_batch_size) * w_new)
    return (nbatch * w_old) // w_new


# ---------------------------------------------------------------------------
# CLI: python -m mxnet_tpu_torch.checkpoint --verify DIR
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.checkpoint",
        description="checkpoint directory integrity audit")
    ap.add_argument("--verify", metavar="DIR",
                    help="verify every step's shards against its "
                         "MANIFEST.json; exit 1 when any step holds a "
                         "corrupt shard")
    ap.add_argument("--num-ranks", type=int, default=None,
                    help="expected world size for steps without a "
                         "manifest")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report")
    args = ap.parse_args(argv)
    if not args.verify:
        ap.print_help()
        return 0
    rep = verify_dir(args.verify, num_ranks=args.num_ranks)
    if args.json:
        print(json.dumps(rep))
    else:
        for s in rep["steps"]:
            if s["corrupt"]:
                status = "CORRUPT (%s)" % ", ".join(s["corrupt"])
            elif s["verified"]:
                status = "verified"
            elif s["complete"]:
                status = "complete, no manifest (legacy, unverifiable)"
            else:
                status = "incomplete"
            print("step %8d: %s" % (s["step"], status))
        print("%s: %d step(s), %d verified, %d corrupt, %d legacy"
              % ("OK" if rep["ok"] else "FAILED", rep["n_steps"],
                 rep["n_verified"], rep["n_corrupt"],
                 rep["n_unverifiable_legacy"]))
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
