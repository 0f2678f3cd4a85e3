"""Memory-for-compute trading: per-scope remat, the mirror and
microbatch gradient accumulation.

Counterpart: ``mxnet_tpu/remat.py``.  The JAX package wraps a scope in
``jax.checkpoint``; the port wraps it in
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``
(:func:`checkpoint`), which keeps the scope's inputs, drops what is
computed inside it and runs the scope's forward again when the
backward reaches it (the flash-attention forward kernel included: its
launches count again there).

Policies (``MXNET_REMAT_POLICY`` or an explicit argument), one scope
at a time (scopes never nest):

  * ``none``       — keep every activation;
  * ``block``      — each decoder block of the transformer;
  * ``attention``  — the attention sub-graph of each block;
  * ``stage``      — each ResNet stage (the zoo's ``_remat_scope``
    markers; the executor's ``stageN_`` segments);
  * ``conv_block`` — each residual unit.

The mirror (``MXNET_BACKWARD_DO_MIRROR``, ref: graph_executor.cc:249)
keeps the outputs of convolutions and matrix products (the JAX
package's ``dot_general`` / ``conv_general_dilated`` save policy) and
recomputes the rest in backward.  Its boundary is the JAX package's:
``FusedTrainStep``'s forward (:func:`maybe_checkpoint`), the outermost
hybridized block's recorded call (the CachedOp) and the executor's
training evaluation.  Inside it the port cuts the program into regions
that end at a convolution or dense layer — the runs of a
``HybridSequential``'s children (:func:`mirror_sequence`), the
executor's graph in topological order — each under a checkpoint: a
region keeps its input (the layer before's output) and its output, and
is recomputed when the backward reaches it, as the mirror pass
recomputes node by node.  Two torch idioms measured worse (PERF.md, PR
11): one selective checkpoint around the whole program recomputes the
whole forward at the first saved tensor backward needs and holds every
recomputed activation at once (the peak stays where it was), and a
selective policy inside each region adds per-op Python dispatch that
keeps nothing more.

A recompute must not change state.  :func:`checkpoint` therefore
replays, for the scope's second forward, what its first one saw:

  * the port's random state (``random.get_state``): explicit
    generators are not covered by checkpoint's ``preserve_rng_state``,
    and a dropout mask drawn anew in backward would give a wrong
    gradient of the right shape.  The advanced state is put back after;
  * the thread's recording/training flags, the block-trace and mirror
    depths and the default context: the backward of a card's tensors
    runs on autograd's device thread, whose thread-locals are not the
    caller's;
  * :func:`recomputing` is true inside, and ``nd.invoke`` then skips
    its aux write-back (BatchNorm's moving statistics would move
    twice).  Only the write-back: the computation takes the same
    branch, as non-reentrant checkpoint checks.
"""
from __future__ import annotations

import contextlib
import threading

from . import env as _env

__all__ = ["mirror_enabled", "maybe_checkpoint",
           "mirror_sequence", "REMAT_POLICIES", "CONV_SCOPES",
           "remat_policy", "checkpoint_scope", "checkpoint_block_call",
           "hybrid_block_call", "grad_accum_steps", "checkpoint",
           "recomputing", "block_trace", "in_block_trace", "mirror_scope",
           "regions_entered"]

REMAT_POLICIES = ("none", "block", "attention", "stage", "conv_block")
# conv-tier scopes: the gluon Block.__call__ hook and the symbolic
# executor's stage segmentation consult this subset
CONV_SCOPES = ("stage", "conv_block")

_tls = threading.local()


def _st():
    if not hasattr(_tls, "depth"):
        _tls.depth = 0
        _tls.mirror = 0
        _tls.recomputing = 0
    return _tls


def recomputing() -> bool:
    """True inside a remat scope's recompute (its second forward)."""
    return _st().recomputing > 0


def in_block_trace() -> bool:
    """True inside the reference's CachedOp trace: a hybridized block's
    call, or a block driven by ``FusedTrainStep``."""
    return _st().depth > 0


@contextlib.contextmanager
def block_trace():
    st = _st()
    st.depth += 1
    try:
        yield
    finally:
        st.depth -= 1


@contextlib.contextmanager
def mirror_scope():
    """The mirror's boundary: ``HybridSequential``s inside run their
    children in mirror regions (:func:`mirror_sequence`)."""
    st = _st()
    st.mirror += 1
    try:
        yield
    finally:
        st.mirror -= 1


def mirror_active() -> bool:
    """Inside a mirror boundary, on a recorded training forward."""
    from . import autograd

    return _st().mirror > 0 and autograd.is_recording() \
        and autograd.is_training()


def mirror_enabled() -> bool:
    """Any value but the shared falsy spellings (0/false/no/off, any
    case; unset/empty keeps the default, False) enables."""
    return _env.get_bool("MXNET_BACKWARD_DO_MIRROR")


class _Recompute:
    """The recompute side of :func:`checkpoint`: the forward's random
    state and thread state in, the advanced random state back after."""

    def __init__(self, rng, env):
        self._rng, self._env = rng, env

    def __enter__(self):
        from . import autograd
        from . import random as _random

        recording, training, depth, mirror, ctx = self._env
        st = _st()
        self._prev = (autograd.set_recording(recording),
                      autograd.set_training(training), st.depth, st.mirror)
        st.depth, st.mirror = depth, mirror
        st.recomputing += 1
        self._ctx = ctx
        ctx.__enter__()
        self._advanced = _random.get_state()
        _random.set_state(self._rng)
        return self

    def __exit__(self, *exc):
        from . import autograd
        from . import random as _random

        _random.set_state(self._advanced)
        self._ctx.__exit__(*exc)
        st = _st()
        st.recomputing -= 1
        st.depth, st.mirror = self._prev[2:]
        autograd.set_training(self._prev[1])
        autograd.set_recording(self._prev[0])


#: checkpoint regions entered in this process (forward calls of
#: :func:`checkpoint`): the static auditor's remat-effectiveness check
#: counts a step's regions by this
_REGIONS = [0]


def regions_entered() -> int:
    """Checkpoint regions entered in this process so far."""
    return _REGIONS[0]


def checkpoint(fn, *args):
    """``fn(*args)`` under non-reentrant ``torch.utils.checkpoint``; the
    recompute replays the random and thread state of this call."""
    from torch.utils.checkpoint import checkpoint as _checkpoint

    _REGIONS[0] += 1
    from . import autograd
    from . import random as _random
    from .context import current_context

    rng = _random.get_state()
    st = _st()
    env = (autograd.is_recording(), autograd.is_training(), st.depth,
           st.mirror, current_context())
    return _checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), _Recompute(rng, env)))


def maybe_checkpoint(fn):
    """``fn`` as a mirror boundary when ``MXNET_BACKWARD_DO_MIRROR`` is
    on (the mirror regions form inside it); identity otherwise.  Apply
    it to the whole training forward, as the JAX package applies its
    ``jax.checkpoint``."""
    if not mirror_enabled():
        return fn

    def wrapped(*args):
        with mirror_scope():
            return fn(*args)

    return wrapped


def mirror_sequence(blocks, x):
    """A ``HybridSequential``'s children on ``x`` under the mirror: runs
    of leaf blocks, each cut after a block that keeps its output (a
    convolution or a dense layer, ``_mirror_keeps``), each run under one
    checkpoint.  A composite child (a residual unit, a stage, a layer
    with a fused activation) runs as itself, and its own sequentials
    cut their runs."""
    out, run = x, []
    for b in blocks:
        if b._children:
            out = _mirror_run(run, out)
            run = []
            out = b(out)
            continue
        run.append(b)
        if getattr(b, "_mirror_keeps", False):
            out = _mirror_run(run, out)
            run = []
    return _mirror_run(run, out)


def _mirror_run(run, x):
    if not run:
        return x
    if len(run) == 1 and getattr(run[0], "_mirror_keeps", False):
        return run[0](x)        # keeps its input for backward anyway

    def seq(x):
        for b in run:
            x = b(x)
        return x

    return _wrapped_call(seq, [x])


def remat_policy(override=None) -> str:
    """The selected per-scope remat policy: explicit argument wins, else
    ``MXNET_REMAT_POLICY`` (default ``none``).  Unknown names raise: a
    typo'd policy silently running without remat would run out of
    memory exactly where it was asked for."""
    pol = override if override is not None \
        else _env.get_str("MXNET_REMAT_POLICY")
    if pol not in REMAT_POLICIES:
        raise ValueError(
            "unknown remat policy %r (MXNET_REMAT_POLICY); pick one of %s"
            % (pol, "/".join(REMAT_POLICIES)))
    return pol


def checkpoint_scope(fn, policy: str, scope: str):
    """Wrap ``fn`` in :func:`checkpoint` when the selected ``policy``
    names this ``scope`` (``'block'`` / ``'attention'``); identity
    otherwise.  The recompute runs the same operations on the same
    inputs, so the gradients equal the no-remat ones."""
    if policy != scope:
        return fn

    def wrapped(*args):
        return checkpoint(fn, *args)

    return wrapped


def _subtree_params(block):
    """Every parameter of a gluon block subtree, once each (the
    ``CachedOp`` walk)."""
    cells, seen = [], set()

    def collect(b):
        for p in b._reg_params.values():
            if id(p) not in seen:
                seen.add(id(p))
                cells.append(p)
        for c in b._children.values():
            collect(c)

    collect(block)
    return cells


def _wrapped_call(block_fn, args):
    """``block_fn(*args)`` (NDArrays in, NDArrays out) under
    :func:`checkpoint`."""
    from .ndarray import NDArray

    ctx = args[0].context
    ctxs = [a.context for a in args]

    def fn(*raws):
        out = block_fn(*[NDArray.from_raw(r, c)
                         for r, c in zip(raws, ctxs)])
        if isinstance(out, (list, tuple)):
            return tuple(o._data for o in out)
        return out._data

    res = checkpoint(fn, *[a._data for a in args])
    if isinstance(res, tuple):
        return [NDArray.from_raw(r, ctx) for r in res]
    return NDArray.from_raw(res, ctx)


def _wraps(block, args) -> bool:
    """A recorded, training forward on NDArrays with every parameter of
    the subtree settled: settle and ``autograd.pause()`` forwards fall
    through, as concrete inputs do in the JAX package."""
    from . import autograd
    from .ndarray import NDArray

    if not (autograd.is_recording() and autograd.is_training()):
        return False
    if not args or not all(isinstance(a, NDArray) for a in args):
        return False
    return all(p._data is not None for p in _subtree_params(block))


def checkpoint_block_call(block, scope: str, args):
    """Checkpoint one gluon sub-block call at its declared remat scope
    (``Block._remat_scope``: ResNet stages are ``'stage'``, residual
    units ``'conv_block'``).

    Returns ``NotImplemented`` when the wrap does not apply — another
    policy, outside a block trace (an eager block that is not
    hybridized: the JAX package's concrete forward), a settle or paused
    forward, unsettled parameters — and the caller runs the plain
    ``forward``.  The port's blocks run eagerly, so the BatchNorm aux
    write-backs happen in the first forward only (the recompute skips
    them); the parameters stay in their cells, and gradients reach them
    through the recorded graph."""
    try:
        policy = remat_policy()
    except ValueError:
        return NotImplemented  # bad env value surfaces at the step
    if policy != scope or not in_block_trace() or not _wraps(block, args):
        return NotImplemented
    return _wrapped_call(block.forward, args)


def hybrid_block_call(block, args):
    """The call of an outermost hybridized block: the JAX package's
    CachedOp.  Its forward runs as a block trace (the conv scopes
    inside fire), and a recorded training call is a mirror boundary
    when the mirror is on."""
    from .gluon.block import Block

    def run(*a):
        with block_trace():
            return Block.__call__(block, *a)

    if _wraps(block, args):
        return maybe_checkpoint(run)(*args)
    return run(*args)


def grad_accum_steps(override=None) -> int:
    """Microbatch gradient-accumulation factor: explicit argument wins,
    else ``MXNET_GRAD_ACCUM_STEPS`` (default 1 = off).  The train step
    splits its batch into this many microbatches, runs forward and
    backward over each, sums the gradients and applies ONE reduce and
    update: effective batch = dispatch batch, live activation memory =
    one microbatch's."""
    n = int(override) if override is not None \
        else _env.get_int("MXNET_GRAD_ACCUM_STEPS")
    if n < 1:
        raise ValueError(
            "MXNET_GRAD_ACCUM_STEPS must be >= 1, got %d" % n)
    return n
