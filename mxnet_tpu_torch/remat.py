"""Per-scope rematerialization for the transformer: trade the memory of
a scope's activations for its recompute in the backward pass.

Counterpart: ``mxnet_tpu/remat.py`` ``remat_policy`` (:103) and
``checkpoint_scope`` (:117), the transformer's part.  The JAX package
wraps a scope in ``jax.checkpoint``; the port wraps it in
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which keeps
the scope's inputs, drops everything computed inside it, and runs the
scope's forward again when the backward reaches it (the flash-attention
forward kernel included: its launches count again there).

Policies (``MXNET_REMAT_POLICY`` or an explicit argument):

  * ``none``      — keep every activation;
  * ``block``     — each decoder block (activation memory O(L + T)
    instead of O(L*T));
  * ``attention`` — the attention sub-graph of each block.

The conv-tier scopes ``stage`` / ``conv_block`` and the whole-program
mirror (``MXNET_BACKWARD_DO_MIRROR``) are not ported yet (ROADMAP A7)
and raise.
"""
from __future__ import annotations

from . import env as _env

__all__ = ["REMAT_POLICIES", "remat_policy", "checkpoint_scope"]

REMAT_POLICIES = ("none", "block", "attention")
# the JAX package's policies the port does not run yet
_QUEUED = ("stage", "conv_block")


def remat_policy(override=None) -> str:
    """The selected per-block remat policy: explicit argument wins, else
    ``MXNET_REMAT_POLICY`` (default ``none``).  Unknown names raise, and
    so do the queued conv scopes and ``MXNET_BACKWARD_DO_MIRROR``: a
    policy that silently did nothing would run out of memory exactly
    where it was asked for."""
    if _env.get_bool("MXNET_BACKWARD_DO_MIRROR"):
        raise ValueError(
            "MXNET_BACKWARD_DO_MIRROR (the whole-program mirror remat) is "
            "not ported to mxnet_tpu_torch yet (ROADMAP A7); unset it")
    pol = override if override is not None \
        else _env.get_str("MXNET_REMAT_POLICY")
    if pol in _QUEUED:
        raise ValueError(
            "remat policy %r (the conv tier's scope) is not ported to "
            "mxnet_tpu_torch yet (ROADMAP A7); the transformer runs %s"
            % (pol, "/".join(REMAT_POLICIES)))
    if pol not in REMAT_POLICIES:
        raise ValueError(
            "unknown remat policy %r (MXNET_REMAT_POLICY); pick one of %s"
            % (pol, "/".join(REMAT_POLICIES)))
    return pol


def checkpoint_scope(fn, policy: str, scope: str):
    """Wrap ``fn`` in ``torch.utils.checkpoint`` when the selected
    ``policy`` names this ``scope`` (``'block'`` / ``'attention'``);
    identity otherwise.  The recompute runs the same operations on the
    same inputs, so the gradients equal the no-remat ones."""
    if policy != scope:
        return fn
    from torch.utils.checkpoint import checkpoint

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return wrapped
