"""Transformer-LM training on one device: the train step and a
checkpointed fit loop.

Counterpart: ``mxnet_tpu/transformer/train.py`` ``TransformerTrainStep``
(:46-757), on one device.  The JAX package compiles forward, loss,
backward and the update into one XLA program over a mesh; the port runs
the same step eagerly on torch: value and gradient of
``lm_loss(apply(...))`` (attention through the Hopper forward and
backward kernels on the card, ``parallel.attention.FlashAttention``),
then ONE fused SGD-momentum update per dtype group
(``optimizer.fused_sgd_mom_grouped``), the JAX package's replicated
stage-0 step.  Same parameter names, same update, same checkpoint
layout (the momenta blob in ``optimizer_states``, the bucket plan's
``n_buckets`` / ``bucket_elems``), so a checkpoint of either package
resumes in the other.

``fit`` rides the robustness stack: checkpoints every N steps
(``checkpoint.CheckpointManager``), exact resume (the iterator
fast-forwards with ``skip_batches``; a resumed run equals the
uninterrupted one bit for bit), the loss-spike divergence guard, the
heartbeat, the tokens/s gauge and the chaos ``kill`` / delay hooks.

Not ported (raise with the ROADMAP item): a mesh of more than one
device, sequence parallelism (ring / Ulysses), ZeRO-1 sharded momenta
and restaging a checkpoint across dp sizes (A6); the SDC fingerprint
vote, ``bitflip_param`` chaos and tuned bucket plans (A11).  ZeRO stage
1 on one device warns and stays replicated, as in the JAX package.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import env as _env
from .._device import resolve_device
from ..remat import remat_policy
from . import model as _model
from .model import TransformerConfig

__all__ = ["TransformerTrainStep"]

_log = logging.getLogger(__name__)


def _to_device_tensor(x, device) -> torch.Tensor:
    """A checkpoint value (numpy array, or a bf16 torch tensor from the
    port's unpickler) as a tensor on ``device`` in its own dtype."""
    from ..convert import _to_tensor

    t = x if isinstance(x, torch.Tensor) else _to_tensor(np.asarray(x))
    return t.to(device)


class TransformerTrainStep:
    """One train step over a ``TransformerConfig``, on one device.

    Parameters
    ----------
    cfg : TransformerConfig (``dtype`` is the compute dtype; parameters
        are stored in ``param_dtype``).
    mesh : None or a one-device mesh; more devices raise (ROADMAP A6).
    learning_rate, momentum, weight_decay : the SGD-momentum update.
    attn_impl / remat / zero_stage : explicit overrides for
        ``MXNET_ATTENTION_IMPL`` / ``MXNET_REMAT_POLICY`` /
        ``MXNET_ZERO_STAGE`` (None = read the env knob at build).
    bucket_bytes : pins the bucket cap the checkpoint's plan records
        (None: ``MXNET_KVSTORE_BUCKET_BYTES``).
    seed : parameters are ``init_params`` from a CPU generator seeded
        with it (other draws than the JAX package's: parity runs carry
        its parameters across with ``load_state({"params": ...})``).
    device : where the step runs; None means ``cuda`` and raises
        without a card (``device="cpu"`` runs the plain versions of the
        kernels).
    """

    def __init__(self, cfg: TransformerConfig, mesh=None,
                 learning_rate: float = 0.01, momentum: float = 0.9,
                 weight_decay: float = 0.0,
                 attn_impl: Optional[str] = None,
                 remat: Optional[str] = None,
                 zero_stage: Optional[int] = None,
                 bucket_bytes: Optional[int] = None, seed: int = 0,
                 device=None):
        from ..parallel.dp import _mesh_size

        if mesh is not None and _mesh_size(mesh) > 1:
            raise ValueError(
                "TransformerTrainStep in mxnet_tpu_torch runs on one "
                "device; a mesh of %d devices (data or sequence "
                "parallelism, ZeRO-1) is not ported yet (ROADMAP A6)"
                % _mesh_size(mesh))
        self.cfg = cfg
        self.device = resolve_device(device)
        self._lr = float(learning_rate)
        self._momentum = float(momentum)
        self._wd = float(weight_decay)
        self._attn_impl = attn_impl
        self._remat = remat
        self._zero_stage = zero_stage
        self._bucket_bytes = bucket_bytes
        self._seed = int(seed)
        self._built = False

    #: data-parallel replicas (one device)
    n_dp = 1

    # -- build ----------------------------------------------------------
    def _build(self):
        from ..parallel import buckets as _buckets
        from ..parallel.dp import zero1_stage

        cfg = self.cfg
        if _env.get_int("MXNET_SDC_CHECK_EVERY_N"):
            raise ValueError(
                "MXNET_SDC_CHECK_EVERY_N: the SDC fingerprint vote is not "
                "ported to mxnet_tpu_torch yet (ROADMAP A11); set it to 0")
        self._impl = _model.attention_impl(self._attn_impl)
        self._policy = remat_policy(self._remat)
        self._attn_fn = _model.make_attn_fn(self._impl)
        gen = torch.Generator().manual_seed(self._seed)
        self._params = _model.init_params(gen, cfg, device=self.device)
        self._names = list(self._params)

        # the gradient bucket plan of the JAX package over the same
        # leaves: on one device it only shapes the checkpoint blob
        entries = [(k, tuple(v.shape), _buckets.dtype_name(v.dtype))
                   for k, v in self._params.items()]
        cap = self._bucket_bytes if self._bucket_bytes is not None \
            else _buckets.bucket_cap_bytes()
        if cap == 0:
            plan = _buckets.partition(entries, 1 << 62)
        else:
            plan, _ = _buckets.plan_with_tuning(entries, self._bucket_bytes)
        self._bucket_plan = plan
        if zero1_stage(self._zero_stage) == 1:
            _log.warning("MXNET_ZERO_STAGE=1 needs a multi-device dp axis "
                         "— momenta stay replicated")
        meta = _buckets.plan_meta(plan, cap if cap else None)
        meta["workload"] = "transformer_lm"
        meta["zero_stage"] = 0
        self._plan_meta = meta
        self._moms = {k: torch.zeros_like(v)
                      for k, v in self._params.items()}
        self._built = True

    # -- introspection --------------------------------------------------
    @property
    def zero1(self) -> bool:
        """Always False: sharded momenta need a multi-device dp axis."""
        return False

    @property
    def attention_impl(self) -> str:
        if not self._built:
            self._build()
        return self._impl

    def bucket_plan_meta(self):
        if not self._built:
            self._build()
        return self._plan_meta

    def optimizer_state_bytes_per_rank(self) -> Optional[int]:
        """Momenta bytes resident on the device, from the live tensors
        (None before the first build)."""
        if not self._built:
            return None
        from ..parallel.dp import momenta_bytes_per_device

        return momenta_bytes_per_device(self._moms)

    def params_numpy(self) -> Dict:
        """Host copies of the parameters (bf16 as float32, exact)."""
        from ..convert import params_to_numpy

        if not self._built:
            self._build()
        return params_to_numpy(self._params)

    # -- stepping -------------------------------------------------------
    def _put(self, x) -> torch.Tensor:
        from ..ndarray import NDArray

        if isinstance(x, NDArray):
            x = x._data
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return t.to(device=self.device, dtype=torch.long)

    def _step(self, tokens: torch.Tensor, labels: torch.Tensor):
        names = self._names
        params = {k: v.detach().requires_grad_(True)
                  for k, v in self._params.items()}
        logits = _model.apply(params, tokens, self.cfg,
                              attn_fn=self._attn_fn, remat=self._policy)
        loss = _model.lm_loss(logits, labels)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        from .. import optimizer as _opt

        with torch.no_grad():
            # ONE multi-tensor update per dtype group, as the JAX
            # package's replicated step
            new_p, new_m = _opt.fused_sgd_mom_grouped(
                names, self._params, dict(zip(names, grads)), self._moms,
                self._lr, self._momentum, self._wd)
        self._params, self._moms = new_p, new_m
        return loss.detach()

    def step(self, tokens, labels):
        """One optimizer step on a (B, T) batch; returns the scalar loss
        as a tensor on the device (not synchronised)."""
        if not self._built:
            self._build()
        return self._step(self._put(tokens), self._put(labels))

    def run_steps(self, tokens, labels, steps: int):
        """``steps`` optimizer steps on the same batch; returns the
        per-step losses (K,) on the device."""
        if not self._built:
            self._build()
        tokens, labels = self._put(tokens), self._put(labels)
        return torch.stack([self._step(tokens, labels)
                            for _ in range(int(steps))])

    # -- checkpoint state ----------------------------------------------
    def optimizer_states_bytes(self) -> bytes:
        """The momenta as the JAX package's pickled blob for a
        checkpoint's ``optimizer_states`` slot (bf16 momenta pickle as
        its bf16 arrays)."""
        from .. import checkpoint as _ckpt
        from ..parallel.dp import zero1_bucket_elems

        if not self._built:
            self._build()
        return _ckpt._dumps_payload({
            "workload": "transformer_lm",
            "zero_stage": 0,
            "dp": self.n_dp,
            "n_buckets": len(self._bucket_plan),
            "bucket_elems": zero1_bucket_elems(self._bucket_plan),
            "momenta": {k: v.detach().cpu()
                        for k, v in self._moms.items()},
        })

    def load_state(self, payload: dict) -> None:
        """Restore parameters (and momenta, when the payload carries
        them) from a checkpoint payload (``checkpoint.load_checkpoint``'s
        dict, or ``{"params": {name: array}}``), each in its own dtype."""
        from .. import checkpoint as _ckpt

        if not self._built:
            self._build()
        params = payload.get("params") or {}
        missing = [k for k in self._names if k not in params]
        if missing:
            raise KeyError("checkpoint payload is missing transformer "
                           "params: %s" % missing[:4])
        self._params = {k: _to_device_tensor(params[k], self.device)
                        for k in self._names}
        blob = payload.get("optimizer_states")
        if not blob:
            return
        state = _ckpt._loads_payload(blob) if isinstance(blob, bytes) \
            else blob
        self._restore_momenta(state)

    def _restore_momenta(self, state: dict) -> None:
        """Momenta from a checkpoint state blob: the stage-0, same-dp
        case (the bitwise exact-resume path).  A ZeRO-1 blob or one
        written at another dp size needs the elastic restage of the
        multi-device tier (ROADMAP A6) and raises."""
        saved_stage = int(state.get("zero_stage", 0))
        saved_dp = state.get("dp")
        if saved_stage != 0 or (saved_dp is not None
                                and int(saved_dp) != self.n_dp):
            raise ValueError(
                "checkpoint momenta were written at ZeRO stage %d, dp=%s; "
                "this one-device step resumes stage 0 at dp=1 only — the "
                "elastic ZeRO-1 restage is not ported yet (ROADMAP A6)"
                % (saved_stage, saved_dp))
        moms = state["momenta"]
        missing = [k for k in self._names if k not in moms]
        if missing:
            raise KeyError("checkpoint momenta missing params: %s"
                           % missing[:4])
        self._moms = {k: _to_device_tensor(moms[k], self.device)
                      for k in self._names}

    def _replay_spec(self, train_iter) -> dict:
        """What re-creates this run's steps: config, hyperparameters
        (the resolved attention and remat choices) and the data
        source's spec, in the JAX package's checkpoint format."""
        spec_fn = getattr(train_iter, "replay_spec", None)
        return {
            "cfg": dict(self.cfg._asdict()),
            "hyper": {
                "learning_rate": self._lr,
                "momentum": self._momentum,
                "weight_decay": self._wd,
                "seed": self._seed,
                "attn_impl": self._impl,
                "remat": self._policy,
                "bucket_bytes": self._bucket_bytes,
            },
            "data": spec_fn() if spec_fn is not None
            else {"kind": "unknown"},
        }

    # -- fit loop -------------------------------------------------------
    def fit(self, train_iter, num_steps: int,
            checkpoint_every_n: Optional[int] = None,
            checkpoint_dir: Optional[str] = None,
            resume_from: Optional[str] = None,
            log_every: int = 0) -> List[float]:
        """Train up to step ``num_steps`` on batches of ``train_iter``
        (any DataIter yielding (tokens, next_tokens) int batches; wraps
        around epoch ends).  Checkpoints every N steps, resumes exactly
        from ``resume_from`` (same world and bucket plan: bit for bit),
        and runs the divergence guard, heartbeat and chaos kill/delay
        hooks.  Returns the per-step losses (floats)."""
        from .. import chaos as _chaos
        from .. import checkpoint as _ckpt
        from .. import diagnostics as _diag

        if not self._built:
            self._build()
        every = checkpoint_every_n if checkpoint_every_n is not None \
            else _env.get_int("MXNET_CKPT_EVERY_N")
        ckpt_dir = checkpoint_dir or _env.get_str("MXNET_CKPT_DIR")
        mgr = None
        if every and ckpt_dir:
            mgr = _ckpt.CheckpointManager(ckpt_dir)
        start = 0
        if resume_from:
            payload = _ckpt.load_checkpoint(resume_from)
            self.load_state(payload)
            start = int(payload["step"])
            train_iter.reset()
            skip = int((payload.get("iterator") or {})
                       .get("nbatch", start))
            if hasattr(train_iter, "skip_batches"):
                train_iter.skip_batches(skip)
            else:
                for _ in range(skip):
                    if not train_iter.iter_next():
                        train_iter.reset()
                        train_iter.iter_next()
        chaos_on = _chaos.enabled()
        guard = _diag.DivergenceGuard()
        tps = _diag.tokens_per_second_gauge()
        losses: List[float] = []
        t_last = time.monotonic()
        for step_i in range(start, int(num_steps)):
            batch = self._next_batch(train_iter)
            tokens, labels = batch.data[0], batch.label[0]
            if chaos_on:
                _chaos.maybe_delay("transformer_step", step=step_i)
            # float() waits for the step: the clock below reads device
            # time, not the enqueue
            loss = float(self.step(tokens, labels))
            if chaos_on:
                # mid-run preemption that didn't say goodbye
                _chaos.should_kill(step_i + 1)
            if guard.enabled and guard.check(loss, step=step_i + 1):
                guard.trip(step_i + 1)
            _diag.touch_heartbeat()
            now = time.monotonic()
            n_tok = int(tokens.shape[0]) * int(tokens.shape[1])
            if now > t_last:
                tps.set(n_tok / (now - t_last))
            t_last = now
            losses.append(loss)
            if log_every and (step_i + 1) % log_every == 0:
                _log.info("transformer step %d loss %.5f", step_i + 1, loss)
            if mgr is not None and (step_i + 1) % every == 0:
                mgr.save(step_i + 1, params=self._params,
                         optimizer_states=self.optimizer_states_bytes(),
                         nbatch=step_i + 1,
                         iterator_state={
                             "nbatch": step_i + 1,
                             "cursor": getattr(train_iter, "cursor", None),
                             "batch_size": getattr(train_iter,
                                                   "batch_size", None)},
                         extra={"workload": "transformer_lm",
                                "replay": self._replay_spec(train_iter)})
        return losses

    @staticmethod
    def _next_batch(train_iter):
        try:
            return train_iter.next()
        except StopIteration:
            train_iter.reset()
            return train_iter.next()
