"""Transformer-LM training: the train step and a checkpointed fit loop,
on one device, data-parallel over a dp mesh, or sequence-parallel over
a dp x sp mesh.

Counterpart: ``mxnet_tpu/transformer/train.py`` ``TransformerTrainStep``
(:46-757).  The JAX package compiles forward, loss, backward, the
gradient exchange and the update into one XLA program over a mesh; the
port runs the same step eagerly on torch, one process per device
(``mxnet_tpu_torch.dist``): value and gradient of
``lm_loss(apply(...))`` (attention through the Hopper forward and
backward kernels on the card, ``parallel.attention.FlashAttention``),
then either

  * replicated (ZeRO stage 0): each bucket of the JAX package's plan
    all-reduced from the backward pass (``parallel.buckets``), scaled by
    ``1/dp``, and ONE fused SGD-momentum update per dtype group
    (``optimizer.fused_sgd_mom_grouped``), or
  * ZeRO-1 (``MXNET_ZERO_STAGE=1`` on a dp mesh of more than one rank):
    per bucket a reduce-scatter, the fused update of this rank's shard
    of the momenta, and an all-gather of the parameters
    (``parallel.dp.zero1_bucketed_update``): each rank holds 1/dp of the
    momenta.

Every rank receives the GLOBAL batch and trains on its block of it:
its rows at its ``dp`` index and, on an ``sp`` axis, its slice of the
sequence at its ``sp`` index (``P("dp", "sp")``), at positions offset by
``sp_index * T/sp``; the attention (``MXNET_ATTENTION_IMPL=ring`` or
``ulysses``) runs over the sp axis on the flash kernels
(``parallel.ring_attention``, ``parallel.sequence``).  The loss is the
mean over every rank (each holds the same token count), and each
gradient bucket is summed over the whole mesh, then scaled by
``1/(dp*sp)``: an all-reduce over sp, then an all-reduce over dp
(replicated) or a reduce-scatter over dp (ZeRO-1: the momenta shard over
dp).  Same
parameter names, same update, same checkpoint layout (the momenta blob
in ``optimizer_states`` with ``zero_stage``, ``dp``, ``n_buckets`` and
``bucket_elems``; ZeRO-1 momenta as the global flat buffers), so a
checkpoint of either package resumes in the other, and a ZeRO-1
checkpoint restages across dp sizes and stages.

Each ``step`` / ``run_steps`` is a ``traceview.step_window``, its
forward, backward and update under the ``mxnet-fwd`` / ``mxnet-bwd`` /
``mxnet-opt`` trace scopes (and each bucket's collective under its
``mxbkt`` scope), so an ``MXNET_TRACE_DIR`` capture attributes its
device time by phase.

``fit`` rides the robustness stack: checkpoints every N steps
(``checkpoint.CheckpointManager``: every rank writes its shard, on the
asynchronous writer unless ``MXNET_CKPT_ASYNC=0``; the fit's end waits
for it), exact
resume (the iterator fast-forwards with ``skip_batches``; a resumed run
equals the uninterrupted one bit for bit at the same world size; across
world sizes the skip is ``checkpoint.scale_resume_skip``'s), the
loss-spike divergence guard, the heartbeat, the tokens/s gauge and the
chaos ``kill`` / delay hooks.

Not ported (raise with the ROADMAP item): the SDC fingerprint vote and
``bitflip_param`` chaos (A11b).  Tuned bucket plans
(``MXNET_AUTOTUNE_PLAN`` / ``_DIR``) apply at the build.  ZeRO stage 1 on
one device warns and stays replicated, as in the JAX package.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import env as _env
from .. import traceview as _traceview
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
    """One train step over a ``TransformerConfig``, on one device or over
    a dp mesh (one process per device).

    Parameters
    ----------
    cfg : TransformerConfig (``dtype`` is the compute dtype; parameters
        are stored in ``param_dtype``).
    mesh : None (one device) or a ``parallel.mesh`` mesh with a ``dp``
        axis and optionally an ``sp`` axis (sequence parallelism: the
        attention impl must be ``ring`` or ``ulysses`` there).
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
        from ..parallel.dp import as_mesh

        self.mesh = as_mesh(mesh, "TransformerTrainStep", exc=ValueError,
                            axes=("dp", "sp"))
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

    @property
    def n_dp(self) -> int:
        """Data-parallel replicas (the mesh's dp axis)."""
        return self.mesh.axis_size("dp") if self.mesh is not None else 1

    @property
    def n_sp(self) -> int:
        """Sequence-parallel ranks of a replica (the mesh's sp axis)."""
        return self.mesh.axis_size("sp") if self.mesh is not None else 1

    @property
    def _n_total(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    # -- build ----------------------------------------------------------
    def _build(self):
        from ..parallel import buckets as _buckets
        from ..parallel.dp import (replicate, zero1_momentum_buffers,
                                   zero1_stage)

        cfg = self.cfg
        if _env.get_int("MXNET_SDC_CHECK_EVERY_N"):
            raise ValueError(
                "MXNET_SDC_CHECK_EVERY_N: the SDC fingerprint vote is not "
                "ported to mxnet_tpu_torch yet (ROADMAP A11); set it to 0")
        self._impl = _model.attention_impl(self._attn_impl)
        self._policy = remat_policy(self._remat)
        n_sp = self.n_sp
        self._sp_axis = "sp" if n_sp > 1 else None
        self._attn_fn = _model.make_attn_fn(self._impl, self._sp_axis,
                                            mesh=self.mesh)
        if self._sp_axis and self._impl == "ulysses" and cfg.n_heads % n_sp:
            raise ValueError(
                "ulysses attention shards heads over sp: n_heads %d must "
                "divide by sp axis size %d" % (cfg.n_heads, n_sp))
        gen = torch.Generator().manual_seed(self._seed)
        self._params = _model.init_params(gen, cfg, device=self.device)
        self._names = list(self._params)
        for v in self._params.values():
            replicate(v, self.mesh)

        # the gradient bucket plan of the JAX package over the same
        # leaves (on one device it only shapes the checkpoint blob)
        entries = [(k, tuple(v.shape), _buckets.dtype_name(v.dtype))
                   for k, v in self._params.items()]
        cap = self._bucket_bytes if self._bucket_bytes is not None \
            else _buckets.bucket_cap_bytes()
        tuning = None
        if cap == 0:
            plan = _buckets.partition(entries, 1 << 62)
        else:
            plan, tuning = _buckets.plan_with_tuning(entries,
                                                     self._bucket_bytes)
            if tuning is not None:
                cap = tuning["cap_bytes"]
        self._bucket_plan = plan
        self._bucket_tuning = tuning
        stage = zero1_stage(self._zero_stage)
        self._zero1 = stage == 1 and self.mesh is not None
        if stage == 1 and not self._zero1:
            _log.warning("MXNET_ZERO_STAGE=1 needs a multi-device dp axis "
                         "— momenta stay replicated")
        meta = _buckets.plan_meta(plan, cap if cap else None,
                                  tuning=tuning)
        meta["workload"] = "transformer_lm"
        meta["zero_stage"] = 1 if self._zero1 else 0
        self._plan_meta = meta
        if self.mesh is not None:
            from .. import diagnostics as _diag

            _diag.set_bucket_plan(meta, owner=id(self))
        if self._zero1:
            self._moms = zero1_momentum_buffers(plan, self.n_dp,
                                                self.device)
        else:
            self._moms = {k: torch.zeros_like(v)
                          for k, v in self._params.items()}
        # every bucket summed over the whole mesh: over sp first (the
        # partial gradients of one replica), then all-reduced over dp,
        # or reduce-scattered under ZeRO-1 (the same sums in the same
        # order, so the two agree bit for bit)
        # recompile tracking and the auditor's work list, under the JAX
        # package's site names
        from .. import diagnostics as _diag
        from ..parallel.buckets import dtype_name

        self._site_meta = {"compute_dtype": dtype_name(cfg.dtype),
                           "bucket_plan": meta,
                           "remat_policy": self._policy,
                           "n_ranks": self._n_total}
        self._step_call = _diag.instrument_jit(
            "TransformerTrainStep.step", self._step, meta=self._site_meta)
        self._same_calls: Dict[int, object] = {}
        self._reducer = None if self.mesh is None else \
            _buckets.OverlappedReduce(plan, self.mesh, scatter=self._zero1,
                                      axis="dp", pre_axis=self._sp_axis)
        self._built = True

    # -- introspection --------------------------------------------------
    @property
    def zero1(self) -> bool:
        """True once built with ZeRO-1 sharded momenta (a dp mesh of more
        than one rank)."""
        return self._built and self._zero1

    @property
    def attention_impl(self) -> str:
        if not self._built:
            self._build()
        return self._impl

    def bucket_plan_meta(self):
        if not self._built:
            self._build()
        return self._plan_meta

    def bucket_tuning(self):
        """The autotune meta the bucket plan was built under (None under
        the env default)."""
        if not self._built:
            self._build()
        return self._bucket_tuning

    def optimizer_state_bytes_per_rank(self) -> Optional[int]:
        """Momenta bytes resident on this rank's device, from the live
        tensors (ZeRO-1: ~1/dp of replicated; None before the build)."""
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
        from .. import optimizer as _opt
        from ..parallel.dp import shard_batch

        names, mesh, sp = self._names, self.mesh, self._sp_axis
        tokens = shard_batch(tokens, mesh, seq_axis=sp)
        labels = shard_batch(labels, mesh, seq_axis=sp)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in self._params.items()}
        if mesh is not None:
            offset = mesh.axis_index(sp) * int(tokens.shape[1]) if sp \
                else 0
            # each bucket's collective is issued from backward
            self._reducer.arm(params)
            try:
                with _traceview.annotation("mxnet-fwd"):
                    loss = _model.lm_loss(_model.apply(
                        params, tokens, self.cfg, attn_fn=self._attn_fn,
                        pos_offset=offset, remat=self._policy), labels)
                with _traceview.annotation("mxnet-bwd"):
                    loss.backward()
                    flats = self._reducer.finish()
            finally:
                self._reducer.disarm()
            with torch.no_grad(), _traceview.annotation("mxnet-opt"):
                return self._dp_update(params, flats, loss)
        with _traceview.annotation("mxnet-fwd"):
            logits = _model.apply(params, tokens, self.cfg,
                                  attn_fn=self._attn_fn,
                                  remat=self._policy)
            loss = _model.lm_loss(logits, labels)
        with _traceview.annotation("mxnet-bwd"):
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        with torch.no_grad(), _traceview.annotation("mxnet-opt"):
            # ONE multi-tensor update per dtype group, as the JAX
            # package's replicated step
            new_p, new_m = _opt.fused_sgd_mom_grouped(
                names, self._params, dict(zip(names, grads)), self._moms,
                self._lr, self._momentum, self._wd)
        self._params, self._moms = new_p, new_m
        return loss.detach()

    def _dp_update(self, params, flats, loss):
        """The update from the reduced bucket flats (sums over every rank
        of the mesh), scaled by ``1/(dp*sp)``; returns the loss averaged
        over every rank (the reference's pmean over dp and sp)."""
        import torch.distributed as dist

        from .. import optimizer as _opt
        from ..parallel import buckets as _buckets
        from ..parallel.dp import zero1_bucketed_update

        n, mesh = self._n_total, self.mesh
        live = {k: v.detach() for k, v in params.items()}
        if self._zero1:
            new_p, self._moms = zero1_bucketed_update(
                None, live, self._moms, self._bucket_plan, mesh,
                lr=self._lr, momentum=self._momentum, wd=self._wd,
                mean_n=n, scattered=flats)
            self._params = {k: new_p[k] for k in self._names}
        else:
            grads = {}
            for b, flat in zip(self._bucket_plan, flats):
                grads.update(_buckets.unpack(_buckets.scale_(flat, n),
                                             b.keys, live))
            self._params, self._moms = _opt.fused_sgd_mom_grouped(
                self._names, live, grads, self._moms, self._lr,
                self._momentum, self._wd)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=mesh.group)
        return loss / n

    def step(self, tokens, labels):
        """One optimizer step on a global (B, T) batch (on a mesh, this
        rank trains on its block); returns the scalar loss (averaged over
        ranks) as a tensor on the device, not synchronised."""
        if not self._built:
            self._build()
        tokens, labels = self._put(tokens), self._put(labels)
        with _traceview.step_window("TransformerTrainStep",
                                    device=self.device) as tvw:
            loss = self._step_call(tokens, labels)
            if tvw is not None:
                tvw.block()
        self._stamp_telemetry()
        return loss

    def run_steps(self, tokens, labels, steps: int):
        """``steps`` optimizer steps on the same batch; returns the
        per-step losses (K,) on the device."""
        if not self._built:
            self._build()
        tokens, labels = self._put(tokens), self._put(labels)
        k = int(steps)
        run = self._same_calls.get(k)
        if run is None:
            from .. import diagnostics as _diag

            # k in the name: each K is its own site
            run = self._same_calls[k] = _diag.instrument_jit(
                "TransformerTrainStep.multi_step_same[k=%d]" % k,
                self._run_same, meta=self._site_meta)
        with _traceview.step_window("TransformerTrainStep", k=k,
                                    device=self.device) as tvw:
            losses = run(tokens, labels, k)
            if tvw is not None:
                tvw.block()
        return torch.stack(losses)

    def _run_same(self, tokens, labels, k: int) -> List[torch.Tensor]:
        """``k`` steps of one batch; the losses."""
        losses = []
        for _ in range(int(k)):
            losses.append(self._step(tokens, labels))
            self._stamp_telemetry()
        return losses

    def audit_state(self) -> Dict[str, torch.Tensor]:
        """The parameter and momentum tensors a step updates (the
        auditor's donation check compares their storage across one)."""
        out = {"param:" + k: v for k, v in self._params.items()}
        moms = self._moms.items() if isinstance(self._moms, dict) \
            else enumerate(self._moms)
        out.update(("momentum:%s" % k, v) for k, v in moms)
        return out

    def _stamp_telemetry(self) -> None:
        if self.mesh is not None:
            from ..parallel import buckets as _buckets

            _buckets.stamp_profiler(self._bucket_plan,
                                    store_type="transformer")

    # -- checkpoint state ----------------------------------------------
    def optimizer_states_bytes(self) -> bytes:
        """The momenta as the JAX package's pickled blob for a
        checkpoint's ``optimizer_states`` slot (bf16 momenta pickle as
        its bf16 arrays).  ZeRO-1 momenta are all-gathered into the
        global flat buffers (a collective: every rank calls it)."""
        from .. import checkpoint as _ckpt
        from ..parallel.dp import zero1_bucket_elems

        if not self._built:
            self._build()
        if self._zero1:
            import torch.distributed as dist

            moms = []
            for m in self._moms:
                full = m.new_empty(m.numel() * self.n_dp)
                dist.all_gather_into_tensor(full, m.contiguous(),
                                            group=self.mesh.axis_group("dp"))
                moms.append(full.cpu())
        else:
            moms = {k: v.detach().cpu() for k, v in self._moms.items()}
        return _ckpt._dumps_payload({
            "workload": "transformer_lm",
            "zero_stage": 1 if self._zero1 else 0,
            "dp": self.n_dp,
            "n_buckets": len(self._bucket_plan),
            "bucket_elems": zero1_bucket_elems(self._bucket_plan),
            "momenta": moms,
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
        """Momenta from a checkpoint state blob, ELASTICALLY (ref
        ``_restore_momenta`` :535-600): a stage-1 checkpoint written at
        one dp resumes at any other — the global flat buffers are
        re-sliced by the (identical) bucket layout and re-padded for
        this dp, and this rank keeps its shard; stage 1 → a replicated
        step unpacks the flats into the per-parameter dict, and a
        replicated checkpoint → ZeRO-1 packs the dict into flats.  Same
        stage and dp is the bitwise exact-resume path (the restage is
        the identity there).  A bucket-LAYOUT mismatch raises: restage
        re-slices, it cannot re-bucket."""
        from ..parallel.dp import (zero1_bucket_elems, zero1_flats_to_tree,
                                   zero1_restage_flats, zero1_tree_to_flats)

        saved_stage = int(state.get("zero_stage", 0))
        saved_dp = state.get("dp")
        moms = state["momenta"]
        plan = self._bucket_plan
        if saved_stage == 1:
            if len(moms) != len(plan):
                raise ValueError(
                    "checkpoint has %d momentum buckets, this plan has %d "
                    "— bucket caps changed between runs; pin bucket_bytes "
                    "to resume" % (len(moms), len(plan)))
            saved_elems = state.get("bucket_elems")
            if saved_elems is not None and \
                    list(saved_elems) != zero1_bucket_elems(plan):
                raise ValueError(
                    "checkpoint bucket layout %s != this plan's %s — "
                    "elastic restage re-slices identical bucket plans "
                    "only; pin bucket_bytes to resume"
                    % (list(saved_elems), zero1_bucket_elems(plan)))
        else:
            missing = [k for k in self._names if k not in moms]
            if missing:
                raise KeyError("checkpoint momenta missing params: %s"
                               % missing[:4])
        if saved_stage == 1 and self._zero1:
            flats = zero1_restage_flats(moms, plan, self.n_dp)
        elif saved_stage == 1:
            shapes = {k: tuple(v.shape) for k, v in self._params.items()}
            moms = zero1_flats_to_tree(zero1_restage_flats(moms, plan, 1),
                                       plan, shapes)
        elif self._zero1:
            flats = zero1_tree_to_flats(moms, plan, self.n_dp)
        if self._zero1:
            r = self.mesh.axis_index("dp")
            self._moms = []
            for f in flats:
                shard = f.numel() // self.n_dp
                # a copy: the rank keeps its shard, not the global flat
                self._moms.append(f[r * shard:(r + 1) * shard].clone().to(
                    self.device))
        else:
            self._moms = {k: _to_device_tensor(moms[k], self.device)
                          for k in self._names}
        cur_stage = 1 if self._zero1 else 0
        if saved_stage != cur_stage or (saved_dp is not None
                                        and int(saved_dp) != self.n_dp):
            _log.warning(
                "ZERO-1 ELASTIC RESTAGE: momenta written at stage %d "
                "(dp=%s) re-sliced for stage %d (dp=%d) over the same "
                "%d-bucket layout", saved_stage, saved_dp, cur_stage,
                self.n_dp, len(plan))

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
            _ckpt.restore_rng(payload, resume_from)
            start = int(payload["step"])
            train_iter.reset()
            skip = int((payload.get("iterator") or {})
                       .get("nbatch", start))
            if payload.get("elastic"):
                # written by another world size: the GLOBAL sample
                # position is the invariant, re-divided by this fleet's
                # per-rank batch x world size
                skip = _ckpt.scale_resume_skip(
                    payload, self._rank_batch(train_iter))
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
                             # the rows this rank trains on: with the
                             # world size, the global sample position
                             "batch_size": self._rank_batch(train_iter)},
                         extra={"workload": "transformer_lm",
                                "replay": self._replay_spec(train_iter)})
        if mgr is not None:
            mgr.wait()
        return losses

    def _rank_batch(self, train_iter) -> Optional[int]:
        """This rank's share of each global batch, in sequences: the
        iterator's batch over every rank of the mesh (dp x sp), so that
        with the world size it gives the global sample position (None
        where the batch does not divide)."""
        b = getattr(train_iter, "batch_size", None)
        if b is None or int(b) % self._n_total:
            return None
        return int(b) // self._n_total

    @staticmethod
    def _next_batch(train_iter):
        try:
            return train_iter.next()
        except StopIteration:
            train_iter.reset()
            return train_iter.next()
