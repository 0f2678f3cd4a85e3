"""BaseModule — the fit/score/predict harness.

ref: python/mxnet/module/base_module.py (fit at :376, the epoch/batch loop
at :487-496).  Semantics preserved: bind → init_params → init_optimizer →
per batch forward_backward/update/update_metric → callbacks → epoch sync +
optional validation.

Counterpart: ``mxnet_tpu/module/base_module.py``, with its checkpoint
manager, exact resume, chaos ``kill`` / ``nan_grad`` injection and the
per-step divergence guard on the port's ``checkpoint``, ``chaos`` and
``diagnostics``.  Not ported yet, and refused when turned on rather
than ignored: the SDC fingerprint vote (``MXNET_SDC_CHECK_EVERY_N``) and
the ``bitflip_param`` / ``bitflip_grad`` chaos kinds (ROADMAP A11b).
The periodic checkpoints go through the asynchronous writer
(``MXNET_CKPT_ASYNC``); the SIGTERM preemption hook drains it
(``wait(timeout=60)``) before the exit 83, and the fit's end waits for
it.  While the profiler runs, a bulk fit steps per batch so that every
step gets its ``Backward`` / ``Module::update`` / comms spans.  The
JAX package's per-step training metrics (``record_step``) are not
ported.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Tuple

from .. import metric as _metric
from ..base import MXNetError
from ..callback import BatchEndParam
from ..initializer import Uniform

__all__ = ["BaseModule"]


def _as_metric(m):
    return m if isinstance(m, _metric.EvalMetric) else _metric.create(m)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ------------------------------------------------------------------
    # abstract surface (ref: base_module.py)
    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # concrete methods
    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        """ref: base_module.py:189."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """ref: base_module.py score."""
        assert self.binded and self.params_initialized
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric, locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
        if score_end_callback is not None:
            param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                  eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(param)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """ref: base_module.py predict."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [
                out[0 : out.shape[0] - pad] for out in self.get_outputs()
            ]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            from ..ndarray import concatenate

            merged = [
                concatenate([out[i] for out in output_list], axis=0)
                for i in range(num_outputs)
            ]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0 : out.shape[0] - pad] for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None,
            checkpoint_every_n=None, checkpoint_dir=None,
            resume_from=None):
        """The training loop (ref: base_module.py:376 fit).

        Fault tolerance (mxnet_tpu/checkpoint.py):

        * ``checkpoint_every_n`` / ``checkpoint_dir`` — save an atomic
          per-rank checkpoint shard (params, optimizer/momenta, RNG,
          epoch/step, iterator position) every N optimizer steps
          (defaults: ``MXNET_CKPT_EVERY_N`` / ``MXNET_CKPT_DIR``);
          writes are asynchronous (``MXNET_CKPT_ASYNC``) so the host
          serialization overlaps the compiled step.
        * ``resume_from`` — a checkpoint directory (or True, meaning
          ``checkpoint_dir``): loads the newest COMPLETE step and
          resumes exactly: params + momenta + RNG restored, the data
          iterator fast-forwarded, step counting continued — a resumed
          run bitwise-matches an uninterrupted control on the CPU mesh
          for deterministic iterators.  Multi-worker resume: create the
          dist kvstore FIRST and pass the instance, so the rank/fleet
          size are known when the shard is selected.
        * while fitting, a preemption hook is registered
          (diagnostics.register_preemption_hook): SIGTERM — and the
          watchdog's MXNET_COLLECTIVE_ABORT_S escalation — dump the
          flight ring, drain collectives, checkpoint the last completed
          step best-effort, and exit with the documented code
          (83 / 85) so the run restarts from where it died.
        """
        assert num_epoch is not None, "please specify number of epochs"

        from .. import chaos as _chaos
        from .. import checkpoint as _ckpt
        from .. import env as _env
        from ..context import cpu
        from ..ndarray import array as _nd_array

        _refuse_a11(_chaos, _env)

        every_n = checkpoint_every_n if checkpoint_every_n is not None \
            else _env.get_int("MXNET_CKPT_EVERY_N")
        ckpt_dir = checkpoint_dir or _env.get_str("MXNET_CKPT_DIR")
        if resume_from is True:
            resume_from = ckpt_dir
        if resume_from and not ckpt_dir:
            # resume_from may name a specific step_NNNNNNNN dir (the
            # explicit fail-fast spelling) — new checkpoints go to its
            # PARENT, never nested inside the step
            ckpt_dir = _ckpt._split_step_dir(resume_from)[0]
        resume_payload = None
        resume_skip = 0
        global_step = 0
        if resume_from:
            resume_payload = _ckpt.load_checkpoint(resume_from)
            # host copies; init_params copies them into the device cells
            arg_params = {k: _nd_array(v, ctx=cpu()) for k, v in
                          resume_payload["params"].items()}
            aux_params = {k: _nd_array(v, ctx=cpu()) for k, v in
                          resume_payload["aux_params"].items()}
            force_init = True
            begin_epoch = int(resume_payload["epoch"])
            resume_skip = int(resume_payload["nbatch"])
            global_step = int(resume_payload["step"])
            self.logger.info(
                "resuming from checkpoint step %d (%s): epoch %d, "
                "batch %d", global_step, resume_from, begin_epoch,
                resume_skip)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if resume_payload is not None:
            # optimizer/momenta AFTER init_optimizer installed the fresh
            # updater; RNG last, so nothing below draws from the
            # pre-restore state (a JAX shard's key warns: the stream
            # restarts)
            if hasattr(self, "restore_checkpoint_state"):
                self.restore_checkpoint_state(
                    {"optimizer_states":
                     resume_payload.get("optimizer_states")})
            _ckpt.restore_rng(resume_payload, resume_from)

        manager = None
        if every_n and every_n > 0:
            if not ckpt_dir:
                raise ValueError(
                    "checkpoint_every_n=%d needs checkpoint_dir (or "
                    "MXNET_CKPT_DIR/resume_from)" % every_n)
            if hasattr(self, "get_checkpoint_state"):
                manager = _ckpt.CheckpointManager(ckpt_dir)
            else:
                self.logger.warning(
                    "%s has no get_checkpoint_state — "
                    "checkpoint_every_n ignored", type(self).__name__)

        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _as_metric(eval_metric)

        # bulk fit: an explicit engine.set_bulk_size(K) groups K batches
        # into one host-sync-free run when the module supports it
        # (Module does; a monitor forces per-batch so its taps see every
        # step, and a running profiler does too: the telemetry layer
        # needs per-step Forward/Backward/update/comms spans).  ref: the
        # engine's bulk segments, MXNET_EXEC_BULK_EXEC_TRAIN
        # (threaded_engine.h:386-458) — here the segment is K whole
        # steps.
        from .. import diagnostics as _diag
        from .. import engine as _engine
        from .. import profiler as _profiler

        # chaos injection (kill/nan_grad at an exact global step) needs
        # per-batch stepping: a K-step group has no mid-group injection
        # point
        chaos_on = _chaos.enabled()
        per_batch = monitor is not None or _profiler.is_running() \
            or chaos_on
        bulk_k = 1 if per_batch else max(1, _engine.fit_bulk_size())
        can_bulk = bulk_k > 1 and hasattr(self, "_bulk_fit_steps")

        # live progress for the checkpoint layer: the periodic saves,
        # and the SIGTERM/watchdog preemption hook, both label their
        # shard with the LAST COMPLETED optimizer step
        progress = {"step": global_step, "epoch": begin_epoch,
                    "nbatch": resume_skip}

        def _save_checkpoint(blocking=None) -> None:
            # blocking=None lets MXNET_CKPT_ASYNC decide (the periodic
            # saves); the preemption hook forces True — it runs last
            st = self.get_checkpoint_state()
            manager.save(progress["step"],
                         params=st["arg_params"],
                         aux_params=st["aux_params"],
                         optimizer_states=st["optimizer_states"],
                         epoch=progress["epoch"],
                         nbatch=progress["nbatch"],
                         iterator_state={
                             "cursor": getattr(train_data, "cursor",
                                               None),
                             # recorded so an elastic resume on a
                             # different world size can re-derive the
                             # global sample position exactly
                             "batch_size": getattr(train_data,
                                                   "batch_size", None)},
                         blocking=blocking)

        def _preempt_save() -> None:
            # a preemption landing right after a periodic boundary
            # save must NOT re-write that step's shard: the bytes
            # would differ (iterator position moved) while the step's
            # assembled manifest still records the boundary digests —
            # the resume would then reject the step as corrupt.  The
            # boundary save may still be in flight on the writer
            # thread (last_save is set when the write is queued):
            # wait it out, and skip only once the shard really landed;
            # a write that errored or never finishes falls through to
            # a blocking re-save (the manifest re-assembles its
            # digest).  Either way the writer drains before the exit.
            if progress["step"] == progress.get("last_save", -1):
                try:
                    if manager.wait(timeout=60):
                        return
                except Exception:
                    pass
            _save_checkpoint(blocking=True)
            try:
                manager.wait(timeout=60)
            except Exception:
                pass

        hook_key = None
        if manager is not None:
            hook_key = _diag.register_preemption_hook(
                _preempt_save, key="module_fit_%d" % id(self))

        try:
            self._fit_epochs(
                train_data, eval_data, eval_metric, validation_metric,
                epoch_end_callback, batch_end_callback,
                eval_end_callback, eval_batch_end_callback, monitor,
                begin_epoch, num_epoch, can_bulk, bulk_k, chaos_on,
                progress, resume_skip, manager, every_n,
                _save_checkpoint)
        finally:
            try:
                # the writes land while the preemption hook still
                # covers them
                if manager is not None:
                    manager.wait()
            finally:
                if hook_key is not None:
                    _diag.unregister_preemption_hook(hook_key)

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, epoch_end_callback,
                    batch_end_callback, eval_end_callback,
                    eval_batch_end_callback, monitor, begin_epoch,
                    num_epoch, can_bulk, bulk_k, chaos_on, progress,
                    resume_skip, manager, every_n, _save_checkpoint):
        """The epoch/batch loop body of :meth:`fit` (split out so the
        checkpoint hook registration wraps it in one try/finally)."""
        from .. import chaos as _chaos
        from .. import diagnostics as _diag
        from .. import profiler as _profiler

        progress["last_save"] = progress["step"]

        # divergence guard (MXNET_DIVERGENCE_WINDOW): the conv path
        # feeds the loss-like training metric — same windowed-median
        # threshold, trip counter and exit-84 contract the transformer
        # fit loop already honors.  The metric accumulates an
        # epoch-running MEAN, which would dilute a late-epoch spike
        # into invisibility (batch 900's 10x loss moves the mean by
        # ~1%), so the guard feeds the PER-STEP value recovered from
        # the metric's (sum_metric, num_inst) deltas where available,
        # falling back to the running mean only for metric classes
        # without that surface.
        guard = _diag.DivergenceGuard()
        _metric_prev: Dict[int, Tuple[float, float]] = {}

        def _loss_metric_obj():
            mets = getattr(eval_metric, "metrics", None)
            for m in ([eval_metric] if mets is None else mets):
                name = str(getattr(m, "name", "")).lower()
                if hasattr(m, "sum_metric") and hasattr(m, "num_inst") \
                        and any(t in name for t in
                                ("loss", "entropy", "perplex", "nll")):
                    return m
            return None

        def _maybe_divergence(step: int) -> None:
            if not guard.enabled:
                return
            m = _loss_metric_obj()
            v = None
            if m is not None:
                prev_sum, prev_n = _metric_prev.get(id(m), (0.0, 0.0))
                cur_sum = float(m.sum_metric)
                cur_n = float(m.num_inst)
                if cur_n < prev_n:  # metric reset (epoch boundary)
                    prev_sum, prev_n = 0.0, 0.0
                _metric_prev[id(m)] = (cur_sum, cur_n)
                if cur_n > prev_n:
                    v = (cur_sum - prev_sum) / (cur_n - prev_n)
            if v is None:
                v = _diag.loss_signal(eval_metric.get_name_value())
            if v is not None and guard.check(v, step=step):
                guard.trip(step)

        def _maybe_save() -> None:
            """Save when an every_n boundary was crossed since the last
            save (the bulk path crosses several per group — one shard,
            labeled with the group-end step, covers them)."""
            if manager is None or not every_n:
                return
            if progress["step"] // every_n > \
                    progress["last_save"] // every_n:
                progress["last_save"] = progress["step"]
                _save_checkpoint()

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            progress["epoch"] = epoch
            if resume_skip and epoch == begin_epoch:
                # exact-resume fast-forward: replay the iterator to the
                # checkpointed position (deterministic iterators only —
                # the exact-resume contract requires one).  An
                # io_pipeline InputPipeline skips on the host side
                # (decode-and-drop) so the replayed batches never cross
                # the H2D link.
                skipper = getattr(train_data, "skip_batches", None)
                if skipper is not None:
                    skipper(resume_skip)
                else:
                    for _ in range(resume_skip):
                        try:
                            next(data_iter)
                        except StopIteration:
                            break
                nbatch = resume_skip
            progress["nbatch"] = nbatch
            start_nbatch = nbatch

            if can_bulk:
                pending = []
                end = False
                while not end:
                    batch = None
                    try:
                        batch = next(data_iter)
                    except StopIteration:
                        end = True
                    if batch is not None:
                        pending.append(batch)
                    if not pending or (len(pending) < bulk_k and not end):
                        continue
                    group, pending = pending, []
                    # a profiler started mid-fit (e.g. from a
                    # batch_end_callback skipping warmup) forces this
                    # group per-batch without disabling bulk for good
                    profiling = _profiler.is_running()
                    outs = self._bulk_fit_steps(group) \
                        if can_bulk and not profiling else None
                    if outs is None:
                        if can_bulk and not profiling:
                            can_bulk = False  # permanent fallback
                        for b in group:
                            self.forward_backward(b)
                            self.update()
                            self.update_metric(eval_metric, b.label)
                            _maybe_divergence(progress["step"] + 1)
                            nbatch = self._fit_batch_end(
                                epoch, nbatch, eval_metric,
                                batch_end_callback)
                            progress["step"] += 1
                            progress["nbatch"] = nbatch
                            _maybe_save()
                        continue
                    # the K steps ran back to back: metrics and callbacks
                    # see every batch now, in order
                    for b, outs_b in zip(group, outs):
                        eval_metric.update(b.label, outs_b)
                        nbatch = self._fit_batch_end(
                            epoch, nbatch, eval_metric, batch_end_callback)
                        progress["step"] += 1
                        progress["nbatch"] = nbatch
                    # device state is post-GROUP: save once here so the
                    # shard's step label matches the params it holds —
                    # and the group-end state is what the divergence
                    # guard can judge
                    _maybe_divergence(progress["step"])
                    _maybe_save()
            else:
                end_of_batch = False
                try:
                    next_data_batch = next(data_iter)
                except StopIteration:
                    # a resume landing exactly on an epoch boundary
                    # fast-forwarded through the whole epoch
                    end_of_batch = True
                    data_batch = None
                while not end_of_batch:
                    data_batch = next_data_batch
                    if monitor is not None:
                        monitor.tic()
                    self.forward_backward(data_batch)
                    if chaos_on:
                        # mid-step fault window: backward done, update
                        # not — exactly where a real preemption hurts
                        _chaos.should_kill(progress["step"] + 1)
                        if _chaos.fault("nan_grad",
                                        step=progress["step"] + 1) \
                                is not None and \
                                hasattr(self, "_corrupt_grads_nan"):
                            self._corrupt_grads_nan()
                    self.update()
                    try:
                        next_data_batch = next(data_iter)
                        self.prepare(next_data_batch)
                    except StopIteration:
                        end_of_batch = True
                    self.update_metric(eval_metric, data_batch.label)
                    _maybe_divergence(progress["step"] + 1)
                    if monitor is not None:
                        monitor.toc_print()
                    if batch_end_callback is not None:
                        param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                              eval_metric=eval_metric,
                                              locals=locals())
                        for cb in _as_list(batch_end_callback):
                            cb(param)
                    nbatch += 1
                    progress["step"] += 1
                    progress["nbatch"] = nbatch
                    _maybe_save()

            if resume_skip and epoch == begin_epoch and \
                    nbatch == start_nbatch and start_nbatch > 0:
                # the checkpoint was taken on this epoch's LAST batch —
                # its training completed before the interruption, so
                # the fast-forward consumed the whole iterator and zero
                # steps ran here.  Re-running the epoch tail would fire
                # duplicate epoch-end callbacks and score a freshly
                # reset (empty) metric; skip straight to the next epoch.
                train_data.reset()
                continue

            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)

            arg_params_, aux_params_ = self.get_params()
            self.set_params(arg_params_, aux_params_)

            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params_, aux_params_)

            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)

            train_data.reset()

    # ------------------------------------------------------------------
    def _fit_batch_end(self, epoch, nbatch, eval_metric,
                       batch_end_callback):
        """Fire per-batch callbacks (shared by the bulk and fallback fit
        paths); returns the incremented batch counter."""
        if batch_end_callback is not None:
            param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                  eval_metric=eval_metric, locals=locals())
            for cb in _as_list(batch_end_callback):
                cb(param)
        return nbatch + 1

    def prepare(self, data_batch, sparse_row_id_fn=None):
        pass

    def install_monitor(self, mon):
        raise NotImplementedError

    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        from ..ndarray import save

        save(fname, save_dict)

    def load_params(self, fname):
        from ..ndarray import load

        save_dict = load(fname)
        arg_params, aux_params = {}, {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise MXNetError("invalid param file " + fname)
        self.set_params(arg_params, aux_params)


def _refuse_a11(chaos, env) -> None:
    """The JAX package's fit runs the SDC fingerprint vote and injects
    the bitflip chaos kinds; the port does not yet (ROADMAP A11), and a
    defense or a fault that silently did nothing would read as a clean
    run."""
    if env.get_int("MXNET_SDC_CHECK_EVERY_N"):
        raise MXNetError(
            "MXNET_SDC_CHECK_EVERY_N: the SDC fingerprint vote is not "
            "ported to mxnet_tpu_torch yet (ROADMAP A11); set it to 0")
    kinds = {r.kind for r in chaos.rules()} & {"bitflip_param",
                                               "bitflip_grad"}
    if kinds:
        raise MXNetError(
            "MXNET_CHAOS kind(s) %s: not injected by mxnet_tpu_torch yet "
            "(ROADMAP A11)" % sorted(kinds))


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, (list, tuple)) else [obj]
