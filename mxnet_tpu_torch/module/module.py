"""Module — symbol + executor + optimizer intermediate-level API.

Counterpart: ``mxnet_tpu/module/module.py`` (ref:
python/mxnet/module/module.py, bind/forward/backward/update at
:570-629).  One device: ``Module(context=None)`` takes the current
context, the card (without one the bind raises and names ``mx.cpu()``).
A context list of more than one device, the reference's data-parallel
executor group, runs through ``parallel.dp.DataParallelRunner``: under
a process group of as many ranks (``python -m mxnet_tpu_torch.dist -n
N``), each rank binds its executor to its own device for its rows of
the global batch, with the global batch's BatchNorm moments, loss
normalisations and gradients (summed over the ranks, bucket by bucket)
and outputs; without one the list collapses onto one device with a
warning, as in the JAX package.  ``group2ctxs`` places ctx groups on
their devices (``executor.place_nodes``); with more than one context it
raises, as the reference build does.  Batches arrive as host data
(``io`` iterators build them on ``mx.cpu()``): ``_feed`` casts each to
its argument's dtype and moves it to the module's device.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from .. import optimizer as _opt
from ..base import MXNetError
from ..context import Context, current_context
from ..executor import Executor
from ..initializer import Uniform, InitDesc
from ..io import DataDesc
from ..model import load_checkpoint, save_checkpoint
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        if context is None:
            context = current_context()
        self._context_list = list(context) \
            if isinstance(context, (list, tuple)) else [context]
        self._num_device = len(self._context_list)
        # data-parallel runner (parallel/dp.py) when #ctx > 1
        self._dp = None
        # group2ctxs: dict (one mapping for the module) or list of dicts
        # (reference: one per context; one executor takes the first)
        if isinstance(group2ctxs, (list, tuple)):
            group2ctxs = group2ctxs[0] if group2ctxs else None
        if group2ctxs and self._num_device > 1:
            raise ValueError(
                "group2ctxs model parallelism cannot be combined with "
                "multi-context data parallelism in this build; use "
                "parallel.FusedTrainStep with a dp mesh instead")
        if self._num_device > 1:
            from ..parallel.dp import DataParallelRunner

            self._dp = DataParallelRunner(self._context_list)
            self._ctx = self._dp.context
        else:
            self._ctx = Context(self._context_list[0])
        self._ctx.torch_device()  # no card: raise now, naming mx.cpu()
        self._dp_outputs = None
        arg_name_set = set(symbol.list_arguments())
        self._data_names = list(data_names or [])
        # labels absent from the symbol are dropped, like the reference's
        # _check_input_names(..., throw=False) path (module.py:_check_names)
        self._label_names = [n for n in (label_names or []) if n in arg_name_set]
        if label_names and not self._label_names:
            # fall back to any *_label argument so default-named iterators
            # keep working with custom-named loss layers
            self._label_names = [n for n in symbol.list_arguments()
                                 if n.endswith("_label")]
        self._fixed_param_names = list(fixed_param_names or [])
        self._group2ctxs = group2ctxs

        arg_names = symbol.list_arguments()
        self._param_names = [
            n for n in arg_names
            if n not in self._data_names and n not in self._label_names
        ]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec: Optional[Executor] = None
        self._optimizer: Optional[_opt.Optimizer] = None
        self._updater: Optional[_opt.Updater] = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._data_shapes = None
        self._label_shapes = None
        self._preloaded_params = None  # set by Module.load
        self._preloaded_states = None
        self._bulk_loop = None  # K-steps-per-dispatch fit path (bulk.py)

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        shapes = {d.name: d.shape for d in self._data_shapes or []}
        shapes.update({d.name: d.shape for d in self._label_shapes or []})
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self.output_names, out_shapes))

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """ref: module.py bind → DataParallelExecutorGroup."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.binded = True

        self._data_shapes = [DataDesc(*d) if not isinstance(d, DataDesc) else d
                             for d in data_shapes]
        self._label_shapes = [DataDesc(*d) if not isinstance(d, DataDesc) else d
                              for d in (label_shapes or [])]

        shapes = {d.name: d.shape for d in self._data_shapes}
        shapes.update({d.name: d.shape for d in self._label_shapes})
        if self._dp is not None:
            # each rank's executor takes its rows of the global batch
            shapes = {k: self._dp.local_shape(v) for k, v in shapes.items()}

        req = grad_req
        if not for_training:
            req = "null"
        elif self._fixed_param_names or not inputs_need_grad:
            req = {}
            for name in self._symbol.list_arguments():
                if name in self._data_names or name in self._label_names:
                    req[name] = "write" if inputs_need_grad and name in self._data_names else "null"
                elif name in self._fixed_param_names:
                    req[name] = "null"
                else:
                    req[name] = grad_req if isinstance(grad_req, str) else grad_req.get(name, "write")

        self._exec = Executor.simple_bind(self._symbol, ctx=self._ctx,
                                          grad_req=req,
                                          group2ctx=self._group2ctxs, **shapes)
        if shared_module is not None and shared_module._exec is not None:
            # share parameter cells with the shared module (bucketing path,
            # ref: graph_executor.cc:1572 shared_exec memory sharing) — the
            # executor reads cells afresh each step, so swapping dict entries
            # is sufficient
            for name, arr in shared_module._exec.arg_dict.items():
                if name in self._exec.arg_dict and arr.shape == self._exec.arg_dict[name].shape:
                    self._exec.arg_dict[name] = arr
                    if shared_module._exec.grad_dict.get(name) is not None:
                        self._exec.grad_dict[name] = shared_module._exec.grad_dict[name]
            for name, arr in shared_module._exec.aux_dict.items():
                if name in self._exec.aux_dict:
                    self._exec.aux_dict[name] = arr

    # ------------------------------------------------------------------
    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """ref: module.py init_params."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before init_params"
        if self._preloaded_params is not None and arg_params is None:
            arg_params, aux_params = self._preloaded_params
            self._preloaded_params = None
        ex = self._exec

        attrs = self._symbol.attr_dict()
        for name in self._param_names:
            arr = ex.arg_dict[name]
            if arg_params is not None and name in arg_params:
                arg_params[name].copyto(arr)
            elif initializer is not None:
                desc = InitDesc(name, attrs.get(name))
                initializer(desc, arr)
            elif not allow_missing:
                raise MXNetError("init_params: %r has no initializer or value" % name)
        for name in self._aux_names:
            arr = ex.aux_dict[name]
            if aux_params is not None and name in aux_params:
                aux_params[name].copyto(arr)
            elif initializer is not None:
                desc = InitDesc(name, attrs.get(name))
                initializer(desc, arr)
        if self._dp is not None:
            self._dp.broadcast([ex.arg_dict[n] for n in self._param_names] +
                               [ex.aux_dict[n] for n in self._aux_names])
        self.params_initialized = True

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux_params = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg_params, aux_params

    # ------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """ref: module.py init_optimizer + model.py:58 _create_kvstore."""
        if self.optimizer_initialized and not force_init:
            return
        assert self.binded and self.params_initialized

        from ..kvstore import create as kv_create, KVStore

        if kvstore is None:
            self._kvstore = None
        elif isinstance(kvstore, KVStore):
            self._kvstore = kvstore
        else:
            self._kvstore = kv_create(kvstore)
        if isinstance(optimizer, str):
            idx2name = {i: n for i, n in enumerate(self._param_names)}
            opt_params = dict(optimizer_params)
            # reference default: grads are batch-summed, so the optimizer
            # rescales by 1/batch_size (ref: module.py init_optimizer
            # "rescale_grad = 1.0/batch_size"), the batch scaled by the
            # store's workers for a dist sync store: its servers sum
            # every worker's gradient
            if "rescale_grad" not in opt_params and self._data_shapes:
                batch_size = self._data_shapes[0].shape[0]
                kind = getattr(self._kvstore, "type", "")
                if "dist" in kind and "_sync" in kind:
                    batch_size *= self._kvstore.num_workers
                opt_params["rescale_grad"] = 1.0 / max(batch_size, 1)
            optimizer = _opt.create(optimizer, param_idx2name=idx2name,
                                    **opt_params)
        self._optimizer = optimizer
        self._updater = _opt.get_updater(optimizer)
        # update_on_kvstore decision (ref: model.py:58 _create_kvstore
        # rules): the optimizer runs on the store whenever there is one
        self._update_on_kvstore = self._kvstore is not None
        if self._kvstore is not None:
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
            for i, name in enumerate(self._param_names):
                self._kvstore.init(i, self._exec.arg_dict[name])
        if self._preloaded_states is not None:
            with open(self._preloaded_states, "rb") as f:
                self._set_optimizer_states(f.read())
            self._preloaded_states = None
        self.optimizer_initialized = True

    def borrow_optimizer(self, shared_module):
        """Share optimizer state with another module bound to the same
        parameters (ref: module.py borrow_optimizer — the bucketing path)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._feed(data_batch)
        if self._dp is None:
            self._exec.forward(is_train=is_train)
            return
        with self._dp.batch_stats():
            self._exec.forward(is_train=is_train)
        self._dp_outputs = self._dp.gather(self._exec.outputs)

    def _feed(self, data_batch):
        """Copy a batch into the bound executor's argument cells, cast to
        each argument's dtype, on the module's device."""
        feed = {}
        for name, arr in zip(self._data_names, data_batch.data):
            feed[name] = arr
        if data_batch.label:
            for name, arr in zip(self._label_names, data_batch.label):
                feed[name] = arr
        for k, v in feed.items():
            if k not in self._exec.arg_dict:
                raise MXNetError("forward: unknown argument %r" % k)
            if self._dp is not None:
                v = self._dp.local(v)
            self._exec._assign_input(k, v)

    def forward_backward(self, data_batch):
        """One walk computes outputs + grads and moves the aux states once
        (ref: the cached-opr RunOps fast path, graph_executor.cc:1440)."""
        assert self.binded and self.params_initialized
        self._feed(data_batch)
        self._run_train_step()

    def _run_train_step(self):
        """The executor's fused step; over ranks, under the global
        batch's statistics, then the gradients summed over the ranks and
        the outputs gathered.  Returns the outputs."""
        if self._dp is None:
            return self._exec.run_train_step()
        with self._dp.batch_stats():
            self._exec.run_train_step()
        self._dp.reduce_grads(self._exec.grad_dict, self._param_names)
        self._dp_outputs = self._dp.gather(self._exec.outputs)
        return self._dp_outputs

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        if self._dp is None:
            self._exec.backward(out_grads=out_grads)
            return
        with self._dp.batch_stats():
            self._exec.backward(out_grads=out_grads)
        self._dp.reduce_grads(self._exec.grad_dict, self._param_names)

    def update(self):
        """ref: module.py:629 update → kvstore push/pull or local updater."""
        assert self.binded and self.params_initialized and self.optimizer_initialized
        self._do_update()

    def _do_update(self):
        from .. import env as _env

        if _env.get_bool("MXNET_SKIP_NONFINITE_GRADS") and \
                not self._grads_finite():
            # non-finite guard: a NaN/Inf gradient pushed into the
            # kvstore poisons EVERY worker's next pull.  Local path:
            # skip the step outright.  Kvstore path: zero the grads and
            # fall through — the sync aggregation round still gets this
            # worker's part (a skipped push would stall every peer's
            # pull), it just contributes nothing.  Counted either way
            # so an operator sees divergence building.
            from .. import diagnostics as _diag

            _diag.metrics.counter(
                "mxnet_training_skipped_steps_total",
                help="optimizer steps skipped (or neutralized) by the "
                     "non-finite gradient guard").inc()
            self.logger.warning(
                "non-finite gradient detected — %s this optimizer step "
                "(MXNET_SKIP_NONFINITE_GRADS=1)",
                "neutralizing" if self._kvstore is not None
                else "skipping")
            if self._kvstore is None:
                return
            self._zero_grads()
        if self._kvstore is not None:
            for i, name in enumerate(self._param_names):
                grad = self._exec.grad_dict.get(name)
                if grad is None:
                    continue
                weight = self._exec.arg_dict[name]
                self._kvstore.push(i, grad, priority=-i)
                if self._update_on_kvstore:
                    self._kvstore.pull(i, weight, priority=-i)
                else:
                    self._kvstore.pull(i, grad, priority=-i)
                    self._updater(i, grad, weight)
        else:
            for i, name in enumerate(self._param_names):
                grad = self._exec.grad_dict.get(name)
                if grad is None:
                    continue
                self._updater(i, grad, self._exec.arg_dict[name])

    def _bulk_fit_steps(self, batches):
        """K train steps back to back on the card, with no host sync
        inside the group (engine.set_bulk_size consumed by fit; the
        reference's bulk-exec segments, threaded_engine.h:386-458).
        Returns per-batch outputs, or None to signal the standard
        per-batch path."""
        if self._bulk_loop is None:
            from .bulk import BulkTrainLoop

            self._bulk_loop = BulkTrainLoop(self)
        return self._bulk_loop.run(batches)

    def get_outputs(self, merge_multi_context=True):
        """The outputs of the last forward (over ranks: the global
        batch's)."""
        assert self.binded
        if self._dp is not None and self._dp_outputs is not None:
            return self._dp_outputs
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        mon.install(self._exec)

    # ------------------------------------------------------------------
    def _grads_finite(self) -> bool:
        """One all-finite check over every gradient buffer (a single host
        sync — the price of the MXNET_SKIP_NONFINITE_GRADS guard)."""
        flags = [torch.isfinite(g._data).all()
                 for g in (self._exec.grad_dict.get(n)
                           for n in self._param_names) if g is not None]
        return bool(torch.stack(flags).all()) if flags else True

    def _zero_grads(self) -> None:
        for name in self._param_names:
            g = self._exec.grad_dict.get(name)
            if g is not None:
                g[:] = 0

    def _corrupt_grads_nan(self) -> None:
        """Chaos 'nan_grad' injection target: poison every gradient with
        NaN — what a diverged loss or a bad reduction does for real."""
        for name in self._param_names:
            g = self._exec.grad_dict.get(name)
            if g is not None:
                g[:] = float("nan")

    # ------------------------------------------------------------------
    def _active_updater(self):
        """The updater that actually holds optimizer state: the kvstore's
        when update_on_kvstore, else the local one (ref: module.py
        save_optimizer_states branching)."""
        if self._update_on_kvstore and self._kvstore is not None:
            return self._kvstore._opt_updater
        return self._updater

    # -- elastic checkpoint/resume surface (mxnet_tpu/checkpoint.py) ----
    def get_checkpoint_state(self) -> dict:
        """Everything fit()'s checkpoint shard needs from the module:
        params, aux (BN moments), and the optimizer/momenta blob.  On a
        dist kvstore, rank 0 gathers the server-held states (other
        ranks shard None — params are replicated, momenta live
        server-side); locally it is the active Updater's pickle."""
        from ..kvstore import KVStoreDist

        arg_params, aux_params = self.get_params()
        opt_states = None
        kv = self._kvstore
        try:
            if isinstance(kv, KVStoreDist):
                if kv.rank == 0:
                    # bounded: a preemption hook must not wait out the
                    # full PS request timeout
                    opt_states = kv.get_optimizer_states_bytes(
                        dump_optimizer=True, timeout=5.0)
            else:
                updater = self._active_updater()
                if updater is not None:
                    opt_states = updater.get_states(dump_optimizer=True)
        except Exception:
            self.logger.exception(
                "checkpoint: optimizer state capture failed — the shard "
                "will resume with fresh momenta")
        return {"arg_params": arg_params, "aux_params": aux_params,
                "optimizer_states": opt_states}

    def restore_checkpoint_state(self, payload: dict) -> None:
        """Re-install a loaded shard's optimizer state after
        init_optimizer (params were already applied through
        init_params(arg_params=...)).  Dist kvstore: rank 0 pushes the
        gathered server states back, then everyone barriers so no
        worker races ahead of the restore."""
        from ..kvstore import KVStoreDist

        opt_states = payload.get("optimizer_states")
        kv = self._kvstore
        if isinstance(kv, KVStoreDist):
            if kv.rank == 0 and opt_states is not None:
                kv.set_optimizer_states_bytes(opt_states)
            kv.barrier()
        elif opt_states is not None:
            updater = self._active_updater()
            if updater is not None:
                updater.set_states(opt_states)

    def _optimizer_states(self) -> bytes:
        """The active optimizer states (a dist store: every server's,
        gathered)."""
        from ..kvstore import KVStoreDist

        if isinstance(self._kvstore, KVStoreDist):
            return self._kvstore.get_optimizer_states_bytes()
        return self._active_updater().get_states()

    def _set_optimizer_states(self, states: bytes) -> None:
        """Install saved optimizer states (a dist store: rank 0 sends
        them to the servers, every rank waits at the barrier)."""
        from ..kvstore import KVStoreDist

        kv = self._kvstore
        if isinstance(kv, KVStoreDist):
            if kv.rank == 0:
                kv.set_optimizer_states_bytes(states)
            kv.barrier()
        else:
            self._active_updater().set_states(states)

    def save_optimizer_states(self, fname: str) -> None:
        """ref: module.py save_optimizer_states."""
        assert self.optimizer_initialized
        with open(fname, "wb") as f:
            f.write(self._optimizer_states())

    def load_optimizer_states(self, fname: str) -> None:
        """ref: module.py load_optimizer_states."""
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._set_optimizer_states(f.read())

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """ref: module.py save_checkpoint → model.py:366."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """ref: module.py Module.load — params apply at init_params time,
        optimizer states at init_optimizer time."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._preloaded_params = (args, auxs)
        if load_optimizer_states:
            mod._preloaded_states = "%s-%04d.states" % (prefix, epoch)
        return mod
