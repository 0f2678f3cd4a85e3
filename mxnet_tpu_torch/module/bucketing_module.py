"""BucketingModule — shape-specialised executors sharing one parameter set
(ref: python/mxnet/module/bucketing_module.py:35).

Counterpart: ``mxnet_tpu/module/bucketing_module.py``, a copy (plus
one planted fault, :data:`FAULTS`, for the checks).  The
reference binds one GraphExecutor per bucket length, sharing memory
pools via ``shared_exec`` (src/executor/graph_executor.cc:913,1572).
Here each bucket gets a Module whose executor runs eagerly at its shapes,
while parameter *cells* are shared across buckets (Module.bind's
shared_module path), so an update through any bucket is visible to all.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule", "FAULTS"]

#: planted faults for the checks that must catch them:
#: ``bucket_own_params`` binds each new bucket to its own copy of the
#: parameters instead of the default bucket's cells
FAULTS: set = set()


class BucketingModule(BaseModule):
    """ref: bucketing_module.py BucketingModule:35."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names or []
        self._state_names = state_names or []
        self._buckets: Dict[object, Module] = {}
        self._curr_module: Optional[Module] = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    def _call_sym_gen(self, bucket_key):
        return self._sym_gen(bucket_key)

    def get_params(self):
        assert self.binded and self.params_initialized
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
            return
        assert self.binded and self.params_initialized
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init)
        self._params_dirty = False

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init)
        self._params_dirty = False
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Binds the default-bucket executor (ref: bucketing_module.py
        bind:244)."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        symbol, data_names, label_names = self._call_sym_gen(
            self._default_bucket_key)
        module = Module(symbol, data_names, label_names, logger=self.logger,
                        context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, shared_module=None,
                    grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Bind (or reuse) the executor for ``bucket_key``, sharing
        parameters with the default bucket (ref: bucketing_module.py
        switch_bucket:286)."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._call_sym_gen(bucket_key)
            module = Module(symbol, data_names, label_names,
                            logger=self.logger, context=self._context,
                            work_load_list=self._work_load_list,
                            fixed_param_names=self._fixed_param_names,
                            state_names=self._state_names)
            default = self._buckets[self._default_bucket_key]
            own = "bucket_own_params" in FAULTS
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad,
                        force_rebind=False,
                        shared_module=None if own else default)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
            if self.params_initialized:
                if own:
                    arg, aux = default.get_params()
                    module.init_params(arg_params=arg, aux_params=aux,
                                       allow_missing=True)
                module.params_initialized = True
                module.binded = True
            if self.optimizer_initialized:
                module.borrow_optimizer(
                    self._buckets[self._default_bucket_key])
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized
        bucket_key = data_batch.bucket_key
        original_bucket_key = self._curr_bucket_key
        data_shapes = data_batch.provide_data
        label_shapes = data_batch.provide_label
        self.switch_bucket(bucket_key, data_shapes, label_shapes)
        self.switch_bucket(original_bucket_key, None, None)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward_backward(data_batch)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)
