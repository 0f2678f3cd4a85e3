"""SequentialModule — chain modules so one's outputs feed the next
(ref: python/mxnet/module/sequential_module.py:28).

Counterpart: ``mxnet_tpu/module/sequential_module.py``, a copy over the port's NDArray.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from ..io import DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """A container chaining modules in order (ref:
    sequential_module.py:28). `add(mod, take_labels=True)` marks the
    module that consumes the data labels (the loss module)."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        """Append a module; returns self for chaining
        (ref: sequential_module.py:52)."""
        self._modules.append(module)
        for key in kwargs:
            if key not in (self.META_TAKE_LABELS, self.META_AUTO_WIRING):
                raise MXNetError("unknown meta %r" % key)
        self._metas.append(dict(kwargs))
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # -- properties ----------------------------------------------------
    @property
    def data_names(self):
        if self._modules:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if self._modules:
            return self._modules[-1].output_names
        return []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    # -- params --------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=True,
                               force_init=force_init,
                               allow_extra=True)
        self.params_initialized = True

    # -- binding: thread shapes module to module -----------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert shared_module is None, \
            "shared_module not supported for SequentialModule"
        assert len(self._modules) > 0
        self.for_training = for_training
        self._label_shapes = label_shapes

        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i_layer, (meta, module) in enumerate(zip(self._metas,
                                                     self._modules)):
            meta_take_labels = meta.get(self.META_TAKE_LABELS, False)
            my_label_shapes = label_shapes if meta_take_labels else None
            if meta_take_labels:
                anybody_ever_needs_label = True
            my_inputs_need_grad = inputs_need_grad if i_layer == 0 \
                else True
            if meta.get(self.META_AUTO_WIRING, False):
                # rename the piped shapes to this module's own data
                # names, positionally (ref: sequential_module.py
                # auto_wiring)
                data_names = module.data_names
                assert len(data_names) == len(my_data_shapes)
                my_data_shapes = [
                    DataDesc(new_name,
                             d.shape if isinstance(d, DataDesc)
                             else d[1])
                    for new_name, d in zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            # wire this module's outputs as the next module's data
            # (output_shapes yields (name, shape) pairs or DataDescs)
            my_data_shapes = [
                DataDesc(d.name, d.shape) if isinstance(d, DataDesc)
                else DataDesc(d[0], d[1])
                for d in module.output_shapes]
        if not anybody_ever_needs_label:
            self._label_shapes = None
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    # -- execution: outputs of module i feed module i+1 ----------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io import DataBatch

        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            batch = DataBatch(module.get_outputs(),
                              data_batch.label, pad=data_batch.pad)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
