"""PythonModule / PythonLossModule — modules implemented directly in
python, usable inside the fit loop (most often as a custom loss at the
end of a SequentialModule). ref: python/mxnet/module/python_module.py:28.

Counterpart: ``mxnet_tpu/module/python_module.py``, a copy over the port's NDArray.
"""
from __future__ import annotations

import logging

import numpy as _np

from ..initializer import Uniform
from ..io import DataDesc
from ..ndarray import NDArray, array
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Subclass and override `forward`/`backward`/`_compute_output_shapes`
    (ref: python_module.py:28). Parameter-less by default."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- params: none by default (ref: python_module.py:96) ------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [
            d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in data_shapes]
        self._label_shapes = ([
            d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in label_shapes] if label_shapes else None)
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """Loss as a python module: forward stores the scores, backward
    computes the input gradient via `grad_func` (default: softmax CE)
    (ref: python_module.py:240)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names=data_names, label_names=label_names,
                         output_names=[name + "_output"], logger=logger)
        self._name = name
        assert len(data_names) == 1 and len(label_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [DataDesc(self._name + "_output",
                         self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, \
            "PythonLossModule is a loss head: no out_grads expected"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        """Default gradient: softmax cross-entropy wrt scores
        (ref: python_module.py:328)."""
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, NDArray):
                grad = array(grad, ctx=self._scores.context)
            self._scores_grad = grad
            return
        scores = self._scores.asnumpy()
        labels = self._labels.asnumpy().astype(_np.int64)
        e = _np.exp(scores - scores.max(axis=1, keepdims=True))
        prob = e / e.sum(axis=1, keepdims=True)
        prob[_np.arange(len(labels)), labels] -= 1.0
        self._scores_grad = array(prob / len(labels),
                                  ctx=self._scores.context)

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError
