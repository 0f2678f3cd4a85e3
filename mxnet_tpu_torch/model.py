"""Checkpoint helpers + legacy FeedForward surface
(ref: python/mxnet/model.py:58,176,366,396).

Counterpart: ``mxnet_tpu/model.py``, a copy over the port's NDArray.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as _np

from .base import MXNetError
from .ndarray import NDArray, load as nd_load, save as nd_save

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam",
           "FeedForward"]

from .callback import BatchEndParam


def save_checkpoint(prefix: str, epoch: int, symbol, arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray], remove_amp_cast: bool = True) -> None:
    """Writes ``prefix-symbol.json`` + ``prefix-####.params``
    (ref: model.py:366 save_checkpoint)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd_save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def split_param_dict(save_dict):
    """Split a params-container dict on the ``arg:``/``aux:`` key prefix
    convention (the prefix-####.params format) → (arg, aux) dicts."""
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix: str, epoch: int):
    """ref: model.py:396 load_checkpoint.  The parameters load as host
    arrays (``mx.cpu()``): ``Module.init_params`` / ``set_params`` copy
    them into the module's cells on its device."""
    from .context import cpu
    from .symbol import load as sym_load

    symbol = sym_load("%s-symbol.json" % prefix)
    save_dict = nd_load("%s-%04d.params" % (prefix, epoch), ctx=cpu())
    arg_params, aux_params = split_param_dict(save_dict)
    return symbol, arg_params, aux_params


class FeedForward:
    """The v0.x estimator-style training API (ref: model.py:434
    FeedForward; deprecated upstream in favour of Module, kept for
    compatibility). Internally delegates to ``mx.mod.Module`` — the
    same approach the reference's own docs recommend."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, **kwargs):
        from . import initializer as _init

        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or _init.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    # -- data massaging (ref: model.py:609 _init_iter) -----------------
    def _init_iter(self, X, y, is_train):
        from . import io

        if isinstance(X, io.DataIter):
            return X
        X = _np.asarray(X, dtype=_np.float32)
        if y is None:
            if is_train:
                raise ValueError("y is required for training")
            y = _np.zeros(X.shape[0], dtype=_np.float32)
        y = _np.asarray(y, dtype=_np.float32)
        batch = min(self.numpy_batch_size, X.shape[0])
        return io.NDArrayIter(X, y, batch_size=batch,
                              shuffle=bool(is_train))

    def _build_module(self, ctx, data_iter=None):
        from . import module as _mod

        # input/label names come from the ITERATOR when it declares them
        # (ref model.py _init_iter + executor_manager bind: nets like
        # example/recommenders' MF feed 'user'/'item' with label
        # 'score', not 'data'/'softmax_label')
        data_names, label_names = None, None
        if data_iter is not None and getattr(data_iter, "provide_data",
                                             None):
            data_names = [d[0] for d in data_iter.provide_data]
        if data_iter is not None and getattr(data_iter, "provide_label",
                                             None):
            label_names = [d[0] for d in data_iter.provide_label]
        if data_names is None:
            data_names = ["data"]
        if not label_names:
            label_names = [n for n in self.symbol.list_arguments()
                           if n.endswith("_label")] or ["softmax_label"]
        return _mod.Module(self.symbol, data_names=data_names,
                           label_names=label_names, context=ctx)

    # -- training (ref: model.py:774 fit) ------------------------------
    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None,
            monitor=None, eval_end_callback=None,
            eval_batch_end_callback=None):
        from . import metric as _metric

        train = self._init_iter(X, y, is_train=True)
        if eval_data is not None and not hasattr(eval_data,
                                                 "provide_data"):
            eval_data = self._init_iter(eval_data[0], eval_data[1],
                                        is_train=False)
        self._module = self._build_module(self.ctx, data_iter=train)
        opt_params = dict(self.kwargs)
        self._module.fit(
            train, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            eval_end_callback=eval_end_callback,
            eval_batch_end_callback=eval_batch_end_callback,
            optimizer=self.optimizer,
            optimizer_params=opt_params or (("learning_rate", 0.01),),
            initializer=self.initializer, arg_params=self.arg_params,
            aux_params=self.aux_params, begin_epoch=self.begin_epoch,
            num_epoch=self.num_epoch, monitor=monitor)
        self.arg_params, self.aux_params = self._module.get_params()
        self._pred_shapes = None  # predictor must rebuild on new params
        return self

    # -- inference (ref: model.py:654 predict, :723 score) -------------
    def predict(self, X, num_batch=None, return_data=False, reset=True):
        data = self._init_iter(X, None, is_train=False)
        if reset:
            data.reset()
        # a dedicated inference module, rebound when the batch shape
        # changes (ref: model.py:593 _init_predictor re-binds likewise)
        shapes = tuple(tuple(d.shape) for d in data.provide_data)
        if getattr(self, "_pred_shapes", None) != shapes:
            mod = self._build_module(self.ctx, data_iter=data)
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label, for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {},
                           allow_missing=False)
            self._pred_module = mod
            self._pred_shapes = shapes
        mod = self._pred_module
        outputs = []
        datas = []
        labels = []
        for i, batch in enumerate(data):
            if num_batch is not None and i >= num_batch:
                break
            mod.forward(batch, is_train=False)
            out = mod.get_outputs()[0].asnumpy()
            n = batch.data[0].shape[0] - batch.pad
            outputs.append(out[:n])
            if return_data:
                datas.append(batch.data[0].asnumpy()[:n])
                labels.append(batch.label[0].asnumpy()[:n])
        preds = _np.concatenate(outputs, axis=0)
        if return_data:
            return (preds, _np.concatenate(datas),
                    _np.concatenate(labels))
        return preds

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        from . import metric as _metric

        data = self._init_iter(X, None, is_train=False)
        if reset:
            data.reset()
        if self._module is None or not self._module.binded:
            if self.arg_params is None:
                raise MXNetError("score before fit/load")
            mod = self._build_module(self.ctx, data_iter=data)
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label, for_training=False)
            mod.set_params(self.arg_params, self.aux_params or {})
            self._module = mod
        m = _metric.create(eval_metric) if isinstance(eval_metric, str) \
            else eval_metric
        res = self._module.score(data, m, num_batch=num_batch)
        return res[0][1]

    # -- persistence (ref: model.py:876 save, :899 load) ---------------
    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               epoch_size=None, optimizer="sgd", initializer=None,
               eval_data=None, eval_metric="acc",
               epoch_end_callback=None, batch_end_callback=None,
               kvstore="local", logger=None, work_load_list=None,
               eval_end_callback=None, eval_batch_end_callback=None,
               **kwargs):
        """Build + fit in one call (ref: model.py:930 create)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback,
                  kvstore=kvstore, logger=logger,
                  work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
