"""Evaluation metrics (ref: python/mxnet/metric.py:44-1042).

Same registry + composite structure as the reference: 16 metric classes +
CustomMetric/np adapter.  ``update`` takes lists of label/pred NDArrays.

Counterpart: ``mxnet_tpu/metric.py``, a copy over the port's NDArray.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as _np

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create"]

_REGISTRY: Dict[str, type] = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def create(metric, *args, **kwargs):
    """ref: metric.py create."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    aliases = {"acc": "accuracy", "ce": "crossentropy", "nll_loss":
               "negativeloglikelihood", "top_k_accuracy": "topkaccuracy",
               "top_k_acc": "topkaccuracy", "pearsonr": "pearsoncorrelation"}
    lname = aliases.get(metric.lower(), metric.lower())
    try:
        return _REGISTRY[lname](*args, **kwargs)
    except KeyError:
        raise MXNetError("unknown metric %r" % metric) from None


class EvalMetric:
    """ref: metric.py EvalMetric."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def update_dict(self, label: Dict[str, Any], pred: Dict[str, Any]):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names if n in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names if n in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        name = _as_list(name)
        value = _as_list(value)
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(_as_list(n))
            values.extend(_as_list(v))
        return names, values


def check_label_shapes(labels, preds, shape=0):
    """Public surface (ref metric.py:33 — custom metrics in example
    code call it, e.g. example/multi-task): compare counts, or shapes
    with shape=1."""
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            "Shape of labels %s does not match shape of predictions %s"
            % (label_shape, pred_shape))


def _check_label_shapes(labels, preds):
    check_label_shapes(labels, preds)


@register
class Accuracy(EvalMetric):
    """ref: metric.py Accuracy."""

    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        _check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab = label.asnumpy() if isinstance(label, NDArray) else _np.asarray(label)
            prd = pred.asnumpy() if isinstance(pred, NDArray) else _np.asarray(pred)
            if prd.ndim > lab.ndim:
                prd = prd.argmax(axis=self.axis)
            lab = lab.astype("int32").reshape(-1)
            prd = prd.astype("int32").reshape(-1)
            self.sum_metric += float((prd == lab).sum())
            self.num_inst += len(lab)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__("%s_%d" % (name, top_k), **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            prd = pred.asnumpy() if isinstance(pred, NDArray) else _np.asarray(pred)
            lab = (label.asnumpy() if isinstance(label, NDArray) else
                   _np.asarray(label)).astype("int32")
            order = _np.argsort(prd, axis=1)[:, ::-1][:, : self.top_k]
            self.sum_metric += float((order == lab.reshape(-1, 1)).any(axis=1).sum())
            self.num_inst += len(lab)


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            prd = pred.asnumpy().argmax(axis=-1).reshape(-1)
            lab = label.asnumpy().astype("int32").reshape(-1)
            tp = float(((prd == 1) & (lab == 1)).sum())
            fp = float(((prd == 1) & (lab == 0)).sum())
            fn = float(((prd == 0) & (lab == 1)).sum())
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            f1 = (2 * precision * recall / (precision + recall)
                  if precision + recall > 0 else 0.0)
            self.sum_metric += f1
            self.num_inst += 1


@register
class Perplexity(EvalMetric):
    """ref: metric.py Perplexity."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss, num = 0.0, 0
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            prd = pred.asnumpy()
            lab = label.asnumpy().astype("int32").reshape(-1)
            prd = prd.reshape(-1, prd.shape[-1])
            probs = prd[_np.arange(len(lab)), lab]
            if self.ignore_label is not None:
                ignore = lab == self.ignore_label
                probs = probs[~ignore]
            loss -= _np.sum(_np.log(_np.maximum(1e-10, probs)))
            num += len(probs)
        self.sum_metric += float(loss)
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            lab, prd = label.asnumpy(), pred.asnumpy()
            if lab.ndim == 1:
                lab = lab.reshape(lab.shape[0], 1)
            if prd.ndim == 1:
                prd = prd.reshape(prd.shape[0], 1)
            self.sum_metric += float(_np.abs(lab - prd).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            lab, prd = label.asnumpy(), pred.asnumpy()
            if lab.ndim == 1:
                lab = lab.reshape(lab.shape[0], 1)
            if prd.ndim == 1:
                prd = prd.reshape(prd.shape[0], 1)
            self.sum_metric += float(((lab - prd) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            lab = label.asnumpy().astype("int32").reshape(-1)
            prd = pred.asnumpy().reshape(len(lab), -1)
            prob = prd[_np.arange(len(lab)), lab]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += len(lab)


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)
        self.eps = eps


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            lab = label.asnumpy().reshape(-1)
            prd = pred.asnumpy().reshape(-1)
            self.sum_metric += float(_np.corrcoef(lab, prd)[0, 1])
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Mean of raw loss outputs (ref: metric.py Loss)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            self.sum_metric += float(pred.asnumpy().sum())
            self.num_inst += pred.size


@register
class Torch(Loss):
    def __init__(self, name="torch", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)


class CustomMetric(EvalMetric):
    """ref: metric.py CustomMetric."""

    def __init__(self, feval, name=None, allow_extra_outputs=False, **kwargs):
        if name is None:
            # reference naming (metric.py:1123): the feval's own name;
            # only anonymous callables get the custom(...) wrapper
            name = getattr(feval, "__name__", "<custom>")
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name, **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            lab = label.asnumpy() if isinstance(label, NDArray) else label
            prd = pred.asnumpy() if isinstance(pred, NDArray) else pred
            result = self._feval(lab, prd)
            if isinstance(result, tuple):
                s, n = result
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += result
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (ref: metric.py np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", "numpy_feval")
    return CustomMetric(feval, name, allow_extra_outputs)
