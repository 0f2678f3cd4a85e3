"""Optimizers: the registry, SGD (with momentum), Adam, AdaGrad, the
fused multi-tensor SGD-momentum update, and the ``Updater``.

Counterpart: ``mxnet_tpu/optimizer.py`` (``_rsp_grad`` at :33-42,
``Optimizer``, ``register`` / ``create``, ``SGD`` with its lazy branch
at :152-160, ``Adam`` at :201, ``AdaGrad`` at :235, ``pack_flat`` /
``unpack_flat`` and their ``_np`` forms, ``fused_sgd_mom_flat``,
``fused_sgd_mom_grouped`` at :556-636, ``Updater`` / ``get_updater``).
``Optimizer.update`` runs the registered update op (``sgd_update``,
``sgd_mom_update``, ``adam_update``, ``adagrad_update``) per key, as the
reference; the fused forms work on raw tensors inside a train step.  A
row-sparse gradient takes the lazy update (SGD and Adam unless
``lazy_update=False``, AdaGrad always): only its rows of the weight and
the states are read and written, and every other row keeps its weight
and its state bit for bit.  Departure: the lazy update writes those rows
into the weight's and the states' own tensors and bumps their versions
(as ``rtc`` launches do), so its work is the touched rows' whatever the
table's size; the JAX package builds new arrays through the registered
``_sparse_*_update`` ops, which the port keeps for ``nd`` callers.
``Updater.get_states`` pickles ``{index: numpy state}`` as the JAX
package does.  The other optimizers (NAG, RMSProp, AdaDelta, Ftrl,
Adamax, Nadam, Signum, SGLD, DCASGD, FTML, LBSGD, Test) are queued
(ROADMAP A12); ``create`` names them as such.
"""
from __future__ import annotations

import io
import math
import pickle
from typing import Any, Dict

import numpy as _np
import torch

from .base import MXNetError
from .ndarray import NDArray, invoke, zeros
from .ops import optimizer_ops as _optimizer_ops

__all__ = ["Optimizer", "SGD", "Adam", "AdaGrad", "Updater", "get_updater", "create",
           "register", "fused_sgd_mom_flat", "fused_sgd_mom_grouped",
           "pack_flat", "unpack_flat", "pack_flat_np", "unpack_flat_np"]

_REGISTRY: Dict[str, type] = {}
_QUEUED = ("nag", "adadelta", "rmsprop", "ftrl", "adamax", "nadam",
           "signum", "sgld", "dcasgd", "ftml", "lbsgd", "test")


def _rsp_grad(grad):
    """``(gdata, rows)`` tensors of a row-sparse gradient for the lazy
    row updates, else None (the dense path)."""
    from .ndarray import sparse as _sparse

    if isinstance(grad, _sparse.RowSparseNDArray):
        p = grad._parts()
        return p["data"], p["indices"]
    return None


def register(klass):
    """ref: Optimizer.register."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    key = name.lower()
    if key not in _REGISTRY and key in _QUEUED:
        raise MXNetError("optimizer %r is not ported yet (ROADMAP A12); "
                         "ported: %s" % (name, sorted(_REGISTRY)))
    try:
        return _REGISTRY[key](**kwargs)
    except KeyError:
        raise MXNetError("unknown optimizer %r" % name) from None


class Optimizer:
    """ref: python/mxnet/optimizer.py Optimizer."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.idx2name = dict(param_idx2name or {})
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.multi_precision = multi_precision
        self.param_dict = param_dict or {}

    create_optimizer = staticmethod(create)

    # -- state ----------------------------------------------------------
    def create_state(self, index, weight: NDArray):
        return None

    def create_state_multi_precision(self, index, weight):
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    # -- bookkeeping ----------------------------------------------------
    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            # reference defaults: no decay on bias/gamma/beta
            if n.endswith("_bias") or n.endswith("_gamma") or \
                    n.endswith("_beta"):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        self._index_update_count.setdefault(index, self.begin_num_update)
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index) -> float:
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        name = self.idx2name.get(index, index)
        lr *= self.lr_mult.get(name, self.lr_mult.get(index, 1.0))
        return lr

    def _get_wd(self, index) -> float:
        wd = self.wd
        name = self.idx2name.get(index, index)
        wd *= self.wd_mult.get(name, self.wd_mult.get(index, 1.0))
        return wd

    def _clip(self):
        return self.clip_gradient if self.clip_gradient is not None else -1.0

    def _lazy(self, op, weight, sp, states, **params) -> None:
        """The lazy row update ``op`` (``ops.optimizer_ops.LAZY_RULES``)
        of ``weight`` and ``states`` (NDArrays) from the row-sparse
        gradient ``sp``, written into their tensors in place."""
        gdata, rows = sp
        dev = weight._data.device
        _optimizer_ops.lazy_update_(
            op, weight._data, gdata.to(dev), rows.to(dev),
            tuple(s._data for s in states),
            rescale_grad=self.rescale_grad, clip_gradient=self._clip(),
            **params)
        for cell in (weight,) + tuple(states):
            cell._bump_version()


@register
class SGD(Optimizer):
    """SGD with momentum through the ``sgd_update`` / ``sgd_mom_update``
    ops (ref: optimizer.py SGD + src/operator/optimizer_op.cc)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        sp = _rsp_grad(grad) if self.lazy_update else None
        if sp is not None:
            if state is None:
                self._lazy("_sparse_sgd_update", weight, sp, (), lr=lr,
                           wd=wd)
            else:
                self._lazy("_sparse_sgd_mom_update", weight, sp, (state,),
                           lr=lr, wd=wd, momentum=self.momentum)
        elif state is None:
            invoke("sgd_update", [weight, grad],
                   {"lr": lr, "wd": wd, "rescale_grad": self.rescale_grad,
                    "clip_gradient": self._clip()}, out=weight)
        else:
            invoke("sgd_mom_update", [weight, grad, state],
                   {"lr": lr, "momentum": self.momentum, "wd": wd,
                    "rescale_grad": self.rescale_grad,
                    "clip_gradient": self._clip()}, out=weight)


@register
class Adam(Optimizer):
    """ref: optimizer.py Adam (the bias corrections folded into lr)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context, dtype=weight.dtype),
                zeros(weight.shape, weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        sp = _rsp_grad(grad) if self.lazy_update else None
        params = {"lr": lr, "beta1": self.beta1, "beta2": self.beta2,
                  "epsilon": self.epsilon, "wd": wd}
        if sp is not None:
            self._lazy("_sparse_adam_update", weight, sp, tuple(state),
                       **params)
            return
        invoke("adam_update", [weight, grad] + list(state),
               dict(params, rescale_grad=self.rescale_grad,
                    clip_gradient=self._clip()), out=weight)


@register
class AdaGrad(Optimizer):
    """ref: optimizer.py AdaGrad (a row-sparse gradient always takes the
    lazy update, as in the reference)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        params = {"lr": self._get_lr(index),
                  "epsilon": self.float_stable_eps,
                  "wd": self._get_wd(index)}
        sp = _rsp_grad(grad)
        if sp is not None:
            self._lazy("_sparse_adagrad_update", weight, sp, (state,),
                       **params)
            return
        invoke("adagrad_update", [weight, grad, state],
               dict(params, rescale_grad=self.rescale_grad,
                    clip_gradient=self._clip()), out=weight)


# ---------------------------------------------------------------------------
# The fused multi-tensor update: ONE elementwise SGD-momentum over a flat
# concatenation of every parameter of a dtype, inside a train step
# (parallel/dp.py FusedTrainStep).  The math is elementwise and keeps the
# dtype, so fused == per-key bitwise.
# ---------------------------------------------------------------------------
def pack_flat(arrays):
    """Concatenate tensors (of one dtype) into one flat buffer."""
    if len(arrays) == 1:
        return arrays[0].reshape(-1)
    return torch.cat([a.reshape(-1) for a in arrays])


def unpack_flat(flat, ref_arrays):
    """Split a flat buffer back into ``ref_arrays``' shapes, in order."""
    out = []
    off = 0
    for ref in ref_arrays:
        sz = ref.numel()
        out.append(flat[off:off + sz].reshape(ref.shape))
        off += sz
    return out


def pack_flat_np(arrays):
    """Host-side (numpy) :func:`pack_flat`."""
    if len(arrays) == 1:
        return _np.asarray(arrays[0]).ravel()
    return _np.concatenate([_np.asarray(a).ravel() for a in arrays])


def unpack_flat_np(flat, shapes):
    """Host-side :func:`unpack_flat` over explicit ``shapes``."""
    flat = _np.asarray(flat)
    out = []
    off = 0
    for shape in shapes:
        sz = 1
        for d in shape:
            sz *= int(d)
        out.append(flat[off:off + sz].reshape(tuple(shape)))
        off += sz
    return out


def fused_sgd_mom_flat(flat_w, flat_g, flat_m, lr, momentum, wd):
    """SGD with momentum over flat buffers, the per-key path's
    elementwise math (``g += wd*w; m = momentum*m - lr*g; w += m``);
    returns ``(new_w, new_m)``."""
    g = flat_g + wd * flat_w
    m = momentum * flat_m - lr * g
    return flat_w + m, m


def fused_sgd_mom_grouped(keys, params, grads, moms, lr, momentum, wd):
    """ONE fused update per dtype group over ``keys`` (in order; a concat
    never mixes dtypes).  ``params`` / ``grads`` / ``moms`` are indexed
    by ``keys``.  Returns ``({key: new_param}, {key: new_mom})``."""
    groups = {}
    for k in keys:
        groups.setdefault(params[k].dtype, []).append(k)
    new_p, new_m = {}, {}
    for ks in groups.values():
        refs = [params[k] for k in ks]
        w, m = fused_sgd_mom_flat(
            pack_flat(refs), pack_flat([grads[k] for k in ks]),
            pack_flat([moms[k] for k in ks]), lr, momentum, wd)
        for k, wv, mv in zip(ks, unpack_flat(w, refs), unpack_flat(m, refs)):
            new_p[k], new_m[k] = wv, mv
    return new_p, new_m


class Updater:
    """Per-index state closure (ref: optimizer.py Updater /
    get_updater)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            # states from set_states were rebuilt from float32 numpy (a
            # bf16 state's asnumpy is float32, exactly) on the host: give
            # them the weight's dtype and device, or the next update
            # promotes a bf16 run to float32 for good
            self.states[index] = _state_like(self.states[index], weight)
            self.states_synced[index] = True
        from . import profiler as _profiler

        # one optimizer span per parameter update, aggregated per
        # optimizer class; record_span no-ops when stopped
        with _profiler.span(type(self.optimizer).__name__ + "::update",
                            cat="optimizer"):
            self.optimizer.update_multi_precision(index, weight, grad,
                                                  self.states[index])

    def get_states(self, dump_optimizer=False) -> bytes:
        states = {k: _state_to_np(v) for k, v in self.states.items()}
        payload = (states, self.optimizer) if dump_optimizer else states
        return pickle.dumps(payload)

    def set_states(self, states: bytes) -> None:
        data = _StatesUnpickler(io.BytesIO(states)).load()
        if isinstance(data, tuple):
            states, opt = data
            if isinstance(opt, Optimizer):
                self.optimizer = opt
            else:
                # the JAX package's optimizer (a checkpoint of its fit):
                # this one stays, with the step counts the schedule reads
                for k in ("num_update", "_index_update_count"):
                    if k in vars(opt):
                        setattr(self.optimizer, k, vars(opt)[k])
        else:
            states = data
        self.states = {k: _state_from_np(v) for k, v in states.items()}
        self.states_synced = {k: False for k in self.states}


class _Foreign:
    """An object of the JAX package inside pickled optimizer states (its
    optimizer, lr scheduler), read without importing that package: its
    attributes only."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, tuple):
            state = state[-1]
        if isinstance(state, dict):
            self.__dict__.update(state)


class _StatesUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "mxnet_tpu" or module.startswith("mxnet_tpu."):
            return _Foreign
        return super().find_class(module, name)


def _state_to_np(state):
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return tuple(_state_to_np(s) for s in state)
    return state.asnumpy()


def _state_like(state, weight):
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return tuple(_state_like(s, weight) for s in state)
    if state.dtype != weight.dtype:
        state = state.astype(weight.dtype)
    if state.context != weight.context:
        state = state.as_in_context(weight.context)
    return state


def _state_from_np(state):
    # host cells: the first update moves each to its weight's device
    # and dtype (Updater.__call__, _state_like)
    from .context import cpu
    from .ndarray import array

    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_from_np(s) for s in state)
    return array(state, ctx=cpu())


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
