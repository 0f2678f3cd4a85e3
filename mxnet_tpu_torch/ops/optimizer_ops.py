"""Optimizer update ops: ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``adagrad_update`` and their lazy row-sparse forms.

Counterpart: ``mxnet_tpu/ops/optimizer_ops.py`` (``_apply_wd_and_clip``
at :18-41, the SGD, Adam and AdaGrad ops, and the row-sparse updates at
:174-250).  Each returns the new weight, and the new states through
``mutate_aux`` (written back into the state cells by ``nd.invoke``), as
the reference's in-place state update.  The other update ops of that
module (NAG, RMSProp, ...) are queued with their optimizers (ROADMAP
A12).
"""
from __future__ import annotations

import functools

import torch

from .registry import register


def _apply_wd_and_clip(grad, weight, wd, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


@register("sgd_update", nondiff=True)
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True, **_):
    g = _apply_wd_and_clip(grad, weight, wd, rescale_grad,
                           clip_gradient if clip_gradient > 0 else None)
    return weight - lr * g


@register("sgd_mom_update", nondiff=True, mutate_aux=(2,))
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                    **_):
    g = _apply_wd_and_clip(grad, weight, wd, rescale_grad,
                           clip_gradient if clip_gradient > 0 else None)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


@register("adam_update", nondiff=True, mutate_aux=(2, 3))
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True, **_):
    g = _apply_wd_and_clip(grad, weight, wd, rescale_grad,
                           clip_gradient if clip_gradient > 0 else None)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


@register("adagrad_update", nondiff=True, mutate_aux=(2,))
def _adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, **_):
    g = _apply_wd_and_clip(grad, weight, wd, rescale_grad,
                           clip_gradient if clip_gradient > 0 else None)
    new_hist = history + torch.square(g)
    return weight - lr * g / torch.sqrt(new_hist + epsilon), new_hist


# ---------------------------------------------------------------------------
# row-sparse (lazy) updates: only the rows present in the gradient are
# read and written (ref: src/operator/optimizer_op.cc SGDUpdateRspImpl /
# SGDMomLazyUpdate / AdamUpdateRspImpl / AdagradUpdateRspImpl): the
# state of an untouched row does not decay.  The gradient comes as
# ``(gdata, rows)`` with unique rows.  Each rule below maps the gathered
# weight and state rows to their new values; the registered ops scatter
# them into copies of the weight and states (the inputs stay as they
# were), ``lazy_update_`` into the tensors themselves.
# ---------------------------------------------------------------------------
def _row_clip_wd(gdata, wrows, wd, rescale_grad, clip_gradient):
    g = gdata * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * wrows


def _rows_sgd(wrows, g, lr=0.01, **_):
    return (wrows + -lr * g,)


def _rows_sgd_mom(wrows, g, mrows, lr=0.01, momentum=0.0, **_):
    new_mrows = momentum * mrows - lr * g
    return wrows + new_mrows, new_mrows


def _rows_adam(wrows, g, mrows, vrows, lr=0.001, beta1=0.9, beta2=0.999,
               epsilon=1e-8, **_):
    mrows = beta1 * mrows + (1.0 - beta1) * g
    vrows = beta2 * vrows + (1.0 - beta2) * torch.square(g)
    return wrows - lr * mrows / (torch.sqrt(vrows) + epsilon), mrows, vrows


def _rows_adagrad(wrows, g, hrows, lr=0.01, epsilon=1e-7, **_):
    hrows = hrows + torch.square(g)
    return wrows + -lr * g / torch.sqrt(hrows + epsilon), hrows


LAZY_RULES = {"_sparse_sgd_update": _rows_sgd,
              "_sparse_sgd_mom_update": _rows_sgd_mom,
              "_sparse_adam_update": _rows_adam,
              "_sparse_adagrad_update": _rows_adagrad}


def lazy_rows(op, weight, gdata, rows, states, wd=0.0, rescale_grad=1.0,
              clip_gradient=-1.0, **params):
    """The touched rows' new weight and states under ``op``'s rule."""
    rows = rows.to(torch.int64)
    wrows = weight.index_select(0, rows)
    g = _row_clip_wd(gdata, wrows, wd, rescale_grad,
                     clip_gradient if clip_gradient > 0 else None)
    return rows, LAZY_RULES[op](
        wrows, g, *(s.index_select(0, rows) for s in states), **params)


def lazy_update_(op, weight, gdata, rows, states, **params) -> None:
    """``op``'s lazy update written into ``weight`` and ``states``
    themselves: the work is the touched rows' whatever the table's size.
    The caller owns the tensors (see ``Optimizer._lazy``)."""
    rows, new = lazy_rows(op, weight, gdata, rows, states, **params)
    with torch.no_grad():
        for t, r in zip((weight,) + tuple(states), new):
            t.index_copy_(0, rows, r.to(t.dtype))


def _scattered(op, weight, gdata, rows, *states, **params):
    rows, new = lazy_rows(op, weight, gdata, rows, states, **params)
    out = tuple(t.clone().index_copy_(0, rows, r.to(t.dtype))
                for t, r in zip((weight,) + states, new))
    return out if states else out[0]


for _name, _aux in (("_sparse_sgd_update", ()),
                    ("_sparse_sgd_mom_update", (3,)),
                    ("_sparse_adam_update", (3, 4)),
                    ("_sparse_adagrad_update", (3,))):
    register(_name, nondiff=True, mutate_aux=_aux,
             input_names=["weight", "grad", "rows"] +
             ["state%d" % i for i in range(len(_aux))])(
        functools.partial(_scattered, _name))
