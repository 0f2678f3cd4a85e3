"""Optimizer update ops: ``sgd_update`` and ``sgd_mom_update``.

Counterpart: ``mxnet_tpu/ops/optimizer_ops.py`` (``_apply_wd_and_clip``
at :18-41 and the two SGD ops).  Each returns the new weight, and the
new momentum through ``mutate_aux`` (written back into the state cell by
``nd.invoke``), as the reference's in-place state update.  The other
update ops of that module (NAG, Adam, RMSProp, ...) are queued with
their optimizers.
"""
from __future__ import annotations

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
