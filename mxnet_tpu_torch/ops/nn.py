"""Neural-network ops — this slice ports the softmax pair only.

Counterpart: ``mxnet_tpu/ops/nn.py`` (``softmax``/``log_softmax`` at
:260-269, which the ``NDArray`` methods call).  The rest of that module
(FullyConnected, Convolution, Pooling, BatchNorm, ...) is queued for the
ResNet path.
"""
from __future__ import annotations

import torch

from .registry import register


@register("softmax")
def _softmax(data, axis=-1, temperature=None, **_):
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def _log_softmax(data, axis=-1, temperature=None, **_):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)
