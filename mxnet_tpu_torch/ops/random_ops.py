"""Random samplers: uniform, normal and randint.

Counterpart: ``mxnet_tpu/ops/random_ops.py`` (``_random_uniform``,
``_random_normal``, ``_random_randint`` at :17-24 and :61-63, with their
aliases).  Each body takes the device's ``torch.Generator`` as its first
argument (``rng=True``), which ``nd.invoke`` passes in place of the JAX
package's PRNG key.  The other samplers of that module (gamma,
exponential, Poisson, the negative binomials, multinomial, the
per-row ``_sample_*`` ops and ``_shuffle``) are queued.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


@register("_random_uniform", aliases=("uniform", "random_uniform"),
          rng=True, nondiff=True)
def _uniform(key, low=0.0, high=1.0, shape=(), dtype="float32", **_):
    u = torch.rand(shape, generator=key, device=key.device,
                   dtype=torch_dtype(dtype))
    return u * (high - low) + low


@register("_random_normal", aliases=("normal", "random_normal"), rng=True,
          nondiff=True)
def _normal(key, loc=0.0, scale=1.0, shape=(), dtype="float32", **_):
    z = torch.randn(shape, generator=key, device=key.device,
                    dtype=torch_dtype(dtype))
    return loc + scale * z


@register("_random_randint", aliases=("random_randint",), rng=True,
          nondiff=True)
def _randint(key, low=0, high=1, shape=(), dtype="int32", **_):
    return torch.randint(int(low), int(high), shape, generator=key,
                         device=key.device, dtype=torch_dtype(dtype))
