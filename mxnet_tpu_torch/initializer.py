"""Weight initializers.

Counterpart: ``mxnet_tpu/initializer.py``, kept as its numpy half: the
same registry, the same name-suffix dispatch (``*_weight`` to the
initializer, ``*_bias`` / ``*_beta`` / ``*_moving_mean`` to zeros,
``*_gamma`` / ``*_moving_var`` to ones) and the same draws from numpy's
global generator, so one ``np.random.seed`` gives the two packages the
same weights when they initialise the same parameters in the same
order.  A bfloat16 array is filled through float32 (numpy has no
bfloat16 here).
"""
from __future__ import annotations

import json
import math
from typing import Dict

import numpy as _np
import torch

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias",
           "Load", "Mixed", "InitDesc", "register", "create"]

_REGISTRY: Dict[str, type] = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Initializer":
    if isinstance(name, Initializer):
        return name
    return _REGISTRY[name.lower()](**kwargs)


def _np_type(arr):
    """The numpy type a fill of ``arr`` is made in."""
    return _np.float32 if arr.dtype == torch.bfloat16 else arr.dtype


class InitDesc(str):
    """Arg name + attrs hint (ref: initializer.py InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self) -> str:
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr) -> None:
        if not isinstance(desc, str):
            desc = InitDesc(str(desc))
        init_attr = getattr(desc, "attrs", {}).get("__init__")
        if init_attr:
            klass, kw = json.loads(init_attr)
            create(klass, **kw)._init_weight(desc, arr)
            return
        name = str(desc)
        if name.endswith("_weight"):
            self._init_weight(name, arr)
        elif name.endswith("_bias"):
            self._init_zero(name, arr)
        elif name.endswith("_gamma"):
            self._init_one(name, arr)
        elif name.endswith("_beta"):
            self._init_zero(name, arr)
        elif name.endswith("_moving_mean") or name.endswith("_running_mean"):
            self._init_zero(name, arr)
        elif name.endswith("_moving_var") or name.endswith("_running_var"):
            self._init_one(name, arr)
        elif name.endswith("_init_h") or name.endswith("_init_c") or \
                name.endswith("_state"):
            self._init_zero(name, arr)
        else:
            self._init_default(name, arr)

    # -- specific fillers ----------------------------------------------
    def _init_zero(self, name, arr):
        arr[:] = _np.zeros(arr.shape, dtype=_np_type(arr))

    def _init_one(self, name, arr):
        arr[:] = _np.ones(arr.shape, dtype=_np_type(arr))

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        self._init_weight(name, arr)

    def __eq__(self, other):
        return type(self) is type(other) and self._kwargs == other._kwargs


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = _np.zeros(arr.shape, dtype=_np_type(arr))


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = _np.ones(arr.shape, dtype=_np_type(arr))


# both spellings, as the reference ("zeros" in Gluon layer defaults)
_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        arr[:] = _np.full(arr.shape, self.value, dtype=_np_type(arr))


@register
class Uniform(Initializer):
    """U(-scale, scale) (ref: initializer.py Uniform)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr[:] = _np.random.uniform(-self.scale, self.scale,
                                    arr.shape).astype(_np_type(arr))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr[:] = _np.random.normal(0, self.sigma,
                                   arr.shape).astype(_np_type(arr))


@register
class Xavier(Initializer):
    """ref: initializer.py Xavier — gaussian/uniform over fan in/out/avg."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError("Xavier requires ndim >= 2 (got %s for %s)"
                             % (shape, name))
        if len(shape) > 2:
            hw_scale = _np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[:] = _np.random.uniform(-scale, scale,
                                        shape).astype(_np_type(arr))
        else:
            arr[:] = _np.random.normal(0, scale, shape).astype(_np_type(arr))


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = _np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = _np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == (nout, nin) else v
        arr[:] = (self.scale * res.reshape(arr.shape)).astype(_np_type(arr))


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernels (ref: initializer.py Bilinear)."""

    def _init_weight(self, name, arr):
        weight = _np.zeros(arr.shape, dtype="float32")
        f = _np.ceil(arr.shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(_np.prod(arr.shape))):
            x = i % arr.shape[3]
            y = (i // arr.shape[3]) % arr.shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight.astype(_np_type(arr))


@register
class LSTMBias(Initializer):
    """Forget-gate bias init (ref: initializer.py LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = _np.zeros(arr.shape, dtype=_np_type(arr))
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = b


class Load:
    """Init from saved dict with fallback (ref: initializer.py Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = default_init

    def __call__(self, name, arr):
        if name in self.param:
            self.param[name].copyto(arr)
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise ValueError("Load: no init for %r" % name)


class Mixed:
    """Pattern-matched initializer list (ref: initializer.py Mixed)."""

    def __init__(self, patterns, initializers):
        import re

        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise ValueError("Mixed: no matching pattern for %r" % name)
