"""Gluon Parameter / ParameterDict.

Counterpart: ``mxnet_tpu/gluon/parameter.py`` (ref:
python/mxnet/gluon/parameter.py: Parameter, deferred init, ParameterDict,
save/load).  Shape-0 dims defer initialisation until the first forward
infers them; ``grad_req`` drives autograd attachment; ``lr_mult`` /
``wd_mult`` reach the optimizer through ``Trainer``; the save format is
the NDArray container keyed by parameter name.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as _np
import torch

from .. import autograd, initializer as _init
from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..ndarray import NDArray, array as nd_array, zeros as nd_zeros

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """ref: gluon/parameter.py DeferredInitializationError."""


class Parameter:
    """ref: gluon/parameter.py Parameter."""

    def __init__(self, name, grad_req="write", shape=None, dtype=_np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._data: Optional[NDArray] = None
        self._grad: Optional[NDArray] = None
        self._deferred_init: Optional[Tuple] = None
        self._ctx_list: Optional[List[Context]] = None

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        self._grad_req = req
        if self._data is not None:
            if req == "null":
                self._grad = None
                self._data._grad = None
            else:
                self._attach_grad()

    def _shape_complete(self) -> bool:
        return self.shape is not None and all(s > 0 for s in self.shape)

    # -- initialization -------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=_init.Uniform(),
                   force_reinit=False):
        """ref: parameter.py initialize — defers when the shape is
        unknown.  ``ctx`` defaults to the current context, the card."""
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        self._ctx_list = list(ctx)
        init = init if init is not None else (
            self.init if self.init is not None else default_init)
        if not self._shape_complete():
            if self.allow_deferred_init:
                # resolve the device now: a missing card raises here,
                # not at the first forward
                self._ctx_list[0].torch_device()
                self._deferred_init = (init, list(ctx))
                return
            raise ValueError(
                "cannot initialize parameter %s of unknown shape %s without "
                "allow_deferred_init" % (self.name, self.shape))
        self._finish_init(init, ctx)

    def _finish_init(self, init, ctx_list):
        ctx = ctx_list[0]
        data = nd_zeros(self.shape, ctx=ctx, dtype=self.dtype)
        initializer = init if not isinstance(init, str) else \
            _init.create(init)
        # a per-param ``self.init`` bypasses the name-suffix dispatch
        explicit = self.init is not None
        if explicit and hasattr(initializer, "_init_weight"):
            initializer._init_weight(_init.InitDesc(self.name), data)
        else:
            initializer(_init.InitDesc(self.name), data)
        self._data = data
        self._deferred_init = None
        if self._grad_req != "null":
            self._attach_grad()

    def _attach_grad(self):
        self._grad = NDArray.from_raw(
            torch.zeros_like(self._data._data.detach()), self._data.ctx)
        autograd.mark_variables([self._data], [self._grad], self._grad_req)

    def _finish_deferred_init(self, inferred_shape: Tuple[int, ...]):
        if self._deferred_init is None:
            raise DeferredInitializationError(self.name)
        if self.shape is not None and len(self.shape) == len(inferred_shape):
            merged = tuple(s if s > 0 else i
                           for s, i in zip(self.shape, inferred_shape))
        else:
            merged = tuple(inferred_shape)
        self.shape = merged
        init, ctx = self._deferred_init
        self._finish_init(init, ctx)

    # -- access ---------------------------------------------------------
    def data(self, ctx: Optional[Context] = None) -> NDArray:
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "parameter %s deferred; forward once or provide "
                    "in_units" % self.name)
            raise RuntimeError("parameter %s not initialized — call "
                               ".initialize()" % self.name)
        return self._data

    def list_data(self):
        return [self.data()]

    def grad(self, ctx: Optional[Context] = None) -> NDArray:
        if self._grad is None:
            raise RuntimeError("parameter %s has no gradient (grad_req=%r)"
                               % (self.name, self._grad_req))
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return list(self._ctx_list or [])

    def set_data(self, data):
        if self._data is None:
            if self._deferred_init is not None:
                self.shape = tuple(data.shape)
                init, ctx = self._deferred_init
                self._finish_init(init, ctx)
            else:
                raise RuntimeError("parameter %s not initialized"
                                   % self.name)
        if isinstance(data, NDArray):
            data.copyto(self._data)
        else:
            self._data[:] = data

    def zero_grad(self):
        if self._grad is not None:
            self._grad[:] = 0

    def var(self):
        """The symbol variable of this parameter (symbolic composition
        and ``HybridBlock.export``), with its shape and dtype."""
        from ..base import dtype_name
        from ..symbol import Variable

        return Variable(self.name, shape=self.shape,
                        dtype=dtype_name(self.dtype))

    def reset_ctx(self, ctx):
        pass  # one device per process in this slice

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is not None:
            self._data = self._data.astype(dtype)
            if self._grad_req != "null":
                self._attach_grad()


class Constant(Parameter):
    """Non-differentiable constant parameter (ref: parameter.py
    Constant)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd_array(value)
        self.value = value

        class _CInit(_init.Initializer):
            def _init_weight(_s, _n, arr):
                value.copyto(arr)

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_CInit())


class ParameterDict:
    """ref: gluon/parameter.py ParameterDict."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params: Dict[str, Parameter] = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        return "ParameterDict(%s)" % ", ".join(self._params)

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def get(self, name, **kwargs) -> Parameter:
        """Create-or-fetch by suffix name (ref: parameter.py get)."""
        name = self._prefix + name
        if name in self._params:
            param = self._params[name]
            for k, v in kwargs.items():
                if v is not None and getattr(param, k, None) is None:
                    setattr(param, k, v)
            new_shape = kwargs.get("shape")
            if new_shape is not None and param.shape is not None:
                ns = (new_shape,) if isinstance(new_shape, int) else \
                    tuple(new_shape)
                if len(ns) != len(param.shape) or any(
                        a > 0 and b > 0 and a != b
                        for a, b in zip(ns, param.shape)):
                    raise AssertionError(
                        "parameter %r already exists with shape %s, got "
                        "conflicting shape %s" % (name, param.shape, ns))
            return param
        if self._shared is not None and name in self._shared:
            self._params[name] = self._shared[name]
            return self._shared[name]
        param = Parameter(name, **kwargs)
        self._params[name] = param
        return param

    def get_constant(self, name, value=None) -> Constant:
        name = self._prefix + name
        if name in self._params:
            return self._params[name]
        c = Constant(name, value)
        self._params[name] = c
        return c

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("duplicate parameter %s" % k)
            self._params[k] = v

    def initialize(self, init=_init.Uniform(), ctx=None, verbose=False,
                   force_reinit=False):
        for param in self._params.values():
            param.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for param in self._params.values():
            param.zero_grad()

    def setattr(self, name, value):
        for param in self._params.values():
            setattr(param, name, value)

    def save(self, filename, strip_prefix=""):
        """ref: parameter.py save."""
        from ..ndarray import save as nd_save

        arg_dict = {}
        for param in self._params.values():
            name = param.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = param.data()
        nd_save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """ref: parameter.py load."""
        from ..ndarray import load as nd_load

        loaded = nd_load(filename, ctx=ctx)
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self._params:
                if name not in loaded:
                    raise MXNetError("parameter %s missing in file %s"
                                     % (name, filename))
        for name, value in loaded.items():
            if name not in self._params:
                if ignore_extra:
                    continue
                raise MXNetError("parameter %s in file not in ParameterDict"
                                 % name)
            param = self._params[name]
            if param._data is None:
                param.shape = tuple(value.shape)
                if param._deferred_init is not None:
                    init, pctx = param._deferred_init
                    param._finish_init(init, pctx)
                else:
                    param.initialize(ctx=ctx or [cpu()])
            param.set_data(value)
