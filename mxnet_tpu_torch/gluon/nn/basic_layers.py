"""Gluon basic layers.

Counterpart: ``mxnet_tpu/gluon/nn/basic_layers.py`` (ref:
python/mxnet/gluon/nn/basic_layers.py), every class of it.  Layers with
deferred shapes infer them from their first input
(``_infer_param_shapes``).
"""
from __future__ import annotations

import math

import numpy as _np

from ... import initializer as _init
from ... import remat
from ...ndarray import NDArray
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU",
           "Embedding", "Flatten", "LayerNorm", "InstanceNorm", "Lambda",
           "HybridLambda"]


class Sequential(Block):
    """ref: basic_layers.py Sequential."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock):
    """ref: basic_layers.py HybridSequential."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        if isinstance(x, NDArray) and remat.mirror_active():
            return remat.mirror_sequence(list(self._children.values()), x)
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __iter__(self):
        return iter(self._children.values())


def _channels(x, axis):
    return (x.shape[axis % len(x.shape)],)


class Dense(HybridBlock):
    """ref: basic_layers.py Dense -> FullyConnected."""

    # the mirror keeps this layer's output (remat.mirror_sequence)
    _mirror_keeps = True

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype=_np.float32, weight_initializer=None,
                 bias_initializer="zero", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._use_bias = use_bias
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=_init.create(bias_initializer)
                    if isinstance(bias_initializer, str)
                    else bias_initializer,
                    allow_deferred_init=True)
            self.act = Activation(activation, prefix=activation + "_") \
                if activation else None

    def _infer_param_shapes(self, x):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        return {"weight": (self._units, in_units)}

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               flatten=self._flatten, no_bias=bias is None)
        if self.act is not None:
            out = self.act(out)
        return out


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return str(self._act_type)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer=_init.Constant(0.25), in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(in_channels,),
                                         init=alpha_initializer,
                                         allow_deferred_init=True)

    def _infer_param_shapes(self, x):
        return {"alpha": _channels(x, 1)}

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(x * self._beta)


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = tuple(axes)

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """ref: basic_layers.py BatchNorm: the op's aux-state contract (the
    running mean/var are inputs the op updates), eps 1e-5 and
    ``fix_gamma = not scale`` (the op's own defaults are 1e-3 and
    True)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zero",
                 gamma_initializer="one", running_mean_initializer="zero",
                 running_variance_initializer="one", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}

        def _resolve(init, default):
            if init is None:
                return default
            return _init.create(init) if isinstance(init, str) else init

        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,),
                init=_resolve(gamma_initializer, _init.One()),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,),
                init=_resolve(beta_initializer, _init.Zero()),
                allow_deferred_init=True)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=_resolve(running_mean_initializer, _init.Zero()),
                allow_deferred_init=True, differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=_resolve(running_variance_initializer, _init.One()),
                allow_deferred_init=True, differentiable=False)

    def _infer_param_shapes(self, x):
        c = _channels(x, self._axis)
        return dict.fromkeys(("gamma", "beta", "running_mean",
                              "running_var"), c)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype=_np.float32,
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zero", gamma_initializer="one",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init.create(gamma_initializer),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init.create(beta_initializer),
                allow_deferred_init=True)

    def _infer_param_shapes(self, x):
        return dict.fromkeys(("gamma", "beta"), _channels(x, self._axis))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class InstanceNorm(HybridBlock):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zero", gamma_initializer="one",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init.create(gamma_initializer),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init.create(beta_initializer),
                allow_deferred_init=True)

    def _infer_param_shapes(self, x):
        return dict.fromkeys(("gamma", "beta"), _channels(x, self._axis))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class Lambda(Block):
    """ref: basic_layers.py Lambda."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as F

            function = getattr(F, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_name = function if isinstance(function, str) else None
        self._func = function

    def hybrid_forward(self, F, *args):
        if self._func_name is not None:
            return getattr(F, self._func_name)(*args)
        return self._func(F, *args)
