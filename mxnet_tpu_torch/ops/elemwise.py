"""Elementwise unary/binary/scalar operators.

Counterpart: ``mxnet_tpu/ops/elemwise.py`` — the same names, aliases
(with those that the JAX package adds from ``ops/extra.py``) and
semantics (the JAX bodies' numpy conventions: ``mod`` takes the
divisor's sign, ``round``/``rint`` round half to even, comparisons
return the lhs dtype).  Every body is plain PyTorch.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "exp": torch.exp,
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "square": torch.square,
    "reciprocal": lambda x: 1.0 / x,
    "abs": torch.abs,
    "sign": torch.sign,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "round": torch.round,
    "rint": torch.round,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "relu": torch.relu,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

for _name, _f in _UNARY.items():
    register(_name)((lambda f: (lambda data, **_: f(data)))(_f))

register("negative", aliases=("_np_negative",))(lambda data, **_: -data)
register("identity", aliases=("_copy", "_CrossDeviceCopy"))(
    lambda data, **_: data)
register("_identity_with_attr_like_rhs")(lambda lhs, rhs, **_: lhs)
register("zeros_like")(lambda data, **_: torch.zeros_like(data))
register("ones_like")(lambda data, **_: torch.ones_like(data))
register("shape_array", nondiff=True)(
    lambda data, **_: torch.tensor(data.shape, dtype=torch.int64,
                                   device=data.device))
register("size_array", nondiff=True)(
    lambda data, **_: torch.tensor(data.numel(), dtype=torch.int64,
                                   device=data.device))
register("stop_gradient", aliases=("BlockGrad",))(
    lambda data, **_: data.detach())


class _MakeLoss(torch.autograd.Function):
    """ref: src/operator/make_loss-inl.h — forward is identity; backward
    IGNORES the incoming gradient (loss head) and emits grad_scale / N,
    where N is the batch size ('batch') or the count of elements above
    valid_thresh ('valid')."""

    @staticmethod
    def forward(ctx, data, grad_scale, normalization, valid_thresh):
        ctx.save_for_backward(data)
        ctx.params = (grad_scale, normalization, valid_thresh)
        return data.clone()

    @staticmethod
    def backward(ctx, _grad):
        (data,) = ctx.saved_tensors
        grad_scale, normalization, valid_thresh = ctx.params
        scale = grad_scale
        if normalization == "valid":
            nvalid = torch.clamp(
                torch.sum((data > valid_thresh).to(data.dtype)), min=1.0)
            return torch.full_like(data, scale) / nvalid, None, None, None
        if normalization == "batch":
            scale = scale / data.shape[0]
        return torch.full_like(data, scale), None, None, None


@register("make_loss", aliases=("MakeLoss",))
def _make_loss(data, grad_scale=1.0, normalization="null",
               valid_thresh=0.0, **_):
    return _MakeLoss.apply(data, float(grad_scale), str(normalization),
                           float(valid_thresh))


@register("Cast", aliases=("cast",))
def _cast(data, dtype="float32", **_):
    return data.to(torch_dtype(dtype))


@register("amp_cast")
def _amp_cast(data, dtype="float32", **_):
    return data.to(torch_dtype(dtype))


@register("clip")
def _clip(data, a_min=None, a_max=None, **_):
    if a_min is None and a_max is None:
        return data
    return torch.clamp(data, a_min, a_max)


# ---------------------------------------------------------------------------
# binary (elementwise, same-shape) + broadcast forms share one body:
# torch broadcasting covers both
# ---------------------------------------------------------------------------
_BINARY = {
    "add": (torch.add, ("elemwise_add", "_plus", "_add", "broadcast_add",
                        "broadcast_plus", "_grad_add")),
    "sub": (torch.sub, ("elemwise_sub", "_minus", "_sub", "broadcast_sub",
                        "broadcast_minus")),
    "mul": (torch.mul, ("elemwise_mul", "_mul", "broadcast_mul")),
    "div": (torch.div, ("elemwise_div", "_div", "broadcast_div")),
    "mod": (torch.remainder, ("_mod", "broadcast_mod")),
    "pow": (torch.pow, ("_power", "_pow", "broadcast_power")),
    "maximum": (torch.maximum, ("_maximum", "broadcast_maximum")),
    "minimum": (torch.minimum, ("_minimum", "broadcast_minimum")),
    "hypot": (torch.hypot, ("_hypot", "broadcast_hypot")),
    "arctan2": (torch.atan2, ("_arctan2", "broadcast_arctan2")),
}
for _name, (_f, _aliases) in _BINARY.items():
    register("_binary_" + _name, aliases=_aliases)(
        (lambda f: (lambda lhs, rhs, **_: f(lhs, rhs)))(_f))

_CMP = {
    "equal": (torch.eq, ("_equal", "broadcast_equal")),
    "not_equal": (torch.ne, ("_not_equal", "broadcast_not_equal")),
    "greater": (torch.gt, ("_greater", "broadcast_greater")),
    "greater_equal": (torch.ge, ("_greater_equal",
                                 "broadcast_greater_equal")),
    "lesser": (torch.lt, ("_lesser", "broadcast_lesser")),
    "lesser_equal": (torch.le, ("_lesser_equal", "broadcast_lesser_equal")),
}
for _name, (_f, _aliases) in _CMP.items():
    register("_cmp_" + _name, aliases=_aliases, nondiff=True)(
        (lambda f: (lambda lhs, rhs, **_: f(lhs, rhs).to(lhs.dtype)))(_f))

for _name, _f in {"logical_and": torch.logical_and,
                  "logical_or": torch.logical_or,
                  "logical_xor": torch.logical_xor}.items():
    register("_logical_op_" + _name,
             aliases=("_" + _name, "broadcast_" + _name), nondiff=True)(
        (lambda f: (lambda lhs, rhs, **_:
                    f(lhs != 0, rhs != 0).to(lhs.dtype)))(_f))


# ---------------------------------------------------------------------------
# scalar forms (ref: elemwise_binary_scalar_op_basic.cc); the scalar is
# a Python number, so the tensor's dtype wins as with jnp's weak types
# ---------------------------------------------------------------------------
def _like(x, s):
    return torch.full((), s, dtype=x.dtype, device=x.device)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, _like(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _like(x, s)),
    "_hypot_scalar": lambda x, s: torch.hypot(x, _like(x, s)),
}
# the JAX package adds these aliases from ops/extra.py
_SCALAR_ALIASES = {"_plus_scalar": ("_scatter_plus_scalar",),
                   "_minus_scalar": ("_scatter_minus_scalar",)}
for _name, _f in _SCALAR.items():
    register(_name, aliases=_SCALAR_ALIASES.get(_name, ()))(
        (lambda f: (lambda data, scalar=0.0, **_: f(data, scalar)))(_f))

_SCALAR_CMP = {
    "_equal_scalar": torch.eq,
    "_not_equal_scalar": torch.ne,
    "_greater_scalar": torch.gt,
    "_greater_equal_scalar": torch.ge,
    "_lesser_scalar": torch.lt,
    "_lesser_equal_scalar": torch.le,
}
for _name, _f in _SCALAR_CMP.items():
    register(_name, nondiff=True)(
        (lambda f: (lambda data, scalar=0.0, **_:
                    f(data, scalar).to(data.dtype)))(_f))


@register("smooth_l1")
def _smooth_l1(data, scalar=1.0, **_):
    # ref: mshadow_op.h smooth_l1_loss — sigma^2 parameterisation
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2, 0.5 * s2 * data * data,
                       torch.abs(data) - 0.5 / s2)


@register("where")
def _where(condition, x, y, **_):
    return torch.where(condition != 0, x, y)


@register("_scatter_elemwise_div")
def _scatter_div(lhs, rhs, **_):
    return lhs / rhs


# add_n: variadic sum (ref: src/operator/tensor/elemwise_sum.cc)
@register("add_n", aliases=("ElementWiseSum", "_sum_nary"))
def _add_n(*args, **_):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out
