"""Neural-network operators.

Counterpart: ``mxnet_tpu/ops/nn.py`` lines 1-530 and ``Pad`` (:552):
FullyConnected, Convolution, Deconvolution, Pooling, Activation,
LeakyReLU, the softmax family, SoftmaxOutput, the regression outputs,
BatchNorm, LayerNorm, InstanceNorm, LRN and Dropout, under the same
names, aliases and flags, and the spatial tail (:532-688):
``UpSampling``, ``BilinearSampler``, ``GridGenerator``,
``SpatialTransformer``, ``ROIPooling``, ``Crop``, with ``CuDNNBatchNorm``
(an alias of ``BatchNorm``, ``mxnet_tpu/ops/extra.py:263``).

Where the JAX package lowers to ``lax.conv_general_dilated`` /
``jnp.dot`` and leaves them to XLA, the port calls
``torch.nn.functional.conv{1,2,3}d`` / ``conv_transpose{1,2,3}d`` (cuDNN
on the card) and ``torch.matmul`` (cuBLAS); NCHW / OIHW layout, as the
reference.  What a straight torch translation would get wrong, and
this module does not:

  * BatchNorm is not ``F.batch_norm`` (which weights the *new* stat by
    ``momentum``, keeps an unbiased running variance and defaults eps to
    1e-5): statistics are single-pass E[x], E[x²] in
    ``promote(dtype, float32)``, the variance is the biased
    ``max(E[x²]-E[x]², 0)``, ``momentum`` weights the old stat, the
    moving stats update in their own dtype, and ``output_mean_var``
    returns the inverse std;
  * Pooling pads explicitly where the reference does: ``-inf`` for max,
    the ``full`` convention's extra right padding, and an avg that
    divides by the whole kernel (``count_include_pad``) even over that
    extra padding, where torch's ``ceil_mode`` would clip the divisor;
  * SoftmaxOutput and the regression outputs are
    ``torch.autograd.Function``s whose backward ignores the incoming
    gradient, as the reference's.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .registry import alias, register

# ---------------------------------------------------------------------------
# cross-device batch semantics (sync BN / global-batch normalisation;
# ref: mxnet_tpu/ops/nn.py:47-61).  A dp train step runs its body under
# ``cross_device_batch_stats("dp", mesh)``: BatchNorm's moments become
# the global batch's (the mean over ranks of each rank's moments, equal
# per-rank batches), and SoftmaxOutput's ``batch`` / ``valid``
# normalisations divide by the global batch / valid count.  One device
# is the whole batch: no collective runs there.
# ---------------------------------------------------------------------------
_cross_device_axis: list = []


@contextlib.contextmanager
def cross_device_batch_stats(axis_name: str, mesh=None):
    """Batch-statistics ops reduce over ``axis_name`` inside: over the
    ranks of ``mesh`` (default: the whole process group)."""
    _cross_device_axis.append((str(axis_name), mesh))
    try:
        yield
    finally:
        _cross_device_axis.pop()


def _batch_stats_axis() -> Optional[str]:
    return _cross_device_axis[-1][0] if _cross_device_axis else None


def _cross_device_group():
    """``(n, process group)`` of the batch-stats axis, or None where no
    collective runs: outside the context, and on one device that is not
    a rank of a process group."""
    if not _cross_device_axis:
        return None
    axis, mesh = _cross_device_axis[-1]
    if mesh is not None:
        if axis in mesh.shape and mesh.axis_size(axis) < mesh.size:
            # a sub-axis (dp of a dp x mp mesh): the ranks of the other
            # axes hold the same rows
            n = mesh.axis_size(axis)
            return (n, mesh.axis_group(axis)) if n > 1 else None
        return (mesh.size, mesh.group) if mesh.collective or mesh.size > 1 \
            else None
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), None
    return None


class _CrossDeviceMean(torch.autograd.Function):
    """``lax.pmean`` under ``shard_map``: forward the mean over ranks
    (the sum, then divided by n); backward the all-reduce of the
    cotangent divided by n, pmean's transpose.  A plain all-reduce in
    the forward would carry no gradient across ranks."""

    @staticmethod
    def forward(ctx, t, n, group):
        import torch.distributed as dist

        ctx.n, ctx.group = n, group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


def _cross_device_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks of the batch-stats axis (``t``
    itself on one device), differentiable as pmean."""
    axis = _cross_device_group()
    return t if axis is None else _CrossDeviceMean.apply(t, *axis)


def _cross_device_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the batch-stats axis (``psum``
    of a count: no gradient)."""
    axis = _cross_device_group()
    if axis is None:
        return t
    import torch.distributed as dist

    out = t.clone()
    dist.all_reduce(out, group=axis[1])
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _tup(v, n, default=None):
    if v is None or v == ():
        v = (default,) * n
    if isinstance(v, int):
        v = (v,) * n
    v = tuple(int(x) for x in v)
    if len(v) < n:
        v = v + (v[-1],) * (n - len(v))
    return v


def _channel_shape(t: torch.Tensor, nd: int):
    return t.reshape((1, -1) + (1,) * nd)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


# ---------------------------------------------------------------------------
# FullyConnected (ref: src/operator/fully_connected.cc)
# ---------------------------------------------------------------------------
@register("FullyConnected", aliases=("fully_connected",),
          input_names=("data", "weight", "bias"))
def _fully_connected(data, weight, *maybe_bias, num_hidden=0, no_bias=False,
                     flatten=True, **_):
    x = data.reshape(data.shape[0], -1) if flatten else data
    # weight: (num_hidden, input_dim), the reference's layout
    out = torch.matmul(x, weight.t())
    if not no_bias and maybe_bias:
        out = out + maybe_bias[0]
    return out


# ---------------------------------------------------------------------------
# Convolution / Deconvolution (NCHW / OIHW, the reference's default)
# ---------------------------------------------------------------------------
@register("Convolution", aliases=("convolution", "Convolution_v1"),
          input_names=("data", "weight", "bias"))
def _convolution(data, weight, *maybe_bias, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, no_bias=False,
                 workspace=1024, layout=None, cudnn_tune=None,
                 cudnn_off=False, **_):
    nd = len(kernel)
    bias = maybe_bias[0] if (not no_bias and maybe_bias) else None
    return _CONV[nd](data, weight, bias, stride=_tup(stride, nd, 1),
                     padding=_tup(pad, nd, 0),
                     dilation=_tup(dilate, nd, 1), groups=num_group)


@register("Deconvolution", aliases=("deconvolution",),
          input_names=("data", "weight", "bias"))
def _deconvolution(data, weight, *maybe_bias, kernel=(), stride=(),
                   dilate=(), pad=(), adj=(), target_shape=(), num_filter=0,
                   num_group=1, no_bias=True, workspace=1024, layout=None,
                   **_):
    """The transposed convolution: the lhs-dilated convolution with the
    flipped kernel and padding ``(ke-1-p, ke-1-p+adj)`` of the JAX
    package, which is ``conv_transpose`` with ``output_padding=adj``.
    Weight layout ``(C_in, F/groups, *k)``."""
    nd = len(kernel)
    stride, dilate = _tup(stride, nd, 1), _tup(dilate, nd, 1)
    pad, adj = _tup(pad, nd, 0), _tup(adj, nd, 0)
    bias = maybe_bias[0] if (not no_bias and maybe_bias) else None
    if all(a < max(s, d) for a, s, d in zip(adj, stride, dilate)):
        return _CONV_T[nd](data, weight, bias, stride=stride, padding=pad,
                           output_padding=adj, groups=num_group,
                           dilation=dilate)
    # torch refuses output_padding >= max(stride, dilation): the extra
    # rows take the explicit route (ref: ops/nn.py:140-158)
    n, c = data.shape[:2]
    spatial = data.shape[2:]
    dil_shape = tuple((s - 1) * st + 1 for s, st in zip(spatial, stride))
    x = data.new_zeros((n, c) + dil_shape)
    x[(slice(None), slice(None)) + tuple(slice(None, None, st)
                                         for st in stride)] = data
    k_eff = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilate)]
    pads = []
    for ke, p, a in reversed(list(zip(k_eff, pad, adj))):
        pads += [ke - 1 - p, ke - 1 - p + a]
    x = F.pad(x, pads)
    g, (c_in, f_g), k = num_group, weight.shape[:2], weight.shape[2:]
    # (C_in, F/g, k) -> (F, C_in/g, k), group by group, kernel flipped
    w = weight.flip(tuple(range(2, 2 + nd))).reshape((g, c_in // g, f_g)
                                                     + tuple(k))
    w = w.transpose(1, 2).reshape((g * f_g, c_in // g) + tuple(k))
    return _CONV[nd](x, w, bias, dilation=dilate, groups=g)


# ---------------------------------------------------------------------------
# Pooling (ref: src/operator/nn/pooling.cc; max/avg/sum, valid|full,
# global_pool, count_include_pad)
# ---------------------------------------------------------------------------
def _sum_pool(x, kernel, stride):
    """Window sums: avg pooling with divisor 1 over an already padded
    input (1-D goes through the 2-D op)."""
    nd = x.ndim - 2
    if nd == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + tuple(kernel),
                            (1,) + tuple(stride),
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


@register("Pooling", aliases=("pooling", "Pooling_v1"))
def _pooling(data, kernel=(), pool_type="max", global_pool=False,
             pooling_convention="valid", stride=(), pad=(),
             count_include_pad=True, cudnn_off=False, **_):
    nd = data.ndim - 2
    if global_pool:
        kernel = tuple(data.shape[2:])
        stride = (1,) * nd
        pad = (0,) * nd
    else:
        kernel = _tup(kernel, nd, 1)
        stride = _tup(stride, nd, 1)
        pad = _tup(pad, nd, 0)
    # pooling_convention="full" (ceil) adds extra right padding
    extra = [0] * nd
    if pooling_convention == "full" and not global_pool:
        for i in range(nd):
            r = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if r:
                extra[i] = stride[i] - r
    if pool_type == "max":
        pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd]
        if not any(extra) and all(2 * p <= k for p, k in zip(pad, kernel)):
            # torch's implicit padding is -inf, as the reference's
            return pool(data, kernel, stride, padding=pad)
        pads = []
        for p, e in reversed(list(zip(pad, extra))):
            pads += [p, p + e]
        return pool(F.pad(data, pads, value=-math.inf), kernel, stride)
    if pool_type not in ("avg", "sum"):
        raise ValueError("unsupported pool_type %r" % pool_type)
    pads = []
    for p, e in reversed(list(zip(pad, extra))):
        pads += [p, p + e]
    padded = F.pad(data, pads) if any(pads) else data
    total = _sum_pool(padded, kernel, stride)
    if pool_type == "sum":
        return total
    if count_include_pad:
        return total / float(math.prod(kernel))
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    counts = _sum_pool(F.pad(ones, pads) if any(pads) else ones, kernel,
                       stride)
    return total / torch.clamp(counts, min=1.0)


# ---------------------------------------------------------------------------
# Activation / LeakyReLU (ref: src/operator/activation.cc, leaky_relu.cc)
# ---------------------------------------------------------------------------
@register("Activation", aliases=("activation",))
def _activation(data, act_type="relu", **_):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        # jax.nn.softplus = logaddexp(x, 0), without torch's threshold
        return torch.logaddexp(data, torch.zeros_like(data))
    if act_type == "softsign":
        return data / (1.0 + torch.abs(data))
    raise ValueError("unknown act_type %r" % act_type)


@register("LeakyReLU", input_names=("data", "gamma"))
def _leaky_relu(data, *maybe_gamma, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, **_):
    pos = data >= 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        gamma = maybe_gamma[0]
        g = _channel_shape(gamma, data.ndim - 2) if data.ndim > 1 else gamma
        return torch.where(pos, data, g * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(pos, data, alpha * torch.expm1(data))
    if act_type == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(data, approximate="tanh")
    if act_type == "rrelu":
        # eval-mode slope: the mean of the training range
        return torch.where(pos, data,
                           0.5 * (lower_bound + upper_bound) * data)
    raise ValueError("unknown act_type %r" % act_type)


# ---------------------------------------------------------------------------
# softmax family (ref: src/operator/nn/softmax.cc).  On the card torch
# accumulates a bf16 log_softmax in float32 where jax.nn.log_softmax works
# in the input type (ROADMAP C); they agree at float32 and float64.
# ---------------------------------------------------------------------------
@register("softmax")
def _softmax(data, axis=-1, temperature=None, **_):
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def _log_softmax(data, axis=-1, temperature=None, **_):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


@register("softmin")
def _softmin(data, axis=-1, **_):
    return torch.softmax(-data, dim=axis)


@register("SoftmaxActivation")
def _softmax_activation(data, mode="instance", **_):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


# ---------------------------------------------------------------------------
# SoftmaxOutput — softmax forward, the reference's hardwired CE gradient
# (ref: src/operator/softmax_output-inl.h; backward ignores the incoming
# gradient)
# ---------------------------------------------------------------------------
class _SoftmaxOutputFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, cfg):
        grad_scale, ignore_label, multi_output, use_ignore, \
            preserve_shape, normalization, smooth_alpha = cfg
        if multi_output:
            prob = torch.softmax(data, dim=1)
        elif preserve_shape:
            prob = torch.softmax(data, dim=-1)
        else:
            prob = torch.softmax(data.reshape(data.shape[0], -1),
                                 dim=-1).reshape(data.shape)
        ctx.cfg = cfg
        ctx.save_for_backward(prob, label)
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        grad_scale, ignore_label, multi_output, use_ignore, \
            preserve_shape, normalization, smooth_alpha = ctx.cfg
        if multi_output:
            # label may arrive flat (N, prod(spatial)), as the reference
            # accepts
            lab = label.to(torch.int64).reshape((prob.shape[0],)
                                                + prob.shape[2:])
            onehot = _one_hot(lab, prob.shape[1], prob.dtype).movedim(-1, 1)
            grad = prob - onehot
            if use_ignore:
                grad = grad * (lab != int(ignore_label)).to(
                    prob.dtype).unsqueeze(1)
        else:
            flat = (prob.reshape(-1, prob.shape[-1]) if preserve_shape
                    else prob.reshape(prob.shape[0], -1))
            lab = label.reshape(-1).to(torch.int64)
            onehot = _one_hot(lab, flat.shape[-1], prob.dtype)
            if smooth_alpha:
                k = flat.shape[-1]
                onehot = onehot * (1.0 - smooth_alpha) + \
                    smooth_alpha / (k - 1) * (1.0 - onehot)
            grad = flat - onehot
            if use_ignore:
                grad = grad * (lab != int(ignore_label)).to(
                    prob.dtype)[:, None]
            grad = grad.reshape(prob.shape)
        scale = grad_scale
        if normalization == "batch":
            # per-rank program: normalise by the GLOBAL batch
            axis = _cross_device_group()
            scale = scale / (prob.shape[0] * (1 if axis is None
                                               else axis[0]))
        elif normalization == "valid" and use_ignore:
            nvalid = (label.reshape(-1).to(torch.int64)
                      != int(ignore_label)).sum()
            nvalid = torch.clamp(_cross_device_sum(nvalid), min=1)
            grad = grad * (1.0 / nvalid.to(prob.dtype))
        return grad * scale, _zero_grad(ctx, label), None


def _zero_grad(ctx, label):
    # the label gets a zero gradient, where it takes one at all
    return torch.zeros_like(label) if ctx.needs_input_grad[1] else None


def _one_hot(idx, depth, dtype):
    # out-of-range indices give all-zero rows, as jax.nn.one_hot
    valid = (idx >= 0) & (idx < depth)
    oh = F.one_hot(torch.where(valid, idx, 0), depth).to(dtype)
    return oh * valid.unsqueeze(-1).to(dtype)


@register("SoftmaxOutput", aliases=("softmax_output", "Softmax"))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0, **_):
    cfg = (float(grad_scale), float(ignore_label), bool(multi_output),
           bool(use_ignore), bool(preserve_shape), str(normalization),
           float(smooth_alpha))
    return _SoftmaxOutputFn.apply(data, label, cfg)


# ---------------------------------------------------------------------------
# regression outputs (ref: src/operator/regression_output.cc): forward
# identity/sigmoid, backward (pred - label) * scale / (label size per row)
# ---------------------------------------------------------------------------
class _RegressionFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, link, grad_fn, grad_scale):
        out = link(data)
        ctx.grad_fn, ctx.grad_scale = grad_fn, grad_scale
        ctx.save_for_backward(out, label)
        return out

    @staticmethod
    def backward(ctx, g):
        pred, label = ctx.saved_tensors
        n = label.numel() // label.shape[0] if label.ndim else 1
        grad = ctx.grad_fn(pred, label.reshape(pred.shape)) * \
            (ctx.grad_scale / n)
        return grad, _zero_grad(ctx, label), None, None, None


def _make_regression(name, link, grad_fn):
    @register(name, aliases=(_snake(name),))
    def op(data, label, grad_scale=1.0, **_):
        return _RegressionFn.apply(data, label, link, grad_fn,
                                   float(grad_scale))

    return op


def _snake(name):
    out = []
    for i, c in enumerate(name):
        if c.isupper() and i and not name[i - 1].isupper():
            out.append("_")
        out.append(c.lower())
    return "".join(out)


_make_regression("LinearRegressionOutput", lambda x: x, lambda p, l: p - l)
_make_regression("LogisticRegressionOutput", torch.sigmoid,
                 lambda p, l: p - l)
_make_regression("MAERegressionOutput", lambda x: x,
                 lambda p, l: torch.sign(p - l))


# ---------------------------------------------------------------------------
# BatchNorm (ref: src/operator/batch_norm.cc + nn/batch_norm.cc)
# inputs: data, gamma, beta, moving_mean, moving_var (aux, mutated)
# outputs: out [, batch_mean, batch_inv_std] + aux writebacks
# ---------------------------------------------------------------------------
@register("BatchNorm", aliases=("batch_norm", "BatchNorm_v1"),
          mutate_aux=(3, 4), train_aware=True,
          input_names=("data", "gamma", "beta", "moving_mean",
                       "moving_var"))
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                _training=True, **_):
    ax = axis % data.ndim
    reduce_axes = tuple(i for i in range(data.ndim) if i != ax)
    bshape = tuple(data.shape[i] if i == ax else 1 for i in range(data.ndim))

    g = torch.ones_like(gamma) if fix_gamma else gamma
    mm, mv = moving_mean.detach(), moving_var.detach()
    acc_t = torch.promote_types(data.dtype, torch.float32)
    if _training and not use_global_stats:
        # single pass: E[x] and E[x²] in one read of the activation, in
        # promote(dtype, float32); the variance is the biased one
        xf = data.to(acc_t)
        mean32 = torch.mean(xf, dim=reduce_axes)
        ex2 = torch.mean(xf * xf, dim=reduce_axes)
        if _batch_stats_axis() is not None:
            # sync BN: equal per-rank batches make the mean over ranks of
            # the local moments the global batch's; E[x] and E[x²] of a
            # layer ride one collective
            mean32, ex2 = _cross_device_mean(
                torch.stack([mean32, ex2])).unbind(0)
        var32 = torch.clamp(ex2 - mean32 * mean32, min=0.0)
        # momentum weights the OLD stat; the update runs in the stats'
        # own dtype (bf16 after a cast)
        new_mm = mm * momentum + \
            mean32.detach().to(mm.dtype) * (1.0 - momentum)
        new_mv = mv * momentum + \
            var32.detach().to(mv.dtype) * (1.0 - momentum)
    else:
        mean32, var32 = mm.to(acc_t), mv.to(acc_t)
        new_mm, new_mv = mm, mv
    # the normalisation folded into a per-channel scale and shift: the
    # activation is touched once (x * scale + shift)
    inv32 = torch.rsqrt(var32 + eps)
    scale = g.to(inv32.dtype) * inv32
    shift = beta.to(inv32.dtype) - mean32 * scale
    out = data * scale.reshape(bshape).to(data.dtype) + \
        shift.reshape(bshape).to(data.dtype)
    if output_mean_var:
        return (out, mean32.to(data.dtype), inv32.to(data.dtype),
                new_mm, new_mv)
    return out, new_mm, new_mv


@register("LayerNorm", aliases=("layer_norm",))
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
                **_):
    mean = torch.mean(data, dim=axis, keepdim=True)
    var = torch.mean(torch.square(data - mean), dim=axis, keepdim=True)
    inv = torch.rsqrt(var + eps)
    ax = axis % data.ndim
    bshape = tuple(data.shape[i] if i == ax else 1 for i in range(data.ndim))
    out = (data - mean) * inv * gamma.reshape(bshape) + beta.reshape(bshape)
    if output_mean_var:
        return out, mean.squeeze(ax), inv.squeeze(ax)
    return out


@register("InstanceNorm", aliases=("instance_norm",))
def _instance_norm(data, gamma, beta, eps=1e-3, **_):
    axes = tuple(range(2, data.ndim))
    mean = torch.mean(data, dim=axes, keepdim=True)
    var = torch.mean(torch.square(data - mean), dim=axes, keepdim=True)
    nd = data.ndim - 2
    return (data - mean) * torch.rsqrt(var + eps) * \
        _channel_shape(gamma, nd) + _channel_shape(beta, nd)


@register("LRN", aliases=("lrn",))
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **_):
    # ref: src/operator/lrn.cc — cross-channel normalisation
    sq = torch.square(data)
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    window = torch.zeros_like(sq)
    for i in range(nsize):
        window = window + padded[:, i:i + data.shape[1]]
    return data / torch.pow(knorm + (alpha / nsize) * window, beta)


# ---------------------------------------------------------------------------
# Dropout (ref: src/operator/dropout.cc; draws, identity at inference)
# ---------------------------------------------------------------------------
@register("Dropout", aliases=("dropout",), rng=True, train_aware=True)
def _dropout(key, data, p=0.5, mode="training", axes=(), _training=True,
             **_):
    if not _training and mode != "always":
        return data
    if p <= 0.0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.bernoulli(torch.full(shape, keep, device=data.device),
                           generator=key).to(data.dtype) / keep
    return data * mask


# ---------------------------------------------------------------------------
# Pad (ref: src/operator/pad.cc; mxnet_tpu/ops/nn.py:552), for
# ReflectionPad2D
# ---------------------------------------------------------------------------
@register("Pad", aliases=("pad",))
def _pad(data, mode="constant", pad_width=(), constant_value=0.0, **_):
    pads = []
    for i in reversed(range(len(pad_width) // 2)):
        pads += [int(pad_width[2 * i]), int(pad_width[2 * i + 1])]
    if mode == "constant":
        return F.pad(data, pads, value=constant_value)
    if mode in ("edge", "reflect"):
        # torch pads only the trailing (spatial) dims in these modes
        lead = 2 * (data.ndim - 2)
        if any(pads[lead:]):
            raise ValueError("Pad mode %r pads only the spatial axes" % mode)
        return F.pad(data, pads[:lead],
                     mode="replicate" if mode == "edge" else "reflect")
    raise ValueError("unknown pad mode %r" % mode)


# ---------------------------------------------------------------------------
# the spatial tail (ref: src/operator/upsampling.cc, bilinear_sampler.cc,
# grid_generator.cc, spatial_transformer.cc, roi_pooling.cc, crop.cc;
# mxnet_tpu/ops/nn.py:532-688)
# ---------------------------------------------------------------------------
alias("BatchNorm", "CuDNNBatchNorm")  # the cuDNN variant: the same math


def _nearest_up(x, s):
    return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)


@register("UpSampling")
def _upsampling(*args, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512, **_):
    """``nearest`` repeats each pixel ``scale`` times a side (further
    inputs scaled to the first's size and concatenated on channels);
    ``bilinear`` resizes with half-pixel centres, edge pixels repeated
    (``jax.image.resize``'s bilinear; the weight input is not read)."""
    data = args[0]
    scale = int(scale)
    if sample_type == "nearest":
        out = _nearest_up(data, scale)
        if num_args > 1 and multi_input_mode == "concat":
            outs = [out] + [_nearest_up(a, out.shape[2] // a.shape[2])
                            for a in args[1:]]
            return torch.cat(outs, dim=1)
        return out
    if sample_type == "bilinear":
        n, c, h, w = data.shape
        return F.interpolate(data, size=(h * scale, w * scale),
                             mode="bilinear", align_corners=False)
    raise ValueError("unknown sample_type %r" % sample_type)


@register("BilinearSampler")
def _bilinear_sampler(data, grid, **_):
    """Sample ``data`` (n, c, h, w) at ``grid`` (n, 2, gh, gw) of (x, y)
    in [-1, 1] (corners at -1 and 1), zero outside."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    x1 = x0 + 1
    y0 = torch.floor(gy)
    y1 = y0 + 1
    wx1 = gx - x0
    wx0 = 1.0 - wx1
    wy1 = gy - y0
    wy0 = 1.0 - wy1
    hwc = data.permute(0, 2, 3, 1)
    bidx = torch.arange(n, device=data.device).reshape(n, 1, 1)

    def gather(yy, xx):
        yi = torch.clamp(yy, 0, h - 1).to(torch.int64)
        xi = torch.clamp(xx, 0, w - 1).to(torch.int64)
        vals = hwc[bidx, yi, xi]  # (n, gh, gw, c)
        inb = ((yy >= 0) & (yy <= h - 1) & (xx >= 0)
               & (xx <= w - 1)).to(data.dtype)
        return vals * inb[..., None]

    out = (gather(y0, x0) * (wy0 * wx0)[..., None]
           + gather(y0, x1) * (wy0 * wx1)[..., None]
           + gather(y1, x0) * (wy1 * wx0)[..., None]
           + gather(y1, x1) * (wy1 * wx1)[..., None])
    return out.permute(0, 3, 1, 2)


@register("GridGenerator")
def _grid_generator(data, transform_type="affine", target_shape=(0, 0), **_):
    """``affine``: data (n, 6) maps the target's normalised (x, y, 1)
    onto a sampling grid (n, 2, h, w); ``warp``: data (n, 2, h, w) pixel
    flow added to each pixel's position, normalised."""
    h, w = int(target_shape[0]), int(target_shape[1])
    if transform_type == "affine":
        n = data.shape[0]
        theta = data.reshape(n, 2, 3)
        kw = dict(dtype=data.dtype, device=data.device)
        ys = torch.linspace(-1.0, 1.0, h, **kw)
        xs = torch.linspace(-1.0, 1.0, w, **kw)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)],
                           dim=0).reshape(3, -1)
        out = torch.einsum("nij,jk->nik", theta, base)
        return out.reshape(n, 2, h, w)
    if transform_type == "warp":
        flow = data
        kw = dict(dtype=flow.dtype, device=flow.device)
        ys = torch.arange(flow.shape[2], **kw)
        xs = torch.arange(flow.shape[3], **kw)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        nx = (gx + flow[:, 0]) * 2.0 / max(flow.shape[3] - 1, 1) - 1.0
        ny = (gy + flow[:, 1]) * 2.0 / max(flow.shape[2] - 1, 1) - 1.0
        return torch.stack([nx, ny], dim=1)
    raise ValueError("unknown transform_type %r" % transform_type)


@register("SpatialTransformer")
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         **_):
    grid = _grid_generator(loc, transform_type="affine",
                           target_shape=target_shape)
    return _bilinear_sampler(data, grid)


@register("ROIPooling")
def _roi_pooling(data, rois, pooled_size=(0, 0), spatial_scale=1.0, **_):
    """Max pooling of each roi (R, 5) [batch, x1, y1, x2, y2] into
    (R, c, ph, pw) bins; the roi's corners scale and round half to even
    (``jnp.round``), an empty bin is 0.  Ties share the gradient
    equally, as JAX's ``max``."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    _, c, h, w = data.shape
    dev = data.device
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)
    bin_h = rh / ph
    bin_w = rw / pw
    img = data[rois[:, 0].to(torch.int64)]  # (R, c, h, w)
    ys = torch.arange(h, device=dev).to(data.dtype)
    xs = torch.arange(w, device=dev).to(data.dtype)
    neg_inf = torch.full((), -math.inf, dtype=data.dtype, device=dev)
    zero = torch.zeros((), dtype=data.dtype, device=dev)
    rows = []
    for iy in range(ph):
        my = ((ys >= torch.floor(y1 + iy * bin_h)[:, None])
              & (ys < torch.ceil(y1 + (iy + 1) * bin_h)[:, None]))
        cols = []
        for ix in range(pw):
            mx = ((xs >= torch.floor(x1 + ix * bin_w)[:, None])
                  & (xs < torch.ceil(x1 + (ix + 1) * bin_w)[:, None]))
            mask = (my[:, :, None] & mx[:, None, :])[:, None]
            val = torch.where(mask, img, neg_inf).amax(dim=(2, 3))
            cols.append(torch.where(torch.isfinite(val), val, zero))
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


@register("Crop", nondiff=False)
def _crop(*args, offset=(0, 0), h_w=(0, 0), num_args=1, center_crop=False,
          **_):
    """Crop to ``h_w``, or to the second input's spatial size (the
    reference's creator fills ``num_args`` from the inputs)."""
    data = args[0]
    if len(args) > 1 or num_args > 1:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    if center_crop:
        oy = (data.shape[2] - th) // 2
        ox = (data.shape[3] - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]
