"""Shape manipulation, indexing, ordering, and joining ops.

Counterpart: ``mxnet_tpu/ops/matrix.py``.  The reference's reshape codes
(0, -1, -2, -3, -4) resolve in Python exactly as there.  Bodies may
return views of their inputs; the NDArray layer copies any output that
shares storage with an input, so no two arrays alias.  ``dot`` and
``batch_dot`` go to ``torch.matmul``/``tensordot``, as the JAX package
leaves them to XLA.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..base import torch_dtype
from .registry import register


def infer_reshape(src_shape: Tuple[int, ...], target: Sequence[int],
                  reverse: bool = False):
    """Resolve MXNet reshape special codes (ref: matrix_op-inl.h
    ReshapeParam).

    0  -> copy this dim from source
    -1 -> infer from remaining elements
    -2 -> copy all remaining source dims
    -3 -> merge two consecutive source dims
    -4 -> split one source dim into the next two targets
    """
    src = list(src_shape)
    target = list(target)
    if reverse:
        src = src[::-1]
        target = target[::-1]
    out = []
    src_i = 0
    i = 0
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src[src_i])
            src_i += 1
        elif t == -1:
            out.append(-1)
            src_i += 1
        elif t == -2:
            out.extend(src[src_i:])
            src_i = len(src)
        elif t == -3:
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            whole = src[src_i]
            if d1 == -1:
                d1 = whole // d2
            if d2 == -1:
                d2 = whole // d1
            out.extend([d1, d2])
            src_i += 1
            i += 2
        else:
            out.append(int(t))
            src_i += 1
        i += 1
    if -1 in out:
        total = 1
        for s in src_shape:
            total *= s
        known = 1
        for s in out:
            if s != -1:
                known *= s
        out[out.index(-1)] = total // max(known, 1)
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def _reshape(data, shape=(), reverse=False, target_shape=None,
             keep_highest=False, **_):
    if not shape and target_shape:
        # legacy pre-0.9 interface: 0 in target_shape infers that dim,
        # keep_highest preserves dim 0
        tgt = list(target_shape)
        if keep_highest:
            tgt = [data.shape[0]] + tgt[1:]
        known = 1
        infer_at = None
        for i, d in enumerate(tgt):
            if d == 0 and not (keep_highest and i == 0):
                infer_at = i
            else:
                known *= d
        if infer_at is not None:
            tgt[infer_at] = data.numel() // known
        return data.reshape(tuple(tgt))
    return data.reshape(infer_reshape(tuple(data.shape), shape, reverse))


@register("reshape_like")
def _reshape_like(lhs, rhs, **_):
    return lhs.reshape(rhs.shape)


@register("Flatten", aliases=("flatten",))
def _flatten(data, **_):
    return data.reshape(data.shape[0], -1)


@register("transpose")
def _transpose(data, axes=(), **_):
    if not axes:
        axes = tuple(range(data.ndim))[::-1]
    return data.permute(*axes)


@register("expand_dims")
def _expand_dims(data, axis=0, **_):
    return data.unsqueeze(axis)


@register("squeeze")
def _squeeze(data, axis=None, **_):
    return data.squeeze() if axis is None else data.squeeze(axis)


@register("SwapAxis", aliases=("swapaxes",))
def _swapaxes(data, dim1=0, dim2=0, **_):
    return torch.swapaxes(data, dim1, dim2)


def positive_slices(data, key):
    """``(data', key')`` with every negative-step slice of ``key`` (a
    tuple of slices, ints, None, Ellipsis and index tensors) turned into
    a positive-step slice over ``data`` flipped along that dim: torch's
    basic indexing refuses negative steps, numpy's (and jnp's) take
    them."""
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in key):
        return data, key
    consumed = sum(1 for k in key if k is not None and k is not Ellipsis)
    dim, out = 0, []
    for k in key:
        if k is None:
            out.append(k)
            continue
        if k is Ellipsis:
            out.append(k)
            dim += data.ndim - consumed
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            n = data.shape[dim]
            start, stop, step = k.indices(n)
            data = data.flip(dim)
            k = slice(n - 1 - start, n - 1 - stop, -step)
        out.append(k)
        dim += 1
    return data, tuple(out)


def builtins_slice(b, e, s):
    return slice(None if b is None else int(b),
                 None if e is None else int(e),
                 None if s is None else int(s))


@register("slice")
def _slice(data, begin=(), end=(), step=(), **_):
    step = step or (None,) * len(begin)
    key = tuple(builtins_slice(b, e, step[i] if i < len(step) else None)
                for i, (b, e) in enumerate(zip(begin, end)))
    data, key = positive_slices(data, key)
    return data[key]


@register("slice_axis")
def _slice_axis(data, axis=0, begin=0, end=None, **_):
    axis = axis % data.ndim
    idx = [slice(None)] * data.ndim
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("slice_like")
def _slice_like(data, shape_like, axes=(), **_):
    axes_ = axes or tuple(range(min(data.ndim, shape_like.ndim)))
    idx = [slice(None)] * data.ndim
    for a in axes_:
        idx[a % data.ndim] = slice(0, shape_like.shape[a % shape_like.ndim])
    return data[tuple(idx)]


@register("repeat")
def _repeat(data, repeats=1, axis=None, **_):
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("tile")
def _tile(data, reps=(), **_):
    return torch.tile(data, tuple(reps))


@register("reverse", aliases=("flip",))
def _reverse(data, axis=(), **_):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, axes)


@register("Concat", aliases=("concat",))
def _concat(*args, dim=1, **_):
    return torch.cat(args, dim=dim)


@register("stack")
def _stack(*args, axis=0, **_):
    return torch.stack(args, dim=axis)


@register("SliceChannel", aliases=("split",), num_outputs=1)
def _slice_channel(data, num_outputs=1, axis=1, squeeze_axis=False, **_):
    # ref: src/operator/slice_channel.cc; equal parts, as jnp.split
    n = data.shape[axis]
    if n % num_outputs:
        raise ValueError("SliceChannel: axis %d of size %d does not split "
                         "into %d equal parts" % (axis, n, num_outputs))
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("space_to_depth")
def _space_to_depth(data, block_size=1, **_):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("depth_to_space")
def _depth_to_space(data, block_size=1, **_):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


# ---------------------------------------------------------------------------
# indexing (ref: src/operator/tensor/indexing_op.cc)
# ---------------------------------------------------------------------------
def _take_rows(a, idx, axis):
    """``jnp.take(a, idx, axis)`` for in-range ``idx`` of any shape."""
    axis = axis % a.ndim
    flat = torch.index_select(a, axis, idx.reshape(-1))
    return flat.reshape(tuple(a.shape[:axis]) + tuple(idx.shape)
                        + tuple(a.shape[axis + 1:]))


@register("take")
def _take(a, indices, axis=0, mode="clip", **_):
    idx = indices.to(torch.int64)
    if mode == "clip":
        idx = torch.clamp(idx, 0, a.shape[axis] - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, a.shape[axis])
    return _take_rows(a, idx, axis)


@register("Embedding")
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False, **_):
    idx = torch.clamp(data.to(torch.int64), 0, weight.shape[0] - 1)
    return _take_rows(weight, idx, 0)


def _one_hot_of(idx, depth, dtype):
    # out-of-range indices give all-zero rows, as jax.nn.one_hot
    ar = torch.arange(depth, device=idx.device)
    return (idx.unsqueeze(-1) == ar).to(dtype)


@register("one_hot", nondiff=True)
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0,
             dtype="float32", **_):
    oh = _one_hot_of(indices.to(torch.int64), int(depth), torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("pick")
def _pick(data, index, axis=-1, keepdims=False, mode="clip", **_):
    idx = torch.clamp(index.to(torch.int64), 0, data.shape[axis] - 1)
    picked = torch.gather(data, axis, idx.unsqueeze(axis))
    if not keepdims:
        picked = picked.squeeze(axis)
    return picked


@register("gather_nd")
def _gather_nd(data, indices, **_):
    return data[tuple(indices.to(torch.int64))]


@register("scatter_nd")
def _scatter_nd(data, indices, shape=(), **_):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return torch.index_put(out, tuple(indices.to(torch.int64)), data)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices, shape=(), **_):
    return torch.index_put(lhs, tuple(indices.to(torch.int64)), rhs)


@register("batch_take")
def _batch_take(a, indices, **_):
    idx = torch.clamp(indices.to(torch.int64), 0, a.shape[1] - 1)
    return torch.gather(a, 1, idx[:, None])[:, 0]


# ---------------------------------------------------------------------------
# ordering (ref: src/operator/tensor/ordering_op.cc)
# ---------------------------------------------------------------------------
@register("sort")
def _sort(data, axis=-1, is_ascend=True, **_):
    out = torch.sort(data, dim=axis, stable=True).values
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out


@register("argsort", nondiff=True)
def _argsort(data, axis=-1, is_ascend=True, dtype="float32", **_):
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch_dtype(dtype))


@register("topk", nondiff=True, num_outputs=1)
def _topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32", **_):
    # ref: ordering_op.cc TopK — ret_typ in {value, indices, mask, both}
    if axis is None:
        # reference: axis=None ranks over the FLATTENED array
        out = _topk(data.reshape(-1), axis=-1, k=k, ret_typ=ret_typ,
                    is_ascend=is_ascend, dtype=dtype)
        if ret_typ == "mask":
            return out.reshape(data.shape)
        return out
    axis = axis % data.ndim
    if k <= 0:
        # reference rule (ordering_op-inl.h:135): k<=0 selects the axis
        k = data.shape[axis]
    moved = torch.movedim(data, axis, -1)
    sel = -moved if is_ascend else moved
    vals, idxs = torch.topk(sel, k, dim=-1, largest=True, sorted=True)
    if is_ascend:
        vals = -vals
    if ret_typ == "mask":
        mask = _one_hot_of(idxs, moved.shape[-1], data.dtype).sum(-2)
        return torch.movedim(mask, -1, axis)
    vals = torch.movedim(vals, -1, axis)
    idxs = torch.movedim(idxs, -1, axis)
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idxs.to(torch_dtype(dtype))
    return (vals, idxs.to(torch_dtype(dtype)))


# ---------------------------------------------------------------------------
# dot products (ref: src/operator/tensor/dot.cc)
# ---------------------------------------------------------------------------
def _reverse_axes(x):
    return x.permute(*range(x.ndim - 1, -1, -1))


@register("dot")
def _dot(lhs, rhs, transpose_a=False, transpose_b=False, **_):
    a = _reverse_axes(lhs) if transpose_a else lhs
    b = _reverse_axes(rhs) if transpose_b else rhs
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))


@register("batch_dot")
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **_):
    a = torch.swapaxes(lhs, -1, -2) if transpose_a else lhs
    b = torch.swapaxes(rhs, -1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("khatri_rao")
def _khatri_rao(*args, **_):
    # ref: contrib/krprod.cc — column-wise Kronecker product
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("ir,jr->ijr", out, m).reshape(-1, out.shape[1])
    return out
