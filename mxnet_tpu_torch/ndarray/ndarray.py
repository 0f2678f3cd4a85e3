"""NDArray — a mutable tensor cell over a ``torch.Tensor``.

Counterpart: ``mxnet_tpu/ndarray/ndarray.py``.  There the cell sits over
an immutable ``jax.Array`` and mutation swaps the buffer.  Torch tensors
can alias (reshape, slicing, transpose and expand return views that
share storage) and can be written in place, so the port keeps the JAX
package's semantics by copy-on-write:

  * no two NDArrays share storage.  ``invoke`` copies any op output
    that shares storage with an input (or is not contiguous),
    ``__getitem__`` copies (a divergence from MXNet, shared with the JAX
    package), and so do ``detach``, ``copyto`` and ``asnumpy``;
  * no op writes into a tensor in place: ``__setitem__``, ``+=``,
    ``out=`` and the ``mutate_aux`` write-back build a new tensor and
    swap it into ``_data`` (:meth:`NDArray._set_data`).

The one sanctioned in-place write is ``rtc.CudaKernel.launch`` into a
non-const pointer argument, safe because no other NDArray holds that
tensor; it bumps the tensor's version (:meth:`NDArray._bump_version`).

Ops return at once (CUDA launches are asynchronous); ``asnumpy()``,
``wait_to_read()`` and :func:`waitall` wait.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as _np
import torch

from .. import autograd
from .. import profiler as _profiler
from .. import remat as _remat
from ..base import (MXNetError, as_shape, dtype_name, np_dtype, storage_id,
                    torch_dtype)
from ..context import Context, current_context, used_cuda_devices
from ..ops import matrix as _matrix
from ..ops import registry as _op_registry

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "full", "empty",
           "arange", "eye", "zeros_like", "ones_like", "concatenate",
           "maximum", "minimum", "moveaxis", "waitall"]


def _tensor(data, ctx: Context, dtype=None) -> torch.Tensor:
    """A new tensor on ``ctx`` holding a copy of ``data``."""
    dev = ctx.torch_device()
    if isinstance(data, torch.Tensor):
        return data.detach().to(dev, dtype=dtype, copy=True)
    return torch.tensor(_np.asarray(data), device=dev, dtype=dtype)


class NDArray:
    """Mutable tensor handle (ref: python/mxnet/ndarray/ndarray.py)."""

    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "__weakref__")

    # make NDArray win against numpy in mixed dunders
    __array_priority__ = 1000.0

    def __init__(self, data, ctx: Optional[Context] = None):
        ctx = ctx if ctx is not None else current_context()
        self._ctx = ctx
        self._data = _tensor(data, ctx)
        self._grad = None
        self._grad_req = "null"

    @classmethod
    def from_raw(cls, data: torch.Tensor,
                 ctx: Optional[Context] = None) -> "NDArray":
        """Wrap a tensor that no other NDArray holds."""
        out = cls.__new__(cls)
        out._data = data
        out._ctx = ctx if ctx is not None else current_context()
        out._grad = None
        out._grad_req = "null"
        return out

    def _set_data(self, t: torch.Tensor) -> None:
        """Swap in a new value.  A marked variable's new value becomes a
        new leaf unless it was computed in a recorded graph."""
        if self._grad is not None and not t.requires_grad:
            t = autograd.make_leaf(self, t)
        self._data = t

    def _bump_version(self) -> None:
        """After an in-place write into ``_data``: a graph that saved the
        old value must refuse to use it, and the cell's value starts
        over as a constant (or a new leaf for a marked variable)."""
        torch.autograd.graph.increment_version(self._data)
        self._data = self._data.detach()
        self._set_data(self._data)

    # -- basic properties ----------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype; ``torch.bfloat16`` for bfloat16 arrays."""
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return np_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return invoke("transpose", [self])

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    def __repr__(self) -> str:
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape), self._ctx)

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self) -> bool:
        if self.size != 1:
            raise ValueError("ambiguous truth value of multi-element NDArray")
        return bool(self._data.item())

    # -- sync / conversion ---------------------------------------------
    def wait_to_read(self) -> None:
        """ref: NDArray::WaitToRead — waits for the work queued on this
        array's device."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    def asnumpy(self) -> _np.ndarray:
        """An owned, writable host copy.  bfloat16 comes back as float32
        (exact values): numpy has no bfloat16 here."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        # a CPU tensor's numpy() shares its storage: copy it
        return t.numpy().copy() if t.device.type == "cpu" else \
            t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("the array is not scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        if not copy and self._data.dtype == torch_dtype(dtype):
            return self
        return invoke("Cast", [self], {"dtype": dtype_name(dtype)})

    def copy(self) -> "NDArray":
        return invoke("_copy", [self])

    def copyto(self, other: Union["NDArray", Context]) -> "NDArray":
        """ref: CopyFromTo (src/ndarray/ndarray.cc)."""
        if isinstance(other, Context):
            ctx = Context(other)
            return NDArray.from_raw(
                self._data.detach().to(ctx.torch_device(), copy=True), ctx)
        other._set_data(self._data.detach().to(
            other._data.device, dtype=other._data.dtype, copy=True))
        return other

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    def as_nd_ndarray(self) -> "NDArray":
        return self

    def detach(self) -> "NDArray":
        return NDArray.from_raw(self._data.detach().clone(), self._ctx)

    def tostype(self, stype: str) -> "NDArray":
        """ref: NDArray.tostype: ``default`` is this array, ``csr`` /
        ``row_sparse`` a compressed copy (``ndarray.sparse``)."""
        if stype == "default":
            return self
        from . import sparse as _sp

        return _sp.cast_storage(self, stype)

    # -- autograd -------------------------------------------------------
    def attach_grad(self, grad_req: str = "write",
                    stype: Optional[str] = None) -> None:
        """ref: python/mxnet/ndarray/ndarray.py attach_grad.  ``stype``
        is checked and, as in the JAX package, the gradient buffer is
        dense whatever it names."""
        if stype not in (None, "default", "row_sparse", "csr"):
            raise MXNetError("unknown storage type %r" % (stype,))
        grad = NDArray.from_raw(torch.zeros_like(self._data.detach()),
                                self._ctx)
        autograd.mark_variables([self], [grad], grad_req)

    def backward(self, out_grad=None, retain_graph=False,
                 train_mode=True) -> None:
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph, train_mode)

    # -- shape ops as methods ------------------------------------------
    def reshape(self, *shape, **kwargs) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return invoke("Reshape", [self], {
            "shape": tuple(shape),
            "reverse": bool(kwargs.get("reverse", False))})

    def reshape_like(self, other) -> "NDArray":
        return invoke("reshape_like", [self, other])

    def expand_dims(self, axis) -> "NDArray":
        return invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None) -> "NDArray":
        return invoke("squeeze", [self], {"axis": axis})

    def flatten(self) -> "NDArray":
        return invoke("Flatten", [self])

    def transpose(self, *axes) -> "NDArray":
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return invoke("transpose", [self], {"axes": tuple(axes)})

    def swapaxes(self, dim1, dim2) -> "NDArray":
        return invoke("SwapAxis", [self], {"dim1": dim1, "dim2": dim2})

    def flip(self, axis) -> "NDArray":
        return invoke("reverse", [self], {"axis": axis})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke("SliceChannel", [self],
                      {"num_outputs": num_outputs, "axis": axis,
                       "squeeze_axis": squeeze_axis})

    def slice(self, begin, end, step=None) -> "NDArray":
        return invoke("slice", [self], {"begin": tuple(begin),
                                        "end": tuple(end),
                                        "step": tuple(step) if step else ()})

    def slice_axis(self, axis, begin, end) -> "NDArray":
        return invoke("slice_axis", [self], {"axis": axis, "begin": begin,
                                             "end": end})

    def take(self, indices, axis=0, mode="clip") -> "NDArray":
        return invoke("take", [self, indices], {"axis": axis, "mode": mode})

    def pick(self, index, axis=-1, keepdims=False) -> "NDArray":
        return invoke("pick", [self, index], {"axis": axis,
                                              "keepdims": keepdims})

    def one_hot(self, depth, **kwargs) -> "NDArray":
        return invoke("one_hot", [self], dict(depth=depth, **kwargs))

    def tile(self, reps) -> "NDArray":
        return invoke("tile", [self], {"reps": tuple(reps)})

    def repeat(self, repeats, axis=None) -> "NDArray":
        return invoke("repeat", [self], {"repeats": repeats, "axis": axis})

    def broadcast_to(self, shape) -> "NDArray":
        return invoke("broadcast_to", [self], {"shape": tuple(shape)})

    def broadcast_like(self, other) -> "NDArray":
        return invoke("broadcast_like", [self, other])

    def clip(self, a_min=None, a_max=None) -> "NDArray":
        return invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    # -- reductions as methods -----------------------------------------
    def sum(self, axis=None, keepdims=False, **kw) -> "NDArray":
        return invoke("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False, **kw) -> "NDArray":
        return invoke("mean", [self], {"axis": axis, "keepdims": keepdims})

    def prod(self, axis=None, keepdims=False) -> "NDArray":
        return invoke("prod", [self], {"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False) -> "NDArray":
        return invoke("max", [self], {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False) -> "NDArray":
        return invoke("min", [self], {"axis": axis, "keepdims": keepdims})

    def norm(self, ord=2, axis=None, keepdims=False) -> "NDArray":
        return invoke("norm", [self], {"ord": ord, "axis": axis,
                                       "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False) -> "NDArray":
        return invoke("argmax", [self], {"axis": axis, "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False) -> "NDArray":
        return invoke("argmin", [self], {"axis": axis, "keepdims": keepdims})

    def argsort(self, axis=-1, is_ascend=True) -> "NDArray":
        return invoke("argsort", [self], {"axis": axis,
                                          "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True) -> "NDArray":
        return invoke("sort", [self], {"axis": axis, "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices",
             is_ascend=False) -> "NDArray":
        return invoke("topk", [self], {"axis": axis, "k": k,
                                       "ret_typ": ret_typ,
                                       "is_ascend": is_ascend})

    def dot(self, other, transpose_a=False, transpose_b=False) -> "NDArray":
        return invoke("dot", [self, other], {"transpose_a": transpose_a,
                                             "transpose_b": transpose_b})

    # elementwise method forms
    def abs(self): return invoke("abs", [self])
    def sqrt(self): return invoke("sqrt", [self])
    def square(self): return invoke("square", [self])
    def exp(self): return invoke("exp", [self])
    def log(self): return invoke("log", [self])
    def sigmoid(self): return invoke("sigmoid", [self])
    def tanh(self): return invoke("tanh", [self])
    def relu(self): return invoke("relu", [self])
    def softmax(self, axis=-1): return invoke("softmax", [self], {"axis": axis})
    def log_softmax(self, axis=-1):
        return invoke("log_softmax", [self], {"axis": axis})
    def sign(self): return invoke("sign", [self])
    def round(self): return invoke("round", [self])
    def floor(self): return invoke("floor", [self])
    def ceil(self): return invoke("ceil", [self])

    # -- arithmetic dunders --------------------------------------------
    _REV_SCALAR = {
        "_minus_scalar": "_rminus_scalar",
        "_div_scalar": "_rdiv_scalar",
        "_mod_scalar": "_rmod_scalar",
        "_power_scalar": "_rpower_scalar",
    }

    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            return invoke(op, [other, self] if reverse else [self, other])
        if isinstance(other, (int, float, _np.generic)):
            name = (self._REV_SCALAR.get(scalar_op, scalar_op) if reverse
                    else scalar_op)
            return invoke(name, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, o): return self._binary(o, "broadcast_add", "_plus_scalar")
    def __radd__(self, o): return self._binary(o, "broadcast_add", "_plus_scalar", True)
    def __sub__(self, o): return self._binary(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binary(o, "broadcast_sub", "_minus_scalar", True)
    def __mul__(self, o): return self._binary(o, "broadcast_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binary(o, "broadcast_mul", "_mul_scalar", True)
    def __truediv__(self, o): return self._binary(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binary(o, "broadcast_div", "_div_scalar", True)
    def __div__(self, o): return self.__truediv__(o)
    def __mod__(self, o): return self._binary(o, "broadcast_mod", "_mod_scalar")
    def __rmod__(self, o): return self._binary(o, "broadcast_mod", "_mod_scalar", True)
    def __pow__(self, o): return self._binary(o, "broadcast_power", "_power_scalar")
    def __rpow__(self, o): return self._binary(o, "broadcast_power", "_power_scalar", True)
    def __neg__(self): return invoke("negative", [self])
    def __matmul__(self, o): return invoke("dot", [self, o])

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o): return self._binary(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._binary(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binary(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binary(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    __hash__ = object.__hash__

    # in-place forms: the result is a new tensor swapped into the cell;
    # a graph that read the old value keeps it
    def _assign(self, result: "NDArray") -> "NDArray":
        self._set_data(result._data)
        return self

    def __iadd__(self, o): return self._assign(self.__add__(o))
    def __isub__(self, o): return self._assign(self.__sub__(o))
    def __imul__(self, o): return self._assign(self.__mul__(o))
    def __itruediv__(self, o): return self._assign(self.__truediv__(o))
    def __imod__(self, o): return self._assign(self.__mod__(o))

    # -- indexing -------------------------------------------------------
    def __getitem__(self, key):
        """Basic/advanced indexing.  The result is a *copy*, not a view
        (as in the JAX package); recorded under ``autograd.record()``."""
        template, arrays = _split_index(key, self)
        return invoke("_index", [self] + arrays, {"key": template})

    def __setitem__(self, key, value):
        """Writes a new tensor into the cell; the old value is left to
        whoever read it.  Not recorded (as in the JAX package)."""
        old = self._data.detach()
        src = (value._data.detach() if isinstance(value, NDArray)
               else torch.as_tensor(_np.asarray(value), device=old.device))
        if key is None or key is Ellipsis or key == slice(None):
            new = torch.empty_like(old)
            new.copy_(src.expand(old.shape) if src.shape != old.shape
                      else src)
        else:
            new = old.clone()
            k = _convert_index(key, old.device)
            k = k if isinstance(k, tuple) else (k,)
            if any(isinstance(s, slice) and s.step is not None and s.step < 0
                   for s in k):
                pos = torch.arange(old.numel(), device=old.device)
                pos = _matrix.positive_slices(pos.reshape(old.shape), k)
                sel = pos[0][pos[1]]
                new.view(-1)[sel.reshape(-1)] = src.to(old.dtype).expand(
                    sel.shape).reshape(-1)
            else:
                new[k] = src.to(old.dtype)
        self._set_data(new)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _convert_index(key, device):
    if isinstance(key, NDArray):
        return key._data.detach().to(torch.int64)
    if isinstance(key, tuple):
        return tuple(_convert_index(k, device) for k in key)
    if isinstance(key, (list, _np.ndarray)):
        return torch.as_tensor(_np.asarray(key), device=device).to(
            torch.int64)
    return key


def _split_index(key, owner: NDArray):
    """Split an index expression into a hashable template plus the list
    of array indices (real op inputs, so autograd sees them)."""
    arrays: List[NDArray] = []

    def walk(k):
        if isinstance(k, NDArray):
            arrays.append(k)
            return ("__arr__", len(arrays) - 1)
        if isinstance(k, (list, _np.ndarray)):
            arrays.append(NDArray.from_raw(
                torch.as_tensor(_np.asarray(k).astype(_np.int64),
                                device=owner._data.device), owner._ctx))
            return ("__arr__", len(arrays) - 1)
        if isinstance(k, tuple):
            return ("__tuple__",) + tuple(walk(x) for x in k)
        if isinstance(k, slice):
            return ("__slice__", k.start, k.stop, k.step)
        return k

    return walk(key), arrays


def _rebuild_index(template, idx_arrays):
    if isinstance(template, tuple):
        if template and template[0] == "__arr__":
            return idx_arrays[template[1]].to(torch.int64)
        if template and template[0] == "__slice__":
            return slice(template[1], template[2], template[3])
        if template and template[0] == "__tuple__":
            return tuple(_rebuild_index(t, idx_arrays) for t in template[1:])
    return template


# registered so indexing is differentiable under autograd.record
@_op_registry.register("_index")
def _index_op(data, *idx_arrays, key=None, **_):
    k = _rebuild_index(key, idx_arrays)
    data, k = _matrix.positive_slices(data, k if isinstance(k, tuple)
                                      else (k,))
    return data[k]


# ---------------------------------------------------------------------------
# the universal op invocation path
# (ref: MXImperativeInvokeEx -> Imperative::Invoke)
# ---------------------------------------------------------------------------
def _owned(outs, raws):
    """Each output as a contiguous tensor that shares storage with no
    input and no other output."""
    seen = {storage_id(r) for r in raws if r.numel()}
    res = []
    for o in outs:
        p = storage_id(o)
        if (p and p in seen) or not o.is_contiguous():
            o = o.clone(memory_format=torch.contiguous_format)
            p = storage_id(o)
        seen.add(p)
        res.append(o)
    return res


#: op hooks (innermost last): ``hook(op, body, tensors)`` returns None
#: or a thunk that computes the op instead of ``body(*tensors)``
_OP_HOOKS: list = []


def invoke(op: Union[str, _op_registry.Op], inputs: Sequence[NDArray],
           params: Optional[dict] = None,
           out: Optional[Union[NDArray, Sequence[NDArray]]] = None,
           ctx: Optional[Context] = None):
    if isinstance(op, str):
        op = _op_registry.get(op)
    params = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in (params or {}).items()}
    first = next((x for x in inputs if isinstance(x, NDArray)), None)
    out_ctx = ctx or (first._ctx if first is not None else current_context())
    raw = []
    for x in inputs:
        if isinstance(x, NDArray):
            raw.append(x._data)
        else:
            dev = (first._data.device if first is not None
                   else out_ctx.torch_device())
            raw.append(torch.as_tensor(_np.asarray(x), device=dev))

    recording = (autograd.is_recording() and not op.nondiff
                 and any(t.requires_grad for t in raw))
    # the per-op span: one flag read while the profiler is stopped
    if _profiler._active:
        _prof, _prof_sync = _profiler.profiling_state()
        _prof_start = _profiler._now_us()
    else:
        _prof = False
    fn = op.bound(**params)
    if op.rng:
        # the device's generator stands where the JAX package passes a
        # PRNG key
        from .. import random as _random

        fn = functools.partial(fn, _random.generator(
            raw[0].device if raw else out_ctx.torch_device()))
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.enable_grad() if recording
                            else torch.no_grad())
        if not raw:
            # creation ops allocate on the target device directly
            stack.enter_context(out_ctx.torch_device())
        # a tensor-parallel step routes ops on sharded parameters
        # (parallel.tensor.dispatch)
        thunk = _OP_HOOKS[-1](op, fn, raw) if _OP_HOOKS else None
        outs = fn(*raw) if thunk is None else thunk()
        if _prof:
            if _prof_sync:  # the op's device time, not its enqueue
                _profiler.sync_device(
                    outs if isinstance(outs, tuple) else (outs,))
            _profiler.record_span(op.name, _prof_start,
                                  _profiler._now_us() - _prof_start)
        tupled = _owned(outs if isinstance(outs, tuple) else (outs,), raw)
        if ctx is not None and raw:
            dev = ctx.torch_device()
            tupled = [o.to(dev) for o in tupled]
        n_visible = len(tupled) - len(op.mutate_aux)
        wrapped = [NDArray.from_raw(o, out_ctx) for o in tupled[:n_visible]]

        # write back mutated aux states (BatchNorm moving stats et al.),
        # once: a remat scope's recompute runs the op again and must not
        # move them twice
        if op.mutate_aux and not _remat.recomputing():
            for pos, new_val in zip(op.mutate_aux, tupled[n_visible:]):
                tgt = inputs[pos]
                if isinstance(tgt, NDArray):
                    tgt._set_data(new_val.detach())

        if out is not None:
            outs_list = [out] if isinstance(out, NDArray) else list(out)
            for o, w in zip(outs_list, wrapped):
                o._set_data(w._data.to(o._data.dtype))
            return out if isinstance(out, NDArray) else outs_list
    if len(wrapped) == 1:
        return wrapped[0]
    return wrapped


# ---------------------------------------------------------------------------
# creation functions (ref: python/mxnet/ndarray/utils.py, init_op.cc)
# ---------------------------------------------------------------------------
def array(source_array, ctx: Optional[Context] = None, dtype=None,
          stype: Optional[str] = None) -> NDArray:
    """Python-native sources default to float32 (ref: ndarray.py
    array()); numpy arrays, tensors and NDArrays keep their dtype.
    ``stype`` ``csr`` / ``row_sparse`` compresses the result."""
    ctx = ctx if ctx is not None else current_context()
    if stype is not None and stype != "default":
        from . import sparse as _sp

        return _sp.cast_storage(array(source_array, ctx, dtype), stype)
    if isinstance(source_array, NDArray):
        src = source_array._data
    elif isinstance(source_array, (_np.ndarray, torch.Tensor)):
        src = source_array
    else:
        src = _np.asarray(source_array)
        if dtype is None and src.dtype in (_np.float64, _np.int64,
                                           _np.int32):
            src = src.astype(_np.float32)
    return NDArray.from_raw(_tensor(src, ctx, None if dtype is None
                                    else torch_dtype(dtype)), ctx)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    stype = kwargs.pop("stype", None)
    if stype is not None and stype != "default":
        from . import sparse as _sp

        return _sp.zeros(stype, shape, ctx, dtype)
    return invoke("_zeros", [], {"shape": as_shape(shape),
                                 "dtype": dtype_name(dtype)}, ctx=ctx)


def ones(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return invoke("_ones", [], {"shape": as_shape(shape),
                                "dtype": dtype_name(dtype)}, ctx=ctx)


def full(shape, val, ctx=None, dtype=None, out=None) -> NDArray:
    return invoke("_full", [], {"shape": as_shape(shape),
                                "value": float(val),
                                "dtype": dtype_name(dtype)}, out=out, ctx=ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    return invoke("_arange", [], {"start": start, "stop": stop,
                                  "step": step, "repeat": repeat,
                                  "dtype": dtype_name(dtype)}, ctx=ctx)


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:
    return invoke("_eye", [], {"N": N, "M": M, "k": k,
                               "dtype": dtype_name(dtype)}, ctx=ctx)


def zeros_like(other: NDArray) -> NDArray:
    return invoke("zeros_like", [other])


def ones_like(other: NDArray) -> NDArray:
    return invoke("ones_like", [other])


def concatenate(arrays: Sequence[NDArray], axis: int = 0,
                always_copy: bool = True) -> NDArray:
    return invoke("Concat", list(arrays), {"dim": axis})


def _public_binary(array_op: str, scalar_op: str):
    """Scalar-aware public binary fn (ref: ndarray.py module-level
    maximum/minimum dispatching on operand types)."""

    def f(lhs, rhs):
        if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
            return invoke(array_op, [lhs, rhs])
        if isinstance(lhs, NDArray):
            return invoke(scalar_op, [lhs], {"scalar": float(rhs)})
        if isinstance(rhs, NDArray):
            return invoke(scalar_op, [rhs], {"scalar": float(lhs)})
        raise TypeError("at least one NDArray operand required")

    f.__name__ = array_op.lstrip("_")
    return f


maximum = _public_binary("_maximum", "_maximum_scalar")
minimum = _public_binary("_minimum", "_minimum_scalar")


def moveaxis(tensor: NDArray, source: int, destination: int) -> NDArray:
    axes = list(range(tensor.ndim))
    axes.insert(destination, axes.pop(source))
    return tensor.transpose(*axes)


def waitall() -> None:
    """ref: Engine::WaitForAll — waits for the work queued on every CUDA
    device a context has used."""
    for i in sorted(used_cuda_devices()):
        torch.cuda.synchronize(i)
