"""Carry parameters between the JAX package and the port.

Both packages key a transformer's parameters by the names of
``param_shapes`` and store matrices in ``(in, out)`` orientation, so
conversion is a per-array copy: nothing is transposed or renamed.
A Gluon block's parameters cross by their names in
``collect_params()`` (:func:`load_block_params`), a ``Module``'s by the
names of its symbol's arguments and aux states
(:func:`module_params_from_jax`) — the recurrent tier's included: a
``FusedRNNCell``'s flat ``<prefix>parameters`` blob (cuDNN's layout in
both packages), the unrolled cells' ``<prefix>{i2h,h2h}_{weight,bias}``
and a Gluon ``RNN`` / ``LSTM`` / ``GRU`` layer's
``l{i}_{i2h,h2h}_{weight,bias}`` (``r{i}_...`` for the reverse
direction), each in its own dtype.  Arrays cross as
numpy (``np.asarray`` of a JAX array), which keeps the port free of any
JAX import.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["params_from_jax", "params_to_numpy", "load_block_params",
           "module_params_from_jax"]


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    # a copy: the tensor must not share (possibly read-only) JAX memory
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX's comes from ml_dtypes):
        # reinterpret the 16-bit patterns, which is exact
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_params: Dict[str, np.ndarray], device=None,
                    dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """The port's parameter dict from the JAX package's flat dict of
    numpy arrays: same names, same shapes, each array copied onto
    ``device`` (default ``cuda``) in its own dtype, or cast to
    ``dtype`` when one is given."""
    dev = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        t = _to_tensor(np.asarray(arr))
        out[name] = t.to(device=dev, dtype=dtype or t.dtype)
    return out


def params_to_numpy(params: Dict[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: host numpy arrays under
    the same names.  bfloat16 tensors come back as float32 (exact),
    since numpy has no bfloat16."""
    out = {}
    for name, t in params.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        out[name] = t.numpy().copy()
    return out


def load_block_params(block, np_params: Dict[str, np.ndarray]) -> None:
    """Set every parameter of ``block.collect_params()`` from
    ``np_params`` (``{name: p.data().asnumpy()}`` of the JAX package's
    block), by name, on the device and in the dtype each parameter
    already has.  The two name sets and every shape must be equal; the
    block's parameters must be initialised (shapes settled)."""
    params = block.collect_params()
    have, got = set(params.keys()), set(np_params)
    if have != got:
        raise ValueError("parameter names differ: only in the block %s, "
                         "only in the dict %s"
                         % (sorted(have - got), sorted(got - have)))
    for name, p in params.items():
        cell = p.data()
        t = _to_tensor(np.asarray(np_params[name]))
        if tuple(t.shape) != cell.shape:
            raise ValueError("parameter %s: shape %s, the dict has %s"
                             % (name, cell.shape, tuple(t.shape)))
        cell._set_data(t.to(device=cell._data.device,
                            dtype=cell._data.dtype))


def module_params_from_jax(arg_params: Dict[str, np.ndarray],
                           aux_params: Optional[Dict[str, np.ndarray]] = None,
                           ctx=None):
    """The port's ``(arg_params, aux_params)`` NDArray dicts, for
    ``Module.set_params`` / ``init_params(arg_params=...)``, from the
    JAX package's (``{name: nd.asnumpy()}`` of ``Module.get_params()``):
    same names, each array copied in its own dtype onto ``ctx``
    (default: the current context, the card; without one this raises
    and names ``mx.cpu()``)."""
    from .context import Context, current_context
    from .ndarray import NDArray

    ctx = Context(ctx) if ctx is not None else current_context()
    dev = ctx.torch_device()

    def convert(d):
        return {name: NDArray.from_raw(_to_tensor(np.asarray(a)).to(dev),
                                       ctx)
                for name, a in (d or {}).items()}

    return convert(arg_params), convert(aux_params)
