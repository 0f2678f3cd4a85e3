"""The fused train step, one device.

Counterpart: ``mxnet_tpu/parallel/dp.py`` ``FusedTrainStep`` (:397-1043,
``run_steps`` :1044, ``__call__`` :1173), single device.  The JAX package
compiles forward, loss, backward and update into one XLA program; the
port runs the same step eagerly on torch (cuDNN convolutions and cuBLAS
GEMMs on the card), with its semantics:

  * the first call settles deferred shapes with one float32 forward
    under ``autograd.pause()`` (inference mode: BatchNorm's running
    statistics do not move), then ``block.cast(dtype)`` casts every
    parameter, running statistics included;
  * the batch is cast to the compute dtype inside the step; the loss is
    the batch mean of the loss block;
  * gradients are taken over the parameters with a gradient (not the
    aux ones, ``grad_req == "null"``); the aux ones keep the values the
    forward wrote into them;
  * the update is ONE fused SGD-momentum per dtype group over a flat
    concatenation of the parameters (``optimizer.fused_sgd_mom_grouped``),
    or the per-key loop with ``fused_update=False``, bitwise equal;
    weight decay applies to every non-aux parameter; momenta start at
    zeros in the parameter dtype.

A mesh of more than one device, ``bucket_bytes``, ``zero_stage``,
``param_spec_fn``, gradient accumulation and remat are the multi-device
and memory tiers (ROADMAP A6, A7): asking for one raises.
"""
from __future__ import annotations

from typing import List

import numpy as _np
import torch

from .. import autograd, env as _env
from ..base import MXNetError, torch_dtype
from ..context import current_context
from ..ndarray import NDArray
from .. import optimizer as _opt

__all__ = ["FusedTrainStep"]


def _mesh_size(mesh) -> int:
    devices = getattr(mesh, "devices", mesh)
    if isinstance(devices, (list, tuple)):
        return len(devices)
    size = getattr(devices, "size", None)
    return int(size) if size is not None else 1


def _refuse(mesh, bucket_bytes, zero_stage, param_spec_fn, accum_steps):
    """Raise for every option of the multi-device or memory tiers."""
    why = []
    if mesh is not None and _mesh_size(mesh) > 1:
        why.append("a mesh of %d devices (ROADMAP A6)" % _mesh_size(mesh))
    if bucket_bytes is not None:
        why.append("bucket_bytes (ROADMAP A6: bucketed gradient exchange)")
    if zero_stage not in (None, 0):
        why.append("zero_stage=%r (ROADMAP A6: ZeRO-1)" % (zero_stage,))
    if param_spec_fn is not None:
        why.append("param_spec_fn (ROADMAP A6: tensor-parallel shardings)")
    accum = accum_steps if accum_steps is not None else \
        _env.get_int("MXNET_GRAD_ACCUM_STEPS")
    if accum != 1:
        why.append("gradient accumulation over %r steps (ROADMAP A7)"
                   % (accum,))
    policy = _env.get_str("MXNET_REMAT_POLICY")
    if policy != "none":
        why.append("MXNET_REMAT_POLICY=%r (ROADMAP A7)" % (policy,))
    if why:
        raise MXNetError("FusedTrainStep in mxnet_tpu_torch runs on one "
                         "device; not ported: " + "; ".join(why))


class FusedTrainStep:
    """Forward + loss + backward + SGD-momentum update, one device.

    Parameters
    ----------
    block : an initialised gluon HybridBlock
    loss_fn : a gluon Loss block
    learning_rate, momentum, weight_decay : the SGD-momentum update
    dtype : compute and parameter dtype (``block.cast`` at build); None
        keeps float32
    fused_update : one update per dtype group (True) or per key (False)

    The step runs on the device the block's parameters were initialised
    on, or the current context where the block has none yet (the card
    by default: it raises where there is none and names ``mx.cpu()``).
    """

    def __init__(self, block, loss_fn, mesh=None, learning_rate=0.05,
                 momentum=0.9, weight_decay=0.0, param_spec_fn=None,
                 dtype=None, bucket_bytes=None, fused_update=True,
                 zero_stage=None, accum_steps=None):
        _refuse(mesh, bucket_bytes, zero_stage, param_spec_fn, accum_steps)
        ctxs = [c for p in block.collect_params().values()
                for c in p.list_ctx()]
        self._ctx = ctxs[0] if ctxs else current_context()
        self._device = self._ctx.torch_device()
        self._block = block
        self._loss_fn = loss_fn
        self._lr = learning_rate
        self._momentum = momentum
        self._wd = weight_decay
        self._dtype = dtype
        self._fused_update = bool(fused_update)
        self._built = False

    def _build(self, sample: NDArray) -> None:
        """Settle deferred shapes with one float32 forward that moves no
        running statistic, cast, and list the parameter cells."""
        from ..gluon.block import CachedOp

        with autograd.pause():
            settle = sample if sample._data.dtype == torch.float32 \
                else sample.astype("float32")
            self._block(settle)
        if self._dtype is not None:
            self._block.cast(self._dtype)
        cached = CachedOp(self._block)
        self._cells = [p for (_, _, p) in cached._param_cells]
        aux = set(cached._aux_positions)
        self._diff = [i for i in range(len(self._cells)) if i not in aux]
        self._compute_dtype = torch_dtype(self._dtype or "float32")
        self._moms = [torch.zeros_like(p.data()._data.detach())
                      for p in self._cells]
        self._built = True

    def _as_tensor(self, x) -> torch.Tensor:
        t = x._data.detach() if isinstance(x, NDArray) else \
            torch.as_tensor(_np.asarray(x))
        return t.to(self._device)

    def _step(self, data: torch.Tensor, label: torch.Tensor):
        """One step on tensors on the device; returns (loss, logits)."""
        if data.dtype != self._compute_dtype:
            data = data.to(self._compute_dtype)
        x = NDArray.from_raw(data, self._ctx)
        y = NDArray.from_raw(label, self._ctx)
        with autograd.record(train_mode=True):
            out = self._block(x)
            loss = self._loss_fn(out, y)._data.mean()
        params = [p.data()._data for p in self._cells]
        got = torch.autograd.grad(loss, [params[i] for i in self._diff],
                                  allow_unused=True)
        grads = {i: (torch.zeros_like(params[i]) if g is None else g)
                 for i, g in zip(self._diff, got)}
        lr, mom_c, wd = self._lr, self._momentum, self._wd
        with torch.no_grad():
            if self._fused_update:
                new_p, new_m = _opt.fused_sgd_mom_grouped(
                    self._diff, params, grads, self._moms, lr, mom_c, wd)
            else:
                new_p, new_m = {}, {}
                for i in self._diff:
                    g = grads[i] + wd * params[i]
                    m = mom_c * self._moms[i] - lr * g
                    new_p[i], new_m[i] = params[i] + m, m
            for i in self._diff:
                self._cells[i].data()._set_data(new_p[i].detach())
                self._moms[i] = new_m[i]
        return loss.detach(), out._data.detach()

    def run_steps(self, data, label, steps=None) -> NDArray:
        """Run K optimizer steps.  ``data`` / ``label`` carry a leading K
        dim (one batch per step), or, with ``steps``, are one batch used
        for every step.  Returns the per-step losses, shape (K,)."""
        d, lab = self._as_tensor(data), self._as_tensor(label)
        if steps is None:
            batches = list(zip(d, lab))
        else:
            batches = [(d, lab)] * int(steps)
        if not self._built:
            self._build(NDArray.from_raw(batches[0][0], self._ctx))
        losses: List[torch.Tensor] = [self._step(x, y)[0]
                                      for x, y in batches]
        return NDArray.from_raw(torch.stack(losses), self._ctx)

    def __call__(self, data, label):
        """One optimizer step; returns ``(loss, logits)`` NDArrays."""
        d, lab = self._as_tensor(data), self._as_tensor(label)
        if not self._built:
            self._build(NDArray.from_raw(d, self._ctx))
        loss, logits = self._step(d, lab)
        return (NDArray.from_raw(loss, self._ctx),
                NDArray.from_raw(logits, self._ctx))
