"""Bulk fit execution: K train steps back to back for Module.fit.

Counterpart: ``mxnet_tpu/module/bulk.py`` ``BulkTrainLoop`` (:89; ref:
src/engine/threaded_engine.h:386-458 bulk-exec fusion,
MXNET_EXEC_BULK_EXEC_TRAIN).  ``engine.set_bulk_size(K)`` means K whole
train steps (forward, backward, optimizer update) per group.  The JAX
package runs a group as one ``lax.scan`` program; the port runs the same
eager steps back to back on the card with no host sync inside the group:

  * the K batches of a group are stacked into a pinned host buffer,
    kept across groups, and copied to the card once, asynchronously (a
    per-batch copy from pageable memory would wait for the step before
    it);
  * the learning rate is read once per group and held for its K steps —
    an ``lr_scheduler`` quantizes to K batches, as the scan does;
  * every step's outputs are kept, so metrics and callbacks see every
    batch, in order, after the group.

The steps are the per-batch path's own operations in the same order, so
with a constant learning rate bulk and per-batch trajectories are equal
bit for bit.  The contract checks (:meth:`BulkTrainLoop._check`) give
the JAX package's fallback reasons, logged once, and fit then takes the
per-batch path for good; that is the reference's documented behaviour,
not a device fallback.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

import torch

from .. import traceview as _traceview
from ..ndarray import NDArray

_log = logging.getLogger(__name__)

__all__ = ["BulkTrainLoop"]


class BulkTrainLoop:
    """The K-step fit path for a bound, optimized Module.  ``groups`` and
    ``steps`` count what it ran."""

    def __init__(self, module):
        self._mod = module
        self._reason: Optional[str] = None
        self._checked = False
        self._pinned: Dict[str, torch.Tensor] = {}
        self._copied = None   # event: the last group's copies are done
        self._call = None     # the instrumented group (recompile tracking)
        self.groups = 0
        self.steps = 0

    # -- eligibility ----------------------------------------------------
    def _check(self) -> Optional[str]:
        mod = self._mod
        ex = mod._exec
        if ex is None or not mod.optimizer_initialized:
            return "module not bound/optimized"
        for name in ex._grad_names:
            if ex._grad_req.get(name) == "add":
                return "grad_req='add' accumulates across calls"
        if mod._active_updater() is None:
            return "no local updater"
        return None

    def available(self) -> bool:
        if not self._checked:
            self._reason = self._check()
            self._checked = True
            if self._reason is not None:
                _log.info("bulk fit disabled: %s (per-batch path)",
                          self._reason)
        return self._reason is None

    # -- dispatch -------------------------------------------------------
    def _stack(self, batches, io_names) -> Dict[str, torch.Tensor]:
        """One stack per input on the module's device.  For the card the
        host batches go into a pinned buffer (one host copy) and cross
        in one asynchronous copy; the buffer is rewritten only once the
        previous group's copy out of it is done."""
        mod = self._mod
        dev = mod._exec._device
        n_data = len(mod._data_names)
        k = len(batches)
        if self._copied is not None:
            self._copied.synchronize()
        out = {}
        for pos, name in enumerate(io_names):
            srcs = [b.data[pos] if pos < n_data else b.label[pos - n_data]
                    for b in batches]
            srcs = [s._data if isinstance(s, NDArray) else torch.as_tensor(s)
                    for s in srcs]
            if dev.type != "cuda" or srcs[0].device.type != "cpu":
                out[name] = torch.stack(srcs).to(dev)
                continue
            buf = self._pinned.get(name)
            if buf is None or buf.shape[0] < k or \
                    buf.shape[1:] != srcs[0].shape or \
                    buf.dtype != srcs[0].dtype:
                buf = torch.empty((k,) + tuple(srcs[0].shape),
                                  dtype=srcs[0].dtype, pin_memory=True)
                self._pinned[name] = buf
            torch.stack(srcs, out=buf[:k])
            out[name] = buf[:k].to(dev, non_blocking=True)
        if dev.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        return out

    def run(self, batches) -> Optional[List[List[NDArray]]]:
        """Run one train step per batch, back to back.  Returns per-batch
        output lists, or None when the configuration is outside the bulk
        contract (the caller falls back per-batch)."""
        if not self.available():
            return None
        mod = self._mod
        ex = mod._exec
        io_names = list(mod._data_names) + list(mod._label_names)
        stacked = self._stack(batches, io_names)
        opt = mod._active_updater().optimizer
        # the effective base lr of this group (per-param lr_mult still
        # applies in the update): the scheduler's granularity is K
        lr = opt.lr_scheduler(opt.num_update) if opt.lr_scheduler \
            else opt.lr
        saved = (opt.lr_scheduler, opt.lr)
        if self._call is None:
            from .. import diagnostics as _diag
            from ..remat import remat_policy

            self._call = _diag.instrument_jit(
                "Module.bulk_fit", self._run_group,
                meta={"remat_policy": remat_policy(),
                      "compute_dtype": str(next(iter(
                          ex.arg_dict.values()))._data.dtype).replace(
                          "torch.", "")})
        try:
            opt.lr_scheduler, opt.lr = None, lr
            with _traceview.step_window(
                    "Module.bulk_fit", k=len(batches),
                    device=ex._ctx.torch_device()) as tvw:
                out = self._call(stacked)
                if tvw is not None:
                    tvw.block()
        finally:
            opt.lr_scheduler, opt.lr = saved
        self.groups += 1
        self.steps += len(batches)
        return out

    def _run_group(self, stacked) -> List[List[NDArray]]:
        """The train steps of one group (``stacked``: one stack per
        input, the group's batches along the leading axis); each step's
        outputs."""
        mod = self._mod
        ex = mod._exec
        out = []
        for k in range(int(next(iter(stacked.values())).shape[0])):
            for name, stack in stacked.items():
                cell = ex.arg_dict[name]
                rows = stack[k] if mod._dp is None \
                    else mod._dp.local(stack[k])
                cell._data = rows.to(cell._data.dtype)
            outs = mod._run_train_step()
            # the output cells are refilled by the next step: keep this
            # step's values in cells of their own
            out.append([NDArray.from_raw(o._data.clone(), ex._ctx)
                        for o in outs])
            mod.update()
        return out

    def audit_state(self):
        """The parameter and auxiliary cells a step updates (the
        auditor's donation check compares their storage across one)."""
        ex = self._mod._exec
        out = {"param:" + k: ex.arg_dict[k]._data
               for k in self._mod._param_names if k in ex.arg_dict}
        out.update(("aux:" + k, v._data) for k, v in ex.aux_dict.items())
        return out
