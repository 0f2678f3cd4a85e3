"""Gluon Trainer.

Counterpart: ``mxnet_tpu/gluon/trainer.py`` (ref:
python/mxnet/gluon/trainer.py), whole.  Applies an optimizer to a
ParameterDict, exchanging gradients through a KVStore (``device`` by
default, one process): ``step(batch_size)`` rescales by 1/batch_size,
pushes the gradients and pulls the updated weights (update_on_kvstore)
or applies the updates locally.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .. import optimizer as _opt
from ..kvstore import KVStore, create as kv_create
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None, kvstore="device",
                 compression_params=None, update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[k] for k in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a dict/ParameterDict/list of Parameter")
        self._params: List[Parameter] = []
        self._param2idx: Dict[str, int] = {}
        for i, p in enumerate(params):
            if not isinstance(p, Parameter):
                raise ValueError("invalid parameter %r" % (p,))
            self._params.append(p)
            self._param2idx[p.name] = i
        self._scale = 1.0
        optimizer_params = dict(optimizer_params or {})
        idx2name = {i: p.name for i, p in enumerate(self._params)}
        if isinstance(optimizer, _opt.Optimizer):
            self._optimizer = optimizer
            if optimizer_params:
                raise ValueError(
                    "optimizer_params must be None when optimizer is an instance"
                )
            # updater calls go by integer index; the instance needs the
            # index→name map or name-keyed lr_mult/wd_mult below never match
            self._optimizer.idx2name.update(idx2name)
        else:
            self._optimizer = _opt.create(optimizer, param_idx2name=idx2name,
                                          **optimizer_params)
        # name-keyed so per-param settings override set_wd_mult's seeded
        # bias/gamma/beta zero defaults (optimizer._get_wd resolves by name)
        self._optimizer.set_lr_mult({p.name: p.lr_mult for p in self._params})
        self._optimizer.set_wd_mult({p.name: p.wd_mult for p in self._params})
        self._updater = _opt.get_updater(self._optimizer)

        self._kvstore: Optional[KVStore] = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
        self._kvstore_spec = kvstore
        self._compression_params = compression_params

    # -- properties ------------------------------------------------------
    @property
    def learning_rate(self) -> float:
        return self._optimizer.lr if self._optimizer.lr_scheduler is None else \
            self._optimizer.lr_scheduler(self._optimizer.num_update)

    def set_learning_rate(self, lr: float) -> None:
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    # -- kvstore ---------------------------------------------------------
    def _init_kvstore(self):
        if self._kv_initialized:
            return
        spec = self._kvstore_spec
        if spec is None:
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            self._kvstore = spec if isinstance(spec, KVStore) else kv_create(spec)
            if self._compression_params:
                self._kvstore.set_gradient_compression(self._compression_params)
            if self._update_on_kvstore is None:
                self._update_on_kvstore = True
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.init(i, p.data())
        self._kv_initialized = True

    # -- stepping --------------------------------------------------------
    def step(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        """ref: trainer.py:156 step — rescale + allreduce + update."""
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self) -> None:
        self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self) -> None:
        if self._kvstore is None:
            return
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            # priority -i: earlier (deeper) layers reduce first, overlapping
            # with remaining backprop (ref: trainer.py:190 priority=-idx)
            self._kvstore.push(i, p.grad(), priority=-i)
            if not self._update_on_kvstore:
                self._kvstore.pull(i, p.grad(), priority=-i)

    def _update(self, ignore_stale_grad: bool = False) -> None:
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if self._update_on_kvstore and self._kvstore is not None:
                self._kvstore.pull(i, p.data(), priority=-i)
            else:
                self._updater(i, p.grad(), p.data())

    def update(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        """Apply updates without a fresh allreduce (ref: trainer.py update)."""
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    # -- state persistence ----------------------------------------------
    def save_states(self, fname: str) -> None:
        """ref: trainer.py:202 save_states."""
        self._init_kvstore()
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=False)
        else:
            with open(fname, "wb") as f:
                f.write(self._updater.get_states(dump_optimizer=False))

    def load_states(self, fname: str) -> None:
        """ref: trainer.py:224 load_states."""
        self._init_kvstore()
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())
