"""Gluon Block / HybridBlock / CachedOp.

Counterpart: ``mxnet_tpu/gluon/block.py`` (ref: python/mxnet/gluon/
block.py: Block, HybridBlock, name scopes; src/imperative/cached_op.cc).

The port runs every block eagerly on ``torch``:

  * ``hybridize()`` records the flag and execution stays eager
    (ROADMAP C); the call of an outermost hybridized block stands for
    the JAX package's CachedOp: the conv remat scopes inside it fire,
    and it is the boundary of the mirror (``remat.py``);
    :class:`CachedOp` keeps the JAX package's listing of
    the block tree's parameter cells, in the same order, with the aux
    positions at the params with ``grad_req == "null"``, and runs
    nothing;
  * deferred shapes resolve per leaf layer, from the input it is called
    with (``_infer_param_shapes``), with the same numpy draws in the
    same order as the JAX package, which infers them through the
    symbol path;
  * names come from the same per-process counters (``_BlockScope``), so
    two nets built the same way in a fresh scope, or with the same
    ``prefix=``, carry the same parameter names in both packages;
  * a ``HybridBlock`` called on a ``Symbol`` composes symbolically
    (``hybrid_forward`` with ``F = mx.sym``, its parameters as
    variables); ``export`` writes ``path-symbol.json`` and
    ``path-%04d.params`` as the JAX package does, and
    :class:`SymbolBlock` (``SymbolBlock.imports``) runs such a file
    through the executor.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as _np

from ..base import MXNetError
from .. import ndarray as _nd_mod  # the generated-op namespace (F)
from ..ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp"]

_naming = threading.local()


class _BlockScope:
    """Name scoping (ref: gluon/block.py _BlockScope)."""

    @staticmethod
    def create(prefix, params, hint) -> Tuple[str, ParameterDict]:
        current = getattr(_naming, "current", None)
        if current is None:
            if prefix is None:
                counters = getattr(_naming, "counters", None)
                if counters is None:
                    counters = _naming.counters = {}
                idx = counters.get(hint, 0)
                counters[hint] = idx + 1
                prefix = "%s%d_" % (hint, idx)
            if params is None:
                params = ParameterDict(prefix)
            return prefix, params
        block = current
        if prefix is None:
            idx = block._counters.get(hint, 0)
            block._counters[hint] = idx + 1
            prefix = "%s%d_" % (hint, idx)
        if params is None:
            params = ParameterDict(block.prefix + prefix,
                                   shared=block._params._shared)
        return block.prefix + prefix, params


class _NameScopeCtx:
    def __init__(self, block):
        self._block = block

    def __enter__(self):
        self._prev = getattr(_naming, "current", None)
        _naming.current = self._block
        return self

    def __exit__(self, *exc):
        _naming.current = self._prev


class Block:
    """ref: gluon/block.py Block."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._children: Dict[str, Block] = {}
        self._reg_params: Dict[str, Parameter] = {}
        self._counters: Dict[str, int] = {}
        self._scope = _NameScopeCtx(self)

    def _alias(self) -> str:
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.__dict__.setdefault("_children", {})[name] = value
        elif isinstance(value, Parameter):
            self.__dict__.setdefault("_reg_params", {})[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self) -> ParameterDict:
        return self._params

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """ref: block.py collect_params (regex ``select``)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._all_params())
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self._all_params().items()
                        if pattern.match(k)})
        return ret

    def _all_params(self) -> Dict[str, Parameter]:
        out = dict(self._params.items())
        for p in self._reg_params.values():
            out.setdefault(p.name, p)
        for child in self._children.values():
            out.update(child._all_params())
        return out

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialise every parameter on ``ctx`` (default: the current
        context, the card; raises without one and names ``mx.cpu()``)."""
        from .. import initializer as _init

        self.collect_params().initialize(
            init if init is not None else _init.Uniform(), ctx,
            verbose=verbose, force_reinit=force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for param in self._reg_params.values():
            param.cast(dtype)

    def register_child(self, block, name=None):
        self._children[name or str(len(self._children))] = block

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    # -- persistence ----------------------------------------------------
    def save_parameters(self, filename, deduplicate=False):
        """ref: block.py save_parameters (names without the block's
        prefix, in the ``.params`` container of ``nd.save``)."""
        from ..ndarray import save as nd_save

        arg_dict = {_strip(self.prefix, name): p.data()
                    for name, p in self._all_params().items()
                    if p._data is not None}
        nd_save(filename, arg_dict)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        from ..ndarray import load as nd_load

        loaded = nd_load(filename, ctx=ctx)
        by_stripped = {_strip(self.prefix, name): p
                       for name, p in self._all_params().items()}
        if not allow_missing:
            for name in by_stripped:
                if name not in loaded:
                    raise MXNetError("parameter %s missing in %s"
                                     % (name, filename))
        for name, value in loaded.items():
            if name not in by_stripped:
                if ignore_extra:
                    continue
                raise MXNetError("unknown parameter %s in %s"
                                 % (name, filename))
            p = by_stripped[name]
            if p._data is None:
                p.shape = tuple(value.shape)
                if p._deferred_init is not None:
                    init, pctx = p._deferred_init
                    p._finish_init(init, pctx)
                else:
                    p.initialize(ctx=ctx)
            p.set_data(value)

    save_params = save_parameters
    load_params = load_parameters

    # -- execution ------------------------------------------------------
    def __call__(self, *args):
        # scoped remat (MXNET_REMAT_POLICY=stage/conv_block): blocks that
        # declare a ``_remat_scope`` (ResNet stages, residual units) run
        # under a checkpoint inside a block trace (remat.py)
        scope = getattr(self, "_remat_scope", None)
        if scope is not None:
            from ..remat import checkpoint_block_call

            out = checkpoint_block_call(self, scope, args)
            if out is not NotImplemented:
                return out
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        self(*inputs)
        return "%s: %d parameters" % (self.name, sum(
            int(_np.prod(p.shape)) for p in self._all_params().values()
            if p.shape is not None))

    def __repr__(self):
        return "{name}(\n{children})".format(
            name=self.__class__.__name__,
            children="".join("  (%s): %r\n" % (k, v)
                             for k, v in self._children.items()))


def _strip(prefix, name):
    return name[len(prefix):] if prefix and name.startswith(prefix) else name


class HybridBlock(Block):
    """ref: gluon/block.py HybridBlock.  Leaf layers with deferred
    shapes override :meth:`_infer_param_shapes`."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False

    def hybridize(self, active=True, **kwargs):
        self._active = active
        super().hybridize(active, **kwargs)

    def infer_shape(self, *args):
        """Settle every deferred shape of the tree with one forward that
        records nothing and moves no running statistic."""
        from .. import autograd

        with autograd.pause():
            self(*args)

    def _infer_param_shapes(self, *args) -> Dict[str, Tuple[int, ...]]:
        """``{registered param name: shape}`` from this layer's inputs."""
        raise DeferredInitializationError(
            "%s cannot infer the shapes of its parameters; give them "
            "explicitly" % self.name)

    def _deferred_infer_shape(self, *args):
        # in registration order, as the JAX package finishes them (the
        # initializers' numpy draws follow this order)
        shapes = self._infer_param_shapes(*args)
        for name, p in self._reg_params.items():
            if p._deferred_init is not None and name in shapes:
                p._finish_deferred_init(shapes[name])

    # -- execution ------------------------------------------------------
    def __call__(self, *args):
        # an outermost hybridized block is the JAX package's CachedOp:
        # its call is a block trace and the mirror's boundary (remat.py)
        if self._active and args and isinstance(args[0], NDArray):
            from .. import remat

            if not remat.in_block_trace():
                return remat.hybrid_block_call(self, args)
        return super().__call__(*args)

    def forward(self, x, *args):
        if not isinstance(x, NDArray):
            # symbol input: compose symbolically (hybrid blocks are
            # symbols too), every parameter a variable
            from .. import symbol as sym_mod

            kwargs = {name: p.var() for name, p in self._reg_params.items()}
            return self.hybrid_forward(sym_mod, x, *args, **kwargs)
        try:
            params = {name: p.data() for name, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._deferred_infer_shape(x, *args)
            params = {name: p.data() for name, p in self._reg_params.items()}
        return self.hybrid_forward(_nd_mod, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Symbol + params export (ref: block.py export): the graph of a
        symbolic call on ``Variable("data")`` to ``path-symbol.json``,
        the parameters to ``path-%04d.params`` under ``arg:`` / ``aux:``
        keys, so ``model.load_checkpoint`` / ``Module`` and
        :meth:`SymbolBlock.imports` read them."""
        from .. import symbol as sym_mod
        from ..ndarray import save as nd_save

        out = self(sym_mod.Variable("data"))
        out.save("%s-symbol.json" % path)
        aux_names = set(out.list_auxiliary_states())
        params = {}
        for name, p in self._all_params().items():
            if p._data is not None:
                prefix = "aux:" if name in aux_names else "arg:"
                params[prefix + name] = p.data()
        nd_save("%s-%04d.params" % (path, epoch), params)


class CachedOp:
    """The parameter listing of a hybridized block's executor (ref:
    src/imperative/cached_op.cc; ``mxnet_tpu/gluon/block.py:334-422``).

    ``_param_cells`` lists every parameter of the block tree in the
    order the JAX package's CachedOp feeds them to its program, and
    ``_aux_positions`` the indices of those with ``grad_req == "null"``
    (BatchNorm's running stats): ``FusedTrainStep`` takes gradients over
    the others.  The port runs the block eagerly, so nothing executes
    here: the ops write each aux state's new value back into its cell
    during the forward, where the JAX CachedOp's program returns them
    for ``invoke`` to write back.
    """

    def __init__(self, block: HybridBlock):
        self._block = block
        self._param_cells: List[Tuple[Block, str, Parameter]] = []
        seen = set()

        def collect(b):
            for name, p in b._reg_params.items():
                if id(p) not in seen:
                    seen.add(id(p))
                    self._param_cells.append((b, name, p))
            for c in b._children.values():
                collect(c)

        collect(block)
        self._aux_positions = [i for i, (_, _, p)
                               in enumerate(self._param_cells)
                               if p.grad_req == "null"]


class SymbolBlock(HybridBlock):
    """Wrap a Symbol as a Block (ref: gluon/block.py SymbolBlock).  Every
    argument and aux state of ``outputs`` that is not an input becomes a
    parameter under its own name; a call binds the symbol on the
    inputs' device and runs the executor's forward (training mode under
    ``autograd.train_mode()``, which moves BatchNorm's statistics), as
    the JAX package's SymbolBlock does: the call is not recorded by
    autograd."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=None)
        from .. import symbol as sym_mod

        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(outputs)
        self._out_symbol = outputs
        self._in_names = [s.name for s in (
            inputs if isinstance(inputs, (list, tuple)) else [inputs])]
        aux_names = outputs.list_auxiliary_states()
        for name in outputs.list_arguments() + aux_names:
            if name in self._in_names:
                continue
            self._reg_params[name] = self.params.get(
                name, allow_deferred_init=True,
                grad_req="null" if name in aux_names else "write")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock from an exported ``-symbol.json`` and (optional)
        ``.params`` file; the parameters live on ``ctx`` (default: the
        current context, the card)."""
        from .. import symbol as sym_mod
        from ..ndarray import load as nd_load

        outputs = sym_mod.load(symbol_file)
        names = input_names if isinstance(input_names, (list, tuple)) \
            else [input_names]
        block = SymbolBlock(outputs, [sym_mod.Variable(n) for n in names])
        if param_file is not None:
            for k, v in nd_load(param_file, ctx=ctx).items():
                name = k.split(":", 1)[-1]
                if name in block._reg_params:
                    p = block._reg_params[name]
                    p.shape = tuple(v.shape)
                    p.initialize(ctx=ctx)
                    p.set_data(v)
        return block

    def forward(self, *args):
        if not isinstance(args[0], NDArray):
            raise MXNetError("SymbolBlock expects NDArray inputs")
        from .. import autograd

        sym = self._out_symbol
        try:
            arg_vals = {n: p.data() for n, p in self._reg_params.items()}
        except DeferredInitializationError:
            shapes = {n: a.shape for n, a in zip(self._in_names, args)}
            arg_shapes, _, aux_shapes = sym.infer_shape_partial(**shapes)
            by_name = dict(zip(sym.list_arguments(), arg_shapes))
            by_name.update(zip(sym.list_auxiliary_states(), aux_shapes))
            for n, p in self._reg_params.items():
                if p._deferred_init is not None and \
                        by_name.get(n) is not None:
                    p._finish_deferred_init(by_name[n])
            arg_vals = {n: p.data() for n, p in self._reg_params.items()}
        for n, a in zip(self._in_names, args):
            arg_vals[n] = a
        ex = sym.bind(ctx=args[0].context, args=arg_vals, grad_req="null",
                      aux_states={n: arg_vals[n]
                                  for n in sym.list_auxiliary_states()
                                  if n in arg_vals})
        outs = ex.forward(is_train=autograd.is_training())
        return outs[0] if len(outs) == 1 else outs
