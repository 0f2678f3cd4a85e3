"""Symbol — declarative graph composition.

Counterpart: ``mxnet_tpu/symbol/symbol.py`` (ref:
python/mxnet/symbol/symbol.py, src/c_api/c_api_symbolic.cc).  A Symbol
is a lightweight DAG of op nodes and variables over the port's op
registry; *binding* gives an :class:`~mxnet_tpu_torch.executor.Executor`
that walks the graph eagerly on torch tensors, with ``torch.autograd``
in place of the nnvm Gradient pass.  The graph, its names and its JSON
are the JAX package's: ``tojson`` writes the same bytes for the same
graph, so symbol files load in either package.

Missing tensor inputs auto-create variables named ``{opname}_{input}``
exactly like the reference (so ``list_arguments()`` matches and init /
checkpoint code written against MXNet keeps working).
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from ..ops import registry as _op_registry
from .. import name as _name_mod

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]

class AttrScope:
    """``with mx.AttrScope(ctx_group='dev1'):`` — attribute injection used by
    model parallelism (ref: python/mxnet/attribute.py; PlaceDevice pass
    consumes ctx_group, src/executor/graph_executor.cc:406)."""

    _current = threading.local()

    def __init__(self, **attrs):
        self._attrs = {k: str(v) for k, v in attrs.items()}

    def __enter__(self):
        stack = getattr(AttrScope._current, "stack", None)
        if stack is None:
            stack = AttrScope._current.stack = []
        merged = dict(stack[-1]) if stack else {}
        merged.update(self._attrs)
        stack.append(merged)
        return self

    def __exit__(self, *exc):
        AttrScope._current.stack.pop()

    @classmethod
    def current_attrs(cls) -> Dict[str, str]:
        stack = getattr(cls._current, "stack", None)
        return dict(stack[-1]) if stack else {}


class _Node:
    """One graph vertex: an op application or a variable."""

    __slots__ = ("op", "name", "inputs", "attrs", "num_outputs")

    def __init__(self, op: Optional[str], name: str,
                 inputs: List[Tuple["_Node", int]], attrs: Dict[str, Any],
                 num_outputs: int = 1):
        self.op = op          # None for variables
        self.name = name
        self.inputs = inputs  # list of (node, out_index)
        self.attrs = attrs
        self.num_outputs = num_outputs

    @property
    def is_variable(self) -> bool:
        return self.op is None


class Symbol:
    """A handle to one (or a group of) node outputs."""

    __slots__ = ("_entries",)

    def __init__(self, entries: List[Tuple[_Node, int]]):
        self._entries = entries

    # -- identity ------------------------------------------------------
    @property
    def name(self) -> str:
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return "grouped"

    def __repr__(self) -> str:
        return "<Symbol %s>" % self.name

    def __iter__(self):
        for i in range(len(self.list_outputs())):
            yield self[i]

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            index = names.index(index)
        flat = self._flat_outputs()
        return Symbol([flat[index]])

    def _flat_outputs(self) -> List[Tuple[_Node, int]]:
        flat = []
        for node, idx in self._entries:
            if idx == -1:  # all visible outputs of the node
                n_vis = _visible_outputs(node)
                flat.extend((node, i) for i in range(n_vis))
            else:
                flat.append((node, idx))
        return flat

    # -- graph walks ---------------------------------------------------
    def _topo(self) -> List[_Node]:
        order: List[_Node] = []
        seen = set()

        def visit(node: _Node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for parent, _ in node.inputs:
                visit(parent)
            order.append(node)

        for node, _ in self._entries:
            visit(node)
        return order

    def list_arguments(self) -> List[str]:
        """Variable names in topo order, aux states excluded
        (ref: symbol.py list_arguments)."""
        aux = set(self.list_auxiliary_states())
        return [n.name for n in self._topo() if n.is_variable and n.name not in aux]

    def list_auxiliary_states(self) -> List[str]:
        aux: List[str] = []
        for node in self._topo():
            if node.is_variable or node.op is None:
                continue
            op = _op_registry.get(node.op)
            for pos in op.mutate_aux:
                if pos < len(node.inputs):
                    parent, _ = node.inputs[pos]
                    if parent.is_variable and parent.name not in aux:
                        aux.append(parent.name)
        return aux

    def list_outputs(self) -> List[str]:
        names = []
        for node, idx in self._flat_outputs():
            n_vis = _visible_outputs(node)
            if node.is_variable:
                names.append(node.name)
            elif n_vis == 1:
                names.append(node.name + "_output")
            else:
                names.append("%s_output%d" % (node.name, idx))
        return names

    def get_internals(self) -> "Symbol":
        entries = []
        for node in self._topo():
            if node.is_variable:
                entries.append((node, 0))
            else:
                entries.extend((node, i) for i in range(_visible_outputs(node)))
        return Symbol(entries)

    def attr(self, key: str) -> Optional[str]:
        node = self._entries[0][0]
        # callers pass either form (reference model-parallel code asks
        # for "__ctx_group__" directly, lstm.py:215) — look up both
        base = key[2:-2] if len(key) > 4 and key.startswith("__") \
            and key.endswith("__") else key
        v = node.attrs.get("__" + base + "__", node.attrs.get(base))
        return str(v) if v is not None else None

    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        out = {}
        for node in self._topo():
            d = {k[2:-2] if k.startswith("__") else k: str(v)
                 for k, v in node.attrs.items()
                 if k.startswith("__") or node.is_variable}
            if d:
                out[node.name] = d
        return out

    # -- composition sugar ---------------------------------------------
    def __add__(self, other): return _binary_sym("broadcast_add", "_plus_scalar", self, other)
    def __radd__(self, other): return self.__add__(other)
    def __sub__(self, other): return _binary_sym("broadcast_sub", "_minus_scalar", self, other)
    def __rsub__(self, other): return _binary_sym("broadcast_sub", "_rminus_scalar", self, other, True)
    def __mul__(self, other): return _binary_sym("broadcast_mul", "_mul_scalar", self, other)
    def __rmul__(self, other): return self.__mul__(other)
    def __truediv__(self, other): return _binary_sym("broadcast_div", "_div_scalar", self, other)
    def __rtruediv__(self, other): return _binary_sym("broadcast_div", "_rdiv_scalar", self, other, True)
    def __pow__(self, other): return _binary_sym("broadcast_power", "_power_scalar", self, other)
    def __neg__(self): return create("negative", data=self)

    def reshape(self, shape, **kw): return create("Reshape", data=self, shape=tuple(shape), **kw)
    def flatten(self): return create("Flatten", data=self)
    def transpose(self, axes=()): return create("transpose", data=self, axes=tuple(axes))
    def sum(self, axis=None, keepdims=False): return create("sum", data=self, axis=axis, keepdims=keepdims)
    def mean(self, axis=None, keepdims=False): return create("mean", data=self, axis=axis, keepdims=keepdims)
    def softmax(self, axis=-1): return create("softmax", data=self, axis=axis)

    # -- shape/type inference ------------------------------------------
    def infer_shape(self, **kwargs):
        from .infer import infer_shape

        return infer_shape(self, partial=False, **kwargs)

    def infer_shape_partial(self, **kwargs):
        from .infer import infer_shape

        return infer_shape(self, partial=True, **kwargs)

    def infer_type(self, **kwargs):
        from .infer import infer_type

        return infer_type(self, **kwargs)

    # -- binding -------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    shared_exec=None, shared_data_arrays=None, group2ctx=None,
                    **kwargs):
        """Allocate arrays from shapes and bind (ref: GraphExecutor::Init,
        src/executor/graph_executor.cc:512; python symbol.py simple_bind).
        ``ctx`` defaults to the current context, the card.
        ``group2ctx`` places each ctx group on its context (model
        parallelism, ``executor.place_nodes``)."""
        from ..executor import Executor

        return Executor.simple_bind(self, ctx=ctx, grad_req=grad_req,
                                    type_dict=type_dict, shared_exec=shared_exec,
                                    group2ctx=group2ctx, **kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, shared_exec=None, group2ctx=None, **kwargs):
        from ..executor import Executor

        return Executor.bind(self, ctx=ctx, args=args, args_grad=args_grad,
                             grad_req=grad_req, aux_states=aux_states,
                             group2ctx=group2ctx)

    def eval(self, ctx=None, **kwargs):
        ex = self.bind(ctx=ctx, args=kwargs)
        return ex.forward()

    # gradient via bind/backward; direct helper for tests
    def grad(self, wrt: Sequence[str]) -> "Symbol":
        raise MXNetError("symbol.grad: use simple_bind + backward "
                         "(torch.autograd replaces the nnvm Gradient pass "
                         "at run time)")

    # -- serialization -------------------------------------------------
    def tojson(self) -> str:
        """nnvm-style JSON graph (ref: nnvm::Graph json; format kept close to
        the reference's so saved models are inspectable)."""
        nodes = self._topo()
        node_ids = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            # strings stay raw; other python values are tagged so load_json
            # can round-trip types exactly (no eval-on-plain-strings drift)
            attrs = {k: (v if isinstance(v, str) else {"py": repr(v)})
                     for k, v in n.attrs.items()}
            out_nodes.append({
                "op": n.op if n.op is not None else "null",
                "name": n.name,
                "attrs": attrs,
                "inputs": [[node_ids[id(p)], int(i), 0] for p, i in n.inputs],
            })
        heads = [[node_ids[id(n)], int(i), 0] for n, i in self._flat_outputs()]
        return json.dumps({"nodes": out_nodes, "arg_nodes":
                           [i for i, n in enumerate(nodes) if n.is_variable],
                           "heads": heads,
                           # mxnet_tpu marks a natively-saved graph; its
                           # absence routes loads through the legacy
                           # (reference-checkpoint) upgrade path
                           "attrs": {"mxnet_version": ["int", 10000],
                                     "mxnet_tpu": ["int", 1]}},
                          indent=2)

    def save(self, fname: str) -> None:
        with open(fname, "w") as f:
            f.write(self.tojson())


def _visible_outputs(node: _Node) -> int:
    if node.is_variable:
        return 1
    op = _op_registry.get(node.op)
    return max(1, node.num_outputs - len(op.mutate_aux))


_DUNDER_HINT = {"broadcast_add": "_plus", "broadcast_sub": "_minus",
                "broadcast_mul": "_mul", "broadcast_div": "_div",
                "broadcast_power": "_power"}


def _binary_sym(op_name, scalar_op, lhs, other, reverse=False):
    if isinstance(other, Symbol):
        # auto-name like the reference's elemwise dunder ops ("_plus12"
        # etc., the _Plus/_Minus registered names): generated model code
        # addresses residual-add internals by these names (e.g.
        # example/ssd/symbol_factory.py from_layers ['_plus12', ...]).
        # The hint rides through create() so the NameManager resolves it
        # exactly ONCE (a pre-resolved name would get a Prefix twice).
        hint = _DUNDER_HINT.get(op_name, op_name)
        return create(op_name, lhs=lhs, rhs=other, __hint__=hint) \
            if not reverse else create(op_name, lhs=other, rhs=lhs,
                                       __hint__=hint)
    return create(scalar_op, data=lhs, scalar=float(other))


def Variable(name: str, attr=None, shape=None, dtype=None, init=None,
             stype=None, **kwargs) -> Symbol:
    """ref: python/mxnet/symbol/symbol.py var()."""
    attrs: Dict[str, Any] = dict(AttrScope.current_attrs())
    if attr:
        attrs.update(attr)
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    attrs.update({k: str(v) for k, v in kwargs.items()})
    node = _Node(None, name, [], attrs)
    return Symbol([(node, 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    entries = []
    for s in symbols:
        entries.extend(s._flat_outputs())
    return Symbol(entries)


def zeros(shape, dtype="float32", **kw):
    return create("_zeros", shape=tuple(shape), dtype=dtype, **kw)


def ones(shape, dtype="float32", **kw):
    return create("_ones", shape=tuple(shape), dtype=dtype, **kw)


def create(op_name: str, *args, name: Optional[str] = None, **kwargs) -> Symbol:
    """Create an op node, auto-creating missing tensor-input variables
    (the reference behavior from the generated symbol stubs)."""
    op = _lookup_op(op_name)
    # string-valued params (C ABI, reference-style code) parse to their
    # typed values here so input-arity decisions ("no_bias") see booleans
    kwargs = {k: (v if isinstance(v, Symbol) else _op_registry.coerce_attr(v))
              for k, v in kwargs.items()}
    attrs = {}
    sym_inputs: List[Tuple[_Node, int]] = []

    scope_attrs = AttrScope.current_attrs()
    if scope_attrs:
        attrs.update({"__" + k + "__" if not k.startswith("__") else k: v
                      for k, v in scope_attrs.items()})

    # all naming (auto and explicit) routes through the active
    # NameManager: a fresh `with NameManager():` scope restarts the
    # counters, and Prefix prefixes explicit names too (ref: name.py:22
    # NameManager.get / :74 Prefix.get semantics)
    hint = kwargs.pop("__hint__", None) or op.name.lower().lstrip("_")
    base = _name_mod.current().get(name, hint)

    # positional symbol inputs
    pos_syms = [a for a in args if isinstance(a, Symbol)]
    for a in args:
        if not isinstance(a, Symbol):
            raise TypeError("positional args to sym.%s must be Symbols" % op_name)

    consumed = 0
    input_names = op.input_names or tuple("arg%d" % i for i in range(len(pos_syms)))
    if op.input_names:
        for iname in input_names:
            if consumed < len(pos_syms):
                sym_inputs.append(pos_syms[consumed]._entries[0])
                consumed += 1
            elif iname in kwargs and isinstance(kwargs[iname], Symbol):
                sym_inputs.append(kwargs.pop(iname)._entries[0])
            elif iname in kwargs and kwargs[iname] is None:
                kwargs.pop(iname)
            else:
                # auto-create a variable if the op needs this input
                if _input_required(op, iname, kwargs):
                    v = Variable("%s_%s" % (base, iname))
                    sym_inputs.append(v._entries[0])
    else:
        # variadic ops (Concat, add_n, …): all positional
        sym_inputs.extend(s._entries[0] for s in pos_syms)
        # also accept the reference's *data kwarg style for variadic ops
        for k in sorted([k for k in kwargs if isinstance(kwargs.get(k), Symbol)]):
            sym_inputs.append(kwargs.pop(k)._entries[0])

    params = {k: v for k, v in kwargs.items() if not isinstance(v, Symbol)}
    attrs.update(params)
    num_outputs = _static_num_outputs(op, params)
    node = _Node(op.name, base, sym_inputs, attrs, num_outputs)
    return Symbol([(node, -1 if _visible_outputs(node) > 1 else 0)])


def _lookup_op(op_name: str) -> _op_registry.Op:
    """The registered op, or an MXNetError naming the ROADMAP item that
    brings it (A12, the op tail: CustomOp, the Caffe/Torch plugins,
    WarpCTC, linalg and the rest of ops/extra)."""
    if _op_registry.exists(op_name):
        return _op_registry.get(op_name)
    raise MXNetError("operator %r is not ported to mxnet_tpu_torch yet "
                     "(ROADMAP A12, the op tail: CustomOp, the Caffe/Torch "
                     "plugins, linalg and the rest of ops/extra)"
                     % op_name)


def _input_required(op: _op_registry.Op, iname: str, kwargs: Dict[str, Any]) -> bool:
    if iname == "bias":
        return not kwargs.get("no_bias", _default_no_bias(op))
    if iname == "gamma" and op.name == "LeakyReLU":
        return kwargs.get("act_type", "leaky") == "prelu"
    if iname == "sequence_length":
        return bool(kwargs.get("use_sequence_length", False))
    if iname == "label":  # loss layers auto-create a label variable
        return True
    return True


def _default_no_bias(op) -> bool:
    return op.name == "Deconvolution"


def _static_num_outputs(op: _op_registry.Op, params: Dict[str, Any]) -> int:
    """Total arrays the op body returns (visible outputs + aux writebacks)."""
    # attrs may arrive as strings (JSON load, C ABI) — "False" is truthy
    params = {k: _op_registry.coerce_attr(v) for k, v in params.items()}
    if op.name == "SliceChannel":
        return int(params.get("num_outputs", 1))
    if op.name == "BatchNorm":
        return (3 if params.get("output_mean_var") else 1) + 2
    if op.name == "LayerNorm":
        return 3 if params.get("output_mean_var") else 1
    if op.name == "topk":
        return 2 if params.get("ret_typ") == "both" else 1
    if op.name in ("_contrib_Proposal", "_contrib_MultiProposal"):
        return 2 if params.get("output_score") else 1
    if op.name == "RNN":
        if not params.get("state_outputs"):
            return 1
        return 3 if params.get("mode", "lstm") == "lstm" else 2
    return op.num_outputs + len(op.mutate_aux)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str: str) -> Symbol:
    """Native graphs round-trip exactly; anything without the
    ``mxnet_tpu`` stamp is treated as a reference/legacy checkpoint and
    canonicalized first (string params -> typed, ``param``/``attr``
    containers, hidden keys, pre-0.9 implicit inputs — ref:
    src/nnvm/legacy_json_util.cc via symbol/legacy_json.py)."""
    data = json.loads(json_str)
    if "mxnet_tpu" not in data.get("attrs", {}):
        from .legacy_json import upgrade_json

        data = upgrade_json(data)
    nodes: List[_Node] = []
    for spec in data["nodes"]:
        inputs = [(nodes[i], oi) for i, oi, _ in spec["inputs"]]
        attrs = {}
        for k, v in spec.get("attrs", {}).items():
            if isinstance(v, dict) and set(v) == {"py"}:
                attrs[k] = eval(v["py"], {"__builtins__": {}})  # reverse of repr()
            else:
                attrs[k] = v
        op = None if spec["op"] == "null" else spec["op"]
        num_outputs = 1
        if op is not None:
            params = {k: v for k, v in attrs.items() if not k.startswith("__")}
            num_outputs = _static_num_outputs(_lookup_op(op), params)
        nodes.append(_Node(op, spec["name"], inputs, attrs, num_outputs))
    heads = [(nodes[i], oi) for i, oi, _ in data["heads"]]
    return Symbol(heads)
