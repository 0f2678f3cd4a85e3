"""Shape/type inference over Symbol graphs.

Counterpart: ``mxnet_tpu/symbol/infer.py`` (ref:
src/executor/infer_graph_attr_pass.cc:477 InferShape/InferType).  Output
shapes and dtypes come from running each op body on ``device="meta"``
tensors (shapes, no data), where the JAX package traces it with
``jax.eval_shape``; the rule table below derives *parameter* shapes from
data shapes, the one direction a forward run cannot recover (weight
shape from data shape), which the reference encodes in each op's
FInferShape.  A body that reads values (``.item()``, numpy) cannot run
on meta tensors: such an op needs a rule.  ``RNN``'s rule derives its
blob and state shapes from the data's; the rules of ``Custom``, the
Caffe/Torch plugins and ``WarpCTC`` come with their ops (ROADMAP A12).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as _np
import torch

from ..base import MXNetError, dtype_name, torch_dtype
from ..ops import registry as _op_registry

# ---------------------------------------------------------------------------
# parameter-shape rules: op name → fn(params, in_shapes) → {input_name: shape}
# in_shapes maps input names to known shapes (None when unknown).
# ---------------------------------------------------------------------------
def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def _fc_rule(p, s):
    data = s.get("data")
    if data is None:
        return {}
    nh = int(p.get("num_hidden", 0))
    in_dim = _prod(data[1:]) if p.get("flatten", True) else data[-1]
    return {"weight": (nh, in_dim), "bias": (nh,)}


def _conv_rule(p, s):
    data = s.get("data")
    if data is None:
        return {}
    nf = int(p.get("num_filter", 0))
    g = int(p.get("num_group", 1))
    kernel = tuple(p.get("kernel", ()))
    return {"weight": (nf, data[1] // g) + kernel, "bias": (nf,)}


def _deconv_rule(p, s):
    data = s.get("data")
    if data is None:
        return {}
    nf = int(p.get("num_filter", 0))
    g = int(p.get("num_group", 1))
    kernel = tuple(p.get("kernel", ()))
    return {"weight": (data[1], nf // g) + kernel, "bias": (nf,)}


def _bn_rule(p, s):
    data = s.get("data")
    if data is None:
        return {}
    ax = int(p.get("axis", 1)) % len(data)
    c = (data[ax],)
    return {"gamma": c, "beta": c, "moving_mean": c, "moving_var": c}


def _ln_rule(p, s):
    data = s.get("data")
    if data is None:
        return {}
    ax = int(p.get("axis", -1)) % len(data)
    return {"gamma": (data[ax],), "beta": (data[ax],)}


def _in_rule(p, s):
    data = s.get("data")
    if data is None:
        return {}
    return {"gamma": (data[1],), "beta": (data[1],)}


def _embedding_rule(p, s):
    return {"weight": (int(p.get("input_dim", 0)), int(p.get("output_dim", 0)))}


def _prelu_rule(p, s):
    data = s.get("data")
    if data is None or p.get("act_type", "leaky") != "prelu":
        return {}
    return {"gamma": (data[1] if len(data) > 1 else 1,)}


def _softmax_out_rule(p, s):
    data = s.get("data")
    if data is None:
        return {}
    if p.get("multi_output"):
        return {"label": (data[0],) + tuple(data[2:])}
    if p.get("preserve_shape"):
        return {"label": tuple(data[:-1])}
    return {"label": (data[0],)}


def _regression_rule(p, s):
    data = s.get("data")
    if data is None:
        return {}
    return {"label": tuple(data)}


def _rnn_rule(p, s):
    """The fused blob and state shapes from (T, N, I) data (ref: the
    reference's RNN FInferShape, src/operator/rnn-inl.h)."""
    data = s.get("data")
    if data is None or len(data) != 3:
        return {}
    from ..ops.rnn import rnn_param_size

    H = int(p.get("state_size", 0))
    L = int(p.get("num_layers", 1))
    bidir = bool(p.get("bidirectional", False))
    mode = p.get("mode", "lstm")
    state = (L * (2 if bidir else 1), data[1], H)
    return {
        "parameters": (rnn_param_size(L, data[2], H, bidir, mode),),
        "state": state,
        "state_cell": state,
    }


PARAM_SHAPE_RULES = {
    "FullyConnected": _fc_rule,
    "Convolution": _conv_rule,
    "Convolution_v1": _conv_rule,
    "Deconvolution": _deconv_rule,
    "BatchNorm": _bn_rule,
    "BatchNorm_v1": _bn_rule,
    "LayerNorm": _ln_rule,
    "InstanceNorm": _in_rule,
    "Embedding": _embedding_rule,
    "LeakyReLU": _prelu_rule,
    "SoftmaxOutput": _softmax_out_rule,
    "Softmax": _softmax_out_rule,
    "LinearRegressionOutput": _regression_rule,
    "LogisticRegressionOutput": _regression_rule,
    "MAERegressionOutput": _regression_rule,
    "RNN": _rnn_rule,
}

# inputs that are integer-typed by nature (indices / labels stay float in
# the reference's convention, so only true index inputs go here)
_INT_INPUTS = {("Embedding", "data"), ("take", "indices"), ("one_hot", "indices"),
               ("gather_nd", "indices"), ("scatter_nd", "indices")}


def public_dtype(dt: torch.dtype):
    """The dtype as the port reports it: a numpy dtype, or
    ``torch.bfloat16`` (numpy has none here), as ``NDArray.dtype``."""
    name = dtype_name(dt)
    return torch.bfloat16 if name == "bfloat16" else _np.dtype(name)


def _incomplete(sh) -> bool:
    return sh is None or any(d == 0 for d in sh)


def _infer_walk(symbol, known_shapes: Dict[str, Tuple[int, ...]],
                known_dtypes: Dict[str, torch.dtype], partial: bool):
    """Single forward pass assigning (shape, torch dtype) to every node
    output."""
    node_out: Dict[int, List[Tuple[Optional[Tuple[int, ...]], Any]]] = {}
    var_info: Dict[str, Tuple[Optional[Tuple[int, ...]], Any]] = {}
    meta = torch.device("meta")
    # rng ops draw from a throwaway generator: inference moves no state
    gen = torch.Generator()

    for node in symbol._topo():
        if node.is_variable:
            shape = known_shapes.get(node.name, node.attrs.get("__shape__"))
            dtype = known_dtypes.get(node.name, node.attrs.get("__dtype__"))
            if node.name in var_info:  # derived earlier by a rule
                dshape, ddtype = var_info[node.name]
                shape = shape if shape is not None else dshape
                dtype = dtype if dtype is not None else ddtype
            node_out[id(node)] = [(tuple(shape) if shape else None,
                                   torch_dtype(dtype) if dtype else None)]
            var_info[node.name] = node_out[id(node)][0]
            continue

        op = _op_registry.get(node.op)
        params = {k: _op_registry.coerce_attr(v)
                  for k, v in node.attrs.items() if not k.startswith("__")}
        in_names = op.input_names or tuple(
            "arg%d" % i for i in range(len(node.inputs)))

        # map known input shapes by name; run the param rule for unknown
        # or partially-known (0-dim, the deferred-init marker) shapes
        named_shapes = {}
        for (parent, oi), iname in zip(node.inputs, in_names):
            named_shapes[iname] = node_out[id(parent)][oi][0]
        rule = PARAM_SHAPE_RULES.get(op.name)
        if rule and any(_incomplete(v) for v in named_shapes.values()):
            derived = rule(params, named_shapes)
            for (parent, oi), iname in zip(node.inputs, in_names):
                cur = named_shapes.get(iname)
                if _incomplete(cur) and iname in derived:
                    new = tuple(int(x) for x in derived[iname])
                    if cur is not None and len(cur) == len(new):
                        # keep user-pinned dims, fill only the 0 markers
                        new = tuple(c if c > 0 else n for c, n in zip(cur, new))
                    old = node_out[id(parent)][oi]
                    node_out[id(parent)][oi] = (new, old[1])
                    if parent.is_variable:
                        var_info[parent.name] = node_out[id(parent)][oi]
                    named_shapes[iname] = new

        in_tensors = []
        missing = []
        for i, (parent, oi) in enumerate(node.inputs):
            sh, dt = node_out[id(parent)][oi]
            if sh is None:
                missing.append(in_names[i] if i < len(in_names) else "arg%d" % i)
                continue
            if dt is None:
                iname = in_names[i] if i < len(in_names) else ""
                dt = torch.int32 if (op.name, iname) in _INT_INPUTS \
                    else torch.float32
                node_out[id(parent)][oi] = (sh, dt)
                if parent.is_variable:
                    var_info[parent.name] = node_out[id(parent)][oi]
            in_tensors.append(torch.empty(sh, dtype=dt, device=meta))
        if missing:
            if partial:
                node_out[id(node)] = [(None, None)] * max(1, node.num_outputs)
                continue
            raise MXNetError(
                "infer_shape: cannot infer input(s) %s of node %s(%s); "
                "provide their shapes" % (missing, node.op, node.name)
            )

        if op.train_aware:
            params.setdefault("_training", True)
        args = ([gen] if op.rng else []) + in_tensors
        try:
            with torch.no_grad(), meta:
                out = op.fn(*args, **params)
        except Exception as e:
            raise MXNetError(
                "infer_shape failed at node %s(%s) (run on meta tensors; an "
                "op whose body reads values needs a shape rule): %s"
                % (node.op, node.name, e)) from None
        outs = out if isinstance(out, tuple) else (out,)
        node_out[id(node)] = [(tuple(o.shape), o.dtype) for o in outs]

    return node_out, var_info


def infer_shape(symbol, partial=False, **kwargs):
    """Returns (arg_shapes, out_shapes, aux_shapes) in list_arguments order
    (ref: symbol.py infer_shape)."""
    known = {k: tuple(v) for k, v in kwargs.items() if v is not None}
    node_out, var_info = _infer_walk(symbol, known, {}, partial)
    args = symbol.list_arguments()
    auxs = symbol.list_auxiliary_states()
    arg_shapes = [var_info.get(a, (None, None))[0] for a in args]
    aux_shapes = [var_info.get(a, (None, None))[0] for a in auxs]
    out_shapes = []
    for node, oi in symbol._flat_outputs():
        out_shapes.append(node_out[id(node)][oi][0])
    return arg_shapes, out_shapes, aux_shapes


def infer_type(symbol, **kwargs):
    """Returns (arg_types, out_types, aux_types) (ref: symbol.py
    infer_type)."""
    known_dtypes = {k: torch_dtype(v) for k, v in kwargs.items()
                    if v is not None}
    # full dtype propagation needs shapes; walk what we can, then fill the
    # rest with the dominant known dtype (float32 default) — the reference's
    # InferType fixpoint degenerates to this for float graphs
    node_out, var_info = _infer_walk(symbol, {}, known_dtypes, partial=True)
    default = torch.float32
    for dt in known_dtypes.values():
        default = dt
        break
    args = symbol.list_arguments()
    auxs = symbol.list_auxiliary_states()

    def _get(name):
        dt = var_info.get(name, (None, None))[1]
        return public_dtype(dt if dt is not None else default)

    arg_types = [_get(a) for a in args]
    aux_types = [_get(a) for a in auxs]
    out_types = [public_dtype(node_out[id(n)][oi][1] or default)
                 for n, oi in symbol._flat_outputs()]
    return arg_types, out_types, aux_types
