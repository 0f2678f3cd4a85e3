"""Legacy / reference symbol-JSON upgrade path.

Counterpart: ``mxnet_tpu/symbol/legacy_json.py``, a copy (pure Python
over the port's op registry).

ref: src/nnvm/legacy_json_util.cc (the upgrader chain applied by
LoadLegacyJSONPass: FixParsing + 0.8->0.9 missing-input variables +
0.9.4->0.9.5 argmin/argmax axis semantics), c_api_symbolic.cc:40
kHiddenKeys, python/mxnet/model.py:396 load_checkpoint.

Reference checkpoints serialize every node attribute as a *string*
("kernel": "(3,3)", "no_bias": "True") and, depending on the saving
version, put them under ``param``, ``attr`` or ``attrs``.  This module
canonicalizes any such graph into the form the executor consumes:
typed python params, ``attrs`` key, hidden keys in ``__key__`` form on
the right node, auxiliary-input variables materialized, and params not
meaningful on this backend (cudnn knobs, workspace hints) dropped.
"""
from __future__ import annotations

import ast
import inspect
import logging
from typing import Any, Dict, List

from ..ops import registry as _op_registry

# node-attr keys the reference treats as framework-level rather than op
# params (c_api_symbolic.cc:40)
HIDDEN_KEYS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring",
               "mirror_stage")

# reference op params with no meaning here: device tuning knobs and
# layout hints the backend owns.  Dropped silently on load.
_BACKEND_ONLY = {
    "workspace", "cudnn_tune", "cudnn_off", "cudnn_algo_verbose",
    "cudnn_algo_fwd", "cudnn_algo_bwd_data", "cudnn_algo_bwd_filter",
    "cudnn_algo_fwd_prec", "cudnn_algo_bwd_prec", "key_var_num_args",
}

_MISSING = object()


def parse_attr_value(v: str) -> Any:
    """A reference string attribute to the typed python value our op
    bodies take: tuples/ints/floats/bools parse, enums and names stay
    strings ("relu" is not a literal, "(3, 3)" is)."""
    if not isinstance(v, str):
        return v
    s = v.strip()
    if s in ("True", "true"):
        return True
    if s in ("False", "false"):
        return False
    if s in ("None", "none"):
        return None
    try:
        parsed = ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return v
    if isinstance(parsed, (int, float, tuple, list)):
        return tuple(parsed) if isinstance(parsed, list) else parsed
    return v


def _node_attrs(spec: Dict[str, Any]) -> Dict[str, str]:
    """Merge the version-dependent attribute containers: 0.8 saved
    ``param``, nnvm-era saved ``attr``, modern saves ``attrs``."""
    attrs: Dict[str, str] = {}
    for key in ("param", "attr", "attrs"):
        d = spec.get(key)
        if isinstance(d, dict):
            attrs.update(d)
    return attrs


def _accepted_params(op_name: str):
    """Keyword params the registered op body accepts (None = anything:
    the body takes **params)."""
    try:
        op = _op_registry.get(op_name)
    except KeyError:
        return None
    try:
        sig = inspect.signature(op.fn)
    except (TypeError, ValueError):
        return None
    names = set()
    for p in sig.parameters.values():
        if p.kind == inspect.Parameter.VAR_KEYWORD:
            return None
        if p.kind in (inspect.Parameter.KEYWORD_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD) \
                and p.default is not inspect.Parameter.empty:
            names.add(p.name)
    return names


def _version(data: Dict[str, Any]) -> int:
    """MXNET_MAKE_VERSION-coded saver version; graphs without the
    stamp predate 0.9 (legacy_json_util.cc:179)."""
    attrs = data.get("attrs", {})
    v = attrs.get("mxnet_version")
    if isinstance(v, (list, tuple)) and len(v) == 2:
        return int(v[1])
    return 800


def upgrade_json(data: Dict[str, Any]) -> Dict[str, Any]:
    """Canonicalize a (possibly legacy) reference graph dict in place:
    after this every node has a typed ``attrs`` dict, hidden keys moved
    to ``__key__`` form on the owning node, pre-0.9 implicit parameter
    variables materialized, and 2-element input/head entries padded."""
    version = _version(data)
    nodes: List[Dict[str, Any]] = data["nodes"]

    # pad [node, out] entries to [node, out, 0]
    for spec in nodes:
        spec["inputs"] = [list(e) + [0] * (3 - len(e))
                          for e in spec.get("inputs", [])]
    if "heads" in data:
        data["heads"] = [list(e) + [0] * (3 - len(e))
                         for e in data["heads"]]

    for spec in nodes:
        raw = _node_attrs(spec)
        op = spec.get("op", "null")
        is_var = op == "null"

        # --- FixParsing: hidden keys out of the op-param namespace ---
        hidden: List = []
        for k in list(raw):
            for key in HIDDEN_KEYS:
                if k == key or (k.endswith("_" + key) and
                                len(k) > len(key) + 1):
                    hidden.append((k, raw.pop(k)))
                    break

        attrs: Dict[str, Any] = {}
        for k, v in raw.items():
            if k.startswith("__") and k.endswith("__"):
                attrs[k] = v
            else:
                attrs[k] = parse_attr_value(v)

        for k, v in hidden:
            for key in HIDDEN_KEYS:
                if k == key:
                    attrs["__%s__" % key] = v
                    break
                if k.endswith("_" + key):
                    # "<argname>_<key>" belongs on the matching input
                    # variable (legacy_json_util.cc:62-77)
                    argname = k[: -(len(key) + 1)]
                    target = _input_var_for(spec, nodes, argname)
                    if target is not None:
                        tattrs = _node_attrs(target)
                        tattrs["__%s__" % key] = v
                        target["attrs"] = tattrs
                    else:
                        attrs[k] = v
                    break

        # --- drop backend-only knobs + params our body doesn't take ---
        if not is_var:
            accepted = _accepted_params(op)
            for k in list(attrs):
                if k.startswith("__"):
                    continue
                if k in _BACKEND_ONLY or \
                        (accepted is not None and k not in accepted):
                    if k not in _BACKEND_ONLY:
                        # loud: a semantic parameter the op body doesn't
                        # take would otherwise be silently ignored and
                        # produce wrong numerics, not an error
                        logging.getLogger(__name__).warning(
                            "legacy load: dropping param %s=%r of %s "
                            "(not accepted by the op body — verify "
                            "the loaded model does not rely on it)",
                            k, attrs[k], op)
                    attrs.pop(k)

        # --- 0.9.4 -> 0.9.5: argmin/argmax axis=-1 meant "flatten" ---
        if version < 905 and op in ("argmin", "argmax") and \
                attrs.get("axis", _MISSING) == -1:
            attrs.pop("axis")

        spec["attrs"] = attrs
        spec.pop("param", None)
        spec.pop("attr", None)

    # --- 0.8 -> 0.9: materialize missing parameter variables ---------
    if version < 900:
        _materialize_missing_inputs(data)
        _toposort(data)
    return data


def _toposort(data):
    """Re-establish the nodes-before-consumers invariant (materialized
    variables were appended after their consumers)."""
    nodes = data["nodes"]
    order: List[int] = []
    state = [0] * len(nodes)  # 0 unvisited, 1 in-stack, 2 done

    def visit(root):
        # explicit stack: legacy unrolled-RNN graphs can be thousands of
        # nodes deep, past Python's recursion limit.  (A cyclic graph —
        # only possible in a corrupt file — surfaces as an index error
        # at node construction, not an infinite loop: gray nodes are
        # never re-pushed.)
        stack = [(root, False)]
        while stack:
            i, expanded = stack.pop()
            if expanded:
                state[i] = 2
                order.append(i)
                continue
            if state[i]:
                continue
            state[i] = 1
            stack.append((i, True))
            for e in reversed(nodes[i].get("inputs", [])):
                if state[e[0]] == 0:
                    stack.append((e[0], False))

    for e in data.get("heads", []):
        visit(e[0])
    for i in range(len(nodes)):  # keep unreachable nodes too
        if state[i] == 0:
            visit(i)
    remap = {old: new for new, old in enumerate(order)}
    data["nodes"] = [nodes[i] for i in order]
    for spec in data["nodes"]:
        spec["inputs"] = [[remap[e[0]], e[1], e[2]]
                          for e in spec.get("inputs", [])]
    data["arg_nodes"] = sorted(remap[i] for i in data.get("arg_nodes", []))
    if "heads" in data:
        data["heads"] = [[remap[e[0]], e[1], e[2]] for e in data["heads"]]


def _input_var_for(spec, nodes, argname):
    """The input variable node bound to op-argument ``argname``."""
    op = spec.get("op", "null")
    try:
        input_names = _op_registry.get(op).input_names or ()
    except KeyError:
        return None
    if argname not in input_names:
        return None
    idx = list(input_names).index(argname)
    inputs = spec.get("inputs", [])
    if idx >= len(inputs):
        return None
    target = nodes[inputs[idx][0]]
    return target if target.get("op", "null") == "null" else None


def _materialize_missing_inputs(data):
    """Pre-0.9 graphs omit trailing parameter/aux inputs; recreate them
    as variables named ``<node>_<argname>``
    (legacy_json_util.cc:116-133)."""
    nodes = data["nodes"]
    arg_nodes = set(data.get("arg_nodes", []))
    for spec in list(nodes):
        op = spec.get("op", "null")
        if op == "null":
            continue
        try:
            input_names = _op_registry.get(op).input_names or ()
        except KeyError:
            continue
        inputs = spec["inputs"]
        if len(inputs) >= len(input_names):
            continue
        for i in range(len(inputs), len(input_names)):
            new_id = len(nodes)
            nodes.append({"op": "null",
                          "name": "%s_%s" % (spec["name"], input_names[i]),
                          "attrs": {}, "inputs": []})
            arg_nodes.add(new_id)
            inputs.append([new_id, 0, 0])
    data["arg_nodes"] = sorted(arg_nodes)
