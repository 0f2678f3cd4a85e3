"""Executor — a bound Symbol, run eagerly on torch tensors.

Counterpart: ``mxnet_tpu/executor.py`` (ref: GraphExecutor,
src/executor/graph_executor.cc:512-1375, include/mxnet/executor.h).
The JAX package lowers the graph to three jit-compiled programs over one
pure evaluator; the port keeps the evaluator (:func:`build_graph_eval`,
an eager walk over the topological order, with every rule of the JAX
package's ``apply_node``) and runs it directly:

  * ``forward(is_train)`` — one walk; in training it writes the aux
    states (BatchNorm's moving statistics) back into their cells;
  * ``run_train_step``    — one walk under ``torch.enable_grad`` and one
    ``torch.autograd.grad`` to the arguments whose ``grad_req`` is not
    ``null`` (the fused step ``Module.forward_backward`` drives); it
    writes the aux states once;
  * ``backward``          — ``run_train_step`` without touching the
    outputs of an earlier ``forward``.  As in the JAX package, whose
    backward recomputes the forward inside its fused program, it runs
    the forward again: a manual ``forward(is_train=True)`` +
    ``backward()`` moves the moving statistics twice, where
    ``Module.forward_backward`` moves them once.

Random ops draw from the per-device ``torch.Generator`` of
``mx.random`` (``mx.random.seed`` reseeds it), where the JAX package
folds the node index into a fresh key; parity tests never compare
draws.  ``group2ctx`` places the graph (model parallelism,
:func:`place_nodes`): each op node runs on its ``ctx_group``'s device,
its inputs copied across at group boundaries (autograd carries the
gradients back), the argument, gradient and aux cells of a variable
live on its placed device, and the outputs come back to the executor's
device.  ``forward`` and the training walk stamp the JAX package's
``Forward<out>`` / ``Backward<out>`` profiler spans (cat ``symbolic``),
synchronised to the card's work while the profiler runs with
``profile_sync``, with the ``profile_memory`` samples around each.

The memory tier is the JAX package's (``remat.py``):

  * ``MXNET_REMAT_POLICY=stage|conv_block`` segments the graph by the
    ``stageN_`` of its node and parameter names (:func:`_remat_plan`);
    a training walk runs each segment under one checkpoint, so only its
    boundary values and its aux write-backs cross it (residual units
    share their stage's prefix on the symbol path: both policies cut at
    stages).  The Monitor tap keeps the inline walk;
  * ``MXNET_BACKWARD_DO_MIRROR`` cuts the graph, in topological order,
    after every convolution and matrix product (:func:`_mirror_plan`)
    and runs each segment under a checkpoint (with a conv policy too,
    the stage segments run);
  * the recompute replays the draws of the executor's generator.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .base import MXNetError, torch_dtype
from .context import Context, current_context
from .ndarray import NDArray
from .ops import registry as _op_registry

__all__ = ["Executor", "build_graph_eval", "place_nodes"]


def place_nodes(symbol, default_ctx: Context,
                group2ctx: Optional[Dict[str, Context]]):
    """The PlaceDevice pass (ref: graph_executor.cc:406, nnvm
    PlaceDevice; counterpart ``mxnet_tpu/executor.py:48-85``): assign
    every graph node a Context.

    Op nodes take their ``__ctx_group__`` attribute's mapped context;
    variables with a group of their own take theirs, the others the
    context of their first consumer (the reference allocates inputs on
    the consuming op's device); everything else ``default_ctx``.
    Returns ``{id(node): Context}``, or None when placement is trivial
    (no group maps away from the default).  Each placed context resolves
    to its device here, so a missing card raises at bind."""
    if not group2ctx:
        return None
    topo = symbol._topo()
    placement: Dict[int, Context] = {}
    nontrivial = False
    for node in topo:
        group = node.attrs.get("__ctx_group__", node.attrs.get("ctx_group"))
        if node.is_variable and group is None:
            continue  # un-grouped variables inherit a consumer below
        ctx = Context(group2ctx.get(str(group), default_ctx)) if group \
            else default_ctx
        ctx.torch_device()
        placement[id(node)] = ctx
        if ctx != default_ctx:
            nontrivial = True
    if not nontrivial:
        return None
    for node in topo:
        if node.is_variable:
            continue
        for parent, _ in node.inputs:
            if parent.is_variable and id(parent) not in placement:
                placement[id(parent)] = placement[id(node)]
    for node in topo:
        placement.setdefault(id(node), default_ctx)
    return placement


# ---------------------------------------------------------------------------
# scoped remat on the symbol path (MXNET_REMAT_POLICY=stage/conv_block;
# mxnet_tpu/executor.py:88-205)
# ---------------------------------------------------------------------------
_STAGE_RE = re.compile(r"(stage\d+)_")


def _stage_keys(topo):
    """Per-node stage key for remat segmentation, or None (boundary).

    A node's stage is read from its own name (hand-written symbols name
    ops ``stage1_unit1_conv1``), else from the stage prefix of its
    parameter variables (gluon-exported symbols carry it only on param
    names, ``...stage1_conv0_weight``), else inherited from its
    producers when they agree (relu/pool/add between parameterized
    nodes).  Parameterized nodes whose params carry no stage (stem
    conv, FC head) or mix stages are boundaries."""
    key_of: Dict[int, Optional[str]] = {}
    for node in topo:
        m = _STAGE_RE.search(node.name or "")
        if node.is_variable:
            key_of[id(node)] = m.group(1) if m else None
            continue
        if m:
            key_of[id(node)] = m.group(1)
            continue
        var_in = [p for p, _ in node.inputs if p.is_variable]
        vkeys = {key_of[id(p)] for p in var_in} - {None}
        if len(vkeys) == 1:
            key_of[id(node)] = vkeys.pop()
        elif vkeys or var_in:
            key_of[id(node)] = None
        else:
            akeys = {key_of[id(p)] for p, _ in node.inputs} - {None}
            key_of[id(node)] = akeys.pop() if len(akeys) == 1 else None
    return key_of


class _RematSegment:
    """One contiguous same-stage run of op nodes, run under ONE
    checkpoint: only the values crossing the segment boundary
    (``in_refs`` consumed from outside, ``out_refs`` read outside or
    graph outputs) and the aux write-backs leave it; everything inside
    is recomputed in backward."""

    __slots__ = ("key", "nodes", "node_ids", "in_refs", "out_refs",
                 "aux_out_names")

    def __init__(self, key, nodes):
        self.key = key
        self.nodes = nodes
        self.node_ids = {id(n) for n in nodes}
        self.in_refs: List[Tuple[int, int]] = []
        self.out_refs: List[Tuple[int, int]] = []
        self.aux_out_names: List[str] = []


# symbol ops whose outputs the mirror keeps: a mirror segment ends at
# each
_MIRROR_KEEPS = frozenset({"Convolution", "Deconvolution",
                           "FullyConnected", "dot", "batch_dot"})


def _mirror_keys(topo):
    """Per-node mirror segment key: a segment runs up to and including
    the next node whose output the mirror keeps."""
    key_of: Dict[int, Optional[str]] = {}
    seg = 0
    for node in topo:
        if node.is_variable:
            key_of[id(node)] = None
            continue
        key_of[id(node)] = "mirror%d" % seg
        if _op_registry.get(node.op).name in _MIRROR_KEEPS:
            seg += 1
    return key_of


def _mirror_plan(topo, flat_outputs, aux_names):
    """:func:`_remat_plan` over the mirror's segments."""
    return _remat_plan(topo, flat_outputs, aux_names, _mirror_keys(topo))


def _remat_plan(topo, flat_outputs, aux_names, key_of=None):
    """Segment the topo order into ('node', n) / ('seg', _RematSegment)
    entries covering every non-variable node, or None when the graph
    carries no stage structure (then the plain inline loop runs).
    Correct for ANY grouping — each segment threads its exact boundary
    values — so an imperfect name heuristic only costs memory, never
    numerics.  ``key_of`` (node id -> segment key) defaults to the
    stages of :func:`_stage_keys`."""
    if key_of is None:
        key_of = _stage_keys(topo)
    op_nodes = [n for n in topo if not n.is_variable]
    if not any(key_of[id(n)] for n in op_nodes):
        return None
    runs: List[Tuple[Optional[str], List[Any]]] = []
    for n in op_nodes:
        k = key_of[id(n)]
        if runs and runs[-1][0] == k:
            runs[-1][1].append(n)
        else:
            runs.append((k, [n]))
    # global consumer map: which op nodes read each (producer, out_idx)
    consumers: Dict[Tuple[int, int], set] = {}
    for n in op_nodes:
        for p, oi in n.inputs:
            consumers.setdefault((id(p), oi), set()).add(id(n))
    out_positions = {(id(n), oi) for n, oi in flat_outputs}

    plan: List[Tuple[str, Any]] = []
    for k, nodes in runs:
        if k is None or len(nodes) < 2:
            plan.extend(("node", n) for n in nodes)
            continue
        seg = _RematSegment(k, nodes)
        seen_in = set()
        aux_out = set()
        for n in nodes:
            for p, oi in n.inputs:
                ref = (id(p), oi)
                if (p.is_variable or id(p) not in seg.node_ids) \
                        and ref not in seen_in:
                    seen_in.add(ref)
                    seg.in_refs.append(ref)
            for pos in _op_registry.get(n.op).mutate_aux:
                if pos < len(n.inputs):
                    parent, _ = n.inputs[pos]
                    if parent.is_variable and parent.name in aux_names:
                        aux_out.add(parent.name)
        seg.aux_out_names = sorted(aux_out)
        pos_of = {id(n): i for i, n in enumerate(nodes)}
        exported = set()
        for (pid, oi), readers in consumers.items():
            if pid in seg.node_ids and readers - seg.node_ids:
                exported.add((pid, oi))
        for pid, oi in out_positions:
            if pid in seg.node_ids:
                exported.add((pid, oi))
        seg.out_refs = sorted(exported, key=lambda r: (pos_of[r[0]], r[1]))
        plan.append(("seg", seg))
    if not any(kind == "seg" for kind, _ in plan):
        return None
    return plan


def build_graph_eval(symbol, collect_internals: bool = False,
                     placement: Optional[Dict[int, Context]] = None
                     ) -> Callable:
    """Build ``fn(arg_vals, aux_vals, generator, training) -> (outputs,
    aux_updates)`` over tensors (``aux_updates``: name -> new value).

    With ``collect_internals`` the function returns a third value, a
    dict name -> tensor of every op node's outputs, named
    ``<node>_output`` / ``<node>_output<k>`` like the reference's
    executor outputs — the data of the Monitor tap (ref:
    GraphExecutor::ExecuteMonCallback, graph_executor.cc:1418).

    Under ``MXNET_REMAT_POLICY=stage|conv_block`` (or the mirror) a walk
    that records a graph runs the segments of :func:`_remat_plan` (or
    :func:`_mirror_plan`) under checkpoints (``fn.remat_plan``); the
    Monitor tap keeps the inline walk.

    With ``placement`` (:func:`place_nodes`) each op node runs on its
    context's device: inputs from another device are copied there, and
    a random op draws from that device's generator."""
    from . import remat as _remat

    topo = symbol._topo()
    flat_outputs = symbol._flat_outputs()
    aux_names = set(symbol.list_auxiliary_states())
    remat_plan = None
    if not collect_internals:
        if _remat.remat_policy() in _remat.CONV_SCOPES:
            remat_plan = _remat_plan(topo, flat_outputs, aux_names)
        elif _remat.mirror_enabled():
            remat_plan = _mirror_plan(topo, flat_outputs, aux_names)

    # per node: (op, parsed params, aux writebacks [(k, aux name)])
    plan = {}
    for node in topo:
        if node.is_variable:
            continue
        op = _op_registry.get(node.op)
        params = {k: _op_registry.coerce_attr(v)
                  for k, v in node.attrs.items() if not k.startswith("__")}
        writes = []
        for k, pos in enumerate(op.mutate_aux):
            if pos < len(node.inputs):
                parent, _ = node.inputs[pos]
                if parent.is_variable and parent.name in aux_names:
                    writes.append((k, parent.name))
        plan[id(node)] = (op, params, writes)
    devices = None if placement is None else \
        {k: c.torch_device() for k, c in placement.items()}

    def apply_node(node, args, generator, training):
        """One op node -> (visible outputs, [(aux name, value)])."""
        op, params, writes = plan[id(node)]
        if devices is not None:
            dev = devices[id(node)]
            args = [a if a.device == dev else a.to(dev) for a in args]
            if op.rng:
                from . import random as _random

                generator = _random.generator(dev)
        if op.train_aware:
            params = dict(params, _training=training)
        if op.rng:
            args = [generator] + args
        out = op.fn(*args, **params)
        outs = list(out) if isinstance(out, tuple) else [out]
        if op.nondiff:
            # the reference registers no gradient for these ops
            outs = [o.detach() for o in outs]
        n_vis = len(outs) - len(op.mutate_aux)
        # aux writebacks route to the feeding variable's name
        aux_writes = [(name, outs[n_vis + k].detach()) for k, name in writes]
        return outs[:n_vis], aux_writes

    def eval_fn(arg_vals: Dict[str, torch.Tensor],
                aux_vals: Dict[str, torch.Tensor], generator,
                training: bool):
        env: Dict[int, List[Any]] = {}
        aux_updates: Dict[str, torch.Tensor] = {}
        internals: Dict[str, torch.Tensor] = {}
        for node in topo:
            if not node.is_variable:
                continue
            if node.name in aux_vals:
                val = aux_vals[node.name]
            elif node.name in arg_vals:
                val = arg_vals[node.name]
            else:
                raise MXNetError("unbound variable %r" % node.name)
            env[id(node)] = [val]

        def run_inline(node):
            args = [env[id(p)][oi] for p, oi in node.inputs]
            outs, aux_writes = apply_node(node, args, generator, training)
            env[id(node)] = outs
            if collect_internals:
                for k in range(len(outs)):
                    suffix = "_output" if len(outs) == 1 else "_output%d" % k
                    internals[node.name + suffix] = outs[k]
            for name, val in aux_writes:
                aux_updates[name] = val

        def run_segment(seg):
            def seg_fn(*ext_vals):
                local = dict(zip(seg.in_refs, ext_vals))
                aux_up = {}
                for node in seg.nodes:
                    args = [local[(id(p), oi)] for p, oi in node.inputs]
                    outs, aux_writes = apply_node(node, args, generator,
                                                  training)
                    for oi, v in enumerate(outs):
                        local[(id(node), oi)] = v
                    aux_up.update(aux_writes)
                return tuple(local[r] for r in seg.out_refs) + \
                    tuple(aux_up[n] for n in seg.aux_out_names)

            res = _remat.checkpoint(
                seg_fn, *[env[pid][oi] for pid, oi in seg.in_refs])
            n_out = len(seg.out_refs)
            for (pid, oi), v in zip(seg.out_refs, res[:n_out]):
                slot = env.setdefault(pid, [])
                while len(slot) <= oi:
                    slot.append(None)
                slot[oi] = v
            aux_updates.update(zip(seg.aux_out_names, res[n_out:]))

        if remat_plan is None or not torch.is_grad_enabled():
            for node in topo:
                if not node.is_variable:
                    run_inline(node)
        else:
            for kind, item in remat_plan:
                if kind == "node":
                    run_inline(item)
                else:
                    run_segment(item)
        outputs = [env[id(n)][oi] for n, oi in flat_outputs]
        if collect_internals:
            return outputs, aux_updates, internals
        return outputs, aux_updates

    eval_fn.remat_plan = remat_plan
    return eval_fn


class Executor:
    """ref: python/mxnet/executor.py Executor."""

    def __init__(self, symbol, ctx: Context, arg_dict: Dict[str, NDArray],
                 grad_dict: Dict[str, Optional[NDArray]],
                 aux_dict: Dict[str, NDArray], grad_req, group2ctx=None,
                 out_shapes=None):
        self._symbol = symbol
        self._ctx = ctx or current_context()
        self._device = self._ctx.torch_device()
        self.arg_dict = arg_dict
        self.grad_dict = grad_dict
        self.aux_dict = aux_dict
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        if isinstance(grad_req, str):
            grad_req = {k: grad_req for k in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(self._arg_names, grad_req))
        self._grad_req = grad_req
        self._group2ctx = dict(group2ctx) if group2ctx else None
        self._placement = place_nodes(symbol, self._ctx, self._group2ctx)
        self._eval = build_graph_eval(symbol, placement=self._placement)
        self._eval_internals = None
        self._grad_names = [k for k in self._arg_names
                            if self._grad_req.get(k, "null") != "null"]

        # outputs are STABLE cells allocated at bind time and refilled by
        # every forward: reference code captures ``exec.outputs`` once
        # and reads it after each forward, so identity must survive
        self.outputs: List[NDArray] = []
        try:
            if out_shapes is None:  # bind() path: infer once here
                from .symbol.infer import infer_shape

                shapes = {k: tuple(v.shape) for k, v in arg_dict.items()}
                _, out_shapes, _ = infer_shape(symbol, **shapes)
            from .ndarray import zeros as _zeros

            # through invoke, as the JAX package's executor (a running
            # profiler stamps these allocations as it does there)
            self.outputs = [_zeros(s, ctx=self._ctx)
                            for s in out_shapes if s is not None]
            if len(self.outputs) != len(self._output_names):
                self.outputs = []
        except MXNetError:
            self.outputs = []  # the first forward materializes them
        # bind-time cells hold zeros until a forward runs
        self._forward_done = False
        self._monitor_callback = None
        self._monitor_all = False

    # -- binding entry points ------------------------------------------
    @staticmethod
    def simple_bind(symbol, ctx=None, grad_req="write", type_dict=None,
                    shared_exec=None, group2ctx=None, **kwargs) -> "Executor":
        """Allocate zero-filled argument, gradient and aux cells from the
        given shapes (float32 unless ``type_dict`` says otherwise; aux
        states float32, as the JAX package) on ``ctx`` (default: the
        current context, the card) and bind."""
        from .symbol.infer import infer_shape

        ctx = Context(ctx) if ctx is not None else current_context()
        placement = place_nodes(symbol, ctx, group2ctx)
        ctx.torch_device()  # a missing card raises here, naming mx.cpu()
        # each variable's cells live on its placed context
        var_ctx: Dict[str, Context] = {}
        if placement is not None:
            for node in symbol._topo():
                if node.is_variable:
                    var_ctx[node.name] = placement[id(node)]
        shapes = {k: v for k, v in kwargs.items()
                  if isinstance(v, (tuple, list))}
        arg_shapes, out_shapes, aux_shapes = infer_shape(symbol, **shapes)
        type_dict = type_dict or {}
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        def cell(shape, dt, name):
            c = var_ctx.get(name, ctx)
            return NDArray.from_raw(torch.zeros(
                tuple(shape), dtype=dt, device=c.torch_device()), c)

        arg_dict: Dict[str, NDArray] = {}
        grad_dict: Dict[str, Optional[NDArray]] = {}
        aux_dict: Dict[str, NDArray] = {}
        for name, shape in zip(arg_names, arg_shapes):
            if shape is None:
                raise MXNetError("simple_bind: could not infer shape of %r"
                                 % name)
            dt = torch_dtype(type_dict.get(name, "float32"))
            arg_dict[name] = cell(shape, dt, name)
            req = grad_req if isinstance(grad_req, str) \
                else grad_req.get(name, "null")
            grad_dict[name] = cell(shape, dt, name) if req != "null" \
                else None
        for name, shape in zip(aux_names, aux_shapes):
            aux_dict[name] = cell(shape, torch.float32, name)
        # out_shapes rides along: the constructor must not re-run the
        # whole-graph inference this bind just performed
        return Executor(symbol, ctx, arg_dict, grad_dict, aux_dict, grad_req,
                        group2ctx=group2ctx, out_shapes=out_shapes)

    @staticmethod
    def bind(symbol, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None) -> "Executor":
        """ref: python/mxnet/symbol.py bind.  ``args_grad=None`` means no
        gradients; a dict grants them only to the names it lists
        (symbol.py:1638).  ``shared_exec`` is accepted and has no effect:
        the caching allocator owns the memory."""
        ctx = Context(ctx) if ctx is not None else current_context()
        ctx.torch_device()  # a missing card raises here, naming mx.cpu()
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            arg_dict = dict(zip(arg_names, args))
        else:
            arg_dict = dict(args or {})
        if isinstance(args_grad, (list, tuple)):
            grad_dict = dict(zip(arg_names, args_grad))
        else:
            grad_dict = dict(args_grad or {})

        def _declared_req(name):
            if isinstance(grad_req, str):
                return grad_req
            if isinstance(grad_req, (list, tuple)):
                return dict(zip(arg_names, grad_req)).get(name, "null")
            return grad_req.get(name, "null")

        eff_req = {}
        for name in arg_names:
            if grad_dict.get(name) is not None:
                eff_req[name] = _declared_req(name)
            else:
                grad_dict[name] = None
                eff_req[name] = "null"
        if isinstance(aux_states, (list, tuple)):
            aux_dict = dict(zip(aux_names, aux_states))
        else:
            aux_dict = dict(aux_states or {})
        for name in aux_names:
            if name not in aux_dict:
                raise MXNetError("bind: missing aux state %r" % name)
        return Executor(symbol, ctx, arg_dict, grad_dict, aux_dict, eff_req,
                        group2ctx=group2ctx)

    # -- execution ------------------------------------------------------
    def _generator(self) -> torch.Generator:
        from . import random as _random

        return _random.generator(self._device)

    def _arg_vals(self) -> Dict[str, torch.Tensor]:
        return {k: v._data for k, v in self.arg_dict.items()}

    def _aux_vals(self) -> Dict[str, torch.Tensor]:
        return {k: v._data for k, v in self.aux_dict.items()}

    def debug_str(self) -> str:
        """The execution plan's summary, ending in the reference's
        'Total N MB allocated' line (graph_executor debug_str;
        example/memcost reads it): the bytes of every bound cell —
        arguments, gradients, aux states and outputs.  The JAX package
        reports its compiled program's buffers there; an eager run has
        no program, so its transient activations are not in the sum."""
        lines = ["Symbol Outputs:"]
        lines += ["\toutput[%d]=%s" % (i, n)
                  for i, n in enumerate(self._output_names)]
        cells = list(self.arg_dict.values()) + list(self.aux_dict.values()) \
            + [g for g in self.grad_dict.values() if g is not None] \
            + list(self.outputs)
        nbytes = sum(c._data.numel() * c._data.element_size() for c in cells)
        lines.append("Total %d MB allocated" % int(round(nbytes / (1 << 20))))
        lines.append("Total 0 MB TempSpace resource requested")
        return "\n".join(lines) + "\n"

    def _assign_input(self, name: str, value) -> None:
        cell = self.arg_dict[name]
        if isinstance(value, NDArray):
            cell._data = value._data.detach().to(
                device=cell._data.device, dtype=cell._data.dtype)
        else:
            cell[:] = value

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """ref: GraphExecutor::Forward (graph_executor.cc:81)."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("forward: unknown argument %r" % k)
            self._assign_input(k, v)
        from . import profiler as _profiler

        _profiler.sample_memory()  # high-water pre-sample (profile_memory)
        with _profiler.span("Forward<%s>" % self._span_name(),
                            cat="symbolic"), torch.no_grad():
            if self._monitor_callback is not None:
                outs, aux_upd, internals = self._eval_monitored()(
                    self._arg_vals(), self._aux_vals(), self._generator(),
                    bool(is_train))
                self._fire_monitor(internals)
            else:
                outs, aux_upd = self._eval(self._arg_vals(),
                                           self._aux_vals(),
                                           self._generator(), bool(is_train))
            if _profiler.sync_enabled():
                _profiler.sync_device(outs)  # the span is device time
            if is_train:
                self._write_aux(aux_upd)
        _profiler.sample_memory()
        self._set_outputs(outs)
        return self.outputs

    def _span_name(self) -> str:
        """The profiler spans' label: the first output's name."""
        return self._output_names[0] if self._output_names else "?"

    # -- monitor tap (ref: MXExecutorSetMonitorCallback ->
    #    GraphExecutor::ExecuteMonCallback, graph_executor.cc:1418) ------
    def set_monitor_callback(self, callback, monitor_all: bool = False):
        """Install a (name, NDArray) callback fired for every internal
        node output after each forward; ``monitor_all`` also reports the
        input arrays (as ``<name>_data``)."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all

    def _eval_monitored(self):
        if self._eval_internals is None:
            self._eval_internals = build_graph_eval(
                self._symbol, collect_internals=True,
                placement=self._placement)
        return self._eval_internals

    def _fire_monitor(self, internals) -> None:
        if self._monitor_all:
            for k, v in self.arg_dict.items():
                self._monitor_callback(k + "_data", NDArray.from_raw(
                    v._data.detach().clone(), self._ctx))
        for name, val in internals.items():
            self._monitor_callback(name, NDArray.from_raw(
                val.detach().clone(), self._ctx))

    def _train_step(self, cots, n_given: int, monitored: bool):
        """One training forward and the gradients of the arguments in
        ``_grad_names``, with the JAX package's head-gradient rules
        (GraphExecutor::Backward): ``None`` means ones (loss outputs),
        outputs past ``n_given`` get zero cotangents (their gradient is
        dropped), a ``(1,)`` head gradient broadcasts over its output."""
        arg_vals = self._arg_vals()
        leaves = {k: arg_vals[k].detach().requires_grad_(True)
                  for k in self._grad_names}
        arg_vals.update(leaves)
        eval_fn = self._eval_monitored() if monitored else self._eval
        with torch.enable_grad():
            res = eval_fn(arg_vals, self._aux_vals(), self._generator(), True)
        outs, aux_upd = res[0], res[1]
        if monitored:
            self._fire_monitor(res[2])
        heads, head_grads = [], []
        for i, o in enumerate(outs):
            if i >= n_given or not o.requires_grad:
                continue
            c = cots[i] if i < len(cots) else None
            if c is None:
                c = torch.ones_like(o)
            else:
                c = c.to(device=o.device, dtype=o.dtype).expand(o.shape)
            heads.append(o)
            head_grads.append(c)
        names = list(leaves)
        grads = torch.autograd.grad(heads, [leaves[n] for n in names],
                                    head_grads, allow_unused=True) \
            if heads and names else [None] * len(names)
        grads = {n: (g if g is not None else torch.zeros_like(leaves[n]))
                 for n, g in zip(names, grads)}
        return [o.detach() for o in outs], grads, aux_upd

    def backward(self, out_grads=None) -> None:
        """ref: GraphExecutor::Backward (graph_executor.cc:94).  Runs the
        training forward again and the gradients (see the module
        docstring); the outputs of an earlier ``forward`` stay."""
        self.run_train_step(out_grads=out_grads, update_outputs=False)

    def run_train_step(self, out_grads=None, update_outputs: bool = True):
        """Forward + gradients in one walk (``Module.forward_backward``):
        writes the gradients per ``grad_req`` (``write`` / ``add``), the
        aux states, and — with ``update_outputs`` or before any forward —
        the outputs."""
        n_out = len(self._output_names)
        if out_grads is None:
            cots = [None] * n_out
            n_given = n_out
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cots = [g._data if g is not None else None for g in out_grads]
            n_given = len(cots)
            cots += [None] * (n_out - n_given)
        # the monitor tap fires on the fused-step path (fit's
        # forward_backward); a manual forward() already fired it
        monitored = self._monitor_callback is not None and update_outputs
        from . import profiler as _profiler

        _profiler.sample_memory()  # high-water pre-sample (profile_memory)
        with _profiler.span("Backward<%s>" % self._span_name(),
                            cat="symbolic"):
            outs, grads, aux_upd = self._train_step(cots, n_given,
                                                    monitored)
            if _profiler.sync_enabled():
                _profiler.sync_device(outs)
        _profiler.sample_memory()
        self._write_aux(aux_upd)
        if update_outputs or not self._forward_done:
            self._set_outputs(outs)
        for name in self._grad_names:
            buf = self.grad_dict.get(name)
            if buf is None:
                continue
            g = grads[name].to(buf._data.dtype)
            if self._grad_req.get(name, "write") == "add":
                buf._data = buf._data + g
            else:
                buf._data = g
        return self.outputs

    def _set_outputs(self, outs) -> None:
        """Write forward results into the stable output cells (identity
        preserved); (re)make cells only on first use or when a shape
        changed."""
        self._forward_done = True
        outs = [o if o.device == self._device else o.to(self._device)
                for o in outs]
        if len(self.outputs) != len(outs):
            self.outputs = [NDArray.from_raw(o, self._ctx) for o in outs]
            return
        for i, o in enumerate(outs):
            cell = self.outputs[i]
            if tuple(cell.shape) == tuple(o.shape):
                cell._data = o
            else:
                self.outputs[i] = NDArray.from_raw(o, self._ctx)

    def _write_aux(self, aux_upd) -> None:
        for name, val in aux_upd.items():
            cell = self.aux_dict.get(name)
            if cell is not None:
                cell._data = val.to(device=cell._data.device,
                                    dtype=cell._data.dtype)

    # -- parameter management ------------------------------------------
    @property
    def grad_arrays(self) -> List[Optional[NDArray]]:
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def arg_arrays(self) -> List[NDArray]:
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def aux_arrays(self) -> List[NDArray]:
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self._output_names, self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params: bool = False) -> None:
        """ref: Executor::CopyParams."""
        for name, arr in (arg_params or {}).items():
            if name in self.arg_dict:
                arr.copyto(self.arg_dict[name])
            elif not allow_extra_params:
                raise MXNetError("copy_params_from: unknown argument %r"
                                 % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                arr.copyto(self.aux_dict[name])
            elif not allow_extra_params:
                raise MXNetError("copy_params_from: unknown aux state %r"
                                 % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """Rebind with new shapes (ref: graph_executor.cc:1572 Reshape).
        Cells whose shape did not change are SHARED with the new
        executor, not copied: callers rely on it (a target network
        forwarding through a reshaped executor while the original's
        parameters are written in place, example/reinforcement-learning/
        dqn/base.py:297)."""
        new_shapes = {k: tuple(v) for k, v in kwargs.items()}
        ex = Executor.simple_bind(self._symbol, ctx=self._ctx,
                                  grad_req=self._grad_req,
                                  group2ctx=self._group2ctx, **new_shapes)
        for name, arr in self.arg_dict.items():
            tgt = ex.arg_dict.get(name)
            if tgt is None or tgt.shape != arr.shape:
                continue
            if tgt.dtype == arr.dtype:
                ex.arg_dict[name] = arr
            else:  # dtype changed under the new shapes: copy-with-cast
                arr.copyto(tgt)
        for name, arr in self.grad_dict.items():
            if arr is not None and ex.grad_dict.get(name) is not None \
                    and ex.grad_dict[name].shape == arr.shape \
                    and ex.grad_dict[name].dtype == arr.dtype:
                ex.grad_dict[name] = arr
        for name, arr in self.aux_dict.items():
            tgt = ex.aux_dict.get(name)
            if tgt is None or tgt.shape != arr.shape:
                continue
            if tgt.dtype == arr.dtype:
                ex.aux_dict[name] = arr
            else:
                arr.copyto(tgt)
        return ex
