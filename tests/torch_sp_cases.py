"""Rank-side cases of the port's sequence-parallel parity tests.

``tests/test_torch_ring_attention.py`` and
``tests/test_torch_transformer_sp.py`` start gloo process groups on the
CPU once per file (``mxnet_tpu_torch.dist.launch``) and run every case
of this module in them; each case's result, or its traceback, comes
back to the test process, which holds it against the JAX package's CPU
mesh.  This module imports no JAX: the inputs cross as numpy arrays and
paths.
"""
import numpy as np
import torch

from torch_dp_cases import run_cases


def _t(a):
    return torch.from_numpy(np.array(a))


def _sp_mesh():
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((dist.num_processes(),), ("sp",))


def _body(impl):
    from mxnet_tpu_torch.parallel.ring_attention import ring_attention
    from mxnet_tpu_torch.parallel.sequence import ulysses_attention

    return ring_attention if impl == "ring" else ulysses_attention


def _gather(x, mesh):
    from mxnet_tpu_torch.parallel.ring_attention import _gather_seq

    return _gather_seq(x, mesh, "sp").numpy()


def attention_run(spec, impl, causal, dtype):
    """This rank's slice of q/k/v through the per-shard body, then the
    gradients of sum(out * dO) — the global output and every gradient
    gathered over the ring."""
    from mxnet_tpu_torch.parallel.ring_attention import _my_slice

    mesh = _sp_mesh()
    full = [_t(spec[n]).to(getattr(torch, dtype))
            for n in ("q", "k", "v", "do")]
    q, k, v, do = (_my_slice(x, mesh, "sp") for x in full)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = _body(impl)(*leaves, mesh, causal=causal)
    out.backward(do)
    return {"out": _gather(out.detach(), mesh),
            "grads": [_gather(x.grad, mesh) for x in leaves]}


def sharded_run(spec, impl, causal, v_name="v"):
    """The global-view helper on full tensors (float64)."""
    from mxnet_tpu_torch.parallel.ring_attention import \
        ring_attention_sharded
    from mxnet_tpu_torch.parallel.sequence import ulysses_attention_sharded

    fn = ring_attention_sharded if impl == "ring" \
        else ulysses_attention_sharded
    return fn(_t(spec["q"]), _t(spec["k"]), _t(spec[v_name]), _sp_mesh(),
              causal=causal).numpy()


def _heads_indivisible(spec):
    from mxnet_tpu_torch.parallel.sequence import ulysses_attention

    q = torch.zeros(1, 4, 3, 8, dtype=torch.float64)
    try:
        ulysses_attention(q, q, q, _sp_mesh())
    except ValueError as e:
        return str(e)
    return None


def attention_cases(spec) -> dict:
    """Every rank-side case of tests/test_torch_ring_attention.py."""
    cases = []
    for impl in ("ring", "ulysses"):
        for causal in (False, True):
            for dtype in ("float64", "float32"):
                cases.append(("%s_%s_%s" % (impl, causal, dtype),
                              lambda s, a=(impl, causal, dtype):
                              attention_run(s, *a)))
            cases.append(("sharded_%s_%s" % (impl, causal),
                          lambda s, a=(impl, causal): sharded_run(s, *a)))
    for v_name in ("v", "v_second_half", "v_pos9"):
        cases.append(("edge_" + v_name,
                      lambda s, v=v_name: sharded_run(s, "ring", True, v)))
    cases.append(("heads_indivisible", _heads_indivisible))
    return run_cases(cases, spec)


# ---------------------------------------------------------------------------
# the transformer LM over a dp x sp mesh
# ---------------------------------------------------------------------------
def lm_mesh(spec):
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(tuple(spec["mesh"]), ("dp", "sp"))


def lm_fit(spec, impl, steps=3, mesh="mesh", ckpt=None, every=None,
           resume=None, **kw):
    """``TransformerTrainStep`` from the JAX package's start parameters
    over ``spec["mesh"]`` (dp x sp; ``mesh=None``: one device) with
    attention ``impl``, ``fit`` for ``steps`` steps."""
    from mxnet_tpu_torch import transformer as tr

    cfg = tr.TransformerConfig(**dict(spec["cfg"], dtype="float64",
                                      param_dtype="float64"))
    s = tr.TransformerTrainStep(
        cfg, mesh=lm_mesh(spec) if mesh == "mesh" else None,
        attn_impl=impl, device="cpu", **dict(spec["step"], **kw))
    s.load_state({"params": {k: _t(v) for k, v in spec["p0"].items()}})
    losses = s.fit(tr.LMTokenIter(**spec["iter"]), steps,
                   checkpoint_every_n=every, checkpoint_dir=ckpt,
                   resume_from=resume)
    return {"losses": losses, "params": s.params_numpy(),
            "zero1": s.zero1, "n_dp": s.n_dp, "n_sp": s.n_sp,
            "impl": s.attention_impl,
            "state_bytes": s.optimizer_state_bytes_per_rank()}


def transformer_cases(spec) -> dict:
    """Every rank-side case of tests/test_torch_transformer_sp.py."""
    d = spec["dirs"]
    cases = []
    for impl in ("ring", "ulysses"):
        cases += [
            (impl + "_z0", lambda s, i=impl: lm_fit(s, i, zero_stage=0)),
            (impl + "_z1", lambda s, i=impl: lm_fit(s, i, zero_stage=1)),
            (impl + "_lr0_z0", lambda s, i=impl: lm_fit(
                s, i, zero_stage=0, learning_rate=0.0)),
            (impl + "_lr0_z1", lambda s, i=impl: lm_fit(
                s, i, zero_stage=1, learning_rate=0.0)),
        ]
    cases.append(("write_z1", lambda s: lm_fit(
        s, "ring", zero_stage=1, ckpt=d["port_sp"], every=3)))
    cases.append(("reduce_axes", _reduce_axes))
    cases.append(("zero1_sp_update", _zero1_sp_update))
    return run_cases(cases, spec)


def _zero1_sp_update(spec):
    """``dp.zero1_bucketed_update`` from this rank's unreduced gradients
    with ``sp_axis``: the new parameters and this rank's momentum
    shards (float64)."""
    from mxnet_tpu_torch.parallel import buckets, dp

    mesh = lm_mesh(spec)
    g = torch.Generator().manual_seed(100 + mesh.rank)
    params = {"a": torch.linspace(-1, 1, 5, dtype=torch.float64),
              "b": torch.ones(3, 2, dtype=torch.float64)}
    grads = {k: torch.randn(v.shape, generator=g, dtype=torch.float64)
             for k, v in params.items()}
    plan = buckets.plan_for_arrays(params, 1 << 20)
    moms = dp.zero1_momentum_buffers(plan, mesh.axis_size("dp"))
    moms = [m.double() for m in moms]
    new_p, new_m = dp.zero1_bucketed_update(
        grads, params, moms, plan, mesh, lr=0.5, momentum=0.9, wd=0.0,
        mean_n=mesh.size, sp_axis="sp")
    return {"params": {k: v.numpy() for k, v in new_p.items()},
            "moms": [m.numpy() for m in new_m],
            "grads": {k: v.numpy() for k, v in grads.items()},
            "p0": {k: v.numpy() for k, v in params.items()}}


def _reduce_axes(spec):
    """``buckets.bucketed_reduce`` over the sp subgroup, the dp subgroup
    and the whole mesh, of this rank's ``rank + 1``."""
    from mxnet_tpu_torch.parallel import buckets

    mesh = lm_mesh(spec)
    out = {}
    for axis in ("sp", "dp", None):
        grads = {"a": torch.full((3,), mesh.rank + 1.0),
                 "b": torch.full((2, 2), mesh.rank + 1.0)}
        plan = buckets.plan_for_arrays(grads, 16)
        got = buckets.bucketed_reduce(grads, plan, mesh, axis=axis,
                                      impl="psum")
        out[str(axis)] = {k: v.numpy() for k, v in got.items()}
    return out


def sp_only_cases(spec) -> dict:
    """The cases of a (1, n) mesh: sequence parallelism alone, the whole
    group one sp line (its collectives on the default group)."""
    return run_cases([
        ("ring_z0", lambda s: lm_fit(s, "ring", zero_stage=0)),
        ("ulysses_z0", lambda s: lm_fit(s, "ulysses", zero_stage=0)),
        ("ring_z1", lambda s: lm_fit(s, "ring", zero_stage=1)),
    ], spec)


def one_rank_sp(spec=None):
    """A (1, 1) dp x sp mesh on one rank: the step builds and runs
    flash; ring raises (no sp axis of more than one rank)."""
    from mxnet_tpu_torch import transformer as tr
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((1, 1), ("dp", "sp"))
    cfg = tr.TransformerConfig(vocab_size=64, n_layers=2, d_model=32,
                               n_heads=2, d_ff=64)
    s = tr.TransformerTrainStep(cfg, mesh=mesh, device="cpu")
    toks = np.arange(32).reshape(2, 16) % 64
    out = {"shape": s.mesh.shape, "impl": s.attention_impl,
           "loss": float(s.step(toks, toks))}
    try:
        tr.TransformerTrainStep(cfg, mesh=mesh, attn_impl="ring",
                                 device="cpu").attention_impl
        out["ring"] = None
    except ValueError as e:
        out["ring"] = str(e)
    return out


def ring_fault_cases(spec) -> dict:
    """chip_smoke's planted ring faults on a (1, n) mesh: a clean ring
    run, each fault (``chip_smoke._ring_fault``), and a clean run after
    them; the parameters after ``spec["steps"]`` steps."""
    import chip_smoke as cs

    def run(fault):
        with cs._ring_fault(fault):
            return lm_fit(spec, "ring", steps=spec["steps"],
                          zero_stage=0)["params"]

    return run_cases([(f, lambda s, f=f: run(f))
                      for f in (None,) + cs.RING_FAULTS] +
                     [("after", lambda s: run(None))], spec)


def sp_attention_check_cases(spec) -> dict:
    """chip_smoke's train_lm_sp attention check (``_sp_attention_check``)
    cut to ``spec``'s shapes, float32 on the CPU, on a (1, n) mesh: ring
    and Ulysses clean, then the ring under each planted fault."""
    import chip_smoke as cs
    from mxnet_tpu_torch import transformer as tr
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    cs.LM_SP = dict(cs.LM_SP, batch=spec["batch"], seq=spec["seq"])
    cs.lm_config = lambda **over: tr.TransformerConfig(**spec["cfg"])
    mesh = make_mesh((1, spec["sp"]), ("dp", "sp"))
    cpu = torch.device("cpu")

    def run(impl, fault=None):
        with cs._ring_fault(fault):
            return cs._sp_attention_check(mesh, impl, device=cpu,
                                          dtype=torch.float32)

    return run_cases([(i, lambda s, i=i: run(i)) for i in
                      ("ring", "ulysses")] +
                     [(f, lambda s, f=f: run("ring", f))
                      for f in cs.RING_FAULTS], spec)
