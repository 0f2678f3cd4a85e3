"""Parity of the port's sequence-parallel attention
(``mxnet_tpu_torch.parallel.ring_attention``, ``.sequence``) with the
JAX package's (``mxnet_tpu.parallel.ring_attention``, ``.sequence``).

The port runs sp=2 and sp=4 gloo ranks on the CPU (once each for this
file, ``tests/torch_sp_cases.py``), the JAX package the same numpy
inputs on its CPU mesh of as many devices.  Forward and the gradients
of ``sum(out * dO)`` for ring and Ulysses, full and causal.

Tolerances.  float32: the JAX package's own limits for these impls
(``tests/test_transformer.py:88-97``: 1e-6 on the forward, atol 2e-5
and rtol 1e-5 on the gradients).  float64: 1e-6 abs, not fp64
round-off: both packages round the scores and run the softmax in
float32 whatever the input dtype (the JAX ring's ``_online_block``
casts them, ``mxnet_tpu/parallel/attention.py:55``, as the port's
kernels and their plain versions do), and they merge the blocks in
different orders (an online softmax against a log-sum-exp merge), so
float64 inputs carry float32 rounding (a few 1e-7 measured here), as in
``tests/test_torch_attention.py``.  The causal edge steps are held bit
for bit.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.parallel.attention import attention_reference as jref
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu.parallel.ring_attention import ring_attention_sharded
from mxnet_tpu.parallel.sequence import ulysses_attention_sharded
from mxnet_tpu_torch import dist
from mxnet_tpu_torch.parallel import attention as tattn
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.transformer import model as tm

import torch_sp_cases as cases

B, T, H, D = 2, 16, 4, 8
FWD_TOL = {"float64": 1e-6, "float32": 1e-6}
GRAD_TOL = {"float64": dict(atol=1e-6, rtol=0),
            "float32": dict(atol=2e-5, rtol=1e-5)}
IMPLS = ("ring", "ulysses")
SP_SIZES = (2, 4)


def _spec():
    rng = np.random.RandomState(0)
    s = {n: rng.randn(B, T, H, D) for n in ("q", "k", "v", "do")}
    s["v_second_half"] = s["v"].copy()
    s["v_second_half"][:, T // 2:] += 100.0
    s["v_pos9"] = s["v"].copy()
    s["v_pos9"][:, 9] += 100.0
    return s


SPEC = _spec()


@pytest.fixture(scope="module")
def ranks():
    return {n: dist.launch(cases.attention_cases, n, (SPEC,), device="cpu",
                           threads=1, timeout_s=600)
            for n in SP_SIZES}


def _got(ranks, n, name, rank=0):
    out = ranks[n][rank][name]
    if isinstance(out, dict) and "error" in out:
        pytest.fail("sp=%d rank %d, case %s:\n%s"
                    % (n, rank, name, out["error"]))
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(impl, causal, dtype, n):
    """The JAX package's sharded impl on an n-device mesh: the output
    and the gradients of sum(out * dO) (``jax.vjp``)."""
    mesh = jmake_mesh((n,), ("sp",), jax.devices()[:n])
    fn = ring_attention_sharded if impl == "ring" \
        else ulysses_attention_sharded
    args = [jnp.asarray(SPEC[k].astype(dtype)) for k in ("q", "k", "v")]
    out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, causal=causal),
                       *args)
    grads = vjp(jnp.asarray(SPEC["do"].astype(dtype)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", SP_SIZES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_gradients_match_jax(ranks, impl, causal, dtype, n):
    want, want_g = _jax_run(impl, causal, dtype, n)
    for r in range(n):
        got = _got(ranks, n, "%s_%s_%s" % (impl, causal, dtype), r)
        assert got["out"].dtype == want.dtype
        np.testing.assert_allclose(got["out"], want, rtol=0,
                                   atol=FWD_TOL[dtype])
        for name, g, w in zip("qkv", got["grads"], want_g):
            np.testing.assert_allclose(g, w, err_msg="d" + name,
                                       **GRAD_TOL[dtype])


@pytest.mark.parametrize("n", SP_SIZES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_helpers_match_jax(ranks, impl, causal, n):
    want = _jax_run(impl, causal, "float64", n)[0]
    got = _got(ranks, n, "sharded_%s_%s" % (impl, causal))
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL["float64"])
    # every rank returns the same full output
    np.testing.assert_array_equal(
        _got(ranks, n, "sharded_%s_%s" % (impl, causal), n - 1), got)


@pytest.mark.parametrize("n", SP_SIZES)
def test_ring_causal_edge_blocks(ranks, n):
    """The port's counterpart of tests/test_transformer.py's
    test_ring_causal_edge_blocks: a fully masked rotation step adds
    nothing (positions 0..7 never see the second half's values, bit for
    bit), and the diagonal block stays causal inside a shard (position 8
    does not see position 9)."""
    out = _got(ranks, n, "edge_v")
    out2 = _got(ranks, n, "edge_v_second_half")
    np.testing.assert_array_equal(out2[:, :T // 2], out[:, :T // 2])
    assert np.abs(out2[:, T // 2:] - out[:, T // 2:]).max() > 1.0
    out3 = _got(ranks, n, "edge_v_pos9")
    np.testing.assert_array_equal(out3[:, :9], out[:, :9])
    assert np.abs(out3[:, 9:] - out[:, 9:]).max() > 1.0


@pytest.mark.parametrize("n", SP_SIZES)
def test_ulysses_heads_not_divisible_raises(ranks, n):
    msg = _got(ranks, n, "heads_indivisible")
    assert msg == "num heads 3 must divide sp axis size %d" % n


def _fake_mesh(shape, names):
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = "cpu"
    return tmesh.Mesh(devs.reshape(shape), names)


def test_make_attn_fn_rules():
    """The JAX package's rules: flash refuses a sequence-sharded axis,
    ring and Ulysses need one, unknown names raise."""
    mesh = _fake_mesh((1, 2), ("dp", "sp"))
    with pytest.raises(ValueError, match="sequence-sharded"):
        tm.make_attn_fn("flash", "sp", mesh=mesh)
    for impl in IMPLS:
        with pytest.raises(ValueError, match="sequence-parallel"):
            tm.make_attn_fn(impl)
        fn = tm.make_attn_fn(impl, "sp", mesh=mesh)
        assert fn.keywords == {"mesh": mesh, "axis_name": "sp",
                               "causal": True}
    assert tm.make_attn_fn("flash").func is tattn.flash_attention_train
    with pytest.raises(ValueError, match="unknown attention impl"):
        tm.attention_impl("rign")
    assert tm.ATTENTION_IMPLS == ("flash", "ring", "ulysses")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("split", [4, 8, 12])
def test_merge_partials_equals_the_unsharded_softmax(causal, split):
    """Two partial results over disjoint key blocks, merged, equal the
    attention over all keys (float32 inside: 1e-6 of unit-scale
    values); an empty partial (lse -inf) leaves the other bit for bit."""
    q, k, v = (torch.from_numpy(SPEC[n]) for n in ("q", "k", "v"))
    want = jref(*(jnp.asarray(SPEC[n]) for n in ("q", "k", "v")),
                causal=causal)
    # causal over the keys with q aligned to the last T positions:
    # block 1 is fully visible, block 2 the causal diagonal part
    o1, l1 = tattn.flash_attention(q, k[:, :split], v[:, :split],
                                   return_lse=True)
    if causal:
        o2, l2 = tattn.flash_attention(q, k[:, split:], v[:, split:],
                                       return_lse=True)
        # row i sees keys split..i of the second block: mask the rest
        s = torch.einsum("bqhd,bkhd->bhqk", q, k[:, split:]).float() \
            * D ** -0.5
        pos_q = torch.arange(T)[:, None]
        pos_k = split + torch.arange(T - split)[None, :]
        s = torch.where(pos_q >= pos_k, s, float("-inf"))
        l2 = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - l2[..., None]).nan_to_num(0.0)
        o2 = torch.einsum("bhqk,bkhd->bqhd", p.double(), v[:, split:])
        # the first block is visible only where it precedes the row
        s1 = torch.einsum("bqhd,bkhd->bhqk", q, k[:, :split]).float() \
            * D ** -0.5
        s1 = torch.where(pos_q >= torch.arange(split)[None, :], s1,
                         float("-inf"))
        l1 = torch.logsumexp(s1, dim=-1)
        p1 = torch.exp(s1 - l1[..., None]).nan_to_num(0.0)
        o1 = torch.einsum("bhqk,bkhd->bqhd", p1.double(), v[:, :split])
    else:
        o2, l2 = tattn.flash_attention(q, k[:, split:], v[:, split:],
                                       return_lse=True)
    o, lse = tattn.merge_partials(o1, l1, o2, l2)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    empty = torch.full_like(l1, float("-inf"))
    o_e, l_e = tattn.merge_partials(torch.zeros_like(o1), empty, o1, l1)
    assert torch.equal(o_e, o1.to(o_e.dtype)) and torch.equal(l_e, l1)
    o_e, l_e = tattn.merge_partials(o1, l1, torch.full_like(o1, 7.0),
                                    empty)
    assert torch.equal(o_e, o1.to(o_e.dtype)) and torch.equal(l_e, l1)
