"""The attention gradient of the port against the JAX package's, on the
CPU: ``flash_attention_bwd_reference`` (the plain version of the Hopper
backward kernel, from the forward's output and log-sum-exp) and autograd
of ``flash_attention_train`` against the VJP of the JAX package's scan
``flash_attention`` (what ``jax.grad`` trains through), on the same
numpy inputs.

Cases: causal, full, Tq < Tk (the aligned diagonal), a ragged last KV
block, and Tq > Tk causal, whose first Tq - Tk rows see no key.
Tolerances: 1e-5 abs in float32 (summation order); 1e-6 abs in float64,
not float64 round-off, because both packages compute the scores,
probabilities and dV in float32 (the scan casts them), which leaves
~1e-7 of float32 rounding in the float64 gradients.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.parallel import attention as jattn
from mxnet_tpu_torch.parallel import attention as tattn

# (B, Tq, Tk, H, D, causal, block_size)
CASES = [
    (2, 16, 16, 2, 8, True, 512),
    (2, 16, 16, 2, 8, False, 512),
    (2, 8, 24, 2, 8, True, 512),     # Tq < Tk: aligned causal diagonal
    (1, 20, 20, 3, 16, True, 8),     # ragged last KV block (20 = 8+8+4)
    (2, 12, 8, 2, 8, True, 512),     # Tq > Tk: 4 rows see no key
    (1, 40, 64, 2, 32, True, 16),
]
ATOL = {"float32": 1e-5, "float64": 1e-6}


def _ids(c):
    return "B%dTq%dTk%dH%dD%d%s-blk%d" % (c[:5] + (
        "causal" if c[5] else "full", c[6]))


def _inputs(case, dtype, seed=0):
    B, Tq, Tk, H, D = case[:5]
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(dtype) for s in
            ((B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D), (B, Tq, H, D))]


def _jax_grads(q, k, v, do, causal, block):
    out, vjp = jax.vjp(
        lambda a, b, c: jattn.flash_attention(a, b, c, causal=causal,
                                              block_size=block),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, atol):
    got = got.detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_reference_backward_matches_jax_grad(case, dtype):
    causal, block = case[5], case[6]
    q, k, v, do = _inputs(case, dtype)
    jout, jgrads = _jax_grads(q, k, v, do, causal, block)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tattn.flash_attention(tq, tk, tv, causal=causal,
                                     block_size=block, return_lse=True)
    _close(out, jout, ATOL[dtype])
    assert lse.dtype == torch.float32 and lse.shape == (
        q.shape[0], q.shape[2], q.shape[1])
    got = tattn.flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                              causal=causal,
                                              block_size=block)
    for g, w in zip(got, jgrads):
        _close(g, w, ATOL[dtype])
    # the wrapper takes the reference for CPU tensors, and launches
    # nothing
    n0 = tattn.flash_attention_bwd.launches
    again = tattn.flash_attention_bwd(tq, tk, tv, out, lse, tdo,
                                      causal=causal)
    assert tattn.flash_attention_bwd.launches == n0
    for a, b in zip(again, got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_attention_train_autograd_matches_jax_grad(case, dtype):
    causal = case[5]
    q, k, v, do = _inputs(case, dtype, seed=1)
    # the training path's block size: the JAX package's default
    jout, jgrads = _jax_grads(q, k, v, do, causal, 512)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    n0 = (tattn.flash_attention_fwd.launches,
          tattn.flash_attention_bwd.launches)
    out = tattn.flash_attention_train(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert (tattn.flash_attention_fwd.launches,
            tattn.flash_attention_bwd.launches) == n0
    _close(out, jout, ATOL[dtype])
    for g, w in zip(got, jgrads):
        _close(g, w, ATOL[dtype])


def test_lse_convention_gives_fully_masked_rows_no_gradient():
    # causal with Tq > Tk: rows 0..Tq-Tk-1 see no key (l == 0)
    B, Tq, Tk, H, D = 2, 12, 8, 2, 8
    q, k, v, do = _inputs((B, Tq, Tk, H, D), "float32", seed=2)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tattn.flash_attention(tq, tk, tv, causal=True,
                                     return_lse=True)
    dead = Tq - Tk
    assert torch.isinf(lse[:, :, :dead]).all() and (lse[:, :, :dead] > 0).all()
    assert torch.isfinite(lse[:, :, dead:]).all()
    assert torch.count_nonzero(out[:, :dead]) == 0
    dq, dk, dv = tattn.flash_attention_bwd_reference(tq, tk, tv, out, lse,
                                                     tdo, causal=True)
    assert torch.count_nonzero(dq[:, :dead]) == 0
    assert torch.count_nonzero(dq[:, dead:]) > 0
    # those rows add nothing to dk or dv: any gradient there, same result
    noisy = tdo.clone()
    noisy[:, :dead] = torch.from_numpy(
        np.random.RandomState(9).randn(B, dead, H, D).astype("float32"))
    dq2, dk2, dv2 = tattn.flash_attention_bwd_reference(
        tq, tk, tv, out, lse, noisy, causal=True)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    assert torch.equal(dq2, dq)
