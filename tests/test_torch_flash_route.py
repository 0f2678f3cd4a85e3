"""The flash-attention wrapper's host side, on the CPU: which kernel a
CUDA call takes (``kernel_route``), the TMA map arguments it computes for
the ``wgmma`` kernel (``_tma_map``), the packed launch arguments the C
interface of ``csrc/flash_attn_fwd.cu`` reads (``_launch_args``), and
the refusals where TMA cannot read a tensor; and which backward kernel a
CUDA call takes (``bwd_route``) with its packed arguments
(``_bwd_launch_args``).  These are metadata of CPU tensors (shapes,
strides, base addresses): no kernel runs here.
"""
import struct

import pytest
import torch

from mxnet_tpu_torch.parallel import attention as tattn

BF16, F32 = torch.bfloat16, torch.float32


def _tma_args(t):
    # (dims, byte strides, box) of the 11 map numbers
    m = tattn._tma_map(t, t.data_ptr())
    return m[:4], m[4:7], m[7:]


@pytest.mark.parametrize("dtype,head_dim,route", [
    (BF16, 64, "wgmma"), (BF16, 128, "wgmma"),
    (BF16, 8, "simt"), (BF16, 24, "simt"), (BF16, 32, "simt"),
    (BF16, 96, "simt"), (F32, 64, "simt"), (F32, 128, "simt"),
    (F32, 8, "simt")])
def test_route_by_dtype_and_head_dim(dtype, head_dim, route):
    assert tattn.kernel_route(dtype, head_dim) == route


@pytest.mark.parametrize("D", [64, 128])
def test_tma_args_of_a_contiguous_tensor(D):
    B, T, H = 2, 100, 12
    t = torch.zeros((B, T, H, D), dtype=BF16)
    dims, strides, box = _tma_args(t)
    assert dims == (D, H, T, B)
    assert strides == (2 * D, 2 * D * H, 2 * D * H * T)
    assert box == (64, 1, 64, 1)


def test_tma_args_of_the_fused_projection_view():
    # the prefill's q/k/v (transformer/model.py _qkv): column blocks of
    # one (B, T, 3 * H * D) projection, read in place through strides
    B, T, H, D = 2, 100, 12, 64
    qkv = torch.zeros((B, T, 3 * H * D), dtype=BF16)
    q, k, v = (x.reshape(B, T, H, D)
               for x in torch.split(qkv, H * D, dim=-1))
    assert not v.is_contiguous()
    row = 3 * H * D * 2
    for i, t in enumerate((q, k, v)):
        assert t.data_ptr() - qkv.data_ptr() == i * H * D * 2
        assert _tma_args(t) == ((D, H, T, B), (2 * D, row, row * T),
                                     (64, 1, 64, 1))


def test_tma_args_give_size_one_dims_the_packed_stride():
    t = torch.zeros((1, 5, 1, 128), dtype=BF16)
    assert _tma_args(t) == ((128, 1, 5, 1), (256, 256, 1280),
                                 (64, 1, 64, 1))


def test_tma_args_refuse_a_misaligned_base():
    t = torch.zeros(1 + 2 * 8 * 2 * 64, dtype=BF16)[1:].view(2, 8, 2, 64)
    assert t.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned base"):
        _tma_args(t)


def test_tma_args_refuse_a_misaligned_stride():
    t = torch.zeros((2, 8, 2, 68), dtype=BF16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 16"):
        _tma_args(t)


def test_tma_args_refuse_a_strided_last_dim():
    t = torch.zeros((2, 8, 2, 128), dtype=BF16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        _tma_args(t)


def _unpack(blob):
    return struct.unpack("%dq" % (len(blob) // 8), blob)


def test_launch_args_of_the_wgmma_route():
    B, Tq, Tk, H, D = 2, 40, 72, 3, 64
    q = torch.zeros((B, Tq, H, D), dtype=BF16)
    k, v = (torch.zeros((B, Tk, H, D), dtype=BF16) for _ in range(2))
    o = torch.empty_like(q)
    got = _unpack(tattn._launch_args("wgmma", q, k, v, o, True, 7, 1))
    assert len(got) == 56
    assert got[:12] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), B, H, Tq, Tk, D, 1, 7, 1)
    for i, t in enumerate((q, k, v, o)):
        dims, strides, box = _tma_args(t)
        assert got[12 + 11 * i:23 + 11 * i] == dims + strides + box


def test_launch_args_of_the_simt_route():
    B, Tq, Tk, H, D = 1, 9, 9, 2, 24
    q, k, v = (torch.zeros((B, T, H, D)) for T in (Tq, Tk, Tk))
    o = torch.empty_like(q)
    got = _unpack(tattn._launch_args("simt", q, k, v, o, False, 0, 0))
    assert len(got) == 25
    assert got[4:13] == (B, H, Tq, Tk, D, 0, 0, 0, 0)
    assert got[13:] == q.stride()[:3] * 4


def test_launch_args_refuse_what_tma_cannot_read():
    # the wrapper builds these arguments before any launch: a view TMA
    # cannot read raises there, on the wgmma route only
    B, T, H, D = 2, 8, 2, 64
    good = torch.zeros((B, T, H, D), dtype=BF16)
    odd = torch.zeros(1 + B * T * H * D, dtype=BF16)[1:].view(B, T, H, D)
    with pytest.raises(ValueError, match="aligned base"):
        tattn._launch_args("wgmma", good, good, odd, good, True, 0, 0)
    wide = torch.zeros((B, T, H, 68), dtype=BF16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 16"):
        tattn._launch_args("wgmma", wide, good, good, good, True, 0, 0)
    assert len(tattn._launch_args("simt", odd, good, good, good, True, 0,
                                  0)) == 25 * 8


def test_cpu_calls_count_no_launch_on_any_route():
    q = torch.randn((1, 16, 2, 64), dtype=BF16)
    before = dict(tattn.flash_attention_fwd.launches_by_route)
    n0 = tattn.flash_attention_fwd.launches
    out = tattn.flash_attention_fwd(q, q, q, causal=True)
    assert out.shape == q.shape and out.dtype == BF16
    assert tattn.flash_attention_fwd.launches == n0
    assert tattn.flash_attention_fwd.launches_by_route == before
    assert set(before) == {"wgmma", "simt"}


# ---------------------------------------------------------------------------
# the backward kernels (csrc/flash_attn_bwd.cu): route and packed arguments
# ---------------------------------------------------------------------------
def _bwd_inputs(dtype, D, B=2, T=8, H=2):
    q, k, v, o, do = (torch.zeros((B, T, H, D), dtype=dtype)
                      for _ in range(5))
    return q, k, v, o, do


@pytest.mark.parametrize("dtype,head_dim,route", [
    (BF16, 64, "wgmma"), (BF16, 128, "wgmma"), (BF16, 32, "simt"),
    (BF16, 8, "simt"), (F32, 64, "simt"), (F32, 128, "simt")])
def test_bwd_route_by_dtype_and_head_dim(dtype, head_dim, route):
    assert tattn.bwd_route(*_bwd_inputs(dtype, head_dim)) == route


def test_bwd_route_of_the_fused_projection_and_of_unaligned_rows():
    B, T, H, D = 2, 10, 3, 64
    qkv = torch.zeros((B, T, 3 * H * D), dtype=BF16)
    q, k, v = (x.reshape(B, T, H, D)
               for x in torch.split(qkv, H * D, dim=-1))
    o, do = torch.zeros_like(q), torch.zeros_like(q)
    assert tattn.bwd_route(q, k, v, o, do) == "wgmma"
    # a base 2 bytes off a 16-byte boundary, or a row stride of 68
    # elements, is not 16-byte aligned: the simt kernels take it
    odd = torch.zeros(1 + B * T * H * D, dtype=BF16)[1:].view(B, T, H, D)
    assert tattn.bwd_route(q, k, v, o, odd) == "simt"
    wide = torch.zeros((B, T, H, 68), dtype=BF16)[..., :64]
    assert tattn.bwd_route(wide, k, v, o, do) == "simt"
    # a size-1 dim's stride is never read
    one = torch.zeros((1, T, 1, 68), dtype=BF16)[..., :64]
    assert tattn.bwd_route(one, one, one, one, one) == "simt"
    one = torch.zeros((1, 1, 1, 64), dtype=BF16).as_strided(
        (1, 1, 1, 64), (3, 5, 7, 1))
    assert tattn.bwd_route(one, one, one, one, one) == "wgmma"


def test_bwd_launch_args_layout():
    B, Tq, Tk, H, D = 2, 9, 7, 3, 24
    q, o, do, dq = (torch.zeros((B, Tq, H, D)) for _ in range(4))
    k, v, dk, dv = (torch.zeros((B, Tk, H, D)) for _ in range(4))
    lse = torch.zeros((B, H, Tq))
    dsum = torch.zeros((B, H, Tq))
    blob = tattn._bwd_launch_args("simt", q, k, v, o, do, lse, dsum, dq,
                                  dk, dv, True, 5, 0)
    got = struct.unpack("43q", blob)
    assert got[:10] == tuple(t.data_ptr() for t in (q, k, v, o, do, lse,
                                                     dsum, dq, dk, dv))
    assert got[10:19] == (B, H, Tq, Tk, D, 1, 5, 0, 0)
    assert got[19:] == (q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
                        + o.stride()[:3] + do.stride()[:3]
                        + dq.stride()[:3] + dk.stride()[:3]
                        + dv.stride()[:3])


def _bwd_wgmma_args(q, k, v, o, do, dq, dk, dv, causal=True, stream=5,
                    device=1):
    B, Tq, H, _ = q.shape
    lse, dsum = (torch.zeros((B, H, Tq)) for _ in range(2))
    return (lse, dsum), _unpack(tattn._bwd_launch_args(
        "wgmma", q, k, v, o, do, lse, dsum, dq, dk, dv, causal, stream,
        device))


def test_bwd_launch_args_of_the_wgmma_route():
    # q/k/v as the training path hands them in (strided views of the
    # fused projection), o and do contiguous, the outputs contiguous
    B, T, H, D = 2, 40, 3, 128
    qkv = torch.zeros((B, T, 3 * H * D), dtype=BF16)
    q, k, v = (x.reshape(B, T, H, D)
               for x in torch.split(qkv, H * D, dim=-1))
    o, do, dq, dk, dv = (torch.zeros((B, T, H, D), dtype=BF16)
                         for _ in range(5))
    (lse, dsum), got = _bwd_wgmma_args(q, k, v, o, do, dq, dk, dv)
    assert len(got) == 19 + 8 * 11
    assert got[:10] == tuple(t.data_ptr() for t in (q, k, v, o, do, lse,
                                                     dsum, dq, dk, dv))
    assert got[10:19] == (B, H, T, T, D, 1, 5, 1, 1)
    row = 3 * H * D * 2
    for i, t in enumerate((q, k, v, o, do, dq, dk, dv)):
        dims, strides, box = _tma_args(t)
        assert got[19 + 11 * i:30 + 11 * i] == dims + strides + box
        assert dims == (D, H, T, B)
        assert strides == ((2 * D, row, row * T) if i < 3 else
                           (2 * D, 2 * D * H, 2 * D * H * T))


def test_bwd_launch_args_refuse_what_tma_cannot_read():
    B, T, H, D = 2, 8, 2, 64
    good = torch.zeros((B, T, H, D), dtype=BF16)
    odd = torch.zeros(1 + B * T * H * D, dtype=BF16)[1:].view(B, T, H, D)
    wide = torch.zeros((B, T, H, 68), dtype=BF16)[..., :64]
    with pytest.raises(ValueError, match="flash_attention_bwd: .*aligned "
                                         "base"):
        _bwd_wgmma_args(good, good, good, good, odd, good, good, good)
    with pytest.raises(ValueError, match="flash_attention_bwd: .*multiples "
                                         "of 16"):
        _bwd_wgmma_args(good, wide, good, good, good, good, good, good)
    # the simt route reads any alignment
    lse = torch.zeros((B, H, T))
    assert len(tattn._bwd_launch_args("simt", good, wide, good, good, odd,
                                      lse, lse, good, good, good, True, 0,
                                      0)) == 43 * 8


def test_bwd_cpu_calls_count_no_launch():
    q = torch.randn((1, 16, 2, 64), dtype=BF16)
    o, lse = tattn.flash_attention_fwd(q, q, q, causal=True,
                                       return_lse=True)
    before = dict(tattn.flash_attention_bwd.launches_by_route)
    n0 = tattn.flash_attention_bwd.launches
    dq, dk, dv = tattn.flash_attention_bwd(q, q, q, o, lse, q, causal=True)
    assert dq.shape == q.shape and dq.dtype == BF16
    assert tattn.flash_attention_bwd.launches == n0
    assert tattn.flash_attention_bwd.launches_by_route == before
    assert set(before) == {"wgmma", "simt"}
