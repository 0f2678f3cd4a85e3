"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_kernels_on_card.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX).
Tolerances: flash attention float32 1e-4 abs (another summation order
than the plain version's einsum), bfloat16 2e-2 abs against the plain
version run in float32 on the same bfloat16 inputs (the output is
rounded to bfloat16, and the ``wgmma`` route also rounds the
probabilities to bfloat16 for P·V).  The backward: each head's largest
error over that head's largest gradient, float32 1e-4, bfloat16 1e-2
(its ``wgmma`` route also rounds P and dS to bfloat16 for their
products).  Every flash case asserts the route it took: bf16 with
head_dim 64 or 128 on ``wgmma``, the rest on ``simt``.  The ``mx.rtc`` add kernel (``csrc/rtc/add.cu``,
compiled by NVRTC) exactly: one IEEE add per element, rounded to
nearest even in bfloat16 as PyTorch's add does.  The NMS kernel
(``csrc/box_nms.cu``) exactly: its keep masks equal the plain greedy
loop's on the same card inputs, on both routes.  ``mx.nd`` ops on
``gpu(0)`` against the same ops on ``cpu()``: exact for elementwise
arithmetic and data movement, 1e-12 (float64) for sums and products,
which the card takes in another order.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.parallel import attention as tattn

ADD_CU = Path(mx.__file__).resolve().parent / "csrc" / "rtc" / "add.cu"
ADD_SIG = "const %s *x, const %s *y, %s *out, long n"

# (B, Tq, Tk, H, D, causal)
CASES = [
    (2, 16, 16, 2, 8, False),
    (2, 16, 16, 2, 8, True),
    (2, 8, 24, 2, 8, True),      # Tq < Tk: aligned causal diagonal
    (2, 20, 20, 2, 8, True),     # ragged T
    (1, 12, 8, 2, 8, True),      # Tq > Tk: fully masked rows write 0
    (2, 200, 200, 12, 64, True),
    (1, 64, 192, 4, 64, True),
    (1, 70, 70, 2, 128, False),
    (1, 33, 33, 3, 24, True),
]


def _ids(case):
    B, Tq, Tk, H, D, causal = case
    return "B%dTq%dTk%dH%dD%d%s" % (B, Tq, Tk, H, D,
                                    "causal" if causal else "full")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_kernel_matches_plain(cuda_device, case, dtype, atol):
    B, Tq, Tk, H, D, causal = case
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn((B, T, H, D), generator=g).to(cuda_device,
                                                          dtype)
               for T in (Tq, Tk, Tk))
    before = tattn.flash_attention_fwd.launches
    route = tattn.kernel_route(dtype, D)
    by_route = tattn.flash_attention_fwd.launches_by_route[route]
    out = tattn.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tattn.flash_attention_fwd.launches == before + 1
    assert tattn.flash_attention_fwd.launches_by_route[route] == by_route + 1
    want = tattn.flash_attention(q.float(), k.float(), v.float(),
                                 causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - want).abs().max().item()
    assert err <= atol, err


# (B, Tq, Tk, H, causal) for the wgmma route, at D 64 and 128
WGMMA_CASES = [(2, T, T, 3, True) for T in (1, 15, 64, 200, 513)] + [
    (2, 64, 192, 3, True),     # Tq < Tk: aligned causal diagonal
    (2, 100, 60, 3, True),     # Tq > Tk: the first 40 rows see no key
    (2, 200, 200, 3, False),
    (1, 513, 300, 2, False),
    (4, 512, 512, 12, True),   # B*H = 48 at T = 512, the serving cell
]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=lambda c: "B%dTq%dTk%dH%d%s" % (
                             c[:4] + ("causal" if c[4] else "full",)))
def test_flash_wgmma_route_matches_plain(cuda_device, case, D):
    B, Tq, Tk, H, causal = case
    g = torch.Generator(device="cpu").manual_seed(2)
    q, k, v = (torch.randn((B, T, H, D), generator=g).to(cuda_device,
                                                          torch.bfloat16)
               for T in (Tq, Tk, Tk))
    n0 = tattn.flash_attention_fwd.launches_by_route["wgmma"]
    out = tattn.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tattn.flash_attention_fwd.launches_by_route["wgmma"] == n0 + 1
    want = tattn.flash_attention(q.float(), k.float(), v.float(),
                                 causal=causal)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - want).abs().max().item() <= 2e-2
    if causal and Tq > Tk:
        assert torch.count_nonzero(out[:, :Tq - Tk]) == 0


@pytest.mark.cuda
def test_flash_wgmma_route_reads_the_fused_projection(cuda_device):
    # the prefill's q/k/v at the serving width: column blocks of one
    # (B, T, 3 * H * D) bf16 projection, read in place by TMA
    B, T, H, D = 2, 200, 12, 64
    g = torch.Generator(device="cpu").manual_seed(3)
    qkv = torch.randn((B, T, 3 * H * D), generator=g).to(cuda_device,
                                                          torch.bfloat16)
    q, k, v = (x.reshape(B, T, H, D)
               for x in torch.split(qkv, H * D, dim=-1))
    assert not q.is_contiguous()
    n0 = tattn.flash_attention_fwd.launches_by_route["wgmma"]
    out = tattn.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tattn.flash_attention_fwd.launches_by_route["wgmma"] == n0 + 1
    want = tattn.flash_attention(q.float(), k.float(), v.float(),
                                 causal=True)
    assert (out.float() - want).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_flash_wgmma_route_refuses_what_tma_cannot_read(cuda_device):
    q = torch.zeros((1, 8, 2, 64), device=cuda_device, dtype=torch.bfloat16)
    odd = torch.zeros(1 + 8 * 2 * 64, device=cuda_device,
                      dtype=torch.bfloat16)[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="aligned base"):
        tattn.flash_attention_fwd(q, q, odd)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    # q/k/v as column slices of one fused projection, as the prefill
    # hands them over: the kernel reads them in place through strides
    B, T, H, D = 2, 50, 4, 32
    g = torch.Generator(device="cpu").manual_seed(1)
    qkv = torch.randn((B, T, 3 * H * D), generator=g).to(cuda_device)
    q, k, v = (x.reshape(B, T, H, D)
               for x in torch.split(qkv, H * D, dim=-1))
    assert not v.is_contiguous()
    n0 = tattn.flash_attention_fwd.launches_by_route["simt"]
    out = tattn.flash_attention_fwd(q, k, v, causal=True)
    assert tattn.flash_attention_fwd.launches_by_route["simt"] == n0 + 1
    want = tattn.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    assert (out - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 8, 2, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        tattn.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 8, 2, 136), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 8, 2, 16), device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tattn.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError):
        tattn.flash_attention_fwd(q.cpu(), q, q)


# the backward kernel (csrc/flash_attn_bwd.cu): (B, Tq, Tk, H, D, causal)
BWD_CASES = CASES + [
    (2, 128, 128, 3, 64, True),
    (1, 100, 60, 2, 64, True),    # Tq > Tk: 40 rows see no key
    (1, 64, 200, 2, 128, True),
    (1, 130, 130, 2, 128, False),
] + [
    # bf16 takes the wgmma route at D 64 and 128: the tile edges (T of 2,
    # 15, 64, 65, 200; at Tq = Tk = 1 dq and dk are exactly 0, dS = P (dP
    # - D) cancelling, so no head has a scale), one query row, Tq < Tk,
    # Tq > Tk (fully masked rows), full attention, several heads
    (B, Tq, Tk, H, D, causal) for D in (64, 128)
    for B, Tq, Tk, H, causal in [(2, T, T, 3, True) for T in (2, 15, 64, 65,
                                                          200)]
    + [(2, 1, 40, 3, True), (2, 64, 192, 3, True), (2, 100, 60, 3, True),
       (2, 200, 200, 3, False), (1, 300, 513, 2, False),
       (2, 256, 256, 12, True)]
]
# head-scaled limits (a head's largest error over that head's largest
# magnitude of the reference, the scale of a gradient's rounding: a row
# can cancel to ~0, as causal row 0 of dq does exactly, so a row's own
# magnitude is no scale): float32 is another summation order; the bf16
# gradients are rounded to bf16 on output, and the wgmma route (bf16,
# head_dim 64/128) also rounds P and dS to bf16 for their products
BWD_HEAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _head_err(got, want):
    # (B, T, H, D): the largest error and magnitude of each (b, h)
    err = (got.float() - want.float()).abs().amax(dim=(1, 3))
    mag = want.float().abs().amax(dim=(1, 3)).clamp_min(1e-30)
    return (err / mag).max().item()


def _fwd_with_lse(q, k, v, causal):
    n0 = tattn.flash_attention_fwd.launches
    o, lse = tattn.flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
    assert tattn.flash_attention_fwd.launches == n0 + 1
    return o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=_ids)
def test_flash_lse_matches_plain(cuda_device, case, dtype):
    B, Tq, Tk, H, D, causal = case
    g = torch.Generator(device="cpu").manual_seed(4)
    q, k, v = (torch.randn((B, T, H, D), generator=g).to(cuda_device,
                                                          dtype)
               for T in (Tq, Tk, Tk))
    _, lse = _fwd_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    _, want = tattn.flash_attention(q.float(), k.float(), v.float(),
                                    causal=causal, return_lse=True)
    assert lse.shape == (B, H, Tq) and lse.dtype == torch.float32
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    assert (lse[fin] - want[fin]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=_ids)
def test_flash_bwd_matches_reference(cuda_device, case, dtype):
    B, Tq, Tk, H, D, causal = case
    g = torch.Generator(device="cpu").manual_seed(5)
    q, k, v = (torch.randn((B, T, H, D), generator=g).to(cuda_device,
                                                          dtype)
               for T in (Tq, Tk, Tk))
    do = torch.randn((B, Tq, H, D), generator=g).to(cuda_device, dtype)
    o, lse = _fwd_with_lse(q, k, v, causal)
    route = tattn.bwd_route(q, k, v, o, do)
    assert route == ("wgmma" if dtype == torch.bfloat16 and D in (64, 128)
                     else "simt")
    n0 = tattn.flash_attention_bwd.launches
    r0 = tattn.flash_attention_bwd.launches_by_route[route]
    got = tattn.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert tattn.flash_attention_bwd.launches == n0 + 1
    assert tattn.flash_attention_bwd.launches_by_route[route] == r0 + 1
    want = tattn.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(),
        causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert _head_err(a, b) <= BWD_HEAD_RTOL[dtype], name
    if causal and Tq > Tk:
        # rows that see no key: no gradient
        assert torch.count_nonzero(got[0][:, :Tq - Tk]) == 0
    # no atomics: the same bits on a second run
    again = tattn.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 70, 70, 3, 64, True),
                                  (1, 40, 90, 2, 32, True),
                                  (2, 33, 33, 2, 128, False)], ids=_ids)
def test_flash_attention_train_matches_autograd_of_the_reference(
        cuda_device, case):
    B, Tq, Tk, H, D, causal = case
    g = torch.Generator(device="cpu").manual_seed(6)
    q, k, v = (torch.randn((B, T, H, D), generator=g).to(cuda_device)
               .requires_grad_(True) for T in (Tq, Tk, Tk))
    do = torch.randn((B, Tq, H, D), generator=g).to(cuda_device)
    n0, b0 = (tattn.flash_attention_fwd.launches,
              tattn.flash_attention_bwd.launches)
    out = tattn.flash_attention_train(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert tattn.flash_attention_fwd.launches == n0 + 1
    assert tattn.flash_attention_bwd.launches == b0 + 1
    ref = tattn.attention_reference(q, k, v, causal=causal)
    want = torch.autograd.grad(ref, (q, k, v), do)
    assert _head_err(out.detach(), ref.detach()) <= 1e-4
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _head_err(a, b) <= 1e-4, name


@pytest.mark.cuda
def test_flash_bwd_reads_the_fused_projection(cuda_device):
    # the training path's q/k/v: strided column blocks of one
    # projection; autograd scatters the gradients back into it
    B, T, H, D = 2, 130, 4, 64
    g = torch.Generator(device="cpu").manual_seed(7)
    for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        qkv = torch.randn((B, T, 3 * H * D), generator=g).to(
            cuda_device, dtype).requires_grad_(True)
        q, k, v = (x.reshape(B, T, H, D)
                   for x in torch.split(qkv, H * D, dim=-1))
        do = torch.randn((B, T, H, D), generator=g).to(cuda_device, dtype)
        (got,) = torch.autograd.grad(
            tattn.flash_attention_train(q, k, v, causal=True), qkv, do)
        ref32 = qkv.detach().float().requires_grad_(True)
        q32, k32, v32 = (x.reshape(B, T, H, D)
                         for x in torch.split(ref32, H * D, dim=-1))
        (want,) = torch.autograd.grad(
            tattn.attention_reference(q32, k32, v32, causal=True), ref32,
            do.float())
        # the (B, T, 3*H*D) gradient of the projection, as 3*H heads
        assert _head_err(got.view(B, T, 3 * H, D),
                         want.view(B, T, 3 * H, D)) <= rtol, dtype


@pytest.mark.cuda
def test_flash_bwd_unaligned_bf16_rows_take_the_simt_route(cuda_device):
    B, T, H, D = 1, 70, 2, 64
    g = torch.Generator(device="cpu").manual_seed(8)
    q, k, v, do = (torch.randn((B, T, H, D), generator=g).to(
        cuda_device, torch.bfloat16) for _ in range(4))
    odd = torch.zeros(1 + B * T * H * D, device=cuda_device,
                      dtype=torch.bfloat16)[1:].view(B, T, H, D)
    odd.copy_(do)
    o, lse = _fwd_with_lse(q, k, v, True)
    assert tattn.bwd_route(q, k, v, o, odd) == "simt"
    n0 = tattn.flash_attention_bwd.launches_by_route["simt"]
    got = tattn.flash_attention_bwd(q, k, v, o, lse, odd, causal=True)
    assert tattn.flash_attention_bwd.launches_by_route["simt"] == n0 + 1
    want = tattn.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for a, b in zip(got, want):
        assert _head_err(a, b) <= BWD_HEAD_RTOL[torch.bfloat16]


@pytest.mark.cuda
def test_flash_attention_train_refuses_float64_on_the_card(cuda_device):
    q = torch.zeros((1, 8, 2, 8), device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tattn.flash_attention_train(q, q, q, causal=True)
    lse = torch.zeros((1, 2, 8), device=cuda_device)
    q32 = q.float()
    with pytest.raises(ValueError, match="lse"):
        tattn.flash_attention_bwd(q32, q32, q32, q32, lse[:, :1], q32)


@pytest.fixture(scope="module")
def add_module():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NVRTC compiles for the card)")
    return rtc.CudaModule(ADD_CU.read_text())


def _launch_add(mod, kernel, ctype, x, y, out, n, grid="resident"):
    # "resident": at most 8 blocks of 256 an SM, the grid-stride loop
    # covering the rest, as chip_smoke.py launches it; "oneshot": one
    # 16-byte vector a thread in 128-thread blocks
    k = mod.get_kernel(kernel, ADD_SIG % (ctype, ctype, ctype))
    if grid == "oneshot":
        per = 128 * 16 // x._data.element_size()
        dims = ((max(1, -(-n // per)), 1, 1), (128, 1, 1))
    else:
        dims = ((max(1, min(-(-n // (256 * 4)), 132 * 8)), 1, 1),
                (256, 1, 1))
    k.launch([x, y, out, n], mx.gpu(0), *dims)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["oneshot", "resident"])
@pytest.mark.parametrize("kernel,ctype,dtype", [
    ("add", "float", "float32"), ("add_bf16", "__nv_bfloat16", "bfloat16")])
# 2**23 + 5 gives the resident grid's threads 3 to 8 vectors each: the
# unrolled loop, its single-vector remainder and the scalar tail
@pytest.mark.parametrize("shape", [(8, 128), (2 ** 20 + 3,), (2 ** 23 + 5,),
                                   (1,), (37,)], ids=str)
def test_rtc_add_matches_plain_exactly(add_module, kernel, ctype, dtype,
                                       shape, grid):
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(shape, generator=g) for _ in range(2)]
    x, y = (mx.nd.array(t, ctx=mx.gpu(0), dtype=dtype) for t in xs)
    out = mx.nd.zeros(shape, ctx=mx.gpu(0), dtype=dtype)
    n0 = rtc.launches[kernel]
    _launch_add(add_module, kernel, ctype, x, y, out, x.size, grid)
    torch.cuda.synchronize()
    assert rtc.launches[kernel] == n0 + 1
    want = rtc.add_reference(x._data, y._data)
    assert torch.equal(out._data, want)


@pytest.mark.cuda
def test_rtc_add_unaligned_pointers_take_the_scalar_path(add_module):
    # views at a 4-byte offset: no 16-byte vector access is legal
    base = [torch.randn(1001, device="cuda") for _ in range(3)]
    x, y, out = (mx.nd.NDArray.from_raw(t[1:], mx.gpu(0)) for t in base)
    _launch_add(add_module, "add", "float", x, y, out, 1000)
    torch.cuda.synchronize()
    assert torch.equal(out._data, base[0][1:] + base[1][1:])


@pytest.mark.cuda
def test_rtc_launch_refuses_wrong_dtype_and_device(add_module):
    k = add_module.get_kernel("add", ADD_SIG % (("float",) * 3))
    x = mx.nd.ones((4,), ctx=mx.gpu(0))
    h = mx.nd.ones((4,), ctx=mx.cpu())
    d = mx.nd.ones((4,), ctx=mx.gpu(0), dtype="float64")
    with pytest.raises(mx.MXNetError, match="argument 1 is torch.float64"):
        k.launch([x, d, x, 4], mx.gpu(0), (1, 1, 1), (32, 1, 1))
    with pytest.raises(mx.MXNetError, match="argument 2 lies on cpu"):
        k.launch([x, x, h, 4], mx.gpu(0), (1, 1, 1), (32, 1, 1))
    with pytest.raises(mx.MXNetError, match="cannot launch on cpu"):
        k.launch([h, h, h, 4], mx.cpu(), (1, 1, 1), (32, 1, 1))
    with pytest.raises(mx.MXNetError, match="cuLaunchKernel"):
        k.launch([x, x, x, 4], mx.gpu(0), (1, 1, 1), (4096, 1, 1))


@pytest.mark.cuda
def test_rtc_cpp_exports_and_compile_errors(add_module):
    src = """
    template <typename T>
    __global__ void axpby(const T* x, T* y, T a, T b, long n) {
      long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
      if (i < n) y[i] = a * x[i] + b * y[i];
    }
    """
    mod = rtc.CudaModule(src, exports=["axpby<double>"])
    k = mod.get_kernel("axpby<double>", "const double *x, double *y, "
                       "double a, double b, long n")
    xa, ya = np.arange(5.0), np.ones(5)
    x = mx.nd.array(xa, ctx=mx.gpu(0))
    y = mx.nd.array(ya, ctx=mx.gpu(0))
    k.launch([x, y, 2.0, 3.0, 5], mx.gpu(0), (1, 1, 1), (32, 1, 1))
    np.testing.assert_array_equal(y.asnumpy(), 2.0 * xa + 3.0 * ya)
    with pytest.raises(mx.MXNetError, match="NVRTC compile"):
        rtc.CudaModule("__global__ void broken( {")


@pytest.mark.cuda
def test_rtc_dynamic_shared_memory_above_48k(add_module):
    # 64 KB of dynamic shared memory needs the function attribute set
    src = """extern "C" __global__ void reverse(const float* x, float* y) {
      extern __shared__ float buf[];
      const int n = 16384;
      for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = buf[n - 1 - i];
    }"""
    k = rtc.CudaModule(src).get_kernel("reverse",
                                       "const float *x, float *y")
    x = mx.nd.array(np.arange(16384.0, dtype=np.float32), ctx=mx.gpu(0))
    y = mx.nd.zeros((16384,), ctx=mx.gpu(0))
    k.launch([x, y], mx.gpu(0), (1, 1, 1), (256, 1, 1),
             shared_mem=16384 * 4)
    np.testing.assert_array_equal(y.asnumpy(), x.asnumpy()[::-1])


@pytest.mark.cuda
def test_rtc_write_bumps_the_version_a_graph_saved(add_module):
    x = mx.nd.ones((8,), ctx=mx.gpu(0))
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum()
    one = mx.nd.ones((8,), ctx=mx.gpu(0))
    # the kernel writes into x's tensor, which the graph saved
    _launch_add(add_module, "add", "float", one, one, x, 8)
    np.testing.assert_array_equal(x.asnumpy(), 2.0)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        y.backward()


@pytest.mark.cuda
def test_nd_ops_on_the_card_equal_the_cpu(cuda_device):
    rng = np.random.RandomState(0)
    a, b = rng.randn(64, 48), rng.randn(48, 32)
    res = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        x = mx.nd.array(a, ctx=ctx)
        w = mx.nd.array(b, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            h = mx.nd.dot(x, w)
            z = mx.nd.relu(h * 2.0 - 1.0) + mx.nd.broadcast_add(
                h, mx.nd.ones((1, 32), ctx=ctx, dtype="float64"))
            loss = (z.sum(axis=1) * z[:, 3]).mean()
        loss.backward()
        assert z.context == ctx and x.grad.context == ctx
        res[ctx.device_type] = {
            "elementwise": (x * 3.0 - x).asnumpy(),
            "move": mx.nd.transpose(x, axes=(1, 0))[::2].asnumpy(),
            "z": z.asnumpy(), "loss": loss.asnumpy(),
            "grad": x.grad.asnumpy(),
            "topk": x.topk(axis=1, k=3).asnumpy()}
    for k in ("elementwise", "move", "topk"):
        np.testing.assert_array_equal(res["gpu"][k], res["cpu"][k])
    for k in ("z", "loss", "grad"):
        np.testing.assert_allclose(res["gpu"][k], res["cpu"][k],
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_rtc_long_is_64_bit_as_the_signature_parser_assumes(add_module):
    # ``long`` in a signature is passed as int64: NVRTC's C++ must agree
    src = """extern "C" __global__ void probe(int* out, long n) {
      out[0] = (int)sizeof(long); out[1] = (int)(n >> 32);
    }"""
    out = mx.nd.zeros((2,), ctx=mx.gpu(0), dtype="int32")
    rtc.CudaModule(src).get_kernel("probe", "int *out, long n").launch(
        [out, (5 << 32) + 7], mx.gpu(0), (1, 1, 1), (1, 1, 1))
    assert out.asnumpy().tolist() == [8, 5]
    assert ".alt." not in rtc._nvrtc.path


# the ResNet-50 path's ops (cuDNN/cuBLAS through torch, and the port's
# BatchNorm and Pooling bodies) on the card against the same ops on the
# CPU, float64, at ResNet-50 shapes (batch cut to 2): forward and the
# gradients of a seeded cotangent, 1e-10 relative to the largest
# magnitude (another summation order on each side)
RESNET_OPS = [
    ("Convolution", [(2, 3, 224, 224), (64, 3, 7, 7)],
     dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=64,
          no_bias=True)),
    ("Convolution", [(2, 64, 56, 56), (64, 64, 3, 3)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=64, no_bias=True)),
    ("Convolution", [(2, 256, 56, 56), (512, 256, 1, 1)],
     dict(kernel=(1, 1), stride=(2, 2), num_filter=512, no_bias=True)),
    ("Pooling", [(2, 64, 112, 112)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max")),
    ("Pooling", [(2, 64, 111, 111)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
          pooling_convention="full")),
    ("Pooling", [(2, 64, 111, 111)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          pooling_convention="full")),
    ("Pooling", [(2, 2048, 7, 7)],
     dict(kernel=(1, 1), global_pool=True, pool_type="avg")),
    ("BatchNorm", [(4, 256, 56, 56), (256,), (256,), (256,), (256,)],
     dict(eps=1e-5, momentum=0.9, fix_gamma=False, _training=True)),
    ("BatchNorm", [(4, 2048, 7, 7), (2048,), (2048,), (2048,), (2048,)],
     dict(eps=1e-5, momentum=0.9, fix_gamma=False, _training=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shapes,params", RESNET_OPS,
                         ids=["conv7x7s2", "conv3x3", "conv1x1s2",
                              "maxpool", "maxpool_full", "avgpool_full",
                              "globalavg", "bn56", "bn7"])
def test_resnet_ops_on_the_card_equal_the_cpu(cuda_device, name, shapes,
                                              params):
    from mxnet_tpu_torch.ops import registry

    fn = registry.get(name).bound(**params)
    rng = np.random.RandomState(0)
    ins = [rng.uniform(0.5, 1.5, s) if name == "BatchNorm" and i in (1, 4)
           else rng.randn(*s) for i, s in enumerate(shapes)]
    n_diff = 3 if name == "BatchNorm" else len(ins)
    res = {}
    for dev in (torch.device("cpu"), cuda_device):
        ts = [torch.tensor(a, device=dev, requires_grad=i < n_diff)
              for i, a in enumerate(ins)]
        outs = fn(*ts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cot = torch.tensor(np.random.RandomState(1).randn(*outs[0].shape),
                           device=dev)
        grads = torch.autograd.grad(outs[0], ts[:n_diff], cot)
        res[dev.type] = [o.detach().cpu().numpy() for o in outs] + \
            [g.cpu().numpy() for g in grads]
    for got, want in zip(res["cuda"], res["cpu"]):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-10 * scale


# --------------------------------------------------------- serving tier
@pytest.mark.cuda
def test_http_generate_prefill_reaches_the_wgmma_route(cuda_device):
    """One ``:generate`` over HTTP on the card: its prefill launches the
    flash kernel, on the ``wgmma`` route (bf16, head_dim 64), and the
    streamed tokens equal the terminal line's count."""
    import json
    import urllib.request

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.transformer import model as tm

    cfg = tm.TransformerConfig(vocab_size=512, n_layers=2, d_model=128,
                               n_heads=2, d_ff=256, dtype="bfloat16",
                               param_dtype="bfloat16")
    rt = serving.GenerationRuntime(
        "gen_card", tm.init_params(torch.Generator().manual_seed(0), cfg),
        cfg, slots=2, block_tokens=16, max_prompt=64, max_context=128,
        max_new=8, prefill_batch=2)
    srv = serving.ModelServer(default_deadline_ms=60_000)
    srv.add_generator(rt)
    fe = serving.HttpFrontend(srv, port=0)
    host, port = fe.start()
    try:
        tattn.flash_attention_fwd.launches = 0
        tattn.flash_attention_fwd.launches_by_route = {"wgmma": 0,
                                                       "simt": 0}
        req = urllib.request.Request(
            "http://%s:%d/v1/models/gen_card:generate" % (host, port),
            data=json.dumps({"prompt": list(range(1, 40)), "max_new": 8,
                             "stream": True}).encode())
        lines = [json.loads(ln) for ln in urllib.request.urlopen(
            req, timeout=120).read().decode().splitlines() if ln]
        by_route = dict(tattn.flash_attention_fwd.launches_by_route)
    finally:
        srv.drain(timeout_s=30.0)
        fe.stop()
    assert lines[-1]["done"] and lines[-1]["tokens"] == 8
    assert len(lines) == 9
    assert by_route == {"wgmma": cfg.n_layers, "simt": 0}, by_route
    assert rt.kv.stats()["blocks_live"] == 0


@pytest.mark.cuda
def test_model_runtime_bf16_on_the_card_matches_cpu_float32(cuda_device):
    """The predictor runtime's bf16 execute on the card against its
    float32 run on the CPU: logits within 2e-2 of the batch's largest
    magnitude (bf16 rounds the input, both weights, the hidden layer
    and the logits: ~1e-2 measured on the CPU), the classes equal where
    the top-2 gap is twice that; results come back as numpy."""
    from mxnet_tpu_torch import serving

    card = serving.demo_runtime("m", dim=64, hidden=128, max_batch=32)
    cpu = serving.demo_runtime("m", dim=64, hidden=128, max_batch=32,
                               compute_dtype=None, device="cpu")
    card.compile()
    x = np.random.RandomState(0).randn(32, 64).astype(np.float32)
    cls, logits = card.execute(x[:27])
    want_cls, want = cpu.execute(x[:27])
    assert isinstance(logits, np.ndarray) and logits.dtype == np.float32
    tol = 2e-2 * np.abs(want).max()
    assert np.abs(logits - want).max() <= tol
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * tol
    assert clear.sum() >= 10
    np.testing.assert_array_equal(cls[clear], want_cls[clear])


# -- greedy NMS (csrc/box_nms.cu) ------------------------------------------
def nms_inputs(B, N, dtype, classes, seed=0, layout="clusters"):
    """Seeded score-ordered rows for ``nms_keep``: (boxes, valid, ids).
    ``clusters``: boxes jittered around N/8 centres (many overlaps),
    every 7th a copy of its image's first (ties), 10 % invalid with id
    -1; ``same``: every box one box; ``apart``: a grid of disjoint
    boxes.  ``classes`` None: no ids."""
    rng = np.random.RandomState(seed)
    if layout == "clusters":
        cen = rng.uniform(0.1, 0.9, (B, max(1, N // 8), 2))
        pick = rng.randint(0, cen.shape[1], (B, N))
        ctr = cen[np.arange(B)[:, None], pick] + rng.normal(0, 0.02,
                                                            (B, N, 2))
        wh = rng.uniform(0.02, 0.2, (B, N, 2))
        boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], axis=-1)
        boxes[:, 7::7] = boxes[:, :1]
        valid = rng.uniform(size=(B, N)) > 0.1
    elif layout == "same":
        boxes = np.tile([0.1, 0.2, 0.5, 0.6], (B, N, 1))
        valid = np.ones((B, N), bool)
    else:
        side = int(np.ceil(np.sqrt(N)))
        k = np.arange(N)
        x, y = (k % side) / side, (k // side) / side
        box = np.stack([x, y, x + 0.5 / side, y + 0.5 / side], axis=-1)
        boxes = np.tile(box, (B, 1, 1))
        valid = np.ones((B, N), bool)
    ids = None
    if classes is not None:
        ids = rng.randint(0, classes, (B, N)).astype(np.float64)
        ids[~valid] = -1.0
        ids = torch.tensor(ids, dtype=dtype, device="cuda")
    return (torch.tensor(boxes, dtype=dtype, device="cuda"),
            torch.tensor(valid, device="cuda"), ids)


# (B, N, dtype, classes): the detection's (32, 400), the RPN's (2, 6000),
# MultiBoxDetection's (32, 6132), both sides of the fused route's limit,
# one row, a ragged block, one class with ids, more classes than the
# tiled route's 256 segment buckets, and one segment longer than the
# sweep's ring of 96 tiles (the earliest rows' words read from device
# memory)
NMS_CASES = [
    (32, 400, torch.float32, 21), (32, 400, torch.float64, None),
    (2, 6000, torch.float32, None), (2, 6000, torch.float64, 21),
    (32, 6132, torch.float64, 21), (32, 6132, torch.float32, None),
    (4, 1024, torch.float32, 3), (4, 1025, torch.float64, 3),
    (3, 1, torch.float32, 2), (5, 65, torch.float64, None),
    (2, 2000, torch.float32, 1), (2, 3000, torch.float64, 300),
    (1, 8000, torch.float32, None), (1, 7000, torch.float64, 1),
]


def _nms_id(case):
    B, N, dtype, classes = case
    return "B%dN%d%s%s" % (B, N, str(dtype)[-7:],
                           "" if classes is None else "C%d" % classes)


@pytest.mark.cuda
@pytest.mark.parametrize("case", NMS_CASES, ids=_nms_id)
def test_nms_kernel_keeps_what_the_plain_loop_keeps(cuda_device, case):
    from mxnet_tpu_torch.ops import contrib

    B, N, dtype, classes = case
    boxes, valid, ids = nms_inputs(B, N, dtype, classes)
    route = contrib.nms_route(N)
    launches = contrib.nms_keep.launches
    calls = dict(contrib.nms_keep.calls_by_route)
    keep = contrib.nms_keep(boxes, valid, ids, 0.45)
    torch.cuda.synchronize()
    assert contrib.nms_keep.launches - launches == \
        contrib.NMS_ROUTE_LAUNCHES[route]
    assert contrib.nms_keep.calls_by_route[route] == calls[route] + 1
    want = contrib.nms_keep_plain(boxes, valid, ids, 0.45)
    assert keep.dtype == torch.bool and keep.shape == (B, N)
    assert int((keep != want).sum()) == 0
    assert bool((keep & ~valid).sum() == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [400, 6000])
@pytest.mark.parametrize("layout", ["same", "apart"])
@pytest.mark.parametrize("classes", [None, 5])
def test_nms_kernel_on_all_overlapping_and_disjoint_boxes(cuda_device, N,
                                                          layout, classes):
    from mxnet_tpu_torch.ops import contrib

    boxes, valid, ids = nms_inputs(2, N, torch.float32, classes,
                                   layout=layout)
    keep = contrib.nms_keep(boxes, valid, ids, 0.5).cpu()
    if layout == "apart":
        assert bool(keep.all())
    else:  # one survivor a class: each class's first row
        want = torch.zeros_like(keep)
        for b in range(2):
            seen = set()
            for j, c in enumerate(
                    [0.0] * N if ids is None else ids[b].tolist()):
                if c not in seen:
                    seen.add(c)
                    want[b, j] = True
        assert torch.equal(keep, want)


@pytest.mark.cuda
def test_nms_kernel_route_limit_and_no_fallback(cuda_device, monkeypatch):
    from mxnet_tpu_torch.ops import contrib

    assert contrib._nms_lib().mxt_box_nms_fused_max() == \
        contrib.NMS_FUSED_MAX
    assert contrib._nms_lib().mxt_box_nms_scratch_bytes(
        0, 2, contrib.NMS_FUSED_MAX) == 0

    def plain(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain loop")

    monkeypatch.setattr(contrib, "nms_keep_plain", plain)
    for N in (contrib.NMS_FUSED_MAX, contrib.NMS_FUSED_MAX + 1):
        boxes, valid, ids = nms_inputs(2, N, torch.float32, 4)
        contrib.nms_keep(boxes, valid, ids, 0.5)
    with pytest.raises(TypeError, match="float32 or float64"):
        contrib.nms_keep(boxes.half(), valid, ids, 0.5)
