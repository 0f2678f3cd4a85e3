"""``mx.rtc`` of the port (``mxnet_tpu_torch.rtc``) against the JAX
package's (``mxnet_tpu.rtc``), on the CPU.

* ``PallasModule`` keeps the JAX package's contract: the ``axpy`` case of
  ``tests/test_parity_tail.py`` ported one to one.
* ``rtc.add_reference``, the plain version of the hand-written
  ``csrc/rtc/add.cu``, equals the Pallas ``add`` kernel of
  ``tests/test_parity_tail.py`` run in interpret mode, on the same
  seeded (8, 128) float32 inputs, exactly (one IEEE add per element).
* The signature parser and ``CudaKernel.launch``'s refusals run without
  a card; ``CudaModule`` raises without one.  The kernel itself runs in
  ``tests/test_torch_kernels_on_card.py``.
"""
import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc

ADD_SIG = "const float *x, const float *y, float *out, long n"


def test_pallas_module_axpy_matches_the_jax_package():
    def axpy(a, x, y):
        return a * x + y

    outs = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        mod = pkg.rtc.PallasModule({"axpy": axpy})
        k = mod.get_kernel("axpy")
        x = pkg.nd.array(np.arange(4.0), ctx=ctx)
        (out,) = k.launch([2.0, x, pkg.nd.ones((4,), ctx=ctx)], ctx)
        outs.append(out.asnumpy())
        with pytest.raises(pkg.MXNetError):
            mod.get_kernel("nope")
        assert mod.exports == ["axpy"]
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], 2.0 * np.arange(4.0) + 1.0)


def _pallas_add(x, y):
    # tests/test_parity_tail.py:148-156, as the JAX package runs it here
    def add_kernel(x_ref, y_ref, o_ref):
        o_ref[...] = x_ref[...] + y_ref[...]

    return pl.pallas_call(
        add_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=jax.default_backend() == "cpu")(x, y)


def test_add_reference_equals_the_pallas_add_exactly():
    rng = np.random.RandomState(0)
    x, y = (rng.randn(8, 128).astype(np.float32) for _ in range(2))
    mod = jmx.rtc.PallasModule()
    mod.add_kernel("add", _pallas_add)
    (want,) = mod.get_kernel("add").launch([jmx.nd.array(x),
                                            jmx.nd.array(y)])
    got = rtc.add_reference(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128)
    np.testing.assert_array_equal(got.numpy(), want.asnumpy())
    # through the port's PallasModule, on NDArrays, the same
    tmod = rtc.PallasModule({"add": rtc.add_reference})
    (tout,) = tmod.get_kernel("add").launch(
        [mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())],
        mx.cpu())
    np.testing.assert_array_equal(tout.asnumpy(), want.asnumpy())


def test_signature_parser():
    args = rtc.parse_signature(ADD_SIG)
    assert [(a.ctype, a.dtype, a.pointer, a.const) for a in args] == [
        ("float", torch.float32, True, True),
        ("float", torch.float32, True, True),
        ("float", torch.float32, True, False),
        ("long", torch.int64, False, False)]
    args = rtc.parse_signature("const  __nv_bfloat16*a,double *  b,int n,"
                               "float s, int8_t *c")
    assert [(a.dtype, a.pointer, a.const) for a in args] == [
        (torch.bfloat16, True, True), (torch.float64, True, False),
        (torch.int32, False, False), (torch.float32, False, False),
        (torch.int8, True, False)]
    for bad in ("float x y", "const x", "unsigned *p", "const int n",
                "__half h", "float **p", ""):
        with pytest.raises(mx.MXNetError):
            rtc.parse_signature(bad)


def test_launch_refusals():
    k = rtc.CudaKernel(None, "add", ADD_SIG)
    with mx.cpu():
        x = mx.nd.ones((8, 128))
        d = mx.nd.ones((8, 128), dtype="float64")
        strided = mx.nd.NDArray.from_raw(torch.ones(128, 8).t(), mx.cpu())
    grid, block = (1, 1, 1), (256, 1, 1)
    cases = {
        "cannot launch on cpu": ([x, x, x, 1024], mx.cpu()),
        "expects 4 arguments": ([x, x, 1024], mx.gpu(0)),
        "argument 2 is torch.float64": ([x, x, d, 1024], mx.gpu(0)),
        "argument 1 is not contiguous": ([x, strided, x, 1024], mx.gpu(0)),
        "argument 0 must be an NDArray": ([x._data, x, x, 1024],
                                          mx.gpu(0)),
        "argument 3 must be a number": ([x, x, x, x], mx.gpu(0)),
    }
    for msg, (args, ctx) in cases.items():
        with pytest.raises(mx.MXNetError, match=msg):
            k.launch(args, ctx, grid, block)
    with pytest.raises(mx.MXNetError, match="3 integers"):
        k.launch([x, x, x, 1024], mx.gpu(0), (1, 1), block)
    assert rtc.launches["add"] == 0


def test_cuda_module_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(mx.MXNetError, match="CUDA device"):
        rtc.CudaModule('extern "C" __global__ void f() {}')
    # the JAX package refuses CUDA sources on its side
    with pytest.raises(jmx.MXNetError):
        jmx.rtc.CudaModule('extern "C" __global__ void f() {}')
    # nothing of NVRTC or the driver was loaded for that
    assert rtc._nvrtc is None and rtc._driver is None
