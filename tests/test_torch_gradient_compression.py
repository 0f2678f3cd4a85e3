"""The port's 2-bit gradient compression
(``mxnet_tpu_torch.gradient_compression``) against the JAX package's
``GradientCompression``, in process: the packed codes and the carried
residual are byte for byte the same on seeded gradients over several
calls, from numpy arrays (the host path) and from tensors (the path a
card runs: codes and residual computed where the tensor lies), at
thresholds that are and are not representable in float32; the wire
bytes agree; the row-sparse residual raises and names its ROADMAP item.
Also: the parameter-server knobs the port registers carry the JAX
package's defaults."""
import numpy as np
import pytest
import torch

from mxnet_tpu import env as jenv
from mxnet_tpu.gradient_compression import GradientCompression as JGC
from mxnet_tpu_torch import env as tenv
from mxnet_tpu_torch.gradient_compression import GradientCompression as TGC


@pytest.mark.parametrize("threshold", [0.5, 0.1, 1.0])
@pytest.mark.parametrize("path", ["numpy", "tensor"])
def test_codes_and_residual_bitwise_over_calls(threshold, path):
    rng = np.random.RandomState(7)
    j, t = JGC(threshold=threshold), TGC(threshold=threshold)
    for call in range(4):
        for key, shape in (("a", (37, 5)), ("b", (64,))):
            g = (rng.randn(*shape) * threshold).astype(np.float32)
            g.flat[0] = -0.0             # the sign of zero in the residual
            g.flat[1] = threshold        # on the threshold
            jcodes, jshape = j.compress(key, g)
            tcodes, tshape = t.compress(
                key, g if path == "numpy" else torch.from_numpy(g))
            if path == "tensor":
                assert isinstance(tcodes, torch.Tensor)
                tcodes = tcodes.numpy().tobytes()
            assert tcodes == jcodes and tshape == jshape, (call, key)
            res = t.residual(key)
            res = res.numpy() if isinstance(res, torch.Tensor) else res
            assert res.tobytes() == j._residual[key].tobytes(), (call, key)
        np.testing.assert_array_equal(t.decompress(tcodes, tshape),
                                      j.decompress(jcodes, jshape))


def test_float64_and_bf16_tensors_encode_as_float32():
    rng = np.random.RandomState(1)
    g = rng.randn(33)
    j, t = JGC(), TGC()
    assert t.compress("a", torch.from_numpy(g))[0].numpy().tobytes() == \
        j.compress("a", g)[0]
    gb = torch.from_numpy(g.astype(np.float32)).to(torch.bfloat16)
    assert t.compress("b", gb)[0].numpy().tobytes() == \
        j.compress("b", gb.float().numpy())[0]


def test_wire_nbytes_and_validation():
    for n in (0, 1, 5, 4096, 4099):
        assert TGC.wire_nbytes(n) == JGC.wire_nbytes(n)
    codes, _ = TGC().compress("k", np.zeros(4096, np.float32))
    assert len(codes) == TGC.wire_nbytes(4096) == 1024
    with pytest.raises(ValueError):
        TGC(type="1bit")
    with pytest.raises(ValueError):
        TGC(threshold=-1.0)
    assert TGC(threshold=0.25).get_params() == \
        JGC(threshold=0.25).get_params()


def test_row_sparse_residual_raises():
    with pytest.raises(NotImplementedError, match="A10 sparse"):
        TGC().compress_rows("k", np.array([1]), np.zeros((1, 4)))


@pytest.mark.parametrize("name", [
    "MXNET_GRADIENT_COMPRESSION", "MXNET_GRADIENT_COMPRESSION_THRESHOLD",
    "MXNET_KVSTORE_SYNC_TIMEOUT", "MXNET_PS_SECRET",
    "MXNET_PS_REQUEST_TIMEOUT", "MXNET_PS_HEARTBEAT_INTERVAL",
    "MXNET_PS_RETRY_MAX", "MXNET_PS_RETRY_BACKOFF_S"])
def test_ps_knobs_carry_the_jax_defaults(name):
    mine, theirs = tenv.var(name), jenv.var(name)
    assert (mine.kind, mine.default) == (theirs.kind, theirs.default)
