"""How far a float32 gradient of ResNet-50 v1 lies from the float64 one,
in the JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/resnet_fp32_conditioning.py

Builds ResNet-50 v1 (1000 classes) in both packages with the same names,
Xavier weights from numpy seed 0 carried from the JAX package into the
port, takes one recorded forward and backward of the mean softmax
cross-entropy of a seeded (4, 3, 64, 64) uniform batch in float32 and in
float64 in each package, and prints one JSON line: the norm of the
difference of all parameter gradients over the norm of the float64
gradients, for each pair.  This is the conditioning that
``chip_smoke.py``'s ``train_numerics`` phase calibrates its float32
limits against.  Imports both packages; runs on the CPU only.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as jvision  # noqa: E402
from mxnet_tpu_torch import convert  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision  # noqa: E402

SHAPE = (4, 3, 64, 64)


def _grads(pkg, net, ctx, w0, x, y, dtype):
    net.cast("float32")
    if pkg is mx:
        convert.load_block_params(net, w0)
    else:
        for k, p in net.collect_params().items():
            p.set_data(pkg.nd.array(w0[k], ctx=ctx))
    net.cast(dtype)
    with pkg.autograd.record():
        loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(pkg.nd.array(x, dtype=dtype, ctx=ctx)),
            pkg.nd.array(y, ctx=ctx)).mean()
    loss.backward()
    return {k: p.grad().asnumpy().astype(np.float64)
            for k, p in net.collect_params().items() if p.grad_req != "null"}


def _norm_err(a, b):
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in b)
    return (num / sum(float(np.sum(b[k] ** 2)) for k in b)) ** 0.5


def main() -> int:
    rng = np.random.RandomState(7)
    x = rng.uniform(0, 1, SHAPE)
    y = rng.randint(0, 1000, SHAPE[:1]).astype(np.float64)
    settle = np.zeros((2,) + SHAPE[1:], np.float32)
    np.random.seed(0)
    jnet = jvision.resnet50_v1(prefix="c_", classes=1000)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jmx.autograd.pause():
        jnet(jmx.nd.array(settle, ctx=jmx.cpu()))
    w0 = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = tvision.resnet50_v1(prefix="c_", classes=1000)
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    with mx.autograd.pause():
        tnet(mx.nd.array(settle, ctx=mx.cpu()))
    g = {}
    for name, pkg, net, ctx in (("jax", jmx, jnet, jmx.cpu()),
                                ("port", mx, tnet, mx.cpu())):
        for dt in ("float32", "float64"):
            g[name, dt] = _grads(pkg, net, ctx, w0, x, y, dt)
    print(json.dumps({
        "model": "resnet50_v1", "batch": list(SHAPE), "init": "Xavier",
        "jax_float32_vs_float64": _norm_err(g["jax", "float32"],
                                            g["jax", "float64"]),
        "port_float32_vs_float64": _norm_err(g["port", "float32"],
                                             g["port", "float64"]),
        "port_float64_vs_jax_float64": _norm_err(g["port", "float64"],
                                                 g["jax", "float64"]),
        "port_float32_vs_jax_float32": _norm_err(g["port", "float32"],
                                                 g["jax", "float32"]),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
