"""Worker script of the port's parameter-server tests: exact arithmetic
identities on pushed and pulled values (after the reference's
tests/nightly/dist_sync_kvstore.py:29-60, and this repo's
``tests/dist_worker.py``), importing only the port.

Run under the port's launcher, one kind a cluster::

    python -m mxnet_tpu_torch.launch -n 2 -s 2 python tests/torch_dist_worker.py sync --device cpu
    python -m mxnet_tpu_torch.launch -n 2 -s 1 python tests/torch_dist_worker.py sync --store dist_device_sync

Kinds: ``sync`` (``dist_sync``, or ``--store dist_device_sync``:
Module.fit with ``--io DIR`` holding ``fit_in.npz``, then the push/pull
identities, several values a key merged before the wire, adversarial
orderings,
liveness, the server optimizer, optimizer-state round trips, the 2-bit
wire, compression with error feedback, barriers, and the sparse and SDC
refusals), ``env`` (``MXNET_GRADIENT_COMPRESSION`` set by the launch, and
``MXNET_CHAOS=drop_push:rank=1,key=c,nth=2``: the env toggle, then a
dropped push response absorbed by the retry), ``async`` (``dist_async``:
every push applied exactly once).  A failed assertion exits non-zero, which fails the launch.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import nd  # noqa: E402


def _counter(op):
    from mxnet_tpu_torch import diagnostics as _diag

    return _diag.metrics.counter("mxnet_kvstore_bytes_total",
                                 labels={"op": op})


def fit_mlp(mx_):
    """The Module.fit parity net (both packages)."""
    with mx_.name.NameManager():
        x = mx_.sym.Variable("data")
        x = mx_.sym.FullyConnected(x, num_hidden=16, name="fc1")
        x = mx_.sym.Activation(x, act_type="relu")
        x = mx_.sym.FullyConnected(x, num_hidden=4, name="fc2")
        return mx_.sym.SoftmaxOutput(x, name="softmax")


FIT_OPT = (("learning_rate", 0.125), ("momentum", 0.9), ("wd", 1e-3))


def module_fit(kv, io_dir):
    """``Module.fit`` over the store at batch B a worker on this worker's
    rows of every global batch of ``nw * B``; rank 0 writes the trained
    parameters (float64)."""
    import torch

    from mxnet_tpu_torch import convert

    f = np.load(os.path.join(io_dir, "fit_in.npz"))
    X, y, B = f["X"], f["y"], int(f["batch"])
    nw, r = kv.num_workers, kv.rank
    idx = np.concatenate([np.arange(s + r * B, s + (r + 1) * B)
                          for s in range(0, len(X), nw * B)])
    it = mx.io.NDArrayIter(X[idx], y[idx], batch_size=B)
    mod = mx.mod.Module(fit_mlp(mx), context=mx.current_context())
    mod.bind(it.provide_data, it.provide_label)
    ex = mod._exec
    for d in (ex.arg_dict, ex.aux_dict, ex.grad_dict):
        for cell in d.values():
            if cell is not None:
                cell._data = cell._data.to(torch.float64)
    args = {k[4:]: f[k] for k in f.files if k.startswith("arg:")}
    args, aux = convert.module_params_from_jax(args, {},
                                               ctx=mx.current_context())
    mod.init_params(arg_params=args, aux_params=aux)
    mod.fit(it, num_epoch=int(f["epochs"]), optimizer="sgd",
            optimizer_params=FIT_OPT, kvstore=kv)
    a, _ = mod.get_params()
    # the server-held momenta travel through the Module
    states = os.path.join(io_dir, "fit_states_rank%d" % r)
    mod.save_optimizer_states(states)
    mod.load_optimizer_states(states)
    if r == 0:
        np.savez(os.path.join(io_dir, "fit_out.npz"),
                 **{k: v.asnumpy() for k, v in a.items()})
    kv.barrier()


def sync_push_pull(kv):
    rank, nw = kv.rank, kv.num_workers
    # each worker pushes rank+1; the aggregate is sum(1..nw)
    kv.init("a", nd.zeros((4, 4)))
    kv.push("a", nd.ones((4, 4)) * (rank + 1))
    out = nd.zeros((4, 4))
    kv.pull("a", out=out)
    want = sum(range(1, nw + 1))
    np.testing.assert_allclose(out.asnumpy(), want)
    # without an optimizer the server replaces with each round's sum
    kv.push("a", nd.ones((4, 4)) * 2 * (rank + 1))
    kv.pull("a", out=out)
    np.testing.assert_allclose(out.asnumpy(), 2 * want)


def adversarial_orderings(kv):
    """Shuffled key orders and a burst of two pushes without a pull: with
    plain SGD the total decrement is lr * (every gradient pushed),
    however the rounds were grouped."""
    rank, nw = kv.rank, kv.num_workers
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.0,
                                      rescale_grad=1.0, wd=0.0))
    rng = np.random.RandomState(1000 + rank)
    keys = ["adv%d" % i for i in range(8)]
    for k in keys:
        kv.init(k, nd.zeros((3,)))
    kv.barrier()
    for rnd in range(3):
        for i in rng.permutation(len(keys)):
            kv.push(keys[i], nd.ones((3,)) * (i + 1) * (rnd + 1))
    for i, k in enumerate(keys):
        out = nd.zeros((3,))
        kv.pull(k, out=out)
        want = -0.1 * nw * (i + 1) * (1 + 2 + 3)
        np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-5)
    kv.barrier()
    kv.init("burst", nd.zeros((2,)))
    kv.push("burst", nd.ones((2,)) * (rank + 1))
    kv.push("burst", nd.ones((2,)) * 10 * (rank + 1))
    out = nd.zeros((2,))
    kv.pull("burst", out=out)
    want = -0.1 * 11 * sum(range(1, nw + 1))
    np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-5)
    kv.barrier()
    kv.set_optimizer(None)
    kv.barrier()


def liveness(kv):
    dead = kv.get_dead_nodes(timeout=60)
    assert dead == [], "unexpected dead nodes: %s" % dead


def sync_optimizer(kv):
    nw = kv.num_workers
    kv.init("w", nd.ones((2, 2)))
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                      rescale_grad=1.0 / nw))
    # every worker pushes nw: the sum nw*nw, rescaled nw; w -= 0.1 * nw
    kv.push("w", nd.ones((2, 2)) * nw)
    out = nd.zeros((2, 2))
    kv.pull("w", out=out)
    np.testing.assert_allclose(out.asnumpy(), 1.0 - 0.1 * nw, rtol=1e-5)


def optimizer_state_roundtrip(kv):
    """Momentum survives a save and a load across every server shard."""
    import pickle
    import tempfile

    nw = kv.num_workers
    for k in ("m0", "m1", "m2", "m3"):
        kv.init(k, nd.ones((2,)))
        kv.push(k, nd.ones((2,)) * nw)
        out = nd.zeros((2,))
        kv.pull(k, out=out)
    kv.barrier()
    if kv.rank == 0:
        fd, fname = tempfile.mkstemp()
        os.close(fd)
        kv.save_optimizer_states(fname)
        with open(fname, "rb") as f:
            blob = pickle.loads(f.read())
        held = set()
        for shard in blob["shards"].values():
            held |= set(pickle.loads(shard)) if shard else set()
        assert {"m0", "m1", "m2", "m3"} <= held, held
        kv.load_optimizer_states(fname)
        os.unlink(fname)
    kv.barrier()


def compression_wire(kv):
    """The 2-bit wire: representable gradients ({-t, 0, +t}) cross
    losslessly at 1/16 of the float32 bytes, and power-of-two
    sub-threshold pushes with error feedback land bitwise on the
    uncompressed SGD control."""
    rank, nw = kv.rank, kv.num_workers
    counter = _counter("push")
    n = 4096
    grad_np = ((np.arange(n) % 3).astype(np.float32) - 1.0) * 0.5
    grad = nd.array(grad_np)
    kv.set_optimizer(None)
    kv.init("gw", nd.zeros((n,)))
    base = counter.value
    kv.push("gw", grad)
    d_unc = counter.value - base
    assert d_unc == n * 4, "uncompressed push wire bytes: %s" % d_unc
    out_unc = nd.zeros((n,))
    kv.pull("gw", out=out_unc)
    np.testing.assert_array_equal(out_unc.asnumpy(), nw * grad_np)
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5, momentum=0.0,
                                      rescale_grad=1.0 / nw, wd=0.0))
    kv.init("ef_raw", nd.zeros((8,)))
    for _ in range(4):
        kv.push("ef_raw", nd.ones((8,)) * 0.25)
        out = nd.zeros((8,))
        kv.pull("ef_raw", out=out)
    w_raw = out.asnumpy().copy()
    np.testing.assert_array_equal(w_raw, -0.5)
    kv.set_optimizer(None)
    kv.barrier()
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    base = counter.value
    kv.push("gw", grad)
    d_comp = counter.value - base
    assert d_comp == n // 4, "compressed push wire bytes: %s" % d_comp
    assert d_unc == 16 * d_comp, (d_unc, d_comp)
    out_comp = nd.zeros((n,))
    kv.pull("gw", out=out_comp)
    np.testing.assert_array_equal(out_comp.asnumpy(), out_unc.asnumpy())
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5, momentum=0.0,
                                      rescale_grad=1.0 / nw, wd=0.0))
    kv.init("ef", nd.zeros((8,)))
    for _ in range(4):
        kv.push("ef", nd.ones((8,)) * 0.25)
        out = nd.zeros((8,))
        kv.pull("ef", out=out)
    np.testing.assert_array_equal(out.asnumpy(), w_raw)
    kv.barrier()


def gradient_compression(kv):
    """After ``sync_optimizer``'s SGD (momentum 0.9, rescale 1/nw): 0.6
    is below the threshold 1.0, so round 1 moves nothing and 0.6
    carries; round 2 emits 1.0 from every worker: w = -0.1."""
    kv.init("g", nd.zeros((8,)))
    kv.set_gradient_compression({"type": "2bit", "threshold": 1.0})
    kv.push("g", nd.ones((8,)) * 0.6)
    out = nd.zeros((8,))
    kv.pull("g", out=out)
    np.testing.assert_allclose(out.asnumpy(), 0.0, atol=1e-6)
    kv.push("g", nd.ones((8,)) * 0.6)
    kv.pull("g", out=out)
    np.testing.assert_allclose(out.asnumpy(), -0.1, atol=1e-6)


def refusals(kv):
    """Row-sparse pulls name ROADMAP A10 sparse; the SDC exchanges A11."""
    for fn, item in ((lambda: kv.row_sparse_pull(
            "a", out=nd.zeros((4, 4)), row_ids=nd.array([0])), "A10"),
            (lambda: kv.sdc_exchange(0, [1]), "A11"),
            (lambda: kv.sdc_reference(["a"]), "A11")):
        try:
            fn()
        except mx.MXNetError as e:
            assert item in str(e), e
        else:
            raise AssertionError("no refusal naming %s" % item)


def merged_push(kv):
    """Several values pushed for a key are summed before the wire (on
    the host for dist_sync, on the card for dist_device_sync)."""
    rank, nw = kv.rank, kv.num_workers
    kv.init("d", nd.zeros((5,)))
    kv.push("d", [nd.ones((5,)) * (rank + 1), nd.ones((5,)) * 10])
    out = nd.zeros((5,))
    kv.pull("d", out=out)
    np.testing.assert_array_equal(out.asnumpy(),
                                  sum(r + 1 for r in range(nw)) + 10 * nw)


def run_sync(store, io_dir):
    kv = mx.kv.create(store)
    assert type(kv).__name__ == "KVStoreDist" and kv.num_workers >= 2
    if io_dir:
        module_fit(kv, io_dir)
        kv.set_optimizer(None)
        kv.barrier()
    sync_push_pull(kv)
    merged_push(kv)
    adversarial_orderings(kv)
    liveness(kv)
    compression_wire(kv)
    # back to uncompressed pushes (the servers decode only the pushes
    # marked compressed)
    kv._gc = None
    kv.barrier()
    sync_optimizer(kv)
    optimizer_state_roundtrip(kv)
    gradient_compression(kv)
    refusals(kv)
    kv.barrier()
    kv.barrier()
    kv.close()


def run_env():
    """``MXNET_GRADIENT_COMPRESSION=2bit`` compresses from create; then,
    uncompressed, rank 1's second push of key ``c`` loses its response
    (``MXNET_CHAOS``): the resend is deduped and the sums stay exact."""
    from mxnet_tpu_torch import chaos as _chaos
    from mxnet_tpu_torch import diagnostics as _diag

    kv = mx.kv.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    assert kv._gc is not None and kv._gc.type == "2bit"
    assert kv._gc.threshold == 0.5
    counter = _counter("push")
    n = 1024
    grad_np = ((np.arange(n) % 3).astype(np.float32) - 1.0) * 0.5
    kv.init("g", nd.zeros((n,)))
    base = counter.value
    kv.push("g", nd.array(grad_np))
    assert counter.value - base == n // 4, \
        "env-toggled push not compressed on the wire"
    out = nd.zeros((n,))
    kv.pull("g", out=out)
    np.testing.assert_array_equal(out.asnumpy(), nw * grad_np)
    kv.barrier()
    kv._gc = None
    kv.init("c", nd.zeros((4,)))
    for rnd in range(1, 4):
        kv.push("c", nd.ones((4,)) * (rank + 1) * rnd)
        out = nd.zeros((4,))
        kv.pull("c", out=out)
        np.testing.assert_allclose(out.asnumpy(),
                                   sum(r + 1 for r in range(nw)) * rnd)
    if rank == 1:
        assert _chaos.injected_total("drop_push") == 1
        retries = _diag.metrics.counter("mxnet_ps_retries_total",
                                        labels={"op": "push"})
        assert retries.value >= 1, "drop was absorbed without a retry?"
    else:
        assert _chaos.injected_total() == 0
    kv.barrier()
    kv.close()


def run_async():
    """Every push of a constant gradient applies exactly once: after
    ``nw * P`` pushes with plain SGD the value is ``init - lr * sum``."""
    kv = mx.kv.create("dist_async")
    nw, pushes = kv.num_workers, 5
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.25, momentum=0.0,
                                      rescale_grad=1.0, wd=0.0))
    kv.init("x", nd.ones((3,)) * 4.0)
    for _ in range(pushes):
        kv.push("x", nd.ones((3,)) * 0.5)
    kv.barrier()
    out = nd.zeros((3,))
    kv.pull("x", out=out)
    np.testing.assert_array_equal(out.asnumpy(),
                                  4.0 - 0.25 * 0.5 * nw * pushes)
    kv.barrier()
    kv.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=("sync", "env", "async"))
    ap.add_argument("--store", default="dist_sync",
                    choices=("dist_sync", "dist_device_sync"))
    ap.add_argument("--device", choices=("cpu", "gpu"), default="gpu")
    ap.add_argument("--io", default=None)
    args = ap.parse_args()
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu(0)
    with ctx:
        if args.kind == "sync":
            run_sync(args.store, args.io)
        elif args.kind == "env":
            run_env()
        else:
            run_async()
    print("worker OK", args.kind, flush=True)


if __name__ == "__main__":
    main()
