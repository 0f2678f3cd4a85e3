"""Sparse storage of the port (``mxnet_tpu_torch.ndarray.sparse``, the
lazy row updates, ``row_sparse_pull`` and row-sparse pushes of the
local store, ``LibSVMIter``, the sparse ops, 2-bit ``compress_rows``)
against the JAX package on the same seeded numpy inputs: one test for
each test of ``tests/test_sparse.py`` (same name, parametrised where it
repeats), each holding the port to the JAX package's result at the
tolerance it states, plus the ``.params`` sparse records read across
the packages byte for byte and the copy-on-write rule for sparse parts.
Everything runs on CPU tensors."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch.ndarray import sparse as tsp

# float32 results computed by the same formula in both packages
F32 = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand_dense(shape, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    arr = rng.uniform(-1, 1, size=shape).astype(np.float32)
    mask = rng.uniform(size=shape) < density
    return (arr * mask).astype(np.float32)


def _same_parts(t, j):
    """Two sparse arrays hold the same parts (values bitwise)."""
    assert t.stype == j.stype and t.shape == j.shape
    names = ("data", "indices") + (("indptr",) if t.stype == "csr" else ())
    for n in names:
        np.testing.assert_array_equal(getattr(t, n).asnumpy(),
                                      getattr(j, n).asnumpy())


# ---------------------------------------------------------------------------
# creation / round trips
# ---------------------------------------------------------------------------
def test_csr_roundtrip():
    dense = _rand_dense((7, 5))
    t, j = tsp.csr_matrix(dense), jsp.csr_matrix(dense)
    _same_parts(t, j)
    np.testing.assert_array_equal(t.asnumpy(), dense)
    back = t.tostype("default")
    assert back.stype == "default" and type(back) is tmx.nd.NDArray
    np.testing.assert_array_equal(back.asnumpy(), j.tostype(
        "default").asnumpy())


def test_csr_from_parts():
    parts = (np.array([1.0, 2.0, 3.0]), np.array([1, 0, 2]),
             np.array([0, 1, 3]))
    t = tsp.csr_matrix(parts, shape=(2, 3))
    j = jsp.csr_matrix(parts, shape=(2, 3))
    _same_parts(t, j)
    assert t.dtype == j.dtype == np.float64
    np.testing.assert_array_equal(t.asnumpy(), [[0, 1, 0], [2, 0, 3]])


def test_rsp_roundtrip():
    dense = np.zeros((6, 4), np.float32)
    dense[1] = 1.5
    dense[4] = -2.0
    t, j = tsp.row_sparse_array(dense), jsp.row_sparse_array(dense)
    _same_parts(t, j)
    assert t.data.shape == (2, 4)
    np.testing.assert_array_equal(t.asnumpy(), dense)


def test_rsp_from_parts():
    parts = (np.ones((2, 3), np.float32), np.array([0, 3]))
    t = tsp.row_sparse_array(parts, shape=(5, 3))
    j = jsp.row_sparse_array(parts, shape=(5, 3))
    _same_parts(t, j)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_cast_storage():
    dense = _rand_dense((4, 6))
    td, jd = tmx.nd.array(dense), jmx.nd.array(dense)
    for stype in ("csr", "row_sparse"):
        t, j = tsp.cast_storage(td, stype), jsp.cast_storage(jd, stype)
        _same_parts(t, j)
        assert tsp.cast_storage(t, stype) is t
        assert tmx.nd.cast_storage(t, "default").stype == "default"
    assert td.tostype("csr").stype == "csr"


def test_sparse_zeros():
    for stype, shape in (("row_sparse", (3, 2)), ("csr", (3, 2))):
        t, j = tsp.zeros(stype, shape), jsp.zeros(stype, shape)
        _same_parts(t, j)
        assert t.asnumpy().sum() == 0
    via_nd = tmx.nd.zeros((3, 2), stype="csr")
    assert via_nd.stype == "csr" and via_nd.nnz == 0
    assert tmx.nd.array(np.eye(3, dtype=np.float32),
                        stype="row_sparse").stype == "row_sparse"


def test_dense_fallback_write():
    """Writing through the dense bridge makes the parts recompress."""
    t = tsp.row_sparse_array(np.zeros((4, 2), np.float32))
    j = jsp.row_sparse_array(np.zeros((4, 2), np.float32))
    t[:] = np.ones((4, 2), np.float32)
    j[:] = np.ones((4, 2), np.float32)
    _same_parts(t, j)
    # an op with out= writes through the same bridge
    tmx.nd.zeros((4, 2)).copyto(t)
    assert t.nnz == 0
    with pytest.raises(ValueError):
        t[1] = 2.0


# ---------------------------------------------------------------------------
# sparse compute
# ---------------------------------------------------------------------------
def test_retain():
    dense = np.zeros((6, 2), np.float32)
    dense[[1, 3, 5]] = [[1, 1], [3, 3], [5, 5]]
    t = tsp.retain(tsp.row_sparse_array(dense), tmx.nd.array([1, 5]))
    j = jsp.retain(jsp.row_sparse_array(dense), jmx.nd.array([1, 5]))
    _same_parts(t, j)
    np.testing.assert_array_equal(
        tmx.nd._sparse_retain(tsp.row_sparse_array(dense),
                              [5, 1]).asnumpy(), j.asnumpy())
    # the dense op of a graph: the same rows kept
    np.testing.assert_array_equal(
        tmx.nd.invoke("_sparse_retain", [tmx.nd.array(dense),
                                         tmx.nd.array([1, 5])]).asnumpy(),
        j.asnumpy())


@pytest.mark.parametrize("ta", [False, True])
def test_csr_dot(ta):
    lhs = _rand_dense((8, 5), 0.4, seed=1)
    rhs = np.random.RandomState(2).uniform(-1, 1, (8 if ta else 5, 3)) \
        .astype(np.float32)
    t = tsp.dot(tsp.csr_matrix(lhs), tmx.nd.array(rhs), transpose_a=ta)
    j = jsp.dot(jsp.csr_matrix(lhs), jmx.nd.array(rhs), transpose_a=ta)
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **F32)
    np.testing.assert_allclose(t.asnumpy(), (lhs.T if ta else lhs) @ rhs,
                               rtol=1e-5, atol=1e-6)


def test_rsp_dot():
    lhs = np.zeros((6, 4), np.float32)
    lhs[[0, 2]] = np.random.RandomState(3).uniform(-1, 1, (2, 4))
    rhs = np.random.RandomState(4).uniform(-1, 1, (4, 3)).astype(np.float32)
    t = tsp.dot(tsp.row_sparse_array(lhs), tmx.nd.array(rhs))
    j = jsp.dot(jsp.row_sparse_array(lhs), jmx.nd.array(rhs))
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **F32)
    # float32 rows against a float64 operand: computed in float64, as
    # JAX promotes, and returned in the sparse array's dtype
    t64 = tsp.dot(tsp.row_sparse_array(lhs),
                  tmx.nd.array(rhs.astype(np.float64)))
    j64 = jsp.dot(jsp.row_sparse_array(lhs),
                  jmx.nd.array(rhs.astype(np.float64)))
    assert t64.dtype == j64.dtype == np.float32
    np.testing.assert_array_equal(t64.asnumpy(), j64.asnumpy())


def test_dense_dot_csr():
    lhs = np.random.RandomState(5).uniform(-1, 1, (3, 4)).astype(np.float32)
    rhs = _rand_dense((4, 6), 0.4, seed=6)
    t = tsp.dot(tmx.nd.array(lhs), tsp.csr_matrix(rhs))
    j = jsp.dot(jmx.nd.array(lhs), jsp.csr_matrix(rhs))
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **F32)
    np.testing.assert_allclose(t.asnumpy(), lhs @ rhs, rtol=1e-5, atol=1e-6)


def test_rsp_elemwise():
    a = np.zeros((5, 3), np.float32)
    b = np.zeros((5, 3), np.float32)
    a[[0, 2]] = 1.0
    b[[2, 4]] = 2.0
    for fn in ("add", "subtract", "multiply"):
        t = getattr(tsp, fn)(tsp.row_sparse_array(a),
                             tsp.row_sparse_array(b))
        j = getattr(jsp, fn)(jsp.row_sparse_array(a),
                             jsp.row_sparse_array(b))
        assert t.stype == "row_sparse"
        _same_parts(t, j)


def test_square_sum():
    dense = _rand_dense((6, 4), 0.5, seed=7)
    t, j = tsp.row_sparse_array(dense), jsp.row_sparse_array(dense)
    for kw in ({}, {"axis": 1}, {"axis": 1, "keepdims": True}):
        np.testing.assert_allclose(tsp.square_sum(t, **kw).asnumpy(),
                                   jsp.square_sum(j, **kw).asnumpy(), **F32)
    np.testing.assert_allclose(tsp.square_sum(t).asnumpy(),
                               (dense ** 2).sum(), rtol=1e-5)


def test_dense_ops_on_sparse_fallback():
    """Dense ops read sparse inputs through the densify bridge."""
    dense = _rand_dense((4, 4), 0.5, seed=8)
    t = tmx.nd.sum(tsp.csr_matrix(dense))
    j = jmx.nd.sum(jsp.csr_matrix(dense))
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **F32)
    r = tsp.row_sparse_array(dense) * 2 + 1
    np.testing.assert_array_equal(r.asnumpy(), dense * 2 + 1)


# ---------------------------------------------------------------------------
# optimizer lazy updates
# ---------------------------------------------------------------------------
def _run_opt(mx, sp, opt_name, touched_rows, steps=3, **opt_kw):
    shape = (8, 3)
    rng = np.random.RandomState(9)
    w0 = rng.uniform(-1, 1, shape).astype(np.float32)
    gd = rng.uniform(-1, 1, (len(touched_rows),) + shape[1:]) \
        .astype(np.float32)
    opt = mx.optimizer.create(opt_name, learning_rate=0.1, **opt_kw)
    w = mx.nd.array(w0)
    state = opt.create_state(0, w)
    for _ in range(steps):
        grad = sp.row_sparse_array((gd, np.asarray(touched_rows)),
                                   shape=shape)
        opt.update(0, w, grad, state)
    states = [] if state is None else (
        list(state) if isinstance(state, tuple) else [state])
    return w0, w.asnumpy(), [s.asnumpy() for s in states]


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", {"momentum": 0.9}),
    ("sgd", {}),
    ("adam", {}),
    ("adagrad", {}),
])
def test_lazy_update_untouched_rows(opt_name, kw):
    """Rows absent from the gradient keep their weight and their states
    bitwise; touched rows follow the JAX package's update (float32: the
    two may contract a multiply-add differently, so 1e-6)."""
    touched = [1, 4, 6]
    w0, tw, ts = _run_opt(tmx, tsp, opt_name, touched, **kw)
    _, jw, js = _run_opt(jmx, jsp, opt_name, touched, **kw)
    untouched = [r for r in range(8) if r not in touched]
    np.testing.assert_array_equal(tw[untouched], w0[untouched])
    for s in ts:
        np.testing.assert_array_equal(s[untouched], 0.0)
    assert np.abs(tw[touched] - w0[touched]).max() > 1e-4
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-6)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_sparse_sgd_matches_dense_on_touched_rows():
    """With wd=0 the lazy row update equals the dense update on the
    touched rows (and the port's dense Adam / AdaGrad the JAX
    package's)."""
    shape = (6, 2)
    rng = np.random.RandomState(11)
    w0 = rng.uniform(-1, 1, shape).astype(np.float32)
    g_rows = np.array([0, 3])
    gd = rng.uniform(-1, 1, (2, 2)).astype(np.float32)
    g_dense = np.zeros(shape, np.float32)
    g_dense[g_rows] = gd
    out = {}
    for name, kw in (("sgd", {"momentum": 0.9}), ("adam", {}),
                     ("adagrad", {})):
        for pkg, sp in ((tmx, tsp), (jmx, jsp)):
            opt_s = pkg.optimizer.create(name, learning_rate=0.2, **kw)
            opt_d = pkg.optimizer.create(name, learning_rate=0.2, **kw)
            ws, wd_ = pkg.nd.array(w0), pkg.nd.array(w0)
            ss, sd = opt_s.create_state(0, ws), opt_d.create_state(0, wd_)
            for _ in range(3):
                opt_s.update(0, ws, sp.row_sparse_array((gd, g_rows),
                                                        shape=shape), ss)
                opt_d.update(0, wd_, pkg.nd.array(g_dense), sd)
            out[name, pkg.__name__] = (ws.asnumpy(), wd_.asnumpy())
        ts, td = out[name, "mxnet_tpu_torch"]
        js, jd = out[name, "mxnet_tpu"]
        if name == "sgd":
            np.testing.assert_allclose(ts[g_rows], td[g_rows], rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# kvstore row_sparse
# ---------------------------------------------------------------------------
def test_kvstore_row_sparse_pull():
    w = np.arange(12, dtype=np.float32).reshape(6, 2)
    res = []
    for pkg, sp in ((tmx, tsp), (jmx, jsp)):
        kv = pkg.kv.create("local")
        kv.init(3, pkg.nd.array(w))
        out = sp.zeros("row_sparse", (6, 2))
        kv.row_sparse_pull(3, out=out, row_ids=pkg.nd.array([4, 1, 4]))
        res.append(out)
    _same_parts(*res)
    np.testing.assert_array_equal(res[0].indices.asnumpy(), [1, 4])


def test_kvstore_rsp_push():
    shape = (5, 2)
    a = np.zeros(shape, np.float32)
    a[1] = 1.0
    b = np.zeros(shape, np.float32)
    b[3] = 2.0
    res = []
    for pkg, sp in ((tmx, tsp), (jmx, jsp)):
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.zeros(shape))
        kv.push("w", [sp.row_sparse_array(a), sp.row_sparse_array(b)])
        out = pkg.nd.zeros(shape)
        kv.pull("w", out=out)
        res.append(out.asnumpy())
    np.testing.assert_array_equal(res[0], res[1])
    np.testing.assert_array_equal(res[0], a + b)


def _write_libsvm(p):
    p.write_text("1 0:1.5 3:2.0\n0 1:3.0\n1 2:0.5 3:1.0\n0 0:2.0 1:1.0\n"
                 "1 3:4.0\n")
    return str(p)


def test_libsvm_iter(tmp_path):
    """CSR batches with round-batch padding, as the JAX package's."""
    path = _write_libsvm(tmp_path / "train.libsvm")
    kw = dict(data_libsvm=path, data_shape=(4,), batch_size=2)
    tb, jb = list(tmx.io.LibSVMIter(**kw)), list(jmx.io.LibSVMIter(**kw))
    assert len(tb) == len(jb) == 3
    for t, j in zip(tb, jb):
        assert isinstance(t.data[0], tsp.CSRNDArray)
        _same_parts(t.data[0], j.data[0])
        np.testing.assert_array_equal(t.label[0].asnumpy(),
                                      j.label[0].asnumpy())
        assert t.pad == j.pad
    assert tb[2].pad == 1
    w = tmx.nd.ones((4, 2))
    np.testing.assert_allclose(tmx.nd.dot(tb[0].data[0], w).asnumpy()[0],
                               [3.5, 3.5])
    np.testing.assert_allclose(tsp.dot(tb[0].data[0], w).asnumpy()[0],
                               [3.5, 3.5])
    it = tmx.io.LibSVMIter(**kw)
    list(it)
    it.reset()
    assert len(list(it)) == 3
    # a CSR label file
    lab = tmp_path / "l.libsvm"
    lab.write_text("0 0:1.0\n0 1:1.0\n0 0:2.0\n0 1:2.0\n0 0:3.0\n")
    kw.update(label_libsvm=str(lab), label_shape=(2,))
    t = next(iter(tmx.io.LibSVMIter(**kw)))
    j = next(iter(jmx.io.LibSVMIter(**kw)))
    _same_parts(t.label[0], j.label[0])


def test_libsvm_iter_validation(tmp_path):
    bad = tmp_path / "bad.libsvm"
    bad.write_text("1 7:1.0\n")
    with pytest.raises(tmx.MXNetError, match="outside"):
        tmx.io.LibSVMIter(data_libsvm=str(bad), data_shape=(4,),
                          batch_size=1)
    data = tmp_path / "d.libsvm"
    data.write_text("1 0:1.0\n0 1:1.0\n")
    lab = tmp_path / "l.libsvm"
    lab.write_text("0 0:1.0\n")
    with pytest.raises(tmx.MXNetError, match="label file"):
        tmx.io.LibSVMIter(data_libsvm=str(data), data_shape=(4,),
                          label_libsvm=str(lab), batch_size=1)


# ---------------------------------------------------------------------------
# wire accounting, the sparse embedding gradient, 2-bit rows, clickstream
# ---------------------------------------------------------------------------
def _bytes_counter(pkg, op):
    return pkg.diagnostics.metrics.counter("mxnet_kvstore_bytes_total",
                                           labels={"op": op})


def test_rsp_dense_roundtrip_via_tostype():
    dense = _rand_dense((9, 3), 0.4, seed=12)
    t = tsp.row_sparse_array(dense).tostype("default").tostype("row_sparse")
    j = jsp.row_sparse_array(dense).tostype("default").tostype("row_sparse")
    _same_parts(t, j)


def test_row_sparse_pull_error_paths():
    kv = tmx.kv.create("local")
    kv.init("w", tmx.nd.zeros((4, 2)))
    out = tsp.zeros("row_sparse", (4, 2))
    with pytest.raises(tmx.MXNetError, match="row_ids"):
        kv.row_sparse_pull("w", out=out)
    with pytest.raises(tmx.MXNetError, match="out"):
        kv.row_sparse_pull("w", row_ids=tmx.nd.array([0]))
    with pytest.raises(tmx.MXNetError, match="uninitialised"):
        kv.row_sparse_pull("missing", out=out, row_ids=tmx.nd.array([0]))


def test_row_sparse_pull_bytes_proportional_to_unique_rows():
    """A pull's bytes are unique rows x (row payload + 8-byte id): the
    same rows of a 64-row and a 4096-row table cost the same, in both
    packages."""
    dim = 4
    rows = [3, 9, 9, 17, 3]
    deltas = {}
    for pkg, sp in ((tmx, tsp), (jmx, jsp)):
        kv = pkg.kv.create("local")
        ctr = _bytes_counter(pkg, "row_sparse_pull")
        for key, vocab in (("small", 64), ("big", 4096)):
            kv.init(key, pkg.nd.zeros((vocab, dim)))
            out = sp.zeros("row_sparse", (vocab, dim))
            base = ctr.value
            kv.row_sparse_pull(key, out=out, row_ids=pkg.nd.array(rows))
            deltas[pkg.__name__, key] = ctr.value - base
    assert set(deltas.values()) == {3 * (dim * 4 + 8)}, deltas


def test_row_sparse_push_bytes_under_own_op_label():
    """An all-row-sparse push counts under op=row_sparse_push (rows and
    ids), op=push stays where it was."""
    dim, vocab = 4, 1024
    got = []
    for pkg, sp in ((tmx, tsp), (jmx, jsp)):
        kv = pkg.kv.create("local")
        kv.init("t", pkg.nd.zeros((vocab, dim)))
        g = sp.row_sparse_array((np.ones((2, dim), np.float32),
                                 np.array([5, 900])), shape=(vocab, dim))
        cs, cd = _bytes_counter(pkg, "row_sparse_push"), \
            _bytes_counter(pkg, "push")
        bs, bd = cs.value, cd.value
        kv.push("t", g)
        got.append((cs.value - bs, cd.value - bd))
    assert got[0] == got[1] == (2 * dim * 4 + 2 * 8, 0), got


def test_sparse_embedding_grad_pins_dense_embedding():
    """``_contrib_SparseEmbedding``'s weight gradient (dedup + segment
    sum) equals the dense ``Embedding``'s and the JAX package's."""
    rng = np.random.RandomState(0)
    vocab, dim = 50, 6
    w_np = rng.randn(vocab, dim).astype(np.float32)
    ids_np = rng.randint(0, vocab, (8, 3)).astype(np.float32)
    ids_np[0, 0] = vocab + 7     # clipped to the last row, not raised
    head = rng.randn(8, 3, dim).astype(np.float32)
    grads = {}
    for pkg in (tmx, jmx):
        for op in ("Embedding", "_contrib_SparseEmbedding"):
            w = pkg.nd.array(w_np)
            w.attach_grad()
            with pkg.autograd.record():
                emb = getattr(pkg.nd, op)(pkg.nd.array(ids_np), w,
                                          input_dim=vocab, output_dim=dim)
                loss = pkg.nd.sum(emb * pkg.nd.array(head))
            loss.backward()
            grads[pkg.__name__, op] = w.grad.asnumpy()
    t = grads["mxnet_tpu_torch", "_contrib_SparseEmbedding"]
    assert np.abs(t).sum() > 0 and np.abs(t[vocab - 1]).sum() > 0
    for k, g in grads.items():
        np.testing.assert_allclose(t, g, rtol=1e-6, atol=1e-6, err_msg=k)


def test_row_sparse_embedding_grad_matches_dense_scatter():
    import jax.numpy as jnp

    from mxnet_tpu.ops.extra import row_sparse_embedding_grad as jgrad
    from mxnet_tpu_torch.ops.extra import row_sparse_embedding_grad as tgrad

    rng = np.random.RandomState(1)
    vocab, dim = 20, 3
    ids = rng.randint(0, vocab, (4, 5))
    cot = rng.randn(4, 5, dim).astype(np.float32)
    tr, tv = tgrad(torch.from_numpy(ids), torch.from_numpy(cot), vocab)
    jr, jv = jgrad(jnp.asarray(ids), jnp.asarray(cot), vocab)
    # the same padded rows (fill id == vocab) and per-row sums
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)
    dense = np.zeros((vocab, dim), np.float32)
    np.add.at(dense, ids.reshape(-1), cot.reshape(-1, dim))
    keep = tr.numpy() < vocab
    got = np.zeros((vocab, dim), np.float32)
    np.add.at(got, tr.numpy()[keep], tv.numpy()[keep])
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-6)


def test_compress_rows_error_feedback_follows_row():
    """2-bit row-sparse compression keeps the residual per (key, row
    id), byte for byte the JAX package's."""
    from mxnet_tpu.gradient_compression import GradientCompression as JGC
    from mxnet_tpu_torch.gradient_compression import \
        GradientCompression as TGC

    t, j = TGC("2bit", threshold=0.5), JGC("2bit", threshold=0.5)
    dim = 4
    quarter = np.full((2, dim), 0.25, np.float32)
    rounds = (("k", [1, 3], quarter), ("k", [3, 5], quarter),
              ("k", [1], quarter[:1]), ("k2", [1], quarter[:1]))
    outs = []
    for key, rows, vals in rounds:
        tc, ts = t.compress_rows(key, np.array(rows), vals)
        jc, js = j.compress_rows(key, np.array(rows), vals)
        assert (tc, ts) == (jc, js)
        assert len(tc) == TGC.wire_nbytes(len(rows) * dim)
        outs.append(t.decompress(tc, ts))
    np.testing.assert_array_equal(outs[0], 0.0)
    np.testing.assert_array_equal(outs[1][0], 0.5)
    np.testing.assert_array_equal(outs[1][1], 0.0)
    np.testing.assert_array_equal(outs[2][0], 0.5)
    np.testing.assert_array_equal(outs[3], 0.0)
    assert TGC.rows_wire_nbytes(3, dim) == JGC.rows_wire_nbytes(3, dim) \
        == 3 * 8 + (3 * dim + 3) // 4


def test_clickstream_iter_determinism_and_sharding():
    from mxnet_tpu.recommender import ClickstreamIter as J
    from mxnet_tpu_torch.recommender import ClickstreamIter as T

    kw = dict(batch_size=8, n_fields=4, vocab=1000, num_samples=64, seed=3)
    for parts in ({}, {"num_parts": 2, "part_index": 1}):
        a, b = T(**kw, **parts), J(**kw, **parts)
        for _ in range(3):
            da, la, pa = a.next_raw()
            db, lb, pb = b.next_raw()
            assert da[0].dtype == db[0].dtype == np.int32
            np.testing.assert_array_equal(da[0], db[0])
            np.testing.assert_array_equal(la[0], lb[0])
            assert pa == pb == 0
        assert a.replay_spec() == b.replay_spec()
    c = T(**kw)
    c.skip_batches(2)
    d = J(**kw)
    d.skip_batches(2)
    np.testing.assert_array_equal(c.next_raw()[0][0], d.next_raw()[0][0])


def test_clickstream_zipf_hotness():
    from mxnet_tpu.recommender import make_clickstream as jmake
    from mxnet_tpu_torch.recommender import make_clickstream as tmake

    ids, clicks = tmake(2048, 4, 10000, alpha=1.05, seed=0)
    jids, jclicks = jmake(2048, 4, 10000, alpha=1.05, seed=0)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(clicks, jclicks)
    assert 0 < clicks.sum() < 2048
    mean_uni = np.mean([np.unique(ids[i:i + 32, 0]).size
                        for i in range(0, 2048, 32)])
    assert mean_uni < 30, mean_uni


def _rec_fit(pkg, rec, cfg, sparse, lr, params=None):
    it = rec.ClickstreamIter(batch_size=16, n_fields=3, vocab=500,
                             num_samples=256, seed=1)
    kv = pkg.kv.create("local")
    kw = {} if params is None else {"params": params}
    step = rec.RecommenderTrainStep(
        cfg, kv, optimizer=pkg.optimizer.SGD(learning_rate=lr,
                                             momentum=0.0, wd=0.0),
        n_shards=3 if sparse else 1, seed=0, sparse=sparse, **kw)
    return step.fit(it, 8)


@pytest.mark.parametrize("lr", [0.05, 0.0])
def test_recommender_sparse_matches_dense_control(lr):
    """The sharded hot-row path and the dense full-table control on the
    same clickstream from the JAX package's parameters: the port's two
    within 1e-6 relative / 1e-7 absolute (bitwise at lr 0), and each
    within 1e-6 of the JAX package's losses."""
    import jax

    import mxnet_tpu.recommender as jrec
    import mxnet_tpu_torch.recommender as trec

    kw = dict(n_fields=3, vocab=500, embed_dim=4, mlp_hidden=(8,))
    params = {n: np.asarray(v) for n, v in jrec.init_params(
        jax.random.PRNGKey(0), jrec.RecommenderConfig(**kw)).items()}
    ctr = _bytes_counter(tmx, "row_sparse_pull")
    base = ctr.value
    s = _rec_fit(tmx, trec, trec.RecommenderConfig(**kw), True, lr, params)
    assert ctr.value > base
    d = _rec_fit(tmx, trec, trec.RecommenderConfig(**kw), False, lr, params)
    if lr == 0.0:
        np.testing.assert_array_equal(s["losses"], d["losses"])
    else:
        np.testing.assert_allclose(s["losses"], d["losses"], rtol=1e-6,
                                   atol=1e-7)
        assert np.mean(s["losses"][-3:]) < np.mean(s["losses"][:3])
    js = _rec_fit(jmx, jrec, jrec.RecommenderConfig(**kw), True, lr)
    np.testing.assert_allclose(s["losses"], js["losses"], rtol=0,
                               atol=1e-6)
    assert s["mean_unique_rows_per_batch"] == \
        js["mean_unique_rows_per_batch"]
    assert 0 < s["mean_unique_rows_per_batch"] <= 16 * 3


# ---------------------------------------------------------------------------
# the .params container's sparse records, copy-on-write
# ---------------------------------------------------------------------------
def _sparse_payload(sp):
    dense = _rand_dense((6, 5), 0.4, seed=21)
    rsp = np.zeros((7, 3), np.float32)
    rsp[[2, 5]] = np.arange(6, dtype=np.float32).reshape(2, 3)
    return {"w_csr": sp.csr_matrix(dense), "w_rsp": sp.row_sparse_array(rsp)}


def test_params_sparse_records_cross_byte_for_byte(tmp_path):
    """A .params file with CSR and row-sparse records (and a dense one)
    written by either package is the other's byte for byte, and each
    loads the other's back into the same storage types and parts."""
    tp, jp = tmp_path / "t.params", tmp_path / "j.params"
    t_arrays = dict(_sparse_payload(tsp),
                    dense=tmx.nd.array(np.ones((2, 3), np.float32)))
    j_arrays = dict(_sparse_payload(jsp),
                    dense=jmx.nd.array(np.ones((2, 3), np.float32)))
    tmx.nd.save(str(tp), t_arrays)
    jmx.nd.save(str(jp), j_arrays)
    assert tp.read_bytes() == jp.read_bytes()
    t_from_j, j_from_t = tmx.nd.load(str(jp)), jmx.nd.load(str(tp))
    for k in ("w_csr", "w_rsp"):
        _same_parts(t_from_j[k], j_arrays[k])
        _same_parts(t_arrays[k], j_from_t[k])
    np.testing.assert_array_equal(t_from_j["dense"].asnumpy(), 1.0)
    # a list payload and load_frombuffer
    tmx.nd.save(str(tp), [t_arrays["w_rsp"], t_arrays["w_csr"]])
    back = tmx.nd.load_frombuffer(tp.read_bytes())
    _same_parts(back[0], t_arrays["w_rsp"])
    _same_parts(back[1], t_arrays["w_csr"])


def test_sparse_parts_are_owned():
    """Copy-on-write: a sparse array copies what it is given, and its
    ``data`` / ``indices`` / ``indptr`` are copies of its parts."""
    data = torch.ones(2, 3)
    idx = torch.tensor([0, 4])
    r = tsp.row_sparse_array((data, idx), shape=(6, 3))
    data.fill_(7.0)
    assert r.asnumpy().max() == 1.0
    d = r.data
    d[:] = 5.0
    np.testing.assert_array_equal(r.data.asnumpy(), 1.0)
    c = r.copy()
    c[:] = np.zeros((6, 3), np.float32)
    assert r.nnz == 2 and c.nnz == 0
    p = r._parts()
    for name in ("data", "indices"):
        assert getattr(r, name)._data.data_ptr() != p[name].data_ptr()
