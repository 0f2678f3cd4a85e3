"""Parity of the port's detection tier with the JAX package's:
``mxnet_tpu_torch.ops.contrib`` (every op of ``mxnet_tpu/ops/contrib.py``),
the spatial tail of ``ops/nn.py`` (``UpSampling`` .. ``Crop``, and the
``CuDNNBatchNorm`` alias) and ``bipartite_matching``.

Each case runs the same seeded numpy inputs through the JAX op body and
the port's, forward and (for the ops autograd reaches) the gradient of
the first output under a seeded cotangent (``jax.vjp`` against
``torch.autograd.grad``), in float64 and float32, and on ``meta``
tensors for the shapes (shape inference runs the bodies there).

Tolerances, relative to the JAX value's largest magnitude (at least 1):
float64 1e-10 (sums in another order, a few ulps); ``fft`` / ``ifft``
1e-5 (float32 transforms inside, pocketfft against XLA's); float32
2e-5 (a float32 ulp is 6e-8, and the CTC recursion, the deformable
samples and the decoders chain tens of roundings).  Integer, boolean and
index outputs (NMS rows kept, class targets, matchings, quantised codes)
must be equal, ties included: the inputs plant equal scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.ops  # noqa: F401  (registers the JAX ops)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import registry as treg

import chip_smoke as cs

TOL = {np.float64: 1e-10, np.float32: 2e-5}
FFT_TOL = 1e-5


# the cases (one table for these tests and the smoke's ssd_numerics)
CASES = cs.DET_CASES
nms_rows = cs.nms_rows
priors = cs.priors
_id = cs.det_case_id


_NEW_NAMES = (
    {n for n, op in jreg._REGISTRY.items()
     if op.fn.__module__ == "mxnet_tpu.ops.contrib"}
    | {"UpSampling", "BilinearSampler", "GridGenerator",
       "SpatialTransformer", "ROIPooling", "Crop", "CuDNNBatchNorm",
       "bipartite_matching", "_contrib_bipartite_matching"})


def _close(got, want, what, tol):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    w64, g64 = want.astype(np.float64), got.astype(np.float64)
    scale = max(float(np.abs(w64).max()), 1.0)
    err = float(np.abs(g64 - w64).max())
    assert err <= tol * scale, (what, err, scale)


def _run(case, dtype):
    ins, rng = cs.det_case_inputs(case, dtype)
    jop, top = jreg.get(case.op), treg.get(case.op)
    jfn, tfn = jop.bound(**case.params), top.bound(**case.params)
    diff = [i for i in case.diff]
    fixed = [jnp.asarray(a) for a in ins]

    def jpart(*d):
        args = list(fixed)
        for i, v in zip(diff, d):
            args[i] = v
        return jfn(*args)

    jouts, vjp = jax.vjp(jax.jit(jpart), *[fixed[i] for i in diff])
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    tins = [torch.tensor(a, requires_grad=i in diff)
            for i, a in enumerate(ins)]
    touts = tfn(*tins)
    touts = touts if isinstance(touts, tuple) else (touts,)
    assert len(touts) == len(jouts)
    tol = FFT_TOL if case.op.endswith("fft") else TOL[dtype]
    for k, (t, j) in enumerate(zip(touts, jouts)):
        assert t.dtype == getattr(torch, str(np.asarray(j).dtype)) or (
            # the JAX package computes GridGenerator's base grid in its
            # default float type (float64 under x64); the port keeps the
            # data's
            case.op in ("GridGenerator", "SpatialTransformer")), \
            (k, t.dtype, j.dtype)
        if k in case.exact:
            np.testing.assert_array_equal(t.detach().numpy(),
                                          np.asarray(j), "output %d" % k)
            continue
        for e in case.exact:
            if isinstance(e, tuple) and e[0] == k:
                np.testing.assert_array_equal(
                    t.detach().numpy()[..., e[1]], np.asarray(j)[..., e[1]],
                    "output %d column %d" % e)
        _close(t.detach().numpy(), j, "output %d" % k, tol)
    if not diff:
        return
    cot = rng.standard_normal(np.shape(jouts[0])).astype(
        np.asarray(jouts[0]).dtype)
    jcots = (jnp.asarray(cot),) + tuple(jnp.zeros_like(o)
                                        for o in jouts[1:])
    jgrads = vjp(jcots if len(jouts) > 1 else jcots[0])
    tgrads = torch.autograd.grad(touts[0], [tins[i] for i in diff],
                                 torch.tensor(cot), allow_unused=True)
    for i, g, jg in zip(diff, tgrads, jgrads):
        g = np.zeros(ins[i].shape) if g is None else g.numpy()
        _close(g, jg, "gradient of input %d" % i, tol)
    return ins, touts


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_op_matches_jax_in_float64(case):
    _run(case, np.float64)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_op_matches_jax_in_float32(case):
    _run(case, np.float32)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_op_runs_on_meta_tensors_with_the_jax_shapes(case):
    ins, _ = cs.det_case_inputs(case)
    jouts = jax.eval_shape(jreg.get(case.op).bound(**case.params),
                           *[jnp.asarray(a) for a in ins])
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    touts = treg.get(case.op).bound(**case.params)(
        *[torch.tensor(a).to("meta") for a in ins])
    touts = touts if isinstance(touts, tuple) else (touts,)
    assert [tuple(t.shape) for t in touts] == \
        [tuple(j.shape) for j in jouts]


def test_every_new_name_is_ported_with_its_flags_and_has_a_case():
    assert len(_NEW_NAMES) == 42
    assert _NEW_NAMES <= set(treg._REGISTRY)
    for n in _NEW_NAMES:
        j, t = jreg.get(n), treg.get(n)
        assert (t.name, t.mutate_aux, t.train_aware, t.rng, t.nondiff,
                t.num_outputs) == (j.name, j.mutate_aux, j.train_aware,
                                   j.rng, j.nondiff, j.num_outputs), n
        assert t.input_names == j.input_names, n
        assert sorted(t.aliases) == sorted(j.aliases), n
    assert {treg.get(c.op).name for c in CASES} == \
        {jreg.get(n).name for n in _NEW_NAMES}
    # the registries: 324 names; 82 of the JAX package's 406 queued
    assert len(treg._REGISTRY) == 324
    assert len(set(jreg._REGISTRY) - set(treg._REGISTRY)) == 82


def test_contrib_namespaces_list_the_jax_packages_names():
    def names(ns):
        return {n for n in vars(ns) if not n.startswith("__")}

    assert names(tmx.nd.contrib) == names(jmx.nd.contrib)
    assert names(tmx.sym.contrib) == names(jmx.sym.contrib)
    assert "SparseEmbedding" in names(tmx.nd.contrib)
    for name in ("ctc_loss", "CTCLoss", "box_nms", "bipartite_matching",
                 "MultiBoxTarget"):
        assert callable(getattr(tmx.nd.contrib, name))
        assert callable(getattr(tmx.sym.contrib, name))


def test_sym_contrib_infers_detection_shapes():
    sym = tmx.sym
    data = sym.Variable("data")
    anchors = sym.contrib.MultiBoxPrior(data, sizes=(0.5,), ratios=(1.0,))
    _, out_shapes, _ = anchors.infer_shape(data=(1, 3, 4, 4))
    assert out_shapes[0] == (1, 16, 4)
    cls = sym.Variable("cls")
    loc = sym.Variable("loc")
    label = sym.Variable("label")
    tgt = sym.contrib.MultiBoxTarget(anchors, label, cls)
    _, outs, _ = tgt.infer_shape(data=(1, 3, 4, 4), label=(2, 3, 5),
                                 cls=(2, 4, 16))
    assert outs == [(2, 64), (2, 64), (2, 16)]
    det = sym.contrib.MultiBoxDetection(cls, loc, anchors, nms_topk=5)
    _, outs, _ = det.infer_shape(data=(1, 3, 4, 4), cls=(2, 4, 16),
                                 loc=(2, 64))
    assert outs == [(2, 16, 6)]
    # Proposal / MultiProposal: two outputs with output_score
    prob, delta, info = (sym.Variable(n) for n in ("p", "d", "i"))
    rois = sym.contrib.MultiProposal(prob, delta, info, output_score=True,
                                     rpn_post_nms_top_n=7)
    assert len(rois.list_outputs()) == 2
    _, outs, _ = rois.infer_shape(p=(2, 24, 3, 3), d=(2, 48, 3, 3),
                                  i=(2, 3))
    assert outs == [(14, 5), (14, 1)]
    one = sym.contrib.Proposal(prob, delta, info, rpn_post_nms_top_n=7)
    assert len(one.list_outputs()) == 1


def test_box_nms_ties_keep_the_first_in_index_order():
    # four identical boxes with one score: the first (stable order)
    # survives and suppresses the rest; a disjoint box survives too
    rows = np.array([[[0, 0.7, 0.1, 0.1, 0.4, 0.4]] * 4
                     + [[0, 0.7, 0.6, 0.6, 0.9, 0.9]]], np.float64)
    rows[0, :, 0] = [0, 1, 0, 2, 0]
    for kw in (dict(id_index=0), {}):
        want = np.asarray(jreg.get("box_nms").fn(jnp.asarray(rows),
                                                 overlap_thresh=0.5, **kw))
        got = treg.get("box_nms").fn(torch.tensor(rows),
                                     overlap_thresh=0.5, **kw).numpy()
        np.testing.assert_array_equal(got, want)
    assert (got[0, :, 0] >= 0).sum() == 2  # without ids: one of four


def test_multibox_target_ties_rank_negatives_stably():
    # every unmatched anchor has the same best foreground probability:
    # the mined negatives are the first ones in anchor order
    anchors = np.asarray(priors(4, 4, sizes=(0.25,), ratios=(1.0,))(None))
    label = np.array([[[1, 0.0, 0.0, 0.25, 0.25], [-1] * 5]], np.float64)
    pred = np.full((1, 3, 16), 1.0 / 3)
    kw = dict(negative_mining_ratio=3.0, negative_mining_thresh=0.2)
    want = [np.asarray(o) for o in jreg.get("MultiBoxTarget").fn(
        jnp.asarray(anchors), jnp.asarray(label), jnp.asarray(pred), **kw)]
    got = [o.numpy() for o in treg.get("MultiBoxTarget").fn(
        torch.tensor(anchors), torch.tensor(label), torch.tensor(pred),
        **kw)]
    np.testing.assert_array_equal(got[2], want[2])
    assert list(got[2][0, :5]) == [2.0, 0.0, 0.0, 0.0, -1.0]


def test_the_contrib_cases_of_the_jax_tests_hold_on_the_port():
    """tests/test_contrib_ops.py's and test_extra_ops.py:102's cases,
    through ``mx.nd`` on the CPU."""
    nd = tmx.nd
    with tmx.cpu():
        # MultiBoxTarget: exact match, threshold match, mining
        anchors = nd.array(np.array([[[0.1, 0.1, 0.5, 0.5],
                                      [0.7, 0.7, 0.9, 0.9]]], np.float32))
        label = nd.array(np.array([[[2, 0.1, 0.1, 0.5, 0.5],
                                    [-1, -1, -1, -1, -1]]], np.float32))
        loc_t, loc_m, cls_t = nd.MultiBoxTarget(anchors, label,
                                                nd.zeros((1, 4, 2)))
        assert cls_t.asnumpy().tolist() == [[3.0, 0.0]]
        assert loc_m.asnumpy().reshape(2, 4)[:, 0].tolist() == [1.0, 0.0]
        np.testing.assert_allclose(loc_t.asnumpy()[0, :4], 0.0, atol=1e-5)
        anchors = nd.array(np.array(
            [[[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9],
              [0.0, 0.6, 0.3, 0.9], [0.6, 0.0, 0.9, 0.3]]], np.float32))
        cls_pred = np.full((1, 3, 4), 0.1, np.float32)
        cls_pred[0, 1, 1] = 0.9
        _, _, cls_t = nd.MultiBoxTarget(
            anchors, nd.array(np.array([[[0, 0.1, 0.1, 0.5, 0.5]]],
                                       np.float32)),
            nd.array(cls_pred), negative_mining_ratio=1.0,
            negative_mining_thresh=0.5, ignore_label=-1)
        assert cls_t.asnumpy().tolist() == [[1.0, 0.0, -1.0, -1.0]]
        # MultiBoxDetection decode
        out = nd.MultiBoxDetection(
            nd.array(np.array([[[0.1], [0.9]]], np.float32)),
            nd.array(np.array([[2.5, 0.0, 0.0, 0.0]], np.float32)),
            nd.array(np.array([[[0.2, 0.2, 0.6, 0.6]]], np.float32)))
        np.testing.assert_allclose(out.asnumpy()[0, 0, 2:],
                                   [0.3, 0.2, 0.7, 0.6], atol=1e-5)
        # Proposal refuses a batch; fft round trip is n * x
        with pytest.raises(ValueError, match="batch size 1"):
            nd.Proposal(nd.zeros((2, 24, 3, 3)), nd.zeros((2, 48, 3, 3)),
                        nd.zeros((2, 3)))
        x = np.random.RandomState(7).rand(3, 8).astype(np.float32)
        inv = nd.contrib.ifft(nd.contrib.fft(nd.array(x)))
        np.testing.assert_allclose(inv.asnumpy(), 8 * x, rtol=1e-3,
                                   atol=1e-3)
        # PSROIPooling picks each bin's own channel
        data = np.zeros((1, 8, 8, 8), np.float32)
        for c in range(8):
            data[:, c] = c
        o = nd.PSROIPooling(nd.array(data),
                            nd.array(np.array([[0, 0, 0, 7, 7]],
                                              np.float32)),
                            spatial_scale=1.0, output_dim=2, pooled_size=2,
                            group_size=2).asnumpy()
        assert o.reshape(-1).tolist() == list(range(8))
        # a whole-pixel offset shifts DeformableConvolution's taps
        x = np.arange(36, dtype=np.float32).reshape(1, 1, 6, 6)
        offset = np.zeros((1, 2, 6, 6), np.float32)
        offset[:, 1] = 1.0
        o = nd.DeformableConvolution(
            nd.array(x), nd.array(offset), nd.ones((1, 1, 1, 1)),
            kernel=(1, 1), num_filter=1, no_bias=True).asnumpy()[0, 0]
        np.testing.assert_allclose(o[:, :-1], x[0, 0, :, 1:], atol=1e-5)
        np.testing.assert_allclose(o[:, -1], 0.0, atol=1e-5)
        # bipartite matching (test_extra_ops.py:102)
        score = nd.array(np.array([[0.5, 0.9], [0.8, 0.2]], np.float32))
        rm, cm = nd.contrib.bipartite_matching(score, threshold=0.1)
        assert rm.asnumpy().tolist() == [1, 0]
        assert cm.asnumpy().tolist() == [1, 0]
        rm, cm = nd.contrib.bipartite_matching(score, threshold=0.85)
        assert rm.asnumpy().tolist() == [1, -1]
        assert cm.asnumpy().tolist() == [-1, 0]
        rm, _ = nd.contrib.bipartite_matching(score, is_ascend=True,
                                              threshold=1.0)
        assert rm.asnumpy().tolist() == [0, 1]
        rm, _ = nd.contrib.bipartite_matching(score, threshold=0.1, topk=1)
        assert rm.asnumpy().tolist() == [1, 0]
        # CTC: frames past a data length get no gradient
        rng = np.random.RandomState(5)
        data = nd.array(rng.randn(5, 2, 4).astype(np.float32))
        data.attach_grad()
        with tmx.autograd.record():
            loss = nd.ctc_loss(
                data, nd.array(np.array([[1, 2, 3], [2, 1, 0]], np.float32)),
                nd.array(np.array([5, 4], np.float32)),
                nd.array(np.array([3, 2], np.float32)),
                use_data_lengths=True, use_label_lengths=True)
            total = loss.sum()
        total.backward()
        assert np.abs(data.grad.asnumpy()[4, 1]).sum() < 1e-6


def test_dtypes_follow_the_jax_package():
    # MultiBoxTarget returns the anchors' dtype; fft computes in float32
    # under float64; ROIPooling rounds the roi's corners half to even
    f32 = torch.float32
    anchors = torch.tensor(priors(2, 2)(None), dtype=torch.float64)
    label = torch.tensor([[[0, 0.1, 0.1, 0.6, 0.6]]], dtype=f32)
    outs = treg.get("MultiBoxTarget").fn(anchors, label,
                                         torch.full((1, 2, 12), 0.5))
    assert [o.dtype for o in outs] == [torch.float64] * 3
    x = torch.tensor(np.random.RandomState(0).rand(2, 8))
    f = treg.get("fft").fn(x)
    assert f.dtype == torch.float64
    assert torch.equal(f, f.to(f32).to(torch.float64))
    data = torch.arange(16.0, dtype=torch.float64).reshape(1, 1, 4, 4)
    # x 0.5 and 2.5 round to 0 and 2 (half to even), not to 1 and 3
    roi = torch.tensor([[0, 0.5, 0.0, 2.5, 0.0]], dtype=torch.float64)
    out = treg.get("ROIPooling").fn(data, roi, pooled_size=(1, 1))
    assert out.item() == 2.0
    jout = jreg.get("ROIPooling").fn(jnp.asarray(data.numpy()),
                                     jnp.asarray(roi.numpy()),
                                     pooled_size=(1, 1))
    assert float(jout.reshape(())) == 2.0


def test_nms_on_the_cpu_takes_the_plain_route_and_counts_it():
    before = dict(tcontrib.nms_keep.calls)
    launches = tcontrib.nms_keep.launches
    rows = torch.tensor(nms_rows(2, 16)(np.random.RandomState(1)))
    treg.get("box_nms").fn(rows, overlap_thresh=0.5)
    assert tcontrib.nms_keep.calls["plain"] == before["plain"] + 1
    assert tcontrib.nms_keep.calls["cuda"] == before["cuda"]
    assert tcontrib.nms_keep.launches == launches


def test_nms_keep_plain_is_the_greedy_loop():
    rng = np.random.RandomState(3)
    rows = nms_rows(3, 30)(rng)
    bx = torch.tensor(rows[..., 2:6])
    valid = torch.tensor(rows[..., 1] > 0.0)
    ids = torch.tensor(rows[..., 0])
    keep = tcontrib.nms_keep_plain(bx, valid, ids, 0.4).numpy()
    for b in range(3):
        want = np.ones(30, bool)
        for i in range(30):
            if not (want[i] and valid[b, i]):
                continue
            for j in range(i + 1, 30):
                iou = float(tcontrib._box_iou_corner(bx[b, i], bx[b, j]))
                if iou > 0.4 and ids[b, i] == ids[b, j]:
                    want[j] = False
        np.testing.assert_array_equal(keep[b], want & valid[b].numpy())


def test_ctc_gradient_with_a_blank_label_matches_finite_differences():
    # a label within its length may be the blank (0 under
    # blank_label='first' with use_label_lengths): the port's recursion
    # differentiates it right, which torch.nn.functional.ctc_loss's
    # analytic gradient does not, so the op keeps its recursion
    rng = np.random.RandomState(7)
    data = torch.tensor(rng.randn(7, 2, 4), requires_grad=True)
    args = (torch.tensor([[1.0, 0.0, 0.0], [3.0, 0.0, 0.0]]),
            torch.tensor([7.0, 5.0]), torch.tensor([3.0, 1.0]))
    kw = dict(use_data_lengths=True, use_label_lengths=True)
    ctc = treg.get("ctc_loss").fn
    ctc(data, *args, **kw).sum().backward()
    eps = 1e-6
    num = np.zeros(data.shape)
    with torch.no_grad():
        for i in np.ndindex(*data.shape):
            d = torch.zeros(data.shape, dtype=torch.float64)
            d[i] = eps
            num[i] = float(ctc(data + d, *args, **kw).sum()
                           - ctc(data - d, *args, **kw).sum()) / (2 * eps)
    # central differences in float64: truncation and rounding ~1e-9
    np.testing.assert_allclose(data.grad.numpy(), num, atol=1e-7)
