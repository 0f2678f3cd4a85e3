"""The NMS kernel's algorithm (``mxnet_tpu_torch/csrc/box_nms.cu``) on the
CPU, where the kernel cannot run: :func:`blockwise_keep`, a plain-torch
model of what its tiled route computes (the valid rows grouped stably
into segments by the kernel's hash of the class id, each segment swept
64 rows at a time: what the kept rows of earlier blocks remove, one OR
over their words, then the block's chain resolved by the fixed-point
iteration on its column words), run chain by chain, against the port's
plain greedy loop ``nms_keep_plain`` and the JAX package's ``box_nms``,
with ties, ``-1``
ids of invalid rows, one class, 21 classes, bucket collisions, N not a
multiple of 64, N = 1 and N on both sides of the fused route's limit.
Keep masks are compared exactly.  Also: the route is a function of N
alone, and ``chip_smoke.nms_bound`` without ids.  The kernel itself is
held to the plain loop on the card in
``tests/test_torch_kernels_on_card.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import contrib as tcontrib

import chip_smoke as cs

TILE = 64
BUCKETS = 256


def bucket(ids, buckets=BUCKETS):
    """The kernel's segment bucket of each class id (``bucket`` in
    ``box_nms.cu``): a mix of the id's bits, +0 for -0."""
    ids = np.asarray(ids)
    x = np.where(ids == 0, np.zeros((), ids.dtype), ids)
    if x.dtype == np.float32:
        m = np.uint64(0xFFFFFFFF)
        u = x.view(np.uint32).astype(np.uint64)
        u ^= u >> np.uint64(16)
        u = (u * np.uint64(0x85EBCA6B)) & m
        u ^= u >> np.uint64(13)
        u = (u * np.uint64(0xC2B2AE35)) & m
        u ^= u >> np.uint64(16)
    else:
        u = x.astype(np.float64).view(np.uint64).copy()
        u ^= u >> np.uint64(33)
        u *= np.uint64(0xFF51AFD7ED558CCD)
        u ^= u >> np.uint64(33)
        u *= np.uint64(0xC4CEB9FE1A85EC53)
        u ^= u >> np.uint64(33)
    return (u & np.uint64(buckets - 1)).astype(np.int64)


def blockwise_keep(boxes, valid, ids, thresh, buckets=BUCKETS):
    """What the kernel's tiled route keeps, in plain torch: per image,
    the valid rows grouped stably by bucket (two classes of one bucket
    share a segment and are told apart by the id compare), then each
    segment's chain 64 rows at a time."""
    B, N = valid.shape
    keep = torch.zeros((B, N), dtype=torch.bool)
    for b in range(B):
        rows = torch.nonzero(valid[b]).flatten().numpy()
        if not rows.size:
            continue
        bk = (np.zeros(rows.size, np.int64) if ids is None
              else bucket(ids[b].numpy()[rows], buckets))
        order = np.argsort(bk, kind="stable")
        rows, bk = rows[order], bk[order]
        cuts = np.flatnonzero(np.diff(bk)) + 1
        for seg in np.split(rows, cuts):
            n = seg.size
            bx = boxes[b, seg]
            sup = tcontrib._box_iou_corner(bx[:, None], bx[None, :]) > thresh
            if ids is not None:
                c = ids[b, seg]
                sup &= c[:, None] == c[None, :]
            sup &= torch.ones((n, n), dtype=torch.bool).triu(1)
            kept = torch.zeros(n, dtype=torch.bool)
            for r0 in range(0, n, TILE):
                r1 = min(n, r0 + TILE)
                # what the kept rows of the earlier blocks remove: one OR
                # over their words for this block
                alive = ~sup[:r0][kept[:r0]][:, r0:r1].any(dim=0)
                col = sup[r0:r1, r0:r1]   # col[i, j]: row i removes row j
                k = alive.clone()
                for _ in range(TILE + 1):
                    k2 = alive & ~(col & k[:, None]).any(dim=0)
                    if torch.equal(k2, k):
                        break
                    k = k2
                else:
                    raise AssertionError("the block's chain did not settle")
                kept[r0:r1] = k
                keep[b, seg[r0:r1]] = k
    return keep


def _rows(B, N, classes, seed, dtype=np.float64):
    """nms_rows with the ids of invalid rows (score <= 0) set to -1."""
    rows = cs.nms_rows(B, N, classes=classes)(np.random.RandomState(seed))
    rows[..., 0] = np.where(rows[..., 1] > 0, rows[..., 0], -1.0)
    return rows.astype(dtype)


def _jax_keep(rows, with_ids, thresh):
    out = np.asarray(jreg.get("box_nms").fn(
        jnp.asarray(rows), overlap_thresh=thresh,
        **(dict(id_index=0) if with_ids else {})))
    return torch.tensor(out[..., 1] > 0)


# (B, N, classes or None, seed): ties throughout (nms_rows plants equal
# scores), invalid rows with id -1, one class, 21 classes, N not a
# multiple of 64, N = 1, both sides of the fused route's limit
SHAPES = [
    (3, 30, 3, 1), (2, 200, 21, 2), (2, 130, 1, 3), (1, 1, 3, 4),
    (2, 64, 4, 5), (2, 65, None, 6), (2, 300, None, 7),
    (1, tcontrib.NMS_FUSED_MAX, 21, 8), (1, tcontrib.NMS_FUSED_MAX + 1, 21, 9),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("B,N,classes,seed", SHAPES)
def test_blockwise_sweep_by_class_keeps_what_greedy_nms_keeps(
        B, N, classes, seed, dtype):
    rows = _rows(B, N, classes or 3, seed, dtype)
    boxes, valid, ids, thresh = cs._nms_sorted(
        torch.tensor(rows), dict(overlap_thresh=0.45, topk=-1))
    ids = ids if classes else None
    got = blockwise_keep(boxes, valid, ids, thresh)
    plain = tcontrib.nms_keep_plain(boxes, valid, ids, thresh)
    assert torch.equal(got, plain)
    assert torch.equal(got, _jax_keep(rows, classes is not None, thresh))


@pytest.mark.parametrize("buckets", [1, 2, 8])
def test_classes_that_share_a_bucket_stay_apart(buckets):
    # fewer buckets than classes: segments mix classes, the id compare
    # inside the segment keeps them apart
    rows = _rows(3, 150, 21, 11)
    boxes, valid, ids, thresh = cs._nms_sorted(
        torch.tensor(rows), dict(overlap_thresh=0.3, topk=-1))
    assert len(set(bucket(ids.numpy().ravel(), buckets))) <= buckets
    got = blockwise_keep(boxes, valid, ids, thresh, buckets=buckets)
    assert torch.equal(got, tcontrib.nms_keep_plain(boxes, valid, ids,
                                                    thresh))


def test_buckets_follow_float_equality():
    # -0 and +0 are one class; the 21 SSD ids spread over the buckets
    assert bucket(np.array([0.0, -0.0])).tolist()[0] == \
        bucket(np.array([-0.0])).tolist()[0]
    assert bucket(np.array([-0.0], np.float32))[0] == \
        bucket(np.array([0.0], np.float32))[0]
    for dt in (np.float32, np.float64):
        b = bucket(np.arange(-1, 20).astype(dt))
        assert len(set(b.tolist())) >= 19
        assert ((b >= 0) & (b < BUCKETS)).all()


def test_the_route_is_a_function_of_n_alone():
    limit = tcontrib.NMS_FUSED_MAX
    assert [tcontrib.nms_route(n) for n in (1, 400, limit, limit + 1,
                                            6000, 6132)] == \
        ["fused"] * 3 + ["tiled"] * 3
    assert tcontrib.NMS_ROUTE_LAUNCHES == {"fused": 1, "tiled": 3}
    assert set(tcontrib.nms_keep.calls_by_route) == {"fused", "tiled"}
    assert set(tcontrib.nms_keep.calls) == {"cuda", "plain"}


def test_nms_on_the_cpu_launches_no_kernel_on_either_route():
    # a CPU tensor runs the plain loop at any N: no kernel launch, no
    # kernel route counted
    routes = dict(tcontrib.nms_keep.calls_by_route)
    launches = tcontrib.nms_keep.launches
    for n in (10, tcontrib.NMS_FUSED_MAX + 1):
        rows = torch.tensor(_rows(1, n, 3, 12))
        boxes, valid, ids, thresh = cs._nms_sorted(
            rows, dict(overlap_thresh=0.5, topk=-1))
        assert torch.equal(tcontrib.nms_keep(boxes, valid, ids, thresh),
                           tcontrib.nms_keep_plain(boxes, valid, ids,
                                                   thresh))
    assert tcontrib.nms_keep.launches == launches
    assert tcontrib.nms_keep.calls_by_route == routes


def test_nms_bound_without_ids_counts_one_class_and_no_compare():
    # the RPN's shape: 2 images of 6000 valid float32 boxes, no ids:
    # 12 operations a pair over 67 TFLOP/s; bytes 6000 * 18 an image
    ms, by = cs.nms_bound([[6000], [6000]], 6000, 4, ids=None)
    assert by == "operations"
    assert ms == pytest.approx(2 * 12 * 6000 * 5999 // 2 / 67e12 * 1e3)
    ms, by = cs.nms_bound([[1], []], 1000, 4, ids=None)
    assert by == "bytes"
    assert ms == pytest.approx(2 * 1000 * 18 / 3.35e12 * 1e3)
    valid = torch.tensor([[True, False, True], [False] * 3])
    assert cs.nms_class_counts(valid) == [[2], []]
    assert cs.nms_class_counts(valid, None) == [[2], []]


def test_rpn_nms_inputs_are_what_multiproposal_gives_nms_keep():
    boxes, valid, ids, thresh = cs.rpn_nms_inputs(device="cpu")
    assert tuple(boxes.shape) == (cs.RPN["batch"], 6000, 4)
    assert boxes.dtype == torch.float32 and ids is None and thresh == 0.7
    assert bool(valid.any())
    assert tcontrib.nms_route(boxes.shape[1]) == "tiled"
