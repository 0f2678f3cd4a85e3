"""Contrib and detection operators (ref: src/operator/contrib/).

Counterpart: ``mxnet_tpu/ops/contrib.py``: the box ops (``box_iou``,
``box_nms``), SSD's ``MultiBoxPrior`` / ``MultiBoxTarget`` /
``MultiBoxDetection``, the RPN's ``Proposal`` / ``MultiProposal``,
R-FCN's and DCN's ``PSROIPooling`` / ``DeformableConvolution`` /
``DeformablePSROIPooling``, ``CTCLoss``, ``fft`` / ``ifft``,
``quantize`` / ``dequantize`` and ``count_sketch``, under the same
names, aliases, flags and ``-1`` padding conventions (static output
shapes, as the JAX package's reformulations of the reference's dynamic
kernels).

The JAX package's ``vmap`` over images is the batch dimension here,
and every count it keeps on the chip (positives, mined negatives, kept
proposals) stays a tensor: no body reads a value to the host, so each
runs on ``meta`` tensors too (shape inference).  Sorts are stable
(``jnp.argsort``), and ``argmax`` takes the first maximum, as JAX's.

Greedy NMS is :func:`nms_keep`: a CUDA tensor launches the hand-written
kernel of ``csrc/box_nms.cu`` on the route :func:`nms_route` picks from
N (``fused``, one launch, up to :data:`NMS_FUSED_MAX` rows an image;
``tiled``, three: the rows grouped by class, the bit matrix of each
group, a block-wise sweep a group), a CPU tensor runs the plain greedy
loop :func:`nms_keep_plain`.  The JAX package's ``fori_loop`` of N
steps has no counterpart on the card that is not N host iterations.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import _build
from .registry import register


def _box_iou_corner(a, b):
    # a: (..., 4), b: (..., 4) xmin, ymin, xmax, ymax
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def _center_to_corner(x):
    cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _stable_argsort(x, dim=-1, descending=False):
    return torch.sort(x, dim=dim, descending=descending, stable=True)[1]


@register("_contrib_box_iou", aliases=("box_iou",), nondiff=True)
def _box_iou(lhs, rhs, format="corner", **_):
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    a = lhs.reshape(tuple(lhs.shape[:-1]) + (1,) * (rhs.dim() - 1) + (4,))
    return _box_iou_corner(a, rhs.reshape((1,) * (lhs.dim() - 1)
                                          + tuple(rhs.shape)))


# ---------------------------------------------------------------------------
# greedy NMS: the kernel and its plain version
# ---------------------------------------------------------------------------
def nms_keep_plain(boxes, valid, ids=None, thresh=0.5):
    """The greedy loop of ``mxnet_tpu/ops/contrib.py:77-81``, batched:
    ``boxes`` (B, N, 4) corner boxes in score order, ``valid`` (B, N)
    bool, ``ids`` (B, N) class ids or None (every box suppresses every
    later one).  Row i, when still kept and valid, removes each later box
    whose IoU with it exceeds ``thresh`` (and whose id is row i's).
    Returns the (B, N) keep mask.  N host steps: the CPU route, where a
    step no image needs is skipped."""
    B, N = valid.shape
    keep = valid.clone()
    # the boxes' areas once: the same operations as _box_iou_corner's
    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    on_host = valid.device.type == "cpu"
    for i in range(N - 1):
        active = keep[:, i]
        if on_host and not bool(active.any()):
            continue
        a, b = boxes[:, i:i + 1], boxes[:, i + 1:]
        tl = torch.maximum(a[..., :2], b[..., :2])
        br = torch.minimum(a[..., 2:4], b[..., 2:4])
        wh = torch.clamp(br - tl, min=0.0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / torch.clamp(area[:, i:i + 1] + area[:, i + 1:] - inter,
                                  min=1e-12)
        sup = iou > thresh
        if ids is not None:
            sup &= ids[:, i + 1:] == ids[:, i:i + 1]
        sup &= active[:, None]
        keep[:, i + 1:] &= ~sup
    return keep


def _nms_lib():
    lib = _build.load("box_nms")
    if lib.mxt_box_nms_keep.argtypes is None:
        lib.mxt_box_nms_keep.restype = ctypes.c_int
        lib.mxt_box_nms_keep.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.mxt_box_nms_scratch_bytes.restype = ctypes.c_longlong
        lib.mxt_box_nms_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.mxt_box_nms_fused_max.restype = ctypes.c_int
        lib.mxt_box_nms_fused_max.argtypes = []
    return lib


_NMS_DTYPES = {torch.float32: 0, torch.float64: 1}
#: the most rows an image the kernel's fused route takes
#: (``csrc/box_nms.cu`` kFusedMax)
NMS_FUSED_MAX = 1024
#: device kernels a CUDA call launches on each route
NMS_ROUTE_LAUNCHES = {"fused": 1, "tiled": 3}


def nms_route(n):
    """The kernel's route for ``n`` rows an image: ``fused`` (a cluster
    of 4 blocks an image, the bit matrix in shared memory, one launch) up to
    :data:`NMS_FUSED_MAX`, else ``tiled`` (the rows grouped by class,
    each group's bit matrix in device memory, a sweep a group: three
    launches).  N alone decides: the same for every dtype, with or
    without ids, whatever the data."""
    return "fused" if n <= NMS_FUSED_MAX else "tiled"


def nms_keep(boxes, valid, ids=None, thresh=0.5):
    """:func:`nms_keep_plain`'s function.  CPU tensors run it; CUDA
    tensors launch ``csrc/box_nms.cu`` on the current stream (float32
    or float64 boxes) on :func:`nms_route`'s route, or raise; ``meta``
    tensors (shape inference) get the mask's shape.  ``nms_keep.calls``
    counts calls by device route (``cuda``, ``plain``),
    ``nms_keep.calls_by_route`` the CUDA calls by kernel route, and
    ``nms_keep.launches`` the device kernels launched
    (:data:`NMS_ROUTE_LAUNCHES` a CUDA call)."""
    dev = boxes.device
    if dev.type == "meta":
        return valid.clone()
    if dev.type == "cpu":
        nms_keep.calls["plain"] += 1
        return nms_keep_plain(boxes, valid, ids, thresh)
    if dev.type != "cuda":
        raise RuntimeError("nms_keep: no kernel for device %s" % dev)
    if boxes.dtype not in _NMS_DTYPES:
        raise TypeError("nms_keep: the kernel takes float32 or float64 "
                        "boxes, got %s" % boxes.dtype)
    B, N = valid.shape
    if tuple(boxes.shape) != (B, N, 4) or (
            ids is not None and tuple(ids.shape) != (B, N)):
        raise ValueError("nms_keep: boxes %s, valid %s, ids %s do not match"
                         % (tuple(boxes.shape), tuple(valid.shape),
                            None if ids is None else tuple(ids.shape)))
    boxes = boxes.contiguous()
    ids = None if ids is None else ids.to(boxes.dtype).contiguous()
    # bool tensors are bytes of 0 / 1: the kernel reads and writes them
    valid = (valid if valid.dtype == torch.bool else valid != 0).contiguous()
    keep = torch.empty((B, N), dtype=torch.bool, device=dev)
    lib = _nms_lib()
    code = _NMS_DTYPES[boxes.dtype]
    route = nms_route(N)
    scratch = None  # the tiled route's grouped rows and bit matrix
    if route == "tiled" and B:
        scratch = torch.empty(lib.mxt_box_nms_scratch_bytes(code, B, N),
                              dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mxt_box_nms_keep(
        code, boxes.data_ptr(), None if ids is None else ids.data_ptr(),
        valid.data_ptr(), B, N, float(thresh),
        None if scratch is None else scratch.data_ptr(), keep.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError("nms_keep: box_nms kernel launch failed with "
                           "CUDA error %d" % err)
    if B and N:
        nms_keep.launches += NMS_ROUTE_LAUNCHES[route]
        nms_keep.calls_by_route[route] += 1
    nms_keep.calls["cuda"] += 1
    return keep


#: device kernel launches since the last reset, and calls by route
nms_keep.launches = 0
nms_keep.calls = {"cuda": 0, "plain": 0}
nms_keep.calls_by_route = {"fused": 0, "tiled": 0}


@register("_contrib_box_nms", aliases=("box_nms",), nondiff=True)
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, background_id=-1,
             force_suppress=False, in_format="corner", out_format="corner",
             **_):
    """Greedy NMS over (B, N, k) or (N, k) rows (ref:
    src/operator/contrib/bounding_box.cc): the rows in descending score
    order (stable), each suppressed one written as -1.  With ``topk`` >
    0 only the first ``topk`` sorted rows can be kept, so only they go
    through :func:`nms_keep`."""
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    B, N, K = data.shape
    scores = data[:, :, score_index]
    boxes = data[:, :, coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    valid = scores > valid_thresh
    neg_inf = torch.tensor(-math.inf, dtype=data.dtype, device=data.device)
    order = _stable_argsort(-torch.where(valid, scores, neg_inf))
    sboxes = torch.gather(boxes, 1, order[:, :, None].expand(B, N, 4))
    svalid = torch.gather(valid, 1, order)
    sids = None
    if id_index >= 0 and not force_suppress:
        sids = torch.gather(data[:, :, id_index], 1, order)
    n = min(int(topk), N) if topk > 0 else N
    keep = nms_keep(sboxes[:, :n], svalid[:, :n],
                    None if sids is None else sids[:, :n], overlap_thresh)
    if n < N:
        keep = torch.cat([keep, torch.zeros((B, N - n), dtype=torch.bool,
                                             device=keep.device)], dim=1)
    rows = torch.gather(data, 1, order[:, :, None].expand(B, N, K))
    out = torch.where(keep[:, :, None], rows,
                      torch.full((), -1.0, dtype=data.dtype,
                                 device=data.device))
    return out[0] if squeeze else out


@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",), nondiff=True)
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5), **_):
    """ref: src/operator/contrib/multibox_prior.cc: anchors per feature
    map cell, (1, h*w*A, 4) corner, A = len(sizes) + len(ratios) - 1.
    Computed in float64 (the JAX package's x64 arithmetic) and cast to
    the data's dtype."""
    h, w = data.shape[2], data.shape[3]
    f64 = dict(dtype=torch.float64, device=data.device)
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, **f64) + offsets[0]) * step_y
    cx = (torch.arange(w, **f64) + offsets[1]) * step_x
    whs = [(s * math.sqrt(ratios[0]), s / math.sqrt(ratios[0]))
           for s in sizes]
    whs += [(sizes[0] * math.sqrt(r), sizes[0] / math.sqrt(r))
            for r in ratios[1:]]
    whs = torch.tensor(whs, **f64)  # (A, 2): (w, h)
    half_w = (whs[:, 0] / 2)[None, None, :]
    half_h = (whs[:, 1] / 2)[None, None, :]
    cxx = cx[None, :, None]
    cyy = cy[:, None, None]
    anchors = torch.stack(torch.broadcast_tensors(
        cxx - half_w, cyy - half_h, cxx + half_w, cyy + half_h),
        dim=-1).reshape(1, -1, 4)
    if clip:
        anchors = torch.clamp(anchors, 0.0, 1.0)
    return anchors.to(data.dtype)


@register("_contrib_count_sketch", aliases=("count_sketch",), nondiff=True)
def _count_sketch(data, h, s, out_dim=0, **_):
    """ref: contrib/count_sketch.cc: column j of ``data``, times s[j],
    added into output column h[j]."""
    n, d = data.shape
    hh = h.reshape(-1).to(torch.int64)[:d]
    ss = s.reshape(-1)[:d]
    signed = (data * ss[None, :]).to(data.dtype)
    out = torch.zeros((n, int(out_dim)), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hh, signed)


@register("_contrib_quantize", aliases=("quantize",), nondiff=True,
          num_outputs=3)
def _quantize(data, min_range, max_range, out_type="uint8", **_):
    """ref: contrib/quantize.cc: affine uint8 / int8 quantisation,
    rounding half to even (``jnp.round``)."""
    if out_type == "uint8":
        qmin, qmax, dt = 0.0, 255.0, torch.uint8
    else:
        qmin, qmax, dt = -127.0, 127.0, torch.int8
    scale = (qmax - qmin) / torch.clamp(max_range - min_range, min=1e-12)
    q = torch.clamp(torch.round((data - min_range) * scale + qmin),
                    qmin, qmax)
    return q.to(dt), min_range, max_range


@register("_contrib_dequantize", aliases=("dequantize",), nondiff=True)
def _dequantize(data, min_range, max_range, out_type="float32", **_):
    if data.dtype == torch.uint8:
        qmin, qmax = 0.0, 255.0
    else:
        qmin, qmax = -127.0, 127.0
    # the JAX package promotes float32 with the range's dtype, whatever
    # the range's rank
    dt = torch.promote_types(torch.float32, torch.promote_types(
        min_range.dtype, max_range.dtype))
    scale = (max_range.to(dt) - min_range.to(dt)) / (qmax - qmin)
    return (data.to(torch.float32) - qmin).to(dt) * scale + min_range.to(dt)


# ---------------------------------------------------------------------------
# SSD training / inference ops (ref: src/operator/contrib/multibox_*.cc)
# ---------------------------------------------------------------------------
def _encode_box(gt, anchor, variances):
    """Corner gt / anchor -> (dx, dy, dw, dh) regression targets."""
    aw = anchor[..., 2] - anchor[..., 0]
    ah = anchor[..., 3] - anchor[..., 1]
    ax = (anchor[..., 0] + anchor[..., 2]) / 2
    ay = (anchor[..., 1] + anchor[..., 3]) / 2
    gw = torch.clamp(gt[..., 2] - gt[..., 0], min=1e-12)
    gh = torch.clamp(gt[..., 3] - gt[..., 1], min=1e-12)
    gx = (gt[..., 0] + gt[..., 2]) / 2
    gy = (gt[..., 1] + gt[..., 3]) / 2
    dx = (gx - ax) / torch.clamp(aw, min=1e-12) / variances[0]
    dy = (gy - ay) / torch.clamp(ah, min=1e-12) / variances[1]
    dw = torch.log(gw / torch.clamp(aw, min=1e-12)) / variances[2]
    dh = torch.log(gh / torch.clamp(ah, min=1e-12)) / variances[3]
    return torch.stack([dx, dy, dw, dh], dim=-1)


def _first_argmax_rows(m):
    """``jnp.argmax`` over each batch row's flattened matrix."""
    return m.reshape(m.shape[0], -1).argmax(dim=1)


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          nondiff=True, num_outputs=3)
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2), **_):
    """SSD training targets (ref: contrib/multibox_target.cc:305).

    anchor (1, N, 4) corner; label (B, O, 5+) rows [cls, x1, y1, x2, y2]
    padded with -1; cls_pred (B, C+1, N).  Returns loc_target (B, N*4),
    loc_mask (B, N*4), cls_target (B, N), in the anchors' dtype.

    Bipartite matching first (O rounds: each takes the global best
    (anchor, gt) pair left, first maximum on ties), then each unmatched
    anchor takes its best gt at IoU >= ``overlap_threshold``; with
    ``negative_mining_ratio`` > 0 the unmatched anchors whose best
    foreground probability exceeds ``negative_mining_thresh`` are ranked
    by it (stable), the first ratio * positives train as background 0
    and every other unmatched anchor gets ``ignore_label``."""
    anchor = anchor.reshape(-1, 4)
    N = anchor.shape[0]
    B, O = label.shape[0], label.shape[1]
    dev = anchor.device
    variances = tuple(variances)
    cls_id = label[:, :, 0]
    valid_gt = cls_id >= 0
    gt = label[:, :, 1:5]
    iou = _box_iou_corner(anchor[None, :, None, :], gt[:, None, :, :])
    iou = torch.where(valid_gt[:, None, :], iou,
                      torch.full((), -1.0, dtype=iou.dtype, device=dev))

    # 1. bipartite: O greedy rounds of the global argmax
    m = iou.clone()
    anchor_gt = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(N, device=dev)
    cols = torch.arange(O, device=dev)
    bidx = torch.arange(B, device=dev)
    for _ in range(O):
        flat = _first_argmax_rows(m)
        ai, gi = flat // O, flat % O
        good = m[bidx, ai, gi] > 1e-12
        hit = (rows[None, :] == ai[:, None]) & good[:, None]
        anchor_gt = torch.where(hit, gi[:, None], anchor_gt)
        gone = hit[:, :, None] | ((cols[None, :] == gi[:, None])
                                  & good[:, None])[:, None, :]
        m = torch.where(gone, torch.full((), -1.0, dtype=m.dtype,
                                         device=dev), m)

    # 2. threshold matching for the rest
    best_iou = iou.max(dim=2).values
    best_gt = iou.argmax(dim=2)
    thresh_match = (best_iou >= overlap_threshold) & (anchor_gt < 0)
    anchor_gt = torch.where(thresh_match, best_gt, anchor_gt)
    matched = anchor_gt >= 0
    gt_idx = torch.clamp(anchor_gt, min=0)

    zero = torch.zeros((), dtype=label.dtype, device=dev)
    cls_target = torch.where(matched, torch.gather(cls_id, 1, gt_idx) + 1.0,
                             zero)

    # 3. hard negative mining
    if negative_mining_ratio > 0:
        max_fg = cls_pred[:, 1:, :].max(dim=1).values  # (B, N)
        neg_cand = (~matched) & (max_fg > negative_mining_thresh)
        num_pos = matched.sum(dim=1)
        num_neg = torch.clamp(
            (num_pos.to(torch.float64) * negative_mining_ratio).to(
                torch.int64), min=int(minimum_negative_samples))
        neg_inf = torch.full((), -math.inf, dtype=max_fg.dtype, device=dev)
        order = _stable_argsort(-torch.where(neg_cand, max_fg, neg_inf))
        rank = torch.empty_like(order).scatter_(
            1, order, rows[None, :].expand(B, N).contiguous())
        keep_neg = neg_cand & (rank < num_neg[:, None])
        cls_target = torch.where(
            matched, cls_target,
            torch.where(keep_neg, zero,
                        torch.full((), float(ignore_label),
                                   dtype=cls_target.dtype, device=dev)))

    gt_m = torch.gather(gt, 1, gt_idx[:, :, None].expand(B, N, 4))
    loc_t = _encode_box(gt_m, anchor[None], variances)
    loc_t = torch.where(matched[:, :, None], loc_t,
                        torch.zeros((), dtype=loc_t.dtype, device=dev))
    loc_m = matched[:, :, None].expand(B, N, 4).to(anchor.dtype)
    return (loc_t.reshape(B, -1).to(anchor.dtype),
            loc_m.reshape(B, -1).contiguous(), cls_target.to(anchor.dtype))


def _decode_box(delta, anchor, variances, clip):
    aw = anchor[..., 2] - anchor[..., 0]
    ah = anchor[..., 3] - anchor[..., 1]
    ax = (anchor[..., 0] + anchor[..., 2]) / 2
    ay = (anchor[..., 1] + anchor[..., 3]) / 2
    cx = delta[..., 0] * variances[0] * aw + ax
    cy = delta[..., 1] * variances[1] * ah + ay
    w = torch.exp(delta[..., 2] * variances[2]) * aw / 2
    h = torch.exp(delta[..., 3] * variances[3]) * ah / 2
    out = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def detection_rows(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                   background_id=0, variances=(0.1, 0.1, 0.2, 0.2)):
    """MultiBoxDetection's rows before its NMS: (B, N, 6) [class_id,
    score, x1, y1, x2, y2], the decoded boxes and each anchor's best
    foreground class, -1 in the first two columns under ``threshold``."""
    anchor = anchor.reshape(-1, 4)
    N = anchor.shape[0]
    B = cls_prob.shape[0]
    boxes = _decode_box(loc_pred.reshape(B, N, 4), anchor[None],
                        tuple(variances), clip)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)
    score = fg.max(dim=1).values
    best = fg.argmax(dim=1)
    valid = score > threshold
    dt = torch.promote_types(cls_prob.dtype, boxes.dtype)
    neg = torch.full((), -1.0, dtype=dt, device=cls_prob.device)
    return torch.cat([torch.where(valid, best.to(dt), neg)[..., None],
                      torch.where(valid, score.to(dt), neg)[..., None],
                      boxes.to(dt)], dim=2)


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
          nondiff=True)
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1, **_):
    """SSD decode + per-class NMS (ref: contrib/multibox_detection.cc).

    cls_prob (B, C+1, N), loc_pred (B, N*4), anchor (1, N, 4) ->
    (B, N, 6) rows [class_id, score, x1, y1, x2, y2], -1 where
    suppressed, in descending score order."""
    rows = detection_rows(cls_prob, loc_pred, anchor, clip, threshold,
                          background_id, variances)
    return _box_nms(rows, overlap_thresh=nms_threshold, valid_thresh=0.0,
                    topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                    background_id=-1, force_suppress=force_suppress)


# ---------------------------------------------------------------------------
# region proposals (ref: src/operator/contrib/proposal.cc,
# multi_proposal.cc: the Faster R-CNN RPN)
# ---------------------------------------------------------------------------
def _gen_base_anchors(base_size, scales, ratios):
    """(A, 4) float32 anchors centred on a ``base_size`` cell (ref:
    proposal.cc GenerateAnchors)."""
    px = (base_size - 1) * 0.5
    py = (base_size - 1) * 0.5
    out = []
    area = base_size * base_size
    for r in ratios:
        size_ratios = area / r
        ws = np.round(np.sqrt(size_ratios))
        hs = np.round(ws * r)
        for s in scales:
            w, h = ws * s, hs * s
            out.append([px - 0.5 * (w - 1), py - 0.5 * (h - 1),
                        px + 0.5 * (w - 1), py + 0.5 * (h - 1)])
    return np.array(out, dtype=np.float32)


def _proposals(score, bbox_delta, im_info, anchors_base, stride, pre_nms,
               post_nms, thresh, min_size, iou_loss):
    """Each image's RPN proposals, batched: score (B, A, H, W) foreground
    probabilities, bbox_delta (B, 4A, H, W), im_info (B, 3) [h, w,
    scale].  Returns boxes (B, post_nms, 4) and scores (B, post_nms):
    the kept proposals in score order, the list padded by cycling
    through them again (ref: the reference pads its roi batch with
    earlier proposals)."""
    B, A, H, W = score.shape
    dev = score.device
    shift_x = torch.arange(W, device=dev) * stride
    shift_y = torch.arange(H, device=dev) * stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")  # (H, W)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).to(torch.float32)
    anchors = (anchors_base.to(dev)[None, None] + shifts[:, :, None, :])
    anchors = anchors.reshape(-1, 4)  # (H*W*A, 4)

    deltas = bbox_delta.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2)
    deltas = deltas.reshape(B, -1, 4)
    scores = score.permute(0, 2, 3, 1).reshape(B, -1)

    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + 0.5 * (aw - 1.0)
    ay = anchors[:, 1] + 0.5 * (ah - 1.0)
    if iou_loss:
        boxes = anchors[None] + deltas
    else:
        cx = deltas[..., 0] * aw + ax
        cy = deltas[..., 1] * ah + ay
        w = torch.exp(deltas[..., 2]) * aw
        h = torch.exp(deltas[..., 3]) * ah
        boxes = torch.stack([cx - 0.5 * (w - 1.0), cy - 0.5 * (h - 1.0),
                             cx + 0.5 * (w - 1.0), cy + 0.5 * (h - 1.0)],
                            dim=-1)
    # clip to the image (jnp.clip: max(., 0) then min(., hi), promoted)
    dt = torch.promote_types(boxes.dtype, im_info.dtype)
    boxes = boxes.to(dt)
    info = im_info.to(dt)
    hi_x = (info[:, 1] - 1.0)[:, None]
    hi_y = (info[:, 0] - 1.0)[:, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    boxes = torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), hi_x),
        torch.minimum(torch.maximum(boxes[..., 1], zero), hi_y),
        torch.minimum(torch.maximum(boxes[..., 2], zero), hi_x),
        torch.minimum(torch.maximum(boxes[..., 3], zero), hi_y)], dim=-1)
    ms = (min_size * info[:, 2])[:, None]
    keep_size = ((boxes[..., 2] - boxes[..., 0] + 1.0) >= ms) & \
                ((boxes[..., 3] - boxes[..., 1] + 1.0) >= ms)
    scores = torch.where(keep_size, scores,
                         torch.full((), -math.inf, dtype=scores.dtype,
                                    device=dev))

    n = scores.shape[1]
    pre = min(pre_nms, n) if pre_nms > 0 else n
    order = _stable_argsort(-scores)[:, :pre]
    sboxes = torch.gather(boxes, 1, order[:, :, None].expand(B, pre, 4))
    sscores = torch.gather(scores, 1, order)
    svalid = torch.isfinite(sscores)
    keep = nms_keep(sboxes, svalid, None, thresh)
    # kept first in score order (a stable sort of "not kept"), then the
    # list cycles through the kept ones again
    kidx = _stable_argsort((~keep).to(torch.uint8))
    n_kept = torch.clamp(keep.sum(dim=1), min=1)
    take = torch.gather(kidx, 1, torch.remainder(
        torch.arange(post_nms, device=dev)[None, :], n_kept[:, None]))
    out_boxes = torch.gather(sboxes, 1,
                             take[:, :, None].expand(B, post_nms, 4))
    out_scores = torch.gather(sscores, 1, take)
    return out_boxes, torch.where(torch.isfinite(out_scores), out_scores,
                                  torch.zeros((), dtype=out_scores.dtype,
                                              device=dev))


@register("_contrib_Proposal", aliases=("Proposal",), nondiff=True,
          num_outputs=1)
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
              feature_stride=16, output_score=False, iou_loss=False, **_):
    """RPN proposal generation (ref: contrib/proposal.cc; batch 1 like
    the reference).  cls_prob (1, 2A, H, W), bbox_pred (1, 4A, H, W),
    im_info (1, 3) -> rois (post_nms, 5) [0, x1, y1, x2, y2] (and scores
    (post_nms, 1) with ``output_score``)."""
    if cls_prob.shape[0] != 1:
        raise ValueError("Proposal supports batch size 1 only (the "
                         "reference CHECK-fails too); use MultiProposal "
                         "for batched input")
    base = torch.from_numpy(_gen_base_anchors(feature_stride, scales,
                                              ratios))
    A = base.shape[0]
    boxes, scores = _proposals(
        cls_prob[:, A:], bbox_pred, im_info, base, feature_stride,
        int(rpn_pre_nms_top_n), int(rpn_post_nms_top_n), threshold,
        float(rpn_min_size), iou_loss)
    boxes, scores = boxes[0], scores[0]
    rois = torch.cat([torch.zeros((boxes.shape[0], 1), dtype=boxes.dtype,
                                  device=boxes.device), boxes], dim=1)
    if output_score:
        return rois, scores[:, None]
    return rois


@register("_contrib_MultiProposal", aliases=("MultiProposal",),
          nondiff=True, num_outputs=1)
def _multi_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                    rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                    scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
                    feature_stride=16, output_score=False, iou_loss=False,
                    **_):
    """Batched Proposal (ref: contrib/multi_proposal.cc): rois
    (B*post_nms, 5), the first column the image's index."""
    base = torch.from_numpy(_gen_base_anchors(feature_stride, scales,
                                              ratios))
    A = base.shape[0]
    B = cls_prob.shape[0]
    post = int(rpn_post_nms_top_n)
    boxes, scores = _proposals(
        cls_prob[:, A:], bbox_pred, im_info, base, feature_stride,
        int(rpn_pre_nms_top_n), post, threshold, float(rpn_min_size),
        iou_loss)
    bidx = torch.arange(B, device=boxes.device).to(
        boxes.dtype).repeat_interleave(post)
    rois = torch.cat([bidx[:, None], boxes.reshape(-1, 4)], dim=1)
    if output_score:
        return rois, scores.reshape(-1, 1)
    return rois


# ---------------------------------------------------------------------------
# position-sensitive and deformable ops (ref: contrib/psroi_pooling.cc,
# deformable_convolution.cc, deformable_psroi_pooling.cc: R-FCN, DCN)
# ---------------------------------------------------------------------------
def _roi_corners(rois, spatial_scale):
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = torch.round(rois[:, 3] + 1.0) * spatial_scale - 0.5
    y2 = torch.round(rois[:, 4] + 1.0) * spatial_scale - 0.5
    return x1, y1, torch.clamp(x2 - x1, min=0.1), \
        torch.clamp(y2 - y1, min=0.1)


def _ps_channels(dim, k, g, device):
    """(dim, k, k) channel of each output bin: d*g*g + gi*g + gj."""
    gi = torch.tensor([min(int(i * g / k), g - 1) for i in range(k)],
                      device=device)
    d = torch.arange(dim, device=device)
    return d[:, None, None] * g * g + gi[None, :, None] * g + \
        gi[None, None, :]


@register("_contrib_PSROIPooling", aliases=("PSROIPooling",))
def _psroi_pooling(data, rois, spatial_scale, output_dim, pooled_size,
                   group_size=0, **_):
    """Position-sensitive ROI average pooling (ref:
    contrib/psroi_pooling.cc, R-FCN).  data (B, dim*g*g, H, W), rois (R,
    5) [batch, x1, y1, x2, y2] image coords -> (R, output_dim, k, k):
    each bin averages its own channel over the pixels its rectangle
    covers (floor of its start to ceil of its end)."""
    B, C, H, W = data.shape
    k = int(pooled_size)
    g = int(group_size) if group_size else k
    dim = int(output_dim)
    dev = data.device
    x1, y1, rw, rh = _roi_corners(rois, spatial_scale)
    iv = torch.arange(k, device=dev).to(data.dtype)
    sy = y1[:, None] + iv * rh[:, None] / k
    ey = y1[:, None] + (iv + 1.0) * rh[:, None] / k
    sx = x1[:, None] + iv * rw[:, None] / k
    ex = x1[:, None] + (iv + 1.0) * rw[:, None] / k
    ys = torch.arange(H, device=dev).to(data.dtype)
    xs = torch.arange(W, device=dev).to(data.dtype)
    my = ((ys >= torch.floor(sy)[..., None])
          & (ys < torch.ceil(ey)[..., None])).to(data.dtype)  # (R, k, H)
    mx = ((xs >= torch.floor(sx)[..., None])
          & (xs < torch.ceil(ex)[..., None])).to(data.dtype)  # (R, k, W)
    cnt = torch.clamp(my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :],
                      min=1.0)  # (R, k, k)
    img = data[rois[:, 0].to(torch.int64)]  # (R, C, H, W)
    sums = torch.einsum("rchw,rih,rjw->rcij", img, my, mx)
    cidx = _ps_channels(dim, k, g, dev)
    ii = torch.arange(k, device=dev)
    picked = sums[:, cidx, ii[None, :, None], ii[None, None, :]]
    return picked / cnt[:, None]


def _bilinear_sample(img, y, x):
    """img (N, C, H, W); y, x (N, *idx) -> (N, C, *idx), zero outside
    (ref: deformable im2col bilinear)."""
    N, C, H, W = img.shape
    idx_shape = tuple(y.shape[1:])
    flat_img = img.reshape(N, C, H * W)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy1 = y - y0
    wx1 = x - x0
    out = 0.0
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yy = y0 + dy
            xx = x0 + dx
            inb = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
            yi = torch.clamp(yy, 0, H - 1).to(torch.int64)
            xi = torch.clamp(xx, 0, W - 1).to(torch.int64)
            flat = (yi * W + xi).reshape(N, 1, -1).expand(N, C, -1)
            v = torch.gather(flat_img, 2, flat).reshape((N, C) + idx_shape)
            out = out + v * (wy * wx * inb.to(img.dtype))[:, None]
    return out


@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution",),
          input_names=["data", "offset", "weight", "bias"])
def _deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                            stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                            num_filter=1, num_group=1,
                            num_deformable_group=1, no_bias=False,
                            layout="NCHW", **_):
    """Deformable convolution v1 (ref: contrib/deformable_convolution.cc,
    DCN): the regular taps moved by learned per-position offsets
    (ordered [group, kh, kw, (y, x)]), bilinear-sampled into an im2col
    tensor and contracted with the weight."""
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    dh, dw = int(dilate[0]), int(dilate[1])
    ph, pw = int(pad[0]), int(pad[1])
    B, C, H, W = data.shape
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = int(num_deformable_group)
    G = int(num_group)
    F = int(num_filter)
    dev = data.device

    oy = torch.arange(Ho, device=dev) * sh - ph
    ox = torch.arange(Wo, device=dev) * sw - pw
    base_y = (oy[:, None, None, None]
              + (torch.arange(kh, device=dev) * dh)[None, None, :, None])
    base_x = (ox[None, :, None, None]
              + (torch.arange(kw, device=dev) * dw)[None, None, None, :])
    base_y = base_y.expand(Ho, Wo, kh, kw).to(data.dtype)
    base_x = base_x.expand(Ho, Wo, kh, kw).to(data.dtype)

    off = offset.reshape(B, dg, kh, kw, 2, Ho, Wo)
    y = base_y + off[:, :, :, :, 0].permute(0, 1, 4, 5, 2, 3)
    x = base_x + off[:, :, :, :, 1].permute(0, 1, 4, 5, 2, 3)
    cpg = C // dg
    cols = _bilinear_sample(data.reshape(B * dg, cpg, H, W),
                            y.reshape(B * dg, Ho, Wo, kh, kw),
                            x.reshape(B * dg, Ho, Wo, kh, kw))
    cols_g = cols.reshape(B, G, C // G, Ho, Wo, kh, kw)
    w = weight.reshape(G, F // G, C // G, kh, kw)
    out = torch.einsum("bgchwij,gfcij->bgfhw", cols_g, w)
    out = out.reshape(B, F, Ho, Wo)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, F, 1, 1)
    return out


@register("_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",),
          input_names=["data", "rois", "trans"])
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=1, group_size=1, pooled_size=1,
                              part_size=0, sample_per_part=1,
                              trans_std=0.0, no_trans=False, **_):
    """Deformable position-sensitive ROI pooling (ref:
    contrib/deformable_psroi_pooling.cc).  Each bin moves by the learned
    normalised offset ``trans`` (R, 2*cls, part, part) of its part,
    times ``trans_std`` and the roi's size (channels 0 and 1: offsets
    shared by the classes), and averages sample_per_part² bilinear
    samples of its own channel."""
    B, C, H, W = data.shape
    k = int(pooled_size)
    g = int(group_size)
    dim = int(output_dim)
    part = int(part_size) if part_size else k
    sp = int(sample_per_part)
    dev = data.device
    R = rois.shape[0]
    x1, y1, rw, rh = _roi_corners(rois, spatial_scale)
    bin_w = rw / k
    bin_h = rh / k
    sub_w = bin_w / sp
    sub_h = bin_h / sp
    iv = torch.arange(k, device=dev).to(data.dtype)
    sv = torch.arange(sp, device=dev).to(data.dtype) + 0.5
    # (R, k, 1, sp, 1) rows and (R, 1, k, 1, sp) columns of sample points
    y = (y1[:, None] + iv * bin_h[:, None])[:, :, None, None, None] + \
        (sv * sub_h[:, None])[:, None, None, :, None]
    x = (x1[:, None] + iv * bin_w[:, None])[:, None, :, None, None] + \
        (sv * sub_w[:, None])[:, None, None, None, :]
    if not (no_trans or trans is None):
        pidx = torch.tensor([min(int(i * part / k), part - 1)
                             for i in range(k)], device=dev)
        tr = trans[:, :2][:, :, pidx[:, None], pidx[None, :]]  # (R,2,k,k)
        dy = tr[:, 0] * trans_std * rh[:, None, None]
        dx = tr[:, 1] * trans_std * rw[:, None, None]
        y = y + dy[..., None, None]
        x = x + dx[..., None, None]
    y, x = torch.broadcast_tensors(y, x)  # (R, k, k, sp, sp)
    cidx = _ps_channels(dim, k, g, dev)  # (dim, k, k)
    # each roi's image, its bins' channels: (R, dim*k*k, H, W)
    img = data[rois[:, 0].to(torch.int64)][:, cidx.reshape(-1)]
    ys = y[:, None].expand(R, dim, k, k, sp, sp).reshape(R * dim * k * k,
                                                         sp, sp)
    xs = x[:, None].expand(R, dim, k, k, sp, sp).reshape(R * dim * k * k,
                                                         sp, sp)
    samples = _bilinear_sample(img.reshape(R * dim * k * k, 1, H, W), ys, xs)
    return samples.reshape(R, dim, k, k, sp * sp).sum(-1) / (sp * sp)


# ---------------------------------------------------------------------------
# CTC loss (ref: contrib/ctc_loss.cc, embedded warp-ctc)
# ---------------------------------------------------------------------------
@register("_contrib_CTCLoss", aliases=("ctc_loss", "CTCLoss"),
          input_names=["data", "label", "data_lengths", "label_lengths"])
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first", **_):
    """Connectionist temporal classification loss
    (ref: contrib/ctc_loss.cc).

    data (T, B, A) pre-softmax activations; label (B, L) padded with 0
    (``blank_label='first'``: blank is class 0) or -1 (``'last'``: blank
    is A-1).  Returns the per-example loss (B,).  The alpha recursion in
    log space runs over time on the host (T steps); the gradient is
    autograd's through it, as the JAX package's is jax autodiff.
    ``torch.nn.functional.ctc_loss`` is not used: its analytic gradient
    is wrong where a label within its length is the blank (0 under
    ``blank_label='first'`` with ``use_label_lengths``), which this op
    takes, and its infeasible loss is inf where this one is ~1e30."""
    T, B, A = data.shape
    L = label.shape[1]
    S = 2 * L + 1
    dev = data.device
    neg_inf = torch.full((), -1e30, dtype=data.dtype, device=dev)
    if blank_label == "first":
        blank, pad = 0, 0
    else:
        blank, pad = A - 1, -1
    lab = label.to(torch.int64)
    logp = torch.log_softmax(data, dim=-1)  # (T, B, A)

    if use_label_lengths and label_lengths is not None:
        lab_len = label_lengths.to(torch.int64)
    else:
        lab_len = (lab != pad).sum(dim=1)
    if use_data_lengths and data_lengths is not None:
        dat_len = data_lengths.to(torch.int64)
    else:
        dat_len = torch.full((B,), T, dtype=torch.int64, device=dev)

    # the extended sequence: blank, l1, blank, l2, ..., blank (S)
    pos = torch.arange(S, device=dev)
    lab_idx = torch.clamp((pos - 1) // 2, 0, L - 1)
    taken = torch.gather(lab, 1, lab_idx[None].expand(B, S))
    ext = torch.where((pos % 2 == 0)[None, :],
                      torch.full((), blank, dtype=torch.int64, device=dev),
                      taken)
    in_range = pos[None, :] < (2 * lab_len[:, None] + 1)
    ext_m2 = torch.cat([torch.full((B, 2), -2, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (pos[None, :] % 2 == 1) & (ext != ext_m2)
    # a padding label of -1 indexes the last class (numpy's wrap, as
    # jnp.take_along_axis): its states are out of range either way
    ext_ix = torch.remainder(ext, A)
    pad1 = neg_inf.expand(B, 1)
    pad2 = neg_inf.expand(B, 2)

    alpha = neg_inf.expand(B, S).clone()
    first = torch.gather(logp[0], 1, ext_ix[:, :2])
    alpha[:, 0] = first[:, 0]
    alpha[:, 1] = torch.where(lab_len > 0, first[:, 1], neg_inf)
    for t in range(1, T):
        p = torch.gather(logp[t], 1, ext_ix)
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                         neg_inf)
        new = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + p
        new = torch.where(in_range, new, neg_inf)
        # each example's alpha freezes once its data length is consumed
        alpha = torch.where((t < dat_len)[:, None], new, alpha)
    end1 = torch.gather(alpha, 1, (2 * lab_len)[:, None])[:, 0]
    end2 = torch.gather(alpha, 1, torch.clamp(2 * lab_len - 1,
                                              min=0)[:, None])[:, 0]
    end2 = torch.where(lab_len > 0, end2, neg_inf)
    return (-torch.logaddexp(end1, end2)).to(data.dtype)


# ---------------------------------------------------------------------------
# FFT (ref: contrib/fft.cc: cuFFT wrappers)
# ---------------------------------------------------------------------------
@register("_contrib_fft", aliases=("fft",))
def _fft(data, compute_size=128, **_):
    """Real -> complex FFT along the last axis in float32, interleaved
    [re0, im0, re1, im1, ...] (ref: contrib/fft-inl.h:53, cuFFT's
    layout; ``compute_size`` is the reference's batching knob)."""
    f = torch.fft.fft(data.to(torch.float32), dim=-1)
    out = torch.stack([f.real, f.imag], dim=-1)
    return out.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],)).to(
        data.dtype)


@register("_contrib_ifft", aliases=("ifft",))
def _ifft(data, compute_size=128, **_):
    """Complex -> real inverse FFT of interleaved input, unnormalised
    like cuFFT: ifft(fft(x)) == n * x (ref: contrib/fft-inl.h)."""
    n = data.shape[-1] // 2
    c = data.reshape(tuple(data.shape[:-1]) + (n, 2))
    z = torch.complex(c[..., 0], c[..., 1])
    out = torch.fft.ifft(z, dim=-1) * n
    return out.real.to(data.dtype)
