"""Detection-aware augmenters and ``ImageDetIter``.

Counterpart: ``mxnet_tpu/image/detection.py``.  Labels ride through
augmentation as numpy arrays of shape (num_objects, 5+): [class_id,
xmin, ymin, xmax, ymax, ...] with coordinates normalized to [0, 1].
The samplers draw from a numpy generator seeded from Python's
``random`` stream, as the JAX package's do, so ``random.seed(n)``
reproduces the whole pipeline in either package.
"""
from __future__ import annotations

import json
import logging
import random as pyrandom

import numpy as np

from .. import io
from ..context import cpu
from ..ndarray import NDArray, array
from . import image as _img
from .image import (Augmenter, CastAug, ColorJitterAug, ColorNormalizeAug,
                    ForceResizeAug, HueJitterAug, ImageIter, LightingAug,
                    RandomGrayAug, ResizeAug, _to_np)

__all__ = [
    "DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
    "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
    "CreateMultiRandCropAugmenter", "CreateDetAugmenter", "ImageDetIter",
]


def _np_rng():
    """Numpy Generator seeded from the ``random`` module stream, so
    ``random.seed(n)`` reproduces the whole detection pipeline (flip and
    select draw from ``random`` directly; the vectorized samplers draw
    from this derived generator)."""
    return np.random.default_rng(pyrandom.getrandbits(63))


class DetAugmenter(object):
    """Detection augmenter: __call__(src, label) → (src, label)
    (ref: detection.py:39)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                kwargs[k] = v.asnumpy().tolist()
            elif isinstance(v, np.ndarray):
                kwargs[k] = v.tolist()

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only Augmenter; label passes through
    (ref: detection.py:65)."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise TypeError("Borrowing from invalid Augmenter")
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def dumps(self):
        return [self.__class__.__name__.lower(), self.augmenter.dumps()]

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one augmenter from a list (or skip with skip_prob)
    (ref: detection.py:90)."""

    def __init__(self, aug_list, skip_prob=0):
        super().__init__(skip_prob=skip_prob)
        if not isinstance(aug_list, (list, tuple)):
            aug_list = [aug_list]
        for aug in aug_list:
            if not isinstance(aug, DetAugmenter):
                raise ValueError("Allow DetAugmenter in list only")
        if not aug_list:
            skip_prob = 1  # disabled
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def dumps(self):
        return [self.__class__.__name__.lower(),
                [x.dumps() for x in self.aug_list]]

    def __call__(self, src, label):
        if pyrandom.random() < self.skip_prob:
            return src, label
        t = pyrandom.choice(self.aug_list)
        return t(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image + x-coords of boxes (ref: detection.py:126)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = _to_np(src)[:, ::-1]
            label = self._flip_label(label)
        return src, label

    def _flip_label(self, label):
        out = np.array(label, copy=True)
        real = out[:, 0] > -1
        x1 = out[real, 1].copy()
        out[real, 1] = 1.0 - out[real, 3]
        out[real, 3] = 1.0 - x1
        return out


class DetRandomCropAug(DetAugmenter):
    """Random crop with constraints on object coverage
    (ref: detection.py:152 — the SSD sampling strategy)."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50):
        if not isinstance(aspect_ratio_range, (tuple, list)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.enabled = (area_range[1] > area_range[0]
                        or area_range[0] < 1.0 or area_range[0] > 1.0)
        if not (area_range[0] <= area_range[1] and 0 < area_range[1] <= 1):
            logging.warning("Skip DetRandomCropAug due to invalid "
                            "area_range: %s", area_range)
            self.enabled = False

    def __call__(self, src, label):
        crop = self._sample_crop(label, *_to_np(src).shape[:2])
        if crop is not None:
            x, y, w, h, label = crop
            src = _img.fixed_crop(_to_np(src), x, y, w, h)
        return src, label

    # The SSD patch-sampling strategy (Liu et al. 2016, §2.2 "Data
    # augmentation"): repeatedly propose a patch whose area / aspect ratio
    # lie in configured ranges, accept it when every object it touches is
    # sufficiently covered, then keep only the boxes that retain at least
    # ``min_eject_coverage`` of their area inside the patch.  This
    # implementation draws every proposal up front as vectorized numpy —
    # a (max_attempts,) batch of (area-fraction, log-aspect) pairs —
    # instead of a scalar rejection loop.

    def _sample_crop(self, label, im_h, im_w):
        """Return (x, y, w, h, new_label) in pixels or None to skip."""
        if not self.enabled or im_h <= 0 or im_w <= 0:
            return None
        n = self.max_attempts
        lo, hi = self.aspect_ratio_range
        if hi < lo or hi <= 0:
            return None
        rng = _np_rng()
        # aspect sampled log-uniformly: symmetric treatment of wide/tall
        ratios = np.exp(rng.uniform(np.log(max(lo, 1e-6)),
                                    np.log(hi), size=n))
        fracs = rng.uniform(self.area_range[0], self.area_range[1],
                            size=n)
        # w/h = ratio and w*h = frac*W*H  →  h = sqrt(frac*W*H/ratio)
        hs = np.sqrt(fracs * im_w * im_h / ratios).round().astype(int)
        ws = np.round(hs * ratios).astype(int)
        ok = (ws >= 1) & (hs >= 1) & (ws <= im_w) & (hs <= im_h)
        # re-check the realized (integer) area against the bounds
        area = ws * hs
        ok &= (area >= self.area_range[0] * im_w * im_h - 1) & \
              (area <= self.area_range[1] * im_w * im_h + 1)
        xs = (rng.uniform(size=n) * (im_w - ws + 1)).astype(int)
        ys = (rng.uniform(size=n) * (im_h - hs + 1)).astype(int)
        boxes = label[:, 1:5]
        for i in np.flatnonzero(ok):
            patch = (xs[i] / im_w, ys[i] / im_h,
                     (xs[i] + ws[i]) / im_w, (ys[i] + hs[i]) / im_h)
            if not self._patch_acceptable(boxes, patch, im_w, im_h):
                continue
            new_label = self._labels_in_patch(label, patch)
            if new_label is not None:
                return (int(xs[i]), int(ys[i]), int(ws[i]), int(hs[i]),
                        new_label)
        return None

    @staticmethod
    def _coverage(boxes, patch):
        """Fraction of each box's area inside the patch; 0 for
        degenerate boxes."""
        px1, py1, px2, py2 = patch
        iw = np.minimum(boxes[:, 2], px2) - np.maximum(boxes[:, 0], px1)
        ih = np.minimum(boxes[:, 3], py2) - np.maximum(boxes[:, 1], py1)
        inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
        area = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * \
            np.clip(boxes[:, 3] - boxes[:, 1], 0, None)
        with np.errstate(divide="ignore", invalid="ignore"):
            cov = np.where(area > 0, inter / area, 0.0)
        return cov

    def _patch_acceptable(self, boxes, patch, im_w, im_h):
        """Accept iff the patch is non-degenerate and every object it
        overlaps is covered beyond ``min_object_covered``."""
        px1, py1, px2, py2 = patch
        if (px2 - px1) * im_w * (py2 - py1) * im_h < 2:
            return False
        # ignore sub-pixel objects
        real = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) \
            * im_w * im_h > 2
        if not real.any():
            return False
        cov = self._coverage(boxes[real], patch)
        touched = cov > 0
        return touched.any() and cov[touched].min() > self.min_object_covered

    def _labels_in_patch(self, label, patch):
        """Clip boxes to the patch, renormalize to patch coords, and drop
        boxes that lost too much area; None when nothing survives."""
        px1, py1, px2, py2 = patch
        pw, ph = px2 - px1, py2 - py1
        cov = self._coverage(label[:, 1:5], patch)
        keep = cov > self.min_eject_coverage
        clipped = label[keep].copy()
        if clipped.shape[0] == 0:
            return None
        cx1 = np.clip((clipped[:, 1] - px1) / pw, 0, 1)
        cy1 = np.clip((clipped[:, 2] - py1) / ph, 0, 1)
        cx2 = np.clip((clipped[:, 3] - px1) / pw, 0, 1)
        cy2 = np.clip((clipped[:, 4] - py1) / ph, 0, 1)
        alive = (cx2 > cx1) & (cy2 > cy1)
        clipped[:, 1], clipped[:, 2] = cx1, cy1
        clipped[:, 3], clipped[:, 4] = cx2, cy2
        clipped = clipped[alive]
        return clipped if clipped.shape[0] else None


class DetRandomPadAug(DetAugmenter):
    """Random expansion padding (zoom-out) (ref: detection.py:325)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(128, 128, 128)):
        if not isinstance(pad_val, (list, tuple)):
            pad_val = (pad_val,)
        if not isinstance(aspect_ratio_range, (list, tuple)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.pad_val = pad_val
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.enabled = area_range[1] > 1.0 and \
            area_range[0] >= 1.0 and \
            aspect_ratio_range[0] <= aspect_ratio_range[1]
        if not self.enabled:
            logging.warning("Skip DetRandomPadAug due to invalid "
                            "parameters: %s, %s", area_range,
                            aspect_ratio_range)

    def __call__(self, src, label):
        a = _to_np(src)
        im_h, im_w = a.shape[:2]
        pad = self._sample_canvas(im_h, im_w)
        if pad is not None:
            x, y, w, h = pad
            fill = (self.pad_val[:a.shape[2]]
                    if len(self.pad_val) >= a.shape[2] else self.pad_val[0])
            out = np.full((h, w, a.shape[2]), fill, dtype=a.dtype)
            out[y:y + im_h, x:x + im_w, :] = a
            a = out
            label = self._labels_on_canvas(label, (x, y, w, h), im_h, im_w)
        return a, label

    # The zoom-out expansion (SSD §2.2): place the image at a random
    # offset on a larger canvas filled with pad_val, so objects shrink.
    # Proposals are drawn as a vectorized batch of (area-factor,
    # log-aspect) pairs; the first canvas that contains the image wins.

    @staticmethod
    def _labels_on_canvas(label, canvas, im_h, im_w):
        """Map [0,1]-normalized image coords to canvas coords."""
        x, y, w, h = canvas
        out = label.copy()
        out[:, 1] = (out[:, 1] * im_w + x) / w
        out[:, 3] = (out[:, 3] * im_w + x) / w
        out[:, 2] = (out[:, 2] * im_h + y) / h
        out[:, 4] = (out[:, 4] * im_h + y) / h
        return out

    def _sample_canvas(self, im_h, im_w):
        """Return (x, y, canvas_w, canvas_h) or None to skip."""
        if not self.enabled or im_h <= 0 or im_w <= 0:
            return None
        n = self.max_attempts
        lo, hi = self.aspect_ratio_range
        rng = _np_rng()
        ratios = np.exp(rng.uniform(np.log(max(lo, 1e-6)),
                                    np.log(max(hi, 1e-6)), size=n))
        factors = rng.uniform(self.area_range[0], self.area_range[1],
                              size=n)
        hs = np.sqrt(factors * im_w * im_h / ratios).round().astype(int)
        ws = np.round(hs * ratios).astype(int)
        area_lo = self.area_range[0] * im_w * im_h
        area_hi = self.area_range[1] * im_w * im_h
        ok = (ws >= im_w) & (hs >= im_h) & \
             (ws * hs >= area_lo - 1) & (ws * hs <= area_hi + 1)
        idx = np.flatnonzero(ok)
        if idx.size == 0:
            return None
        i = idx[0]
        x = int(rng.uniform() * (ws[i] - im_w + 1))
        y = int(rng.uniform() * (hs[i] - im_h + 1))
        return (x, y, int(ws[i]), int(hs[i]))


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """Batch-create a DetRandomSelectAug of crop augmenters from
    list-valued params (ref: detection.py:419)."""
    def align_parameters(params):
        out_params = []
        num = 1
        for p in params:
            if not isinstance(p, list):
                p = [p]
            out_params.append(p)
            num = max(num, len(p))
        for k, p in enumerate(out_params):
            if len(p) != num:
                assert len(p) == 1
                out_params[k] = p * num
        return out_params

    aligned_params = align_parameters([min_object_covered,
                                       aspect_ratio_range, area_range,
                                       min_eject_coverage, max_attempts])
    augs = []
    for moc, arr, ar, mec, ma in zip(*aligned_params):
        augs.append(DetRandomCropAug(min_object_covered=moc,
                                     aspect_ratio_range=arr, area_range=ar,
                                     min_eject_coverage=mec,
                                     max_attempts=ma))
    return DetRandomSelectAug(augs, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Standard detection augmenter list (ref: detection.py:484)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop_augs = CreateMultiRandCropAugmenter(
            min_object_covered, aspect_ratio_range,
            (area_range[0], min(1.0, area_range[1])), min_eject_coverage,
            max_attempts, skip_prob=(1 - rand_crop))
        auglist.append(crop_augs)
    if rand_mirror > 0:
        auglist.append(DetHorizontalFlipAug(0.5))
    # apply pad before color jitter so pad_val is in raw pixel units
    if rand_pad > 0:
        pad_aug = DetRandomPadAug(aspect_ratio_range,
                                  (1.0, area_range[1]), max_attempts,
                                  pad_val)
        auglist.append(DetRandomSelectAug([pad_aug], 1 - rand_pad))
    # force resize to the network input size
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(ColorJitterAug(brightness, contrast,
                                                   saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = np.asarray(mean)
        assert mean.shape[0] in [1, 3]
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = np.asarray(std)
        assert std.shape[0] in [1, 3]
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: variable-object labels padded to a fixed
    (batch, num_obj, label_width) block with header_width metadata
    (ref: detection.py:626)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 last_batch_handle="pad", **kwargs):
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name,
                         last_batch_handle=last_batch_handle, **kwargs)
        if aug_list is None:
            self.auglist = CreateDetAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        # estimate label shape by scanning
        self.max_objects, self.label_width_det = self._estimate_label_shape()
        self.label_shape = (self.max_objects, self.label_width_det)
        self.provide_label_ = [io.DataDesc(
            label_name, (self.batch_size,) + self.label_shape, "float32")]

    def _check_valid_label(self, label):
        if len(label.shape) != 2 or label.shape[1] < 5:
            raise RuntimeError("Label with shape (1+, 5+) required, %s "
                               "received." % str(label))
        valid_label = np.where(np.logical_and(
            label[:, 0] >= 0, label[:, 3] > label[:, 1]))[0]
        if valid_label.size < 1:
            raise RuntimeError("Invalid label occurs.")

    def _estimate_label_shape(self):
        """Scan the dataset once for the max object count
        (ref: detection.py:697)."""
        max_count = 0
        label_width = 6
        self.reset()
        try:
            while True:
                label, _ = self.next_sample()
                label = self._parse_label(label)
                max_count = max(max_count, label.shape[0])
                label_width = label.shape[1]
        except StopIteration:
            pass
        self.reset()
        return max(max_count, 1), label_width

    def _parse_label(self, label):
        """Header-format label → (num_obj, width) float array
        (ref: detection.py:711). Raw layout: [header_width, obj_width,
        (extras...), obj0..., obj1...]."""
        if isinstance(label, NDArray):
            label = label.asnumpy()
        raw = np.asarray(label).ravel().astype(np.float32)
        if raw.size < 7:
            raise RuntimeError("Label shape is invalid: " + str(raw.shape))
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if (raw.size - header_width) % obj_width != 0:
            raise RuntimeError("Label shape %s inconsistent with annotation "
                               "width %d." % (str(raw.shape), obj_width))
        out = raw[header_width:].reshape(-1, obj_width)
        self._check_valid_label(out)
        return out

    def reshape(self, data_shape=None, label_shape=None):
        """Change data/label shape between epochs (ref: detection.py:737)."""
        if data_shape is not None:
            self.check_data_shape(data_shape)
            self.provide_data_ = [io.DataDesc(
                self.provide_data_[0].name,
                (self.batch_size,) + data_shape,
                self.provide_data_[0].dtype)]
            self.data_shape = data_shape
        if label_shape is not None:
            self.check_label_shape(label_shape)
            self.label_shape = label_shape
            self.provide_label_ = [io.DataDesc(
                self.provide_label_[0].name,
                (self.batch_size,) + label_shape, "float32")]

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, c, h, w), dtype=np.float32)
        batch_label = np.full((batch_size,) + self.label_shape, -1.0,
                              dtype=np.float32)
        i = 0
        try:
            while i < batch_size:
                raw_label, s = self.next_sample()
                data = self.imdecode(s)
                try:
                    self.check_valid_image(data)
                    label = self._parse_label(raw_label)
                except RuntimeError as e:
                    logging.debug("Invalid image, skipping:  %s", str(e))
                    continue
                data, label = self.augmentation_transform(data, label)
                n = min(label.shape[0], self.label_shape[0])
                batch_label[i, :n, :label.shape[1]] = label[:n]
                batch_data[i] = self.postprocess_data(data)
                i += 1
        except StopIteration:
            if not i:
                raise StopIteration
        pad = batch_size - i
        if pad != 0 and self.last_batch_handle == "discard":
            raise StopIteration
        if pad != 0:
            self._allow_read = False
        return io.DataBatch([array(batch_data, ctx=cpu())],
                            [array(batch_label, ctx=cpu())], pad=pad)

    def augmentation_transform(self, data, label):
        for aug in self.auglist:
            data, label = aug(data, label)
        return _to_np(data), label

    def check_label_shape(self, label_shape):
        if not len(label_shape) == 2:
            raise ValueError("label_shape should have length 2")
        if label_shape[1] < 5:
            raise ValueError("label_shape[1] should be at least 5")

    def sync_label_shape(self, it, verbose=False):
        """Synchronize label padding with another iterator (train/val
        pairs) (ref: detection.py:902)."""
        assert isinstance(it, ImageDetIter)
        train_label_shape = self.label_shape
        val_label_shape = it.label_shape
        assert train_label_shape[1] == val_label_shape[1]
        max_count = max(train_label_shape[0], val_label_shape[0])
        if max_count > train_label_shape[0]:
            self.reshape(None, (max_count, train_label_shape[1]))
        if max_count > val_label_shape[0]:
            it.reshape(None, (max_count, val_label_shape[1]))
        if verbose and max_count > min(train_label_shape[0],
                                       val_label_shape[0]):
            logging.info("Resized label_shape to (%d, %d).", max_count,
                         train_label_shape[1])
        return it
