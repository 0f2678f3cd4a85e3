"""Image I/O and augmentation.

Counterpart: ``mxnet_tpu/image/image.py``.  Augmenters work on host
numpy arrays (HWC, RGB); the assembled batch crosses to the card once
(``io_pipeline.InputPipeline`` or the consumer), never an image at a
time.  Decode and resize use PIL, as the JAX package's do, so the
deterministic ops give the same bytes.  Public functions take an
``NDArray`` or numpy and return the same kind; an ``NDArray`` result
lies on the input's context, and decoded images and ``ImageIter``
batches are host data (``mx.cpu()``, as ``io``'s iterators).  The
random draws come from Python's ``random`` module (and numpy's global
generator for the PCA lighting noise): seeded host generators, the
same streams the JAX package draws from, so ``random.seed(n)`` gives
both packages the same augmentations.
"""
from __future__ import annotations

import json
import logging
import os
import random as pyrandom

import numpy as np

from .. import io, recordio
from ..base import MXNetError
from ..context import cpu
from ..ndarray import NDArray, array

__all__ = [
    "imread", "imdecode", "imresize", "scale_down", "resize_short",
    "copyMakeBorder", "fixed_crop", "random_crop", "center_crop",
    "color_normalize", "random_size_crop",
    "Augmenter", "SequentialAug", "ResizeAug", "ForceResizeAug",
    "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
    "RandomOrderAug", "BrightnessJitterAug", "ContrastJitterAug",
    "SaturationJitterAug", "HueJitterAug", "ColorJitterAug", "LightingAug",
    "ColorNormalizeAug", "RandomGrayAug", "HorizontalFlipAug", "CastAug",
    "CreateAugmenter", "ImageIter",
]


def _to_np(img):
    if isinstance(img, NDArray):
        return img.asnumpy()
    return np.asarray(img)


def _wrap_like(out, like):
    """Return `out` as NDArray iff the input was one (API parity with the
    reference, which always hands back NDArray)."""
    if isinstance(like, NDArray):
        return array(out, ctx=like.context)
    return out


def _pil():
    try:
        from PIL import Image  # noqa: F401
        return Image
    except ImportError as e:  # pragma: no cover
        raise MXNetError("mx.image requires Pillow for decode/resize") from e


# cv2-style interp codes kept for API parity
# (ref: image.py:174 _get_interp_method)
_INTERP_TO_PIL = {}


def _interp_to_pil(interp):
    Image = _pil()
    if not _INTERP_TO_PIL:
        _INTERP_TO_PIL.update({
            0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
            3: Image.BOX, 4: Image.LANCZOS,
        })
    return _INTERP_TO_PIL[int(interp)]


def _get_interp_method(interp, sizes=()):
    """ref: image.py:174 — 9 = auto (area for shrink / cubic for grow),
    10 = random choice per call."""
    if interp == 9:
        if sizes:
            oh, ow, nh, nw = sizes
            return 3 if nh < oh and nw < ow else 2
        return 2
    if interp == 10:
        return pyrandom.randint(0, 4)
    if interp not in (0, 1, 2, 3, 4):
        raise ValueError("Unknown interp method %s" % interp)
    return interp


def _resize_np(src, w, h, interp=2):
    Image = _pil()
    a = np.asarray(src)
    method = _interp_to_pil(interp)
    if a.dtype == np.uint8 and (a.ndim == 2 or a.shape[2] in (1, 3, 4)):
        squeeze = a.ndim == 3 and a.shape[2] == 1
        im = Image.fromarray(a[:, :, 0] if squeeze else a)
        out = np.asarray(im.resize((w, h), method))
        return out[:, :, None] if squeeze else out
    # non-uint8 (or odd channel count): per-channel float32 resize
    dtype = a.dtype
    if a.ndim == 2:
        a = a[:, :, None]
    chans = [np.asarray(Image.fromarray(a[:, :, c].astype(np.float32),
                                        mode="F").resize((w, h), method))
             for c in range(a.shape[2])]
    out = np.stack(chans, axis=2)
    if np.asarray(src).ndim == 2:
        out = out[:, :, 0]
    return out.astype(dtype)


def imdecode(buf, flag=1, to_rgb=True, **kwargs):
    """Decode an image byte buffer → HWC uint8 NDArray
    (ref: image.py:85; OpenCV decode → our PIL decode).

    flag=0 decodes grayscale (HW1). to_rgb=False gives BGR channel order
    (the reference's OpenCV-native layout)."""
    import io as _io
    Image = _pil()
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    elif isinstance(buf, np.ndarray):
        buf = buf.tobytes()
    im = Image.open(_io.BytesIO(bytes(buf)))
    if flag == 0:
        a = np.asarray(im.convert("L"))[:, :, None]
    else:
        a = np.asarray(im.convert("RGB"))
        if not to_rgb:
            a = a[:, :, ::-1]
    return array(np.ascontiguousarray(a), ctx=cpu())


def imread(filename, flag=1, to_rgb=True, **kwargs):
    """ref: image.py:44 — read + decode in one step."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=2):
    """Resize to (w, h) (ref: the backend imresize op, image_io.cc)."""
    a = _to_np(src)
    out = _resize_np(a, int(w), int(h),
                     _get_interp_method(interp, (a.shape[0], a.shape[1],
                                                 h, w)))
    return _wrap_like(out, src)


def scale_down(src_size, size):
    """Scale (w, h) down to fit inside src_size keeping aspect ratio
    (ref: image.py:139)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize the shorter edge to `size` (ref: image.py:229)."""
    a = _to_np(src)
    h, w = a.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    out = _resize_np(a, new_w, new_h,
                     _get_interp_method(interp, (h, w, new_h, new_w)))
    return _wrap_like(out, src)


def copyMakeBorder(src, top, bot, left, right, type=0, values=0.0):
    """Pad an image with a constant border (ref: the backend
    copyMakeBorder op; only BORDER_CONSTANT is used by the iterators)."""
    a = _to_np(src)
    pad = ((top, bot), (left, right)) + ((0, 0),) * (a.ndim - 2)
    out = np.pad(a, pad, mode="constant", constant_values=values)
    return _wrap_like(out, src)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop a fixed window, optionally resizing (ref: image.py:291)."""
    a = _to_np(src)
    out = a[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _resize_np(out, size[0], size[1],
                         _get_interp_method(interp, (h, w, size[1], size[0])))
    return _wrap_like(out, src)


def random_crop(src, size, interp=2):
    """Random crop of `size`, scaled down if the image is smaller
    (ref: image.py:323). Returns (img, (x0, y0, w, h))."""
    a = _to_np(src)
    h, w = a.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(a, x0, y0, new_w, new_h, size, interp)
    return _wrap_like(_to_np(out), src), (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """Center crop (ref: image.py:362). Returns (img, (x0, y0, w, h))."""
    a = _to_np(src)
    h, w = a.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(a, x0, y0, new_w, new_h, size, interp)
    return _wrap_like(_to_np(out), src), (x0, y0, new_w, new_h)


def random_size_crop(src, size, min_area, ratio, interp=2, max_area=1.0,
                     max_attempts=10, **kwargs):
    """Random area+aspect crop, the Inception-style crop
    (ref: image.py:435). Returns (img, (x0, y0, w, h)); falls back to a
    center crop when no proposal fits."""
    a = _to_np(src)
    h, w = a.shape[:2]
    src_area = h * w
    log_lo, log_hi = np.log(ratio[0]), np.log(ratio[1])
    for _ in range(max_attempts):
        target_area = pyrandom.uniform(min_area, max_area) * src_area
        aspect = np.exp(pyrandom.uniform(log_lo, log_hi))
        new_w = int(round(np.sqrt(target_area * aspect)))
        new_h = int(round(np.sqrt(target_area / aspect)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(a, x0, y0, new_w, new_h, size, interp)
            return _wrap_like(_to_np(out), src), (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std in float (ref: image.py:411)."""
    a = _to_np(src).astype(np.float32)
    a = a - _to_np(mean)
    if std is not None:
        a = a / _to_np(std)
    return _wrap_like(a, src)


# --------------------------------------------------------------------- #
# Augmenters (ref: image.py:482-884)
# --------------------------------------------------------------------- #

class Augmenter(object):
    """Image augmenter base; `dumps()` serializes ctor args to JSON so an
    augmenter list can round-trip through iterator kwargs
    (ref: image.py:482)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                kwargs[k] = v.asnumpy().tolist()
            elif isinstance(v, np.ndarray):
                kwargs[k] = v.tolist()

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    """Compose a list of augmenters in order (ref: image.py:508)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [self.__class__.__name__.lower(), [x.dumps() for x in self.ts]]

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    """resize_short (ref: image.py:531)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """Exact-size resize, ignoring aspect (ref: image.py:551)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        a = _to_np(src)
        sizes = (a.shape[0], a.shape[1], self.size[1], self.size[0])
        out = _resize_np(a, self.size[0], self.size[1],
                         _get_interp_method(self.interp, sizes))
        return _wrap_like(out, src)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, min_area, ratio, interp=2, **kwargs):
        super().__init__(size=size, min_area=min_area, ratio=ratio,
                         interp=interp, **kwargs)
        self.size, self.min_area = size, min_area
        self.ratio, self.interp = ratio, interp
        self.kwargs = kwargs

    def __call__(self, src):
        return random_size_crop(src, self.size, self.min_area, self.ratio,
                                self.interp, **self.kwargs)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomOrderAug(Augmenter):
    """Apply child augmenters in random order (ref: image.py:639)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def dumps(self):
        return [self.__class__.__name__.lower(), [x.dumps() for x in self.ts]]

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class BrightnessJitterAug(Augmenter):
    """src *= 1 + U(-b, b) (ref: image.py:663)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return _wrap_like(_to_np(src).astype(np.float32) * alpha, src)


_GRAY_COEF = np.array([0.299, 0.587, 0.114], dtype=np.float32)


class ContrastJitterAug(Augmenter):
    """Blend with the mean gray level (ref: image.py:682)."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        a = _to_np(src).astype(np.float32)
        gray_mean = (a * _GRAY_COEF).sum(axis=2).mean()
        return _wrap_like(a * alpha + (1.0 - alpha) * gray_mean, src)


class SaturationJitterAug(Augmenter):
    """Blend with the per-pixel gray image (ref: image.py:705)."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        a = _to_np(src).astype(np.float32)
        gray = (a * _GRAY_COEF).sum(axis=2, keepdims=True)
        return _wrap_like(a * alpha + gray * (1.0 - alpha), src)


class HueJitterAug(Augmenter):
    """Rotate hue in YIQ space (ref: image.py:729, the Ke Sun method)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], dtype=np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], dtype=np.float32)

    def __call__(self, src):
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      dtype=np.float32)
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        a = _to_np(src).astype(np.float32)
        return _wrap_like(np.dot(a, t), src)


class ColorJitterAug(RandomOrderAug):
    """brightness+contrast+saturation in random order (ref: image.py:763)."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise (ref: image.py:786)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd, eigval=eigval, eigvec=eigvec)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, dtype=np.float32)
        self.eigvec = np.asarray(eigvec, dtype=np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return _wrap_like(_to_np(src).astype(np.float32) + rgb, src)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    """With prob p, collapse to gray (ref: image.py:832)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = np.full((3, 3), 1.0 / 3.0, dtype=np.float32)

    def __call__(self, src):
        if pyrandom.random() < self.p:
            a = _to_np(src).astype(np.float32)
            return _wrap_like(np.dot(a, self.mat), src)
        return src


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return _wrap_like(_to_np(src)[:, ::-1], src)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _wrap_like(_to_np(src).astype(self.typ), src)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """Standard classification augmenter list (ref: image.py:885)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3.0 / 4.0,
                                                            4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
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
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# --------------------------------------------------------------------- #
# ImageIter (ref: image.py:999)
# --------------------------------------------------------------------- #

class ImageIter(io.DataIter):
    """Image iterator with per-image python augmenters, reading either a
    .rec file (path_imgrec [+ path_imgidx]) or an image list + raw files
    (path_imglist/imglist + path_root). ref: image.py:999.

    Sharding for distributed loaders: (part_index, num_parts) slices the
    sequence the same way the reference's InputSplit does."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 last_batch_handle="pad", **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or (isinstance(imglist, list))
        assert dtype in ("int32", "float32", "int64", "float64"), \
            dtype + " label not supported"
        from .. import env as _env

        num_threads = _env.get_int("MXNET_CPU_WORKER_NTHREADS")
        logging.info("Using %s threads for decoding...", num_threads)
        self.seq = None
        self.imgrec = None
        self.imglist = None
        self.imgidx = None
        if path_imgrec:
            logging.info("loading recordio %s...", path_imgrec)
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(
                    path_imgidx, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
        if path_imglist:
            logging.info("loading image list %s...", path_imglist)
            with open(path_imglist) as fin:
                imglist_d = {}
                imgkeys = []
                for line in iter(fin.readline, ""):
                    line = line.strip().split("\t")
                    label = np.array(line[1:-1], dtype=dtype)
                    key = int(line[0])
                    imglist_d[key] = (label, line[-1])
                    imgkeys.append(key)
                self.imglist = imglist_d
                self.seq = imgkeys
        elif isinstance(imglist, list):
            logging.info("loading image list...")
            result = {}
            imgkeys = []
            index = 1
            for img in imglist:
                key = str(index)
                index += 1
                if len(img) > 2:
                    label = np.array(img[:-1], dtype=dtype)
                elif isinstance(img[0], np.ndarray):
                    label = img[0]
                else:
                    label = np.array(img[0], dtype=dtype)
                result[key] = (label, img[-1])
                imgkeys.append(str(key))
            self.imglist = result
            self.seq = imgkeys
        else:
            self.imglist = None
            if self.imgidx is not None:
                self.seq = self.imgidx

        self.path_root = path_root
        self.check_data_shape(data_shape)
        self.provide_data_ = [io.DataDesc(data_name,
                                          (batch_size,) + data_shape, dtype)]
        if label_width > 1:
            self.provide_label_ = [io.DataDesc(
                label_name, (batch_size, label_width), dtype)]
        else:
            self.provide_label_ = [io.DataDesc(label_name, (batch_size,),
                                               dtype)]
        self.batch_size = batch_size
        self.data_shape = data_shape
        self.label_width = label_width
        self.shuffle = shuffle
        if num_parts > 1 and self.seq is not None:
            assert part_index < num_parts
            N = len(self.seq)
            C = N // num_parts
            self.seq = self.seq[part_index * C:(part_index + 1) * C]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.cur = 0
        self._allow_read = True
        self.last_batch_handle = last_batch_handle
        self.num_image = len(self.seq) if self.seq is not None else None
        self._cache_data = None
        self._cache_label = None
        self._cache_idx = None
        self.dtype = dtype
        self.reset()

    @property
    def provide_data(self):
        return self.provide_data_

    @property
    def provide_label(self):
        return self.provide_label_

    def reset(self):
        """Start the next epoch.  Under roll_over a cached partial batch
        survives the reset and is completed from the new epoch's samples
        (the reference's carry-over contract)."""
        if self.seq is not None and self.shuffle:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0
        self._allow_read = True

    def hard_reset(self):
        if self.seq is not None and self.shuffle:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0
        self._allow_read = True
        self._cache_data = None
        self._cache_label = None
        self._cache_idx = None

    def next_sample(self):
        """Return (label, decoded numpy image) for the next sample."""
        if not self._allow_read:
            raise StopIteration
        if self.seq is not None:
            if self.cur < len(self.seq):
                idx = self.seq[self.cur]
            else:
                if self.last_batch_handle != "discard":
                    self.cur = 0
                raise StopIteration
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                if self.imglist is None:
                    return header.label, img
                return self.imglist[idx][0], img
            label, fname = self.imglist[idx]
            return label, self.read_image(fname)
        s = self.imgrec.read()
        if s is None:
            if self.last_batch_handle != "discard":
                self.imgrec.reset()
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def _batchify(self, batch_data, batch_label, start=0):
        i = start
        batch_size = self.batch_size
        try:
            while i < batch_size:
                label, s = self.next_sample()
                data = self.imdecode(s)
                try:
                    self.check_valid_image(data)
                except RuntimeError as e:
                    logging.debug("Invalid image, skipping:  %s", str(e))
                    continue
                data = self.augmentation_transform(data)
                batch_data[i] = self.postprocess_data(data)
                batch_label[i] = label
                i += 1
        except StopIteration:
            if not i:
                raise StopIteration
        return i

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        if self._cache_data is not None:
            # roll_over: resume the partial batch carried across reset()
            batch_data = self._cache_data
            batch_label = self._cache_label
            start = self._cache_idx
            self._cache_data = None
            self._cache_label = None
            self._cache_idx = None
        else:
            batch_data = np.zeros((batch_size, c, h, w), dtype=np.float32)
            if self.label_width > 1:
                batch_label = np.zeros((batch_size, self.label_width),
                                       dtype=self.dtype)
            else:
                batch_label = np.zeros((batch_size,), dtype=self.dtype)
            start = 0
        i = self._batchify(batch_data, batch_label, start)
        pad = batch_size - i
        if pad != 0:
            if self.last_batch_handle == "discard":
                raise StopIteration
            if self.last_batch_handle == "roll_over":
                # stash the partial batch for the next epoch
                # (ref: image.py ImageIter.next roll_over cache)
                self._cache_data = batch_data
                self._cache_label = batch_label
                self._cache_idx = i
                self._allow_read = False
                raise StopIteration
            self._allow_read = False
        return io.DataBatch([array(batch_data.astype(self.dtype), ctx=cpu())],
                            [array(batch_label, ctx=cpu())], pad=pad)

    def check_data_shape(self, data_shape):
        if not len(data_shape) == 3:
            raise ValueError("data_shape should have length 3, with "
                             "dimensions CxHxW")
        if not data_shape[0] == 3 and not data_shape[0] == 1:
            raise ValueError("This iterator expects inputs to have 1 or 3 "
                             "channels.")

    def check_valid_image(self, data):
        if len(data.shape) == 0:
            raise RuntimeError("Data shape is wrong")

    def imdecode(self, s):
        """Decode a sample's bytes → numpy HWC (uint8)."""
        img = imdecode(s)
        return img.asnumpy()

    def read_image(self, fname):
        with open(os.path.join(self.path_root or "", fname), "rb") as fin:
            return fin.read()

    def augmentation_transform(self, data):
        for aug in self.auglist:
            data = aug(data)
        return _to_np(data)

    def postprocess_data(self, datum):
        """HWC → CHW (ref: image.py:1242 transposes axes (2, 0, 1))."""
        a = _to_np(datum)
        if a.shape[2] != self.data_shape[0] and a.shape[2] == 1:
            a = np.repeat(a, self.data_shape[0], axis=2)
        return np.transpose(a, (2, 0, 1))
