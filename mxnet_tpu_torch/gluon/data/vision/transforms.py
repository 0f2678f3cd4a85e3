"""Vision transforms.

Counterpart: ``mxnet_tpu/gluon/data/vision/transforms.py``.  ``Resize``
is the JAX package's ``jax.image.resize(..., "bilinear")``: a triangle
kernel widened by the scale when it shrinks (antialiased), weights
normalised per output pixel, applied one spatial axis at a time in
float32 (:func:`_resize_weights`), then cast back to the input's dtype;
the two sum in other orders, so float32 results agree to a few units in
the last place and a truncated uint8 result may differ by one where the
exact value is an integer.
The random transforms draw from numpy's global generator, as the JAX
package's do.
"""
from __future__ import annotations

import numpy as _np
import torch

from ....ndarray import NDArray, array as nd_array
from ...block import Block, HybridBlock
from ...nn.basic_layers import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "RandomResizedCrop",
           "Resize", "RandomFlipLeftRight", "CenterCrop"]


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def hybrid_forward(self, F, x):
        out = F.Cast(x, dtype="float32") * (1.0 / 255.0)
        return F.transpose(out, axes=(2, 0, 1)) if out.ndim == 3 else \
            F.transpose(out, axes=(0, 3, 1, 2))


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        mean = _np.asarray(self._mean, dtype="float32").reshape(-1, 1, 1)
        std = _np.asarray(self._std, dtype="float32").reshape(-1, 1, 1)
        return (x - nd_array(mean, ctx=x.context)) / \
            nd_array(std, ctx=x.context)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of the antialiased linear resize of one axis
    (``jax.image.scale_and_translate``'s weight matrix, scale n_out /
    n_in, no translation), computed in float64 as the JAX package's
    are under 64-bit mode; the caller rounds them to its dtype."""
    f64 = torch.float64
    inv = 1.0 / (n_out / n_in)
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=f64, device=device) + 0.5) * inv \
        - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f64,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(_np.finfo(_np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_axis(t: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    n_in = t.shape[axis]
    if n_in == n_out:
        return t
    w = _resize_weights(n_in, n_out, t.device).to(t.dtype)
    return torch.movedim(torch.tensordot(torch.movedim(t, axis, -1), w,
                                         dims=1), -1, axis)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        t = x._data.to(torch.float32)
        hwc = t.ndim == 3
        h_axis = 0 if hwc else 1
        out = _resize_axis(t, h_axis, self._size[0])
        out = _resize_axis(out, h_axis + 1, self._size[1])
        return NDArray.from_raw(out.to(x._data.dtype), x.context)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        h, w = x.shape[0], x.shape[1]
        th, tw = self._size
        oy, ox = max(0, (h - th) // 2), max(0, (w - tw) // 2)
        return x[oy: oy + th, ox: ox + tw]


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return x.flip(axis=1 if x.ndim == 3 else 2)
        return x


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        h, w = x.shape[0], x.shape[1]
        area = h * w
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            aspect = _np.random.uniform(*self._ratio)
            new_w = int(round((target_area * aspect) ** 0.5))
            new_h = int(round((target_area / aspect) ** 0.5))
            if new_w <= w and new_h <= h:
                ox = _np.random.randint(0, w - new_w + 1)
                oy = _np.random.randint(0, h - new_h + 1)
                crop = x[oy: oy + new_h, ox: ox + new_w]
                return Resize(self._size)(crop)
        return Resize(self._size)(CenterCrop(min(h, w))(x))
