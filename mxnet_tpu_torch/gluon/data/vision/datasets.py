"""Vision datasets.

Counterpart: ``mxnet_tpu/gluon/data/vision/datasets.py``.  When the
canonical files are absent, MNIST / FashionMNIST / CIFAR10 synthesize
the JAX package's deterministic class-separable data (the same bytes),
so examples and tests run without a download.  Items are host
NDArrays (``mx.cpu()``).
"""
from __future__ import annotations

import gzip
import os
import struct
import numpy as _np

from ....context import cpu
from ....ndarray import array as nd_array
from .. import dataset as _ds
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _LabeledImageDataset(Dataset):
    def __init__(self, images: _np.ndarray, labels: _np.ndarray, transform=None):
        self._images = images
        self._labels = labels
        self._transform = transform

    def __len__(self):
        return len(self._images)

    def __getitem__(self, idx):
        img = nd_array(self._images[idx], ctx=cpu())
        label = int(self._labels[idx])
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class MNIST(_LabeledImageDataset):
    """ref: datasets.py MNIST — items are (HxWx1 uint8 image, int label)."""

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True, transform=None):
        root = os.path.expanduser(root)
        split = "train" if train else "t10k"
        img_path = os.path.join(root, "%s-images-idx3-ubyte.gz" % split)
        lab_path = os.path.join(root, "%s-labels-idx1-ubyte.gz" % split)
        if os.path.exists(img_path) and os.path.exists(lab_path):
            with gzip.open(lab_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                labels = _np.frombuffer(f.read(), dtype=_np.uint8)
            with gzip.open(img_path, "rb") as f:
                _, n, r, c = struct.unpack(">IIII", f.read(16))
                images = _np.frombuffer(f.read(), dtype=_np.uint8).reshape(n, r, c, 1)
        else:
            from ....io import _synthetic_mnist

            imgs, labels = _synthetic_mnist(6000 if train else 1000,
                                            seed=42 if train else 43)
            images = imgs.reshape(-1, 28, 28, 1)
        super().__init__(images, labels, transform)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


def _synthetic_cifar(n, num_classes, seed):
    rng = _np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(_np.int32)
    images = rng.randint(0, 64, size=(n, 32, 32, 3)).astype(_np.uint8)
    for cls in range(num_classes):
        mask = labels == cls
        r = (cls * 37) % 256
        g = (cls * 91) % 256
        b = (cls * 151) % 256
        images[mask, 4:28, 4:28] = _np.array([r, g, b], dtype=_np.uint8)
    return images, labels


class CIFAR10(_LabeledImageDataset):
    """ref: datasets.py CIFAR10 — items are (32x32x3 uint8, int)."""

    _num_classes = 10

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True, transform=None):
        root = os.path.expanduser(root)
        files = [os.path.join(root, "data_batch_%d.bin" % i) for i in range(1, 6)] \
            if train else [os.path.join(root, "test_batch.bin")]
        if all(os.path.exists(f) for f in files):
            data, labels = [], []
            for fname in files:
                raw = _np.fromfile(fname, dtype=_np.uint8).reshape(-1, 3073)
                labels.append(raw[:, 0])
                data.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            images = _np.concatenate(data)
            labels = _np.concatenate(labels)
        else:
            images, labels = _synthetic_cifar(5000 if train else 1000,
                                              self._num_classes,
                                              seed=44 if train else 45)
        super().__init__(images, labels, transform)


class CIFAR100(CIFAR10):
    _num_classes = 100

    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=False, transform=None):
        super().__init__(root, train, transform)


class ImageRecordDataset(_ds.RecordFileDataset):
    """Image dataset over a .rec packed by im2rec → (image HWC uint8
    NDArray, label) (ref: gluon/data/vision.py ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import image as _image
        from .... import recordio as _recordio

        record = super().__getitem__(idx)
        header, img_bytes = _recordio.unpack(record)
        label = header.label
        img = _image.imdecode(img_bytes, flag=self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(_ds.Dataset):
    """root/category/*.jpg layout → (image, category index)
    (ref: gluon/data/vision.py ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = {".jpg", ".jpeg", ".png"}
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                ext = os.path.splitext(filename)[1].lower()
                if ext not in self._exts:
                    continue
                self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from .... import image as _image

        img = _image.imread(self.items[idx][0], flag=self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
