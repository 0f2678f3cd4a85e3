"""``mx.image``: Python-side image loading and augmentation.

Counterpart: ``mxnet_tpu/image/``.  The flexible per-image pipeline
(``ImageIter``, ``ImageDetIter`` and their augmenters); the
high-throughput batch path is the native ``io.ImageRecordIter``.
"""
from .image import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from . import image, detection  # noqa: F401
