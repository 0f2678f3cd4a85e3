"""Model zoo.  Counterpart: ``mxnet_tpu/gluon/model_zoo/__init__.py``."""
from . import vision
from .vision import get_model
