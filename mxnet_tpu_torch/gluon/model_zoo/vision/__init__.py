"""Model zoo, vision: the ResNet family.

Counterpart: ``mxnet_tpu/gluon/model_zoo/vision/__init__.py``.  Only
the ResNet entries are ported; AlexNet, VGG, SqueezeNet, DenseNet,
MobileNet, Inception and ResNeXt are queued (ROADMAP A12).
"""
from .resnet import *  # noqa: F401,F403
from .resnet import (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """ref: model_zoo/vision get_model."""
    name = name.lower()
    if name not in _models:
        raise ValueError("model %r not supported; options: %s"
                         % (name, sorted(_models.keys())))
    return _models[name](**kwargs)
