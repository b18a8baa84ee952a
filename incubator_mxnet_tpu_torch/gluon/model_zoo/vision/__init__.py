"""Vision model zoo (counterpart of
`incubator_mxnet_tpu/gluon/model_zoo/vision/`): the ResNet v1/v2
family and ``get_model`` for its names.  The JAX package's other vision
models (lenet, alexnet, vgg, squeezenet, densenet, mobilenet,
inception) are not ported yet: ``get_model`` raises `MXNetError` for
them, and for any unknown name."""
from ....base import MXNetError
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1, resnet18_v2,
                     resnet34_v1, resnet34_v2, resnet50_v1, resnet50_v2,
                     resnet101_v1, resnet101_v2, resnet152_v1, resnet152_v2,
                     resnet_spec)

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "get_model", "get_resnet", "resnet_spec",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """The model ``name`` (a ResNet of `_models`) built with ``kwargs``
    (``classes``, ``device``, ``dtype``, ...)."""
    key = name.lower()
    if key not in _models:
        raise MXNetError(f"model {name!r} is not ported yet (ported: "
                         f"{sorted(_models)})")
    return _models[key](**kwargs)
