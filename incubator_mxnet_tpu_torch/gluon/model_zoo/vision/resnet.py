"""ResNet v1 and v2 (counterpart of
`incubator_mxnet_tpu/gluon/model_zoo/vision/resnet.py`), NCHW.

The JAX package's blocks, not torchvision's: a bottleneck v1 takes its
stride on its first 1x1 convolution and its 1x1 convolutions keep their
bias; v2 is pre-activation, with a first BatchNorm of its own
(``scale=False, center=False``) on the input.  Children and parameter
names are the JAX package's structural names (``features.0.weight``,
``features.4.0.body.1.running_mean``, ``output.weight``, ...), so
`convert.load_jax_params` carries a JAX ResNet's weights and running
stats one to one.  Every layer is given its input width (the JAX
layers infer theirs at the first forward); the input has
``in_channels`` channels (3).  The nets run on ``cuda`` unless
``device`` says otherwise.
"""
from __future__ import annotations

import torch

from .... import ndarray as nd
from ....base import MXNetError
from ....context import resolve_device
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", "resnet_spec",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


def _conv3x3(channels, stride, in_channels, **kw):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, **kw)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kw):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels, **kw))
        self.body.add(nn.BatchNorm(in_channels=channels, **kw))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, **kw))
        self.body.add(nn.BatchNorm(in_channels=channels, **kw))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels, **kw))
            self.downsample.add(nn.BatchNorm(in_channels=channels, **kw))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return nd.Activation(self.body(x) + residual, act_type="relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kw):
        super().__init__()
        mid = channels // 4
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                in_channels=in_channels, **kw))
        self.body.add(nn.BatchNorm(in_channels=mid, **kw))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid, **kw))
        self.body.add(nn.BatchNorm(in_channels=mid, **kw))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                in_channels=mid, **kw))
        self.body.add(nn.BatchNorm(in_channels=channels, **kw))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels, **kw))
            self.downsample.add(nn.BatchNorm(in_channels=channels, **kw))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return nd.Activation(self.body(x) + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kw):
        super().__init__()
        self.bn1 = nn.BatchNorm(in_channels=in_channels, **kw)
        self.conv1 = _conv3x3(channels, stride, in_channels, **kw)
        self.bn2 = nn.BatchNorm(in_channels=channels, **kw)
        self.conv2 = _conv3x3(channels, 1, channels, **kw)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, **kw) \
            if downsample else None

    def forward(self, x):
        out = nd.Activation(self.bn1(x), act_type="relu")
        residual = x if self.downsample is None else self.downsample(out)
        out = nd.Activation(self.bn2(self.conv1(out)), act_type="relu")
        return self.conv2(out) + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kw):
        super().__init__()
        mid = channels // 4
        self.bn1 = nn.BatchNorm(in_channels=in_channels, **kw)
        self.conv1 = nn.Conv2D(mid, 1, 1, use_bias=False,
                               in_channels=in_channels, **kw)
        self.bn2 = nn.BatchNorm(in_channels=mid, **kw)
        self.conv2 = _conv3x3(mid, stride, mid, **kw)
        self.bn3 = nn.BatchNorm(in_channels=mid, **kw)
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False,
                               in_channels=mid, **kw)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, **kw) \
            if downsample else None

    def forward(self, x):
        out = nd.Activation(self.bn1(x), act_type="relu")
        residual = x if self.downsample is None else self.downsample(out)
        out = nd.Activation(self.bn2(self.conv1(out)), act_type="relu")
        out = nd.Activation(self.bn3(self.conv2(out)), act_type="relu")
        return self.conv3(out) + residual


def _make_layer(block, layers, channels, stride, in_channels, kw):
    layer = nn.HybridSequential()
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels, **kw))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels, **kw))
    return layer


def _stem(features, channels, thumbnail, in_channels, kw):
    if thumbnail:
        features.add(_conv3x3(channels, 1, in_channels, **kw))
    else:
        features.add(nn.Conv2D(channels, 7, 2, 3, use_bias=False,
                               in_channels=in_channels, **kw))
        features.add(nn.BatchNorm(in_channels=channels, **kw))
        features.add(nn.Activation("relu"))
        features.add(nn.MaxPool2D(3, 2, 1))


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, in_channels=3, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        assert len(layers) == len(channels) - 1
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.features = nn.HybridSequential()
        _stem(self.features, channels[0], thumbnail, in_channels, kw)
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          1 if i == 0 else 2, channels[i],
                                          kw))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1], **kw)

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, in_channels=3, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        assert len(layers) == len(channels) - 1
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(scale=False, center=False,
                                       in_channels=in_channels, **kw))
        _stem(self.features, channels[0], thumbnail, in_channels, kw)
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          1 if i == 0 else 2, channels[i],
                                          kw))
        self.features.add(nn.BatchNorm(in_channels=channels[-1], **kw))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=channels[-1], **kw)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` (18, 34, 50, 101,
    152); ``kwargs`` go to the net (``classes``, ``thumbnail``,
    ``device``, ``dtype``).  Pretrained weights are not available, as in
    the JAX package."""
    if pretrained:
        raise MXNetError("pretrained weights unavailable (no network "
                         "egress)")
    block_type, layers, channels = resnet_spec[num_layers]
    block = resnet_block_versions[version - 1][block_type]
    return resnet_net_versions[version - 1](block, layers, channels,
                                            **kwargs)


def resnet18_v1(**kw):
    return get_resnet(1, 18, **kw)


def resnet34_v1(**kw):
    return get_resnet(1, 34, **kw)


def resnet50_v1(**kw):
    return get_resnet(1, 50, **kw)


def resnet101_v1(**kw):
    return get_resnet(1, 101, **kw)


def resnet152_v1(**kw):
    return get_resnet(1, 152, **kw)


def resnet18_v2(**kw):
    return get_resnet(2, 18, **kw)


def resnet34_v2(**kw):
    return get_resnet(2, 34, **kw)


def resnet50_v2(**kw):
    return get_resnet(2, 50, **kw)


def resnet101_v2(**kw):
    return get_resnet(2, 101, **kw)


def resnet152_v2(**kw):
    return get_resnet(2, 152, **kw)
