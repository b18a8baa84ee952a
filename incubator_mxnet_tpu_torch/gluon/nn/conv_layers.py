"""Convolution and pooling layers (counterpart of
`incubator_mxnet_tpu/gluon/nn/conv_layers.py`): Conv1D/2D/3D, their
transposes Conv1D/2D/3DTranspose, the max, average and global pools in
1-, 2- and 3-D, channels first (NCW, NCHW, NCDHW), over
`nd.Convolution`, `nd.Deconvolution` and `nd.Pooling` (cuDNN and
torch's pooling kernels on the card, as the JAX package leaves them to
XLA), and ReflectionPad2D.

Parameter names and layouts are the JAX package's: ``weight`` (out,
in/groups, *kernel) and ``bias`` (out,); a transposed convolution's
``weight`` is (in, out/groups, *kernel).  A convolution is given its
input width (``in_channels``): the port has no deferred shapes.  The
transposed convolutions make their parameters on ``device`` (default
the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import ndarray as nd
from ...base import MXNetError
from ...context import resolve_device
from ..block import HybridBlock, new_parameter
from .basic_layers import _width

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "ReflectionPad2D",
           "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _layout(layout, ndim):
    if layout != _LAYOUTS[ndim]:
        raise MXNetError(f"layout {layout!r} is not ported "
                         f"({_LAYOUTS[ndim]} only)")


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, ndim=2, device=None, dtype=torch.float32):
        super().__init__()
        _layout(layout, ndim)
        self._channels = channels
        self._kernel = _tuple(kernel_size, ndim)
        self._strides = _tuple(strides, ndim)
        self._padding = _tuple(padding, ndim)
        self._dilation = _tuple(dilation, ndim)
        self._groups = groups
        self._activation = activation
        cin = _width(type(self).__name__, in_channels)
        self.weight = new_parameter((channels, cin // groups) + self._kernel,
                                    device, dtype)
        self.bias = new_parameter((channels,), device, dtype) \
            if use_bias else None

    def forward(self, x):
        out = nd.Convolution(x, self.weight, self.bias, kernel=self._kernel,
                             stride=self._strides, dilate=self._dilation,
                             pad=self._padding, num_filter=self._channels,
                             num_group=self._groups)
        if self._activation:
            out = nd.Activation(out, act_type=self._activation)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", in_channels=0,
                 activation=None, use_bias=True, *, device=None,
                 dtype=torch.float32):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         1, device, dtype)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 in_channels=0, activation=None, use_bias=True, *,
                 device=None, dtype=torch.float32):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         2, device, dtype)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", in_channels=0, activation=None,
                 use_bias=True, *, device=None, dtype=torch.float32):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         3, device, dtype)


class _ConvTranspose(HybridBlock):
    """A transposed convolution (`nd.Deconvolution`): ``weight`` (in,
    out/groups, *kernel), ``bias`` (out,); ``output_padding`` adds to
    each output axis' far end."""

    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, in_channels=0,
                 activation=None, use_bias=True, ndim=2, device=None,
                 dtype=torch.float32):
        super().__init__()
        _layout(layout, ndim)
        self._channels = channels
        self._kernel = _tuple(kernel_size, ndim)
        self._strides = _tuple(strides, ndim)
        self._padding = _tuple(padding, ndim)
        self._output_padding = _tuple(output_padding, ndim)
        self._dilation = _tuple(dilation, ndim)
        self._groups = groups
        self._activation = activation
        dev = resolve_device(device)
        cin = _width(type(self).__name__, in_channels)
        self.weight = new_parameter((cin, channels // groups) + self._kernel,
                                    dev, dtype)
        self.bias = new_parameter((channels,), dev, dtype) \
            if use_bias else None

    def forward(self, x):
        out = nd.Deconvolution(x, self.weight, self.bias,
                               kernel=self._kernel, stride=self._strides,
                               dilate=self._dilation, pad=self._padding,
                               adj=self._output_padding,
                               num_filter=self._channels,
                               num_group=self._groups,
                               no_bias=self.bias is None)
        if self._activation:
            out = nd.Activation(out, act_type=self._activation)
        return out


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 in_channels=0, activation=None, use_bias=True, *,
                 device=None, dtype=torch.float32):
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         in_channels, activation, use_bias, 1, device, dtype)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", in_channels=0, activation=None,
                 use_bias=True, *, device=None, dtype=torch.float32):
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         in_channels, activation, use_bias, 2, device, dtype)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", in_channels=0,
                 activation=None, use_bias=True, *, device=None,
                 dtype=torch.float32):
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         in_channels, activation, use_bias, 3, device, dtype)


class ReflectionPad2D(HybridBlock):
    """NCHW padded by reflection (the edge not repeated): ``padding`` an
    int for every side of H and W, or MXNet's ``pad_width``, (before,
    after) for each of N, C, H and W, those of N and C zero."""

    def __init__(self, padding=0):
        super().__init__()
        pw = (0, 0, 0, 0) + (padding,) * 4 if isinstance(padding, int) \
            else tuple(padding)
        if len(pw) != 8 or any(pw[:4]):
            raise MXNetError(f"ReflectionPad2D: padding {padding!r} (an int "
                             f"or 8 widths, none on N or C)")
        self._pad = (pw[6], pw[7], pw[4], pw[5])

    def forward(self, x):
        return F.pad(x, self._pad, mode="reflect")


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=True, ndim=2):
        super().__init__()
        _layout(layout, ndim)
        self._kernel = _tuple(pool_size, ndim) if pool_size else None
        self._strides = None if global_pool else _tuple(
            strides if strides is not None else pool_size, ndim)
        self._padding = None if global_pool else _tuple(padding, ndim)
        self._ceil = ceil_mode
        self._global = global_pool
        self._type = pool_type
        self._count_include_pad = count_include_pad

    def forward(self, x):
        return nd.Pooling(x, kernel=self._kernel, pool_type=self._type,
                          stride=self._strides, pad=self._padding,
                          global_pool=self._global,
                          pooling_convention="full" if self._ceil
                          else "valid",
                          count_include_pad=self._count_include_pad)


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(pool_size, strides, padding, ceil_mode, False, "max",
                         layout, ndim=1)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, ceil_mode, False, "max",
                         layout, ndim=2)


class MaxPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, ceil_mode, False, "max",
                         layout, ndim=3)


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, ceil_mode, False, "avg",
                         layout, count_include_pad, ndim=1)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, ceil_mode, False, "avg",
                         layout, count_include_pad, ndim=2)


class AvgPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, ceil_mode, False, "avg",
                         layout, count_include_pad, ndim=3)


class GlobalMaxPool1D(_Pool):
    def __init__(self, layout="NCW"):
        super().__init__(None, None, None, False, True, "max", layout, ndim=1)


class GlobalMaxPool2D(_Pool):
    def __init__(self, layout="NCHW"):
        super().__init__(None, None, None, False, True, "max", layout, ndim=2)


class GlobalMaxPool3D(_Pool):
    def __init__(self, layout="NCDHW"):
        super().__init__(None, None, None, False, True, "max", layout, ndim=3)


class GlobalAvgPool1D(_Pool):
    def __init__(self, layout="NCW"):
        super().__init__(None, None, None, False, True, "avg", layout, ndim=1)


class GlobalAvgPool2D(_Pool):
    def __init__(self, layout="NCHW"):
        super().__init__(None, None, None, False, True, "avg", layout, ndim=2)


class GlobalAvgPool3D(_Pool):
    def __init__(self, layout="NCDHW"):
        super().__init__(None, None, None, False, True, "avg", layout, ndim=3)
