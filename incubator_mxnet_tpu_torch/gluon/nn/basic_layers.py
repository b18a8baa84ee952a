"""Basic layers (counterpart of
`incubator_mxnet_tpu/gluon/nn/basic_layers.py`): Dense, Dropout,
DropoutAdd, LayerNorm and Embedding, trainable.

Parameter names and layouts are the JAX package's: `Dense` keeps
``weight`` (out, in) and ``bias`` and computes ``x @ W.T + b`` over the
last axis (the JAX layer's ``flatten=False``, which every model of the
port uses); `LayerNorm` keeps ``gamma`` and ``beta`` (not torch's
weight/bias); `Embedding` keeps ``weight`` (vocab, units).  The math
is `ndarray.nn_ops`'.  Every layer is given its input width, so no
parameter waits for a first forward to learn its shape.
"""
from __future__ import annotations

import torch

from ... import ndarray as nd
from ..block import HybridBlock, new_parameter

__all__ = ["Dense", "Dropout", "DropoutAdd", "Embedding", "LayerNorm",
           "layer_norm"]


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """Statistics and affine in f32, result in x.dtype — the math of
    the JAX ``generation._ln``, which the decode path uses (the
    `LayerNorm` layer follows ``nd.LayerNorm`` instead)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma.float()
            + beta.float()).to(x.dtype)


class Dense(HybridBlock):
    """``y = act(x @ W.T + b)`` over the last axis; weight
    (units, in_units).  ``activation`` names an `nd.Activation`."""

    def __init__(self, units, in_units, use_bias=True, *, activation=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self._units = units
        self._activation = activation
        self.weight = new_parameter((units, in_units), device, dtype)
        self.bias = new_parameter((units,), device, dtype) \
            if use_bias else None

    def forward(self, x):
        out = nd.FullyConnected(x, self.weight, self.bias, flatten=False)
        if self._activation:
            out = nd.Activation(out, act_type=self._activation)
        return out


class LayerNorm(HybridBlock):
    def __init__(self, in_channels, epsilon=1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self.gamma = new_parameter((in_channels,), device, dtype)
        self.beta = new_parameter((in_channels,), device, dtype)

    def forward(self, x):
        return nd.LayerNorm(x, self.gamma, self.beta, eps=self._epsilon)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = new_parameter((input_dim, output_dim), device, dtype)

    def forward(self, x):
        return nd.Embedding(x, self.weight)


class Dropout(HybridBlock):
    """`nd.Dropout` at ``rate``: active inside ``autograd.record()`` (or
    ``train_mode()``), the identity outside."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return nd.Dropout(x, p=self._rate, axes=self._axes)


class DropoutAdd(HybridBlock):
    """``residual + dropout(y)`` (`nd.DropoutAdd`), with the same mask
    kernel and train-mode rule as `Dropout`."""

    def __init__(self, rate):
        super().__init__()
        self._rate = rate

    def forward(self, y, residual):
        return nd.DropoutAdd(y, residual, p=self._rate)
