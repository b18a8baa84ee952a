"""Basic layers of the serving slice (counterpart of
`incubator_mxnet_tpu/gluon/nn/basic_layers.py`).

Parameter names and layouts are the JAX package's: `Dense` keeps
``weight`` (out, in) and ``bias`` and computes ``x @ W.T + b``;
`LayerNorm` keeps ``gamma`` and ``beta`` (not torch's weight/bias) with
the f32 statistics of ``generation._ln``; `Embedding` keeps ``weight``
(vocab, units).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..block import HybridBlock, new_parameter

__all__ = ["Dense", "DropoutAdd", "Embedding", "LayerNorm", "layer_norm"]


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """Statistics and affine in f32, result in x.dtype — the math of
    the JAX ``generation._ln``, shared by the layer and the decode
    path."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma.float()
            + beta.float()).to(x.dtype)


class Dense(HybridBlock):
    """``y = x @ W.T + b`` over the last axis; weight (units, in_units)."""

    def __init__(self, units, in_units, use_bias=True, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._units = units
        self.weight = new_parameter((units, in_units), device, dtype)
        self.bias = new_parameter((units,), device, dtype) \
            if use_bias else None

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class LayerNorm(HybridBlock):
    def __init__(self, in_channels, epsilon=1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self.gamma = new_parameter((in_channels,), device, dtype)
        self.beta = new_parameter((in_channels,), device, dtype)

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta, self._epsilon)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = new_parameter((input_dim, output_dim), device, dtype)

    def forward(self, x):
        return self.weight[x.long()]


class DropoutAdd(HybridBlock):
    """``residual + dropout(y)``.  This slice serves only: the layer is
    the identity dropout of inference (eval mode, or rate 0); training
    with a nonzero rate waits for the dropout kernel."""

    def __init__(self, rate):
        super().__init__()
        self._rate = rate

    def forward(self, y, residual):
        if self.training and self._rate > 0:
            raise NotImplementedError(
                "DropoutAdd: training-mode dropout is not ported yet")
        return residual + y
