"""Basic layers (counterpart of
`incubator_mxnet_tpu/gluon/nn/basic_layers.py`): Sequential,
HybridSequential, Dense, Dropout, DropoutAdd, BatchNorm, LayerNorm,
Embedding and Flatten, trainable.

Parameter names and layouts are the JAX package's: `Dense` keeps
``weight`` (out, in) and ``bias`` and computes ``x @ W.T + b``, by
default over the input flattened to (N, -1) (``flatten=True``) and
with ``flatten=False`` over the last axis, as the sequence models of
the port call it; `LayerNorm` keeps ``gamma`` and ``beta`` (not torch's
weight/bias); `BatchNorm` keeps ``gamma``, ``beta`` and its running
stats ``running_mean`` and ``running_var`` as parameters with
``grad_req="null"`` (the JAX package's aux params), so ``cast`` and
`convert.load_jax_params` carry them and the Trainer skips them;
`Embedding` keeps ``weight`` (vocab, units); a sequential container
names its children ``"0"``, ``"1"``, ...  The math is
`ndarray.nn_ops`'.  Every layer is given its input width, so no
parameter waits for a first forward to learn its shape.
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import ndarray as nd
from ...base import MXNetError
from ..block import Block, HybridBlock, new_parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "DropoutAdd", "BatchNorm", "Embedding", "Flatten", "LayerNorm",
           "layer_norm"]


class _Sequence:
    """The container surface both sequential blocks share: children
    named by their position, called in order."""

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)
        return self

    def forward(self, x, *args):
        for b in self._modules.values():
            x = b(x)
        return x

    def __getitem__(self, i):
        blocks = list(self._modules.values())
        if isinstance(i, slice):
            return type(self)().add(*blocks[i])
        return blocks[i]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Sequence, Block):
    """Blocks run in order; hybridizing it hybridizes its children."""


class HybridSequential(_Sequence, HybridBlock):
    """Blocks run in order, hybridizable as one block."""


def _width(name, n):
    if not n:
        raise MXNetError(f"{name}: the port's layers are given their input "
                         f"width (in_channels / in_units); deferred shapes "
                         f"are not ported")
    return n


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
    """``y = act(x @ W.T + b)``; weight (units, in_units).  With
    ``flatten`` (the default) the input is folded to (N, in_units)
    first, else the product is over its last axis.  ``activation``
    names an `nd.Activation`."""

    def __init__(self, units, in_units, use_bias=True, *, activation=None,
                 flatten=True, device=None, dtype=torch.float32):
        super().__init__()
        self._units = units
        self._activation = activation
        self._flatten = flatten
        self.weight = new_parameter((units, _width("Dense", in_units)),
                                    device, dtype)
        self.bias = new_parameter((units,), device, dtype) \
            if use_bias else None

    def forward(self, x):
        out = nd.FullyConnected(x, self.weight, self.bias,
                                flatten=self._flatten)
        if self._activation:
            out = nd.Activation(out, act_type=self._activation)
        return out


class BatchNorm(HybridBlock):
    """`nd.BatchNorm` over ``axis``.  In train mode (``autograd.
    is_training()``, and not ``use_global_stats``) it normalizes by the
    batch's statistics and writes the new running stats into
    ``running_mean`` and ``running_var`` in place, outside autograd, as
    the JAX layer rebinds them; inside a captured program that write is
    a node of its graph, so every replay moves the stats once.  In
    predict mode it reads them.  ``scale=False`` / ``center=False``
    keep gamma (1) / beta (0) with ``grad_req="null"``."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._use_global_stats = use_global_stats
        shape = (_width("BatchNorm", in_channels),)
        self.gamma = new_parameter(shape, device, dtype,
                                   "write" if scale else "null")
        self.beta = new_parameter(shape, device, dtype,
                                  "write" if center else "null")
        self.running_mean = new_parameter(shape, device, dtype, "null")
        self.running_var = new_parameter(shape, device, dtype, "null")

    def forward(self, x):
        training = autograd.is_training()
        out, mean, var = nd.BatchNorm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, momentum=self._momentum, axis=self._axis,
            use_global_stats=self._use_global_stats, training=training)
        if training and not self._use_global_stats:
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return out


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return nd.flatten(x)


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
