"""Activation blocks (counterpart of
`incubator_mxnet_tpu/gluon/nn/activations.py`): `Activation`, over
every ``act_type`` of `nd.Activation`, and LeakyReLU, PReLU, ELU, SELU,
GELU and Swish (SiLU) over `nd.LeakyReLU` and `nd.gelu`."""
from __future__ import annotations

import torch

from ... import initializer
from ... import ndarray as nd
from ...context import resolve_device
from ..block import HybridBlock, new_parameter

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish", "SiLU"]


class Activation(HybridBlock):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return nd.Activation(x, act_type=self._act_type)


class LeakyReLU(HybridBlock):
    """``x`` where x >= 0, else ``alpha·x``."""

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return nd.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope ``alpha`` per channel (axis 1),
    ``in_channels`` of them, initialized by ``alpha_initializer``
    (default ``Constant(0.25)``) whatever ``initialize()`` is given, as
    in the JAX package.  Its parameter is made on ``device`` (default
    the card)."""

    def __init__(self, alpha_initializer=None, in_channels=1, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.alpha = new_parameter(
            (in_channels,), resolve_device(device), dtype,
            init=alpha_initializer or initializer.Constant(0.25))

    def forward(self, x):
        return nd.LeakyReLU(x, gamma=self.alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return nd.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return nd.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """GELU, exact (``approximation="erf"``, the default) or the tanh
    approximation (any other value)."""

    def __init__(self, approximation="erf"):
        super().__init__()
        self._approx = approximation != "erf"

    def forward(self, x):
        return nd.gelu(x, approximate=self._approx)


class Swish(HybridBlock):
    """``x·sigmoid(beta·x)``."""

    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(x * self._beta)


SiLU = Swish
