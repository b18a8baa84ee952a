"""Activation blocks (counterpart of
`incubator_mxnet_tpu/gluon/nn/activations.py`): `Activation`, over
every ``act_type`` of `nd.Activation`.  The file's other blocks
(LeakyReLU, PReLU, ELU, SELU, GELU, Swish) are not ported yet."""
from __future__ import annotations

from ... import ndarray as nd
from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return nd.Activation(x, act_type=self._act_type)
