"""Initializers of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/initializer.py`): what a BERT model's default
``initialize()`` uses.

An initializer is called with a parameter's structural name and its
tensor and fills the tensor in place.  As in the JAX package, the name
decides before the initializer does: ``*bias``, ``*beta`` and running
means become 0, ``*gamma`` and running variances become 1, everything
else is the initializer's own draw.
Draws come from the thread's key stream (`random.generator`) on the
CPU in f32 and are then cast to the parameter's dtype and device, so a
seed gives the same weights on every device.
"""
from __future__ import annotations

import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Uniform", "create"]


class Initializer:
    def __call__(self, name: str, arr: torch.Tensor) -> None:
        name = str(name)
        with torch.no_grad():
            if name.endswith("bias"):
                arr.zero_()
            elif name.endswith("gamma") or "moving_var" in name \
                    or "running_var" in name:
                arr.fill_(1.0)
            elif name.endswith("beta") or "moving_mean" in name \
                    or "running_mean" in name:
                arr.zero_()
            else:
                arr.copy_(self._draw(tuple(arr.shape)))

    def _draw(self, shape) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class Uniform(Initializer):
    """U(-scale, scale); the default of ``Block.initialize``."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _draw(self, shape):
        u = torch.rand(shape, generator=_random.generator())
        return u * (2 * self.scale) - self.scale


def create(init) -> Initializer:
    """An initializer from an instance or its name."""
    if isinstance(init, Initializer):
        return init
    if str(init).lower() == "uniform":
        return Uniform()
    raise MXNetError(f"initializer {init!r} is not ported (ported: "
                     f"uniform)")
