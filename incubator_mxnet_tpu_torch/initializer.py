"""Initializers of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/initializer.py`): Zero, One, Constant, Uniform,
Normal, Orthogonal, Xavier, MSRAPrelu, Bilinear, LSTMBias and Mixed,
`InitDesc`, `create` by name and the ``init`` namespace.

An initializer is called with a parameter's structural name and its
tensor and fills the tensor in place.  As in the JAX package, the name
decides before the initializer does: ``*bias``, ``*beta`` and running
means become 0, ``*gamma`` and running variances become 1, everything
else is the initializer's own weight (`Mixed` picks an initializer by
the name first).
Draws come from the thread's key stream (`random.generator`) on the
CPU in f32 and are then cast to the parameter's dtype and device, so a
seed gives the same weights on every device.  Torch's stream is not
JAX's, so a seed gives other draws than in the JAX package, from the
same distributions.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "InitDesc", "register", "create", "init"]

_REGISTRY: dict = {}


def register(cls, *aliases):
    """Register ``cls`` under its lower-cased name and ``aliases`` (the
    names `create` takes)."""
    for key in (cls.__name__,) + aliases:
        _REGISTRY[key.lower()] = cls
    return cls


class InitDesc(str):
    """A parameter's name carrying its init attributes (Gluon's
    ``InitDesc``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

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
                arr.copy_(self._weight(name, tuple(arr.shape)))

    def _weight(self, name, shape) -> torch.Tensor:
        """The weight of ``shape`` (f32 on the CPU, or anything ``copy_``
        takes)."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


def _uniform(shape, scale):
    u = torch.rand(shape, generator=_random.generator())
    return u * (2 * scale) - scale


def _normal(shape, sigma):
    return torch.randn(shape, generator=_random.generator()) * sigma


class Zero(Initializer):
    def _weight(self, name, shape):
        return torch.zeros(shape)


class One(Initializer):
    def _weight(self, name, shape):
        return torch.ones(shape)


class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _weight(self, name, shape):
        return torch.full(shape, float(self.value))


class Uniform(Initializer):
    """U(-scale, scale); the default of ``Block.initialize``."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _weight(self, name, shape):
        return _uniform(shape, self.scale)


class Normal(Initializer):
    """N(0, sigma²)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _weight(self, name, shape):
        return _normal(shape, self.sigma)


class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of the QR decomposition of
    a normal draw, shaped (out, prod(rest)): orthonormal rows where
    out <= prod(rest), orthonormal columns otherwise."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale

    def _weight(self, name, shape):
        nout, nin = shape[0], math.prod(shape[1:])
        a = torch.randn((max(nout, nin), min(nout, nin)),
                        generator=_random.generator())
        q, _ = torch.linalg.qr(a)
        q = q.T if nout < nin else q
        return (self.scale * q[:nout, :nin]).reshape(shape)


class Xavier(Initializer):
    """Uniform in ±sqrt(magnitude / factor) or normal with that deviation
    (``rnd_type="gaussian"``), the factor the fan in, out or their mean
    (each times the product of the spatial axes)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _weight(self, name, shape):
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim>=2, got {shape} for "
                             f"{name}")
        hw = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw, shape[0] * hw
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            return _uniform(shape, scale)
        return _normal(shape, scale)


class MSRAPrelu(Xavier):
    """Xavier's gaussian with magnitude 2 / (1 + slope²) (He et al.)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


class Bilinear(Initializer):
    """The bilinear upsampling kernel, for a (.., .., kh, kw) weight."""

    def _weight(self, name, shape):
        n = math.prod(shape)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(n)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        return torch.from_numpy(w.astype(np.float32).reshape(shape))


class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter (the second) at
    ``forget_bias``.  Like every initializer it yields to the name rules:
    a parameter named ``*bias`` becomes 0, as in the JAX package."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _weight(self, name, shape):
        b = torch.zeros(shape)
        n = shape[0] // 4
        b[n:2 * n] = self.forget_bias
        return b


class Mixed(Initializer):
    """The initializer of the first pattern (a regular expression matched
    at the name's start) that matches the parameter's name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = [(re.compile(p), i)
                    for p, i in zip(patterns, initializers)]

    def __call__(self, name, arr):
        for pat, ini in self.map:
            if pat.match(str(name)):
                ini(name, arr)
                return
        raise ValueError(f"parameter {name} did not match any pattern")


for _cls in (Constant, Uniform, Normal, Orthogonal, Xavier, MSRAPrelu,
             Bilinear, LSTMBias):
    register(_cls)
register(Zero, "zeros")
register(One, "ones")


def create(init, **kwargs) -> Initializer:
    """An initializer from an instance, or from its registered name
    (case-insensitive; ``"zeros"`` and ``"ones"`` too) and ``kwargs``."""
    if isinstance(init, Initializer):
        return init
    cls = _REGISTRY.get(str(init).lower())
    if cls is None:
        raise MXNetError(f"initializer {init!r} is not registered. Known: "
                         f"{sorted(_REGISTRY)}")
    return cls(**kwargs)


class init:
    """The ``mx.init.*`` namespace."""

    Zero = Zero
    One = One
    Constant = Constant
    Uniform = Uniform
    Normal = Normal
    Orthogonal = Orthogonal
    Xavier = Xavier
    MSRAPrelu = MSRAPrelu
    Bilinear = Bilinear
    LSTMBias = LSTMBias
    Mixed = Mixed
    Initializer = Initializer
    InitDesc = InitDesc
