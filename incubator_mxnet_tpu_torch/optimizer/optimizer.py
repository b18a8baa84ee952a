"""Optimizers of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/optimizer/optimizer.py`): the `Optimizer` base,
``create``/``register``, and `SGD` with momentum — the flagship's
optimizer.  The other rules are a later slice's.

An update rule is written once, over lists of tensors, with
``torch._foreach_*`` ops (`Optimizer.update_many`): the Trainer's step
runs it over every parameter at once (the counterpart of the JAX
package's one stacked update program), and the reference API's
per-parameter ``update_multi_precision`` runs it on a list of one.
Updates are in place.

Multi-precision (``multi_precision=True``) keeps an f32 master copy of
each bf16/fp16 weight in its state, updates the master and writes it
back rounded to the weight's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "create", "register"]

_REG: Dict[str, type] = {}
_LOW = (torch.float16, torch.bfloat16)


def register(cls):
    """Register an optimizer class under its lower-case name."""
    _REG[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    cls = _REG.get(str(name).lower())
    if cls is None:
        raise MXNetError(f"optimizer {name!r} is not ported "
                         f"(ported: {sorted(_REG)})")
    return cls(**kwargs)


class Optimizer:
    """Base optimizer: learning rate, weight decay, gradient rescale and
    clipping, multi-precision state."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False):
        if lr_scheduler is not None:
            raise MXNetError("lr_scheduler is not ported")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision

    # -- state ---------------------------------------------------------- #
    def create_state(self, index, weight: torch.Tensor):
        return None

    def _mp(self, weight) -> bool:
        return self.multi_precision and weight.dtype in _LOW

    def create_state_multi_precision(self, index, weight: torch.Tensor):
        """(f32 master, state of the master) for a bf16/fp16 weight under
        multi_precision; else the plain state."""
        if self._mp(weight):
            master = weight.detach().float()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # -- update --------------------------------------------------------- #
    def _prep(self, grads: List[torch.Tensor],
              weights: List[torch.Tensor]) -> List[torch.Tensor]:
        """``clip(g.astype(w) * rescale) + wd * w`` for every pair, in
        fresh f32 (or weight-dtype) tensors."""
        gs = [g.to(w.dtype, copy=True) for g, w in zip(grads, weights)]
        if self.rescale_grad != 1.0:
            torch._foreach_mul_(gs, float(self.rescale_grad))
        clip = self.clip_gradient
        if clip is not None and not math.isinf(clip):
            torch._foreach_clamp_min_(gs, -float(clip))
            torch._foreach_clamp_max_(gs, float(clip))
        if self.wd != 0.0:
            torch._foreach_add_(gs, torch._foreach_mul(weights,
                                                       float(self.wd)))
        return gs

    def update_many(self, weights, grads, states) -> None:
        """Update ``weights`` (and their states) in place from
        ``grads``; one rule over lists."""
        raise NotImplementedError

    @torch.no_grad()
    def update_all(self, weights, grads, states) -> None:
        """One step over ``weights``: master weights here, the rule in
        `update_many`."""
        mp = [self._mp(w) for w in weights]
        ws = [s[0] if m else w for w, s, m in zip(weights, states, mp)]
        ss = [s[1] if m else s for s, m in zip(states, mp)]
        self.update_many(ws, grads, ss)
        low = [(w, s[0]) for w, s, m in zip(weights, states, mp) if m]
        if low:
            torch._foreach_copy_([w for w, _ in low], [m for _, m in low])

    def update_multi_precision(self, index, weight, grad, state):
        """Reference API: one parameter, through its f32 master when
        `create_state_multi_precision` gave it one."""
        self.update_all([weight], [grad], [state])

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum·mom - lr·g; w += mom``
    (``w -= lr·g`` without momentum), g as `Optimizer._prep` makes it."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def update_many(self, weights, grads, states):
        gs = self._prep(grads, weights)
        torch._foreach_mul_(gs, -float(self.lr))              # -lr·g
        if self.momentum == 0.0:
            torch._foreach_add_(weights, gs)
            return
        torch._foreach_mul_(states, float(self.momentum))
        torch._foreach_add_(states, gs)                       # new mom
        torch._foreach_add_(weights, states)
