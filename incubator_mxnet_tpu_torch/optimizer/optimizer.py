"""Optimizers of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/optimizer/optimizer.py`): the `Optimizer` base
with its learning-rate schedule (`lr_scheduler`), ``create``/
``register``, `SGD` with momentum (the BERT flagship's optimizer) and
`Adam` (the Transformer recipe's).  The other rules are a later
slice's.

An update rule is written once, over lists of tensors, with
``torch._foreach_*`` ops (`Optimizer.update_many`): the Trainer's step
runs it over every parameter at once (the counterpart of the JAX
package's one stacked update program), and the reference API's
per-parameter ``update_multi_precision`` runs it on a list of one.
Updates are in place.

Multi-precision (``multi_precision=True``) keeps an f32 master copy of
each bf16/fp16 weight in its state, updates the master and writes it
back rounded to the weight's dtype.

The scalars of a rule (learning rate, gradient rescale, weight decay,
momentum, Adam's bias-corrected rate) come from ``hyper``: Python
floats from the optimizer's attributes by default, or 0-d tensors on
the weights' device that the Trainer's update program stages each step
(`hyper_values`), as the JAX
step passes ``lr``, ``wd`` and ``rescale`` as arguments — so a captured
update reads this step's values and a new learning rate or batch size
needs no new capture.  Which terms the rule has (a weight decay, a
momentum, a clip) is fixed by `structure`, which keys the program.  Both
give the same bits: every product with a scalar is taken in f32 and
rounded once to the tensor's dtype (`_mul`).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "create", "register"]

_REG: Dict[str, type] = {}
_LOW = (torch.float16, torch.bfloat16)


def _mul(xs, s) -> list:
    """``[x * s for x in xs]``, each product taken in f32 (or wider) and
    rounded once to the tensor's dtype, for a Python float ``s`` and a
    tensor ``s`` alike.  torch's own foreach product on a bf16/fp16 list
    may round ``s`` to the list's dtype first (a tensor ``s``; a float
    ``s`` in place on the CPU), so such lists go through f32."""
    if all(x.dtype not in _LOW for x in xs):
        return torch._foreach_mul(xs, s)
    out = torch._foreach_mul([x.float() if x.dtype in _LOW else x
                              for x in xs], s)
    return [o.to(x.dtype) for o, x in zip(out, xs)]


def _mul_(xs, s) -> None:
    """``x *= s`` for every tensor of ``xs``, as `_mul`."""
    if all(x.dtype not in _LOW for x in xs):
        torch._foreach_mul_(xs, s)
    else:
        torch._foreach_copy_(xs, _mul(xs, s))


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
    """Base optimizer: learning rate (fixed, or ``lr_scheduler`` read at
    ``num_update``), weight decay, gradient rescale and clipping,
    multi-precision state.  ``num_update`` counts the steps taken; a
    step advances it before its update, as the JAX package's
    ``_update_count`` does, so the first update reads the schedule and
    the bias corrections at 1."""

    # the scalars a rule reads from ``hyper``, in `hyper_values` order
    HYPER = ("lr", "rescale_grad", "wd")

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = 0

    @property
    def learning_rate(self) -> float:
        """The rate of update ``num_update``: the schedule's, if any."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr) -> None:
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already "
                              "been defined.")
        self.lr = lr

    def hyper_values(self) -> list:
        """This step's scalars, in `HYPER` order (``lr`` from the
        schedule)."""
        return [float(self.learning_rate if k == "lr" else getattr(self, k))
                for k in self.HYPER]

    def _clip(self):
        clip = self.clip_gradient
        return None if clip is None or math.isinf(clip) else float(clip)

    def structure(self) -> tuple:
        """What the rule computes besides its scalars' values (which
        terms it has, the clip bound): a captured update is keyed on
        it."""
        return (type(self), self.wd != 0.0, self._clip())

    def _hyper(self, hyper):
        """``hyper`` (name -> value), or the attributes as floats."""
        return hyper if hyper is not None else dict(
            zip(self.HYPER, self.hyper_values()))

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
    def _prep(self, grads: List[torch.Tensor], weights: List[torch.Tensor],
              hyper) -> List[torch.Tensor]:
        """``clip(g.astype(w) * rescale) + wd * w`` for every pair, in
        fresh f32 (or weight-dtype) tensors."""
        gs = [g.to(w.dtype, copy=True) for g, w in zip(grads, weights)]
        rescale = hyper["rescale_grad"]
        if isinstance(rescale, torch.Tensor) or rescale != 1.0:
            _mul_(gs, rescale)
        clip = self._clip()
        if clip is not None:
            torch._foreach_clamp_min_(gs, -clip)
            torch._foreach_clamp_max_(gs, clip)
        if self.wd != 0.0:
            torch._foreach_add_(gs, _mul(weights, hyper["wd"]))
        return gs

    def update_many(self, weights, grads, states, hyper=None) -> None:
        """Update ``weights`` (and their states) in place from
        ``grads``; one rule over lists, its scalars from ``hyper``."""
        raise NotImplementedError

    @torch.no_grad()
    def update_all(self, weights, grads, states, hyper=None) -> None:
        """One step over ``weights``: master weights here, the rule in
        `update_many`; ``hyper`` maps `HYPER` to this step's scalars
        (default: the attributes, as floats)."""
        mp = [self._mp(w) for w in weights]
        ws = [s[0] if m else w for w, s, m in zip(weights, states, mp)]
        ss = [s[1] if m else s for s, m in zip(states, mp)]
        self.update_many(ws, grads, ss, self._hyper(hyper))
        low = [(w, s[0]) for w, s, m in zip(weights, states, mp) if m]
        if low:
            torch._foreach_copy_([w for w, _ in low], [m for _, m in low])

    def update_multi_precision(self, index, weight, grad, state):
        """Reference API: one parameter, through its f32 master when
        `create_state_multi_precision` gave it one."""
        self.num_update += 1
        self.update_all([weight], [grad], [state])

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum·mom - lr·g; w += mom``
    (``w -= lr·g`` without momentum), g as `Optimizer._prep` makes it."""

    HYPER = Optimizer.HYPER + ("momentum",)

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def structure(self) -> tuple:
        return super().structure() + (self.momentum != 0.0,)

    def update_many(self, weights, grads, states, hyper=None):
        hyper = self._hyper(hyper)
        gs = self._prep(grads, weights, hyper)
        _mul_(gs, -hyper["lr"])                               # -lr·g
        if self.momentum == 0.0:
            torch._foreach_add_(weights, gs)
            return
        _mul_(states, hyper["momentum"])
        torch._foreach_add_(states, gs)                       # new mom
        torch._foreach_add_(weights, states)


@register
class Adam(Optimizer):
    """Adam (`optimizer/optimizer.py:248-265` of the JAX package), g as
    `Optimizer._prep` makes it: ``m = β1·m + (1-β1)·g``, ``v = β2·v +
    (1-β2)·g²``, ``w -= lr_t·m / (√v + ε)`` with the bias-corrected rate
    ``lr_t = lr·√(1-β2ᵗ)/(1-β1ᵗ)`` at update t, worked out on the host
    each step (`lr_t`) and staged like the other scalars."""

    HYPER = Optimizer.HYPER + ("lr_t",)

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    @property
    def lr_t(self) -> float:
        t = max(self.num_update, 1)
        return self.learning_rate * math.sqrt(1.0 - self.beta2 ** t) \
            / (1.0 - self.beta1 ** t)

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def structure(self) -> tuple:
        return super().structure() + (self.beta1, self.beta2, self.epsilon)

    def update_many(self, weights, grads, states, hyper=None):
        hyper = self._hyper(hyper)
        gs = self._prep(grads, weights, hyper)
        ms = [s[0] for s in states]
        vs = [s[1] for s in states]
        _mul_(ms, self.beta1)
        torch._foreach_add_(ms, _mul(gs, 1.0 - self.beta1))
        _mul_(vs, self.beta2)
        torch._foreach_add_(vs, _mul(torch._foreach_mul(gs, gs),
                                     1.0 - self.beta2))
        den = torch._foreach_sqrt(vs)
        torch._foreach_add_(den, self.epsilon)
        step = _mul(ms, hyper["lr_t"])                        # lr_t·m
        torch._foreach_div_(step, den)
        torch._foreach_sub_(weights, step)
