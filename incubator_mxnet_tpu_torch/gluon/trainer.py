"""Single-device Gluon `Trainer` of the PyTorch/CUDA port (counterpart
of `incubator_mxnet_tpu/gluon/trainer.py`).

``step(batch_size)`` is the counterpart of the JAX package's fused
step (`_fused_step`): one pass of the optimizer's rule over every
trainable parameter at once, as ``torch._foreach_*`` ops
(`optimizer.Optimizer.update_all`), with gradients rescaled by
``1/batch_size``.  A trainable parameter the backward did not reach
steps with a zero gradient, as its zero-initialised gradient does in
the JAX package.  ``keep_grads=False`` frees every gradient after the
step.  Multi-device reduction (kvstores other than the single-device
``"device"``), meshes, ZeRO and chained steps are not ported and raise
`MXNetError`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params: Optional[dict]
                 = None, kvstore="device", keep_grads: bool = True,
                 chain_steps: int = 1, zero_stage: Optional[int] = None,
                 mesh=None):
        if kvstore not in (None, "device"):
            raise MXNetError(f"kvstore {kvstore!r} is not ported (the "
                             f"port's Trainer is single-device)")
        if int(chain_steps) != 1:
            raise MXNetError("chain_steps > 1 is not ported")
        if zero_stage not in (None, 0):
            raise MXNetError("ZeRO (zero_stage=1) is not ported")
        if mesh is not None:
            raise MXNetError("a device mesh is not ported")
        if isinstance(params, dict):
            # collect_params() keeps the model's order; a plain dict is
            # taken in key order, as the JAX package takes it
            plist = list(params.values()) \
                if isinstance(params, ParameterDict) \
                else [params[k] for k in sorted(params)]
        elif isinstance(params, (list, tuple)):
            plist = list(params)
        else:
            raise ValueError("First argument must be a list or dict of "
                             "Parameters")
        for p in plist:
            if not isinstance(p, torch.nn.Parameter):
                raise ValueError(f"First argument must contain Parameters, "
                                 f"got {type(p)}")
        self._params = plist
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None when "
                                 "optimizer is an instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        self._keep_grads = keep_grads
        self._states: Dict[int, object] = {}

    def step(self, batch_size) -> None:
        """One optimizer update of every trainable parameter, gradients
        rescaled by ``1/batch_size``."""
        opt = self._optimizer
        opt.rescale_grad = self._scale / batch_size
        idxs = [i for i, p in enumerate(self._params) if p.requires_grad]
        for i in idxs:
            if i not in self._states:
                self._states[i] = opt.create_state_multi_precision(
                    i, self._params[i].detach())
        weights = [self._params[i] for i in idxs]
        grads = [w.grad if w.grad is not None else torch.zeros_like(w)
                 for w in weights]
        opt.update_all(weights, grads, [self._states[i] for i in idxs])
        if not self._keep_grads:
            for w in weights:
                w.grad = None

    def flush(self) -> None:
        """Nothing is buffered (steps are not chained in the port); kept
        for the API."""
