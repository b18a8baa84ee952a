"""Single-device Gluon `Trainer` of the PyTorch/CUDA port (counterpart
of `incubator_mxnet_tpu/gluon/trainer.py`).

``step(batch_size)`` is the counterpart of the JAX package's fused
step (`_fused_step`): one pass of the optimizer's rule over every
trainable parameter at once, as ``torch._foreach_*`` ops
(`optimizer.Optimizer.update_all`), with gradients rescaled by
``1/batch_size``.  With ``fuse_step=True`` (the default) that pass is
the update program U, a `_graphs.Program` captured into a CUDA graph at
its first step and replayed after that (run eagerly on the CPU and
inside `_graphs.eager()`): its scalars (learning rate, rescale, weight
decay, momentum; Adam's bias-corrected rate) are staged into it each
step with one copy, so `set_learning_rate`, a learning-rate schedule,
Adam's step count or a new batch size takes effect without a new
capture.  It reads the gradients in place where hybridized blocks'
recorded backwards left them (`gluon.block._Recorded`), and captures
into that backward's graph pool where there is one.  Other gradients (a block never hybridized,
``grad_req="add"``, a gradient read before the step) and
``fuse_step=False`` take the same rule eagerly.

A trainable parameter the backward did not reach steps with a zero
gradient, as its zero-initialised gradient does in the JAX package.
``keep_grads=False`` frees every gradient after the step; reading one
that a recorded backward produced then raises `MXNetError`.  With
``keep_grads=True`` a gradient outlives the next backward.  A step
whose update program fails to capture raises, with the weights, the
states and the update count as they were (the JAX package's rollback).
Multi-device reduction (kvstores other than the single-device
``"device"``), meshes, ZeRO and chained steps are not ported and raise
`MXNetError`.

Each parameter's ``lr_mult``/``wd_mult`` reach the optimizer through its
``param_dict`` (index -> parameter, as the JAX Trainer sets it).  The
update program makes one pass of the rule per group of parameters with
the same multipliers (`optimizer.Optimizer.update_all`), and the groups
are part of its key, so a new multiplier recaptures (the JAX package's
``_mults_key``).

Training state: `save_states`/`load_states` write and read the JAX
package's pickle (``states`` by parameter index as numpy trees of the
state's nesting, ``num_update``, ``index_update_count``), so a file
either package wrote loads in the other; `host_states` and
`device_states` are what `utils.checkpoint.CheckpointManager` saves.
Loading copies into the state tensors in place (`restore_states`):
the update program keeps reading the same addresses.
"""
from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np
import torch

from .. import _graphs
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..optimizer.optimizer import copy_pairs_, state_pairs, state_to_host
from .parameter import ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params: Optional[dict]
                 = None, kvstore="device", keep_grads: bool = True,
                 chain_steps: int = 1, zero_stage: Optional[int] = None,
                 mesh=None, fuse_step: bool = True):
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
        self._optimizer.param_dict = dict(enumerate(plist))
        self._scale = self._optimizer.rescale_grad
        self._keep_grads = keep_grads
        self._fuse_step = fuse_step
        self._states: Dict[int, object] = {}
        self._updates = None        # the update programs (`_Update`)

    @property
    def learning_rate(self) -> float:
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr) -> None:
        """The learning rate of the following steps (a captured update
        reads it from its staged scalars: no new capture)."""
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size) -> None:
        """One optimizer update of every trainable parameter, gradients
        rescaled by ``1/batch_size``."""
        opt = self._optimizer
        opt.rescale_grad = self._scale / batch_size
        idxs = [i for i, p in enumerate(self._params) if p.requires_grad]
        # every state exists before an update program captures
        for i in idxs:
            if i not in self._states:
                self._states[i] = opt.create_state_multi_precision(
                    i, self._params[i].detach())
        weights = [self._params[i] for i in idxs]
        states = [self._states[i] for i in idxs]
        grads = [_take_grad(w) for w in weights]
        pools = _recorded_pools(weights, grads) if self._fuse_step \
            else None
        # the update counts (and with them the schedule's rate and the
        # bias corrections) advance first, as in the JAX package; a step
        # that raises leaves them as they were
        counts = (opt.num_update, dict(opt._index_update_count))
        for i in idxs:
            opt._update_count(i)
        groups = [opt.group_of(i) for i in idxs]
        try:
            if pools:
                self._fused(idxs, weights, grads, states, pools, groups)
            elif weights:
                opt.update_all(weights, [
                    g if g is not None else torch.zeros_like(w)
                    for w, g in zip(weights, grads)], states, groups=groups)
        except Exception:
            opt.num_update, opt._index_update_count = counts
            raise
        for w in weights:
            if hasattr(w, "consume_grad"):
                w.consume_grad(self._keep_grads)
            elif not self._keep_grads:
                w.grad = None

    def _fused(self, idxs, weights, grads, states, pools, groups) -> None:
        opt = self._optimizer
        # the backward's pool; its own when several backwards left them
        pool = pools.popitem()[1] if len(pools) == 1 else None
        key = (tuple(idxs), id(pool), opt.structure(), tuple(groups),
               tuple((w.data_ptr(), w.dtype) for w in weights))
        if self._updates is None or self._updates.key != key:
            self._updates = _Update(key, opt, weights, states, groups,
                                    pool or _graphs.Pool(weights[0].device))
        upd = self._updates
        upd.set_grads(grads)
        sig = tuple(0 if g is None else g.data_ptr() for g in upd.grads)
        hyper = np.asarray(opt.hyper_values(dict.fromkeys(groups)),
                           dtype=np.float32)
        if not upd.prog.will_capture(sig):
            upd.prog.run(sig, hyper=hyper)
            return
        # the capture runs the body once for real first: keep what it
        # changes, to put back if the capture fails; on the host, so that
        # the capturing step holds no second copy of the weights and
        # states on the card
        saved = [t.detach().to("cpu", copy=True) for t in upd.targets]
        try:
            upd.prog.run(sig, hyper=hyper)
        except Exception:
            with torch.no_grad():
                for t, s in zip(upd.targets, saved):
                    t.copy_(s)
            raise

    def flush(self) -> None:
        """Nothing is buffered (steps are not chained in the port); kept
        for the API."""

    # -- training state -------------------------------------------------- #
    def host_states(self) -> dict:
        """A host copy of every optimizer state (parameter index -> numpy
        tree of the state's nesting), fetched one tensor at a time."""
        return {k: state_to_host(st) for k, st in self._states.items()}

    def device_states(self) -> dict:
        """The live optimizer states (parameter index -> state), no copy:
        what `utils.checkpoint.CheckpointManager.save` snapshots on the
        device."""
        return dict(self._states)

    def save_states(self, fname) -> None:
        """Write the optimizer states and update counts to ``fname`` in
        the JAX package's pickle layout."""
        opt = self._optimizer
        blob = {"states": self.host_states(), "num_update": opt.num_update,
                "index_update_count": dict(opt._index_update_count)}
        with open(fname, "wb") as f:
            pickle.dump(blob, f)

    def load_states(self, fname) -> None:
        """Read a file `save_states` of either package wrote into the
        states in place (`restore_states`)."""
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        self.restore_states(blob["states"], blob["num_update"],
                            blob["index_update_count"])

    def restore_states(self, states: dict, num_update: int,
                       index_update_count: dict) -> None:
        """Copy host state trees (parameter index -> numpy tree) into the
        optimizer states with one copy, and set the update counts.  The
        states keep their tensors, so an update program captured over
        them reads the loaded values; a state that does not exist yet is
        made first, as a step would make it, so that a later capture
        sees it.  Every tree is checked against its state's nesting and
        shapes before anything is written."""
        opt = self._optimizer
        made, pairs = {}, []
        for k, tree in states.items():
            i = int(k)
            if not 0 <= i < len(self._params):
                raise MXNetError(f"load_states: state {k} names no "
                                 f"parameter of this Trainer "
                                 f"({len(self._params)} parameters)")
            st = self._states.get(i)
            if st is None:
                st = made[i] = opt.create_state_multi_precision(
                    i, self._params[i].detach())
            pairs += state_pairs(st, tree, f"state {i}")
        self._states.update(made)
        copy_pairs_(pairs)
        opt.num_update = int(num_update)
        opt._index_update_count = {int(k): int(v) for k, v in
                                   index_update_count.items()}


def _take_grad(w):
    """The gradient the update reads, not copied: a recorded backward's
    buffer or torch's ``.grad``; None where the backward did not reach
    ``w``."""
    take = getattr(w, "take_grad", None)
    return take() if take is not None else w.grad


def _recorded_pools(weights, grads):
    """The graph pools (by id) of the recorded backwards whose buffers
    hold every gradient (None for a weight they did not reach); None
    when a gradient is another tensor."""
    pools = {}
    for w, g in zip(weights, grads):
        if g is None:
            continue
        if g is not getattr(w, "_grad_src", None):
            return None
        pools[id(w._grad_pool)] = w._grad_pool
    return pools


def _state_tensors(state):
    """The tensors of an optimizer state (nested tuples, None)."""
    if isinstance(state, torch.Tensor):
        yield state
    elif isinstance(state, tuple):
        for s in state:
            yield from _state_tensors(s)


class _Update:
    """Update program U over one list of weights: the optimizer's rule
    (`Optimizer.update_all`, one pass per group of parameters) with this
    step's scalars read from a staged tensor, over recorded backwards'
    gradient buffers, read in place (zeros for a weight no backward
    reaches).  Where one backward left
    them all, it captures into that backward's graph pool, whose
    programs replay in the order they were captured (forward, backward,
    update), so its temporaries reuse the backward's."""

    def __init__(self, key, opt, weights, states, groups, pool):
        self.key = key
        self._weights = weights
        self._zeros = {}
        self.grads = None
        # what a step writes: the weights and every state tensor
        self.targets = list(weights) + [t for s in states
                                        for t in _state_tensors(s)]

        def update(hyper):
            opt.update_all(weights, self.grads, states, hyper, groups)
            return ()

        self.prog = _graphs.Program("update", update, pool)

    def set_grads(self, grads) -> None:
        self.grads = [g if g is not None else self._zero(i)
                      for i, g in enumerate(grads)]

    def _zero(self, i):
        z = self._zeros.get(i)
        if z is None:
            z = self._zeros[i] = torch.zeros_like(self._weights[i])
        return z
