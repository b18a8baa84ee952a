"""Gluon parameters of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/parameter.py`).

A `Parameter` is an `nn.Parameter` that also carries Gluon's
``lr_mult`` and ``wd_mult`` (the optimizer scales the learning rate and
the weight decay of this parameter by them; a new value takes effect at
the next step, and a captured update recaptures) and ``grad_req``, kept
in ``requires_grad``: ``"null"`` is ``False``;
``"write"`` and ``"add"`` are ``True``.  As in the JAX package, each
backward that reaches a ``"write"`` parameter replaces its gradient
and each one that reaches an ``"add"`` parameter adds to it; a
backward that does not reach it leaves it alone.  Torch always adds,
so a ``"write"`` parameter carries a gradient hook that drops the old
gradient just before torch stores the new one.  The hook belongs to
the parameter alone, so backwards on other threads or other models
touch no gradient but their own.  (`torch.autograd.grad`, which stores
no gradient, runs the hook too; the port's API never calls it on a
parameter.)

A hybridized block's recorded backward (`gluon.block`) does not go
through torch's gradient accumulation: it leaves each ``"write"``
parameter's gradient in its captured program's static buffer (the
parameter's ``_grad_src``), which the Trainer's update reads in place.
Reading ``p.grad`` then gives a copy of that buffer, made at the first
read after the backward, so a gradient held by Python never changes
under a later replay.  After a ``Trainer(..., keep_grads=False)`` step
has consumed such a gradient, reading it raises `MXNetError`, as the
JAX package's never-materialized gradient does; so does reading the
gradient of a chained step (`engine`), which never materializes it.

Parameters are allocated when their block is built (no deferred
shapes: every port layer is given its input width) and filled by
``initialize()``.
"""
from __future__ import annotations

import functools
import weakref

import torch
from torch import nn

from .. import initializer as init_mod
from ..base import MXNetError

__all__ = ["Parameter", "ParameterDict", "new_parameter"]

_REQS = ("write", "add", "null")
_grad = torch.Tensor.grad           # torch's own gradient slot


def _grads_not_kept():
    raise MXNetError(
        "This gradient was consumed inside a fused Trainer step and never "
        "materialized (Trainer(..., keep_grads=False)). Construct the "
        "Trainer with keep_grads=True to read p.grad() after step().")


def _write_hook(ref, grad):
    """Before torch adds ``grad`` to the parameter's gradient: under
    ``"write"``, drop the old gradient so that ``grad`` replaces it; a
    recorded program's gradient is replaced too."""
    p = ref()
    if p is None:
        return
    p._grad_src = None
    p._grad_consumed = False
    if p._req == "write" and _grad.__get__(p) is not None:
        _grad.__set__(p, None)


class Parameter(nn.Parameter):
    def __new__(cls, data, grad_req: str = "write", lr_mult: float = 1.0,
                wd_mult: float = 1.0):
        if grad_req not in _REQS:
            raise MXNetError(f"grad_req must be one of {_REQS}, got "
                             f"{grad_req!r}")
        p = super().__new__(cls, data, requires_grad=True)
        p.lr_mult = lr_mult
        p.wd_mult = wd_mult
        p._req = "add" if grad_req == "add" else "write"
        p._initialized = False
        p.init = None               # its own initializer, before the global
        p._grad_src = None          # a recorded program's gradient buffer
        p._grad_pool = None         # and that program's graph pool
        p._grad_task = -1           # the backward that set it
        p._grad_consumed = False    # taken by a keep_grads=False step
        p._pending = None           # a deferred step whose backward is
        # requested (`engine.Step`): reading the gradient runs it
        # a weak reference: the hook must not keep its parameter alive.
        # torch takes hooks only while the tensor requires grad, and
        # keeps them when grad_req turns it off and on again
        p.register_hook(functools.partial(_write_hook, weakref.ref(p)))
        p.requires_grad_(grad_req != "null")
        return p

    def set_data(self, data) -> None:
        """Write ``data`` (a tensor or array of this shape) into the
        parameter in place, in its dtype and on its device, as Gluon's
        ``Parameter.set_data``: the same object and storage, one more
        in-place version (what the int8 decode copies are keyed on)."""
        src = torch.as_tensor(data)
        if tuple(src.shape) != tuple(self.shape):
            raise MXNetError(f"set_data: shape {tuple(src.shape)} does not "
                             f"match the parameter's {tuple(self.shape)}")
        with torch.no_grad():
            self.copy_(src.to(device=self.device, dtype=self.dtype))
        self._initialized = True

    @property
    def grad(self):
        """The gradient (torch's ``.grad``); after a recorded program's
        backward, a copy of its gradient buffer (made once).  A deferred
        step whose backward reaches this parameter runs first."""
        if self._pending is not None:
            self._pending.force()
        src = self._grad_src
        if src is not None and _grad.__get__(self) is None:
            _grad.__set__(self, src.detach().clone())
        g = _grad.__get__(self)
        if g is None and self._grad_consumed:
            _grads_not_kept()
        return g

    @grad.setter
    def grad(self, value) -> None:
        self._grad_src = None
        self._grad_consumed = False
        _grad.__set__(self, value)

    def set_program_grad(self, buf, pool=None, task=-1) -> None:
        """A recorded program's backward left this parameter's gradient
        in ``buf`` (its static buffer; ``pool`` that program's graph
        pool, which an update reading ``buf`` may share; ``task`` the
        autograd graph task of that backward): it replaces the
        gradient."""
        _grad.__set__(self, None)
        self._grad_consumed = False
        self._grad_src = buf
        self._grad_pool = pool
        self._grad_task = task

    def take_grad(self):
        """The gradient an update reads, without copying: the program's
        buffer, else torch's gradient (None when there is none)."""
        g = _grad.__get__(self)
        return self._grad_src if g is None else g

    def consume_grad(self, keep: bool) -> None:
        """After an update read the gradient: with ``keep`` a copy that
        outlives the next backward, else gone (a program's gradient then
        raises on reading, as in the JAX package)."""
        if keep:
            self.grad      # materialize the program's buffer
            self._grad_src = None
        else:
            self._grad_consumed = self._grad_src is not None
            self._grad_src = None
            _grad.__set__(self, None)

    @property
    def grad_req(self) -> str:
        return self._req if self.requires_grad else "null"

    @grad_req.setter
    def grad_req(self, req: str) -> None:
        if req not in _REQS:
            raise MXNetError(f"grad_req must be one of {_REQS}, got {req!r}")
        if req != "null":
            self._req = req
        self.requires_grad_(req != "null")
        if req == "null":
            self.grad = None


def new_parameter(shape, device, dtype, grad_req: str = "write",
                  init=None) -> Parameter:
    """An uninitialized parameter (``initialize()`` or a weight loader
    fills it); ``init`` its own initializer (an instance or a name),
    which ``initialize()`` takes before the one it is given."""
    p = Parameter(torch.empty(shape, device=device, dtype=dtype), grad_req)
    p.init = init
    return p


class ParameterDict(dict):
    """Structural name -> `Parameter`, as ``Block.collect_params``
    returns it."""

    def initialize(self, init=None, force_reinit: bool = False) -> None:
        """Fill every parameter not filled yet (all of them with
        ``force_reinit``) with its own initializer (``p.init``) or else
        ``init`` (default ``Uniform(0.07)``), after the name rules of
        `initializer.Initializer`, as the JAX package does."""
        initializer = init_mod.create(init) if init is not None \
            else init_mod.Uniform()
        for name, p in self.items():
            if getattr(p, "_initialized", False) and not force_reinit:
                continue
            own = getattr(p, "init", None)
            (initializer if own is None else init_mod.create(own))(
                init_mod.InitDesc(name), p)
            p._initialized = True

    def zero_grad(self) -> None:
        for p in self.values():
            if isinstance(p, Parameter) and p._grad_consumed:
                continue
            if p.grad is not None:
                p.grad.zero_()

    def setattr(self, name: str, value) -> None:
        """Set attribute ``name`` (``grad_req``, ...) on every
        parameter."""
        for p in self.values():
            setattr(p, name, value)

    def save(self, fname: str, strip_prefix: str = "") -> None:
        """Write every parameter to a ``.params`` file under its name,
        less ``strip_prefix`` where the name starts with it."""
        from ..utils import serialization

        serialization.save_ndarrays(fname, {
            n[len(strip_prefix):] if n.startswith(strip_prefix) else n: p
            for n, p in self.items()})

    def load(self, fname: str, ctx=None, allow_missing: bool = False,
             ignore_extra: bool = False, restore_prefix: str = "") -> None:
        """Read a ``.params`` file into the parameters in place: each
        key (``arg:``/``aux:`` dropped) with ``restore_prefix`` before
        it names a parameter.  A parameter the file lacks raises
        `IOError` unless ``allow_missing``, a key no parameter takes
        unless ``ignore_extra``, as in the JAX package."""
        from ..utils import serialization

        loaded = {restore_prefix + k.removeprefix("arg:").removeprefix(
            "aux:"): v for k, v in serialization.load_ndarrays(fname).items()}
        for name, p in self.items():
            if name in loaded:
                p.set_data(loaded[name])
            elif not allow_missing:
                raise IOError(f"Parameter {name} missing in file {fname}")
        if not ignore_extra:
            extra = set(loaded) - set(self)
            if extra:
                raise IOError(f"Parameters in file not in model: "
                              f"{sorted(extra)}")
