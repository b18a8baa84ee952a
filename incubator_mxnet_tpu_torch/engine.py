"""Deferred recorded calls: the port's counterpart of the JAX package's
`engine.LazyRef` and `gluon.block._PendingStep`.

The reference pushes every operation to an asynchronous engine and a
value exists only at a sync point.  Here, a hybridized block called
under ``autograd.record()`` whose trainable parameters all belong to a
`gluon.Trainer` that takes the one-program step
(``Trainer(..., keep_grads=False, chain_steps=K)`` with ``K > 1``)
does not run: it returns `Deferred` tensors of a `Step`.  A block called
on those outputs (a separate loss block) joins the same step instead of
running (`splice`).  ``backward()`` on a deferred head only requests the
backward.  ``Trainer.step`` then queues the whole step — the forwards,
the backward and the update — and runs K of them as one captured
program (`gluon.trainer`).

`Deferred` is a ``torch.Tensor`` wrapper subclass that holds shape,
dtype and device and no storage.  What forces and what does not:

* Metadata never forces: ``shape``, ``size()``, ``dim()``, ``ndim``,
  ``numel()``, ``dtype``, ``device``, ``is_cuda``, ``layout``,
  ``element_size()``, ``is_floating_point()``, ``requires_grad``,
  ``len()``, ``hash()`` (the names in `_META`).
* ``Tensor.backward()`` on a deferred scalar head, and
  `autograd.backward` on deferred heads with no head gradients, request
  the backward of its step without running anything (`Step.request`).
  With head gradients, ``retain_graph``, ``create_graph`` or
  ``inputs``, or on heads of two steps, they force the step and run
  torch's backward on the values.
* Every other torch function or method (arithmetic, ``item()``,
  ``detach()``, ``cpu()``, ``float()``, ``numpy()``, printing,
  indexing, ``torch.*`` functions, ``data_ptr()``, ``grad_fn``) forces
  the step through ``__torch_function__``, then runs on the real
  tensor.  An op that reaches ``__torch_dispatch__`` (torch functions
  disabled) runs on a value that is there and raises on one that is
  not.

Forcing a step that is queued in a Trainer's chain flushes the chain.
Forcing a step that was not queued yet runs it as the call would have
run outside a chain (the block's recorded programs F and B, and the
downstream blocks' own calls, on clones of the inputs taken at the
call), so its outputs carry their autograd graph and a requested
backward leaves the gradients where ``Trainer.step`` reads them.

While a Trainer holds queued steps its weights and its blocks' running
stats are stale.  Every op on such a `gluon.Parameter` other than the
metadata above (and ``data_ptr()``, ``_version``, ``requires_grad_()``,
``stride()``, which a deferred call reads) flushes every open chain
first, and so does every `_graphs.Program` run outside a body and every
draw from the thread's key stream outside a body (`random.seed`,
`random.next_seed`, `random.get_state`, `random.set_state`): a chained
step draws its dropout seeds when it runs, so seeding between steps
would reorder the masks.  The hook on `gluon.Parameter` is installed
only while a chain is open.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import weakref
from typing import List

import torch
from torch.utils import _pytree as pytree

from .base import MXNetError

__all__ = ["Deferred", "Step", "armed", "flush_all", "chain_trainers"]

_T = torch.Tensor
# metadata of a deferred tensor: read without forcing its step
_META = frozenset([
    _T.shape.__get__, _T.dtype.__get__, _T.device.__get__,
    _T.ndim.__get__, _T.layout.__get__, _T.is_cuda.__get__,
    _T.requires_grad.__get__, _T.size, _T.dim, _T.numel, _T.nelement,
    _T.element_size, _T.is_floating_point, _T.is_complex, _T.get_device,
    _T.__len__, _T.__hash__])
# a chained parameter's: also what a deferred call and the Trainer read
# of the weights (addresses, versions, flags), none of their values
_PARAM_META = _META | frozenset([
    _T.data_ptr, _T._version.__get__, _T.is_leaf.__get__,
    _T.requires_grad_, _T.requires_grad.__set__, _T.stride,
    _T.is_contiguous, _T.storage_offset, _T.grad_fn.__get__])

_local = threading.local()          # .off: deferring disarmed here
_lock = threading.RLock()           # open chains, their flushes
_open: dict = {}                    # id(trainer) -> trainer with queued steps
chain_trainers: "weakref.WeakSet" = weakref.WeakSet()


def armed() -> bool:
    """Whether a recorded call on this thread may be deferred: some
    Trainer takes the one-program step, and no step is being forced
    here."""
    return bool(chain_trainers) and not getattr(_local, "off", False)


@contextlib.contextmanager
def _disarmed():
    prev = getattr(_local, "off", False)
    _local.off = True
    try:
        yield
    finally:
        _local.off = prev


# -- open chains ---------------------------------------------------------- #
def open_chain(trainer, params) -> None:
    """``trainer`` holds queued steps over ``params`` (every parameter of
    the queued steps' blocks): mark them and install the hooks."""
    with _lock:
        for p in params:
            p._chain_open = trainer
        if not _open:
            _install(True)
        _open[id(trainer)] = trainer


def close_chain(trainer, params) -> None:
    """``trainer``'s queued steps are about to run: unmark their
    parameters, and remove the hooks when no chain is open."""
    with _lock:
        for p in params:
            if getattr(p, "_chain_open", None) is trainer:
                p._chain_open = None
        _open.pop(id(trainer), None)
        if not _open:
            _install(False)


def flush_all() -> None:
    """Run every open chain's queued steps (a read of a weight, a running
    stat or the key stream, a program's run)."""
    with _lock:
        for t in list(_open.values()):
            t.flush()


def _install(on: bool) -> None:
    from . import _graphs, random as _random
    from .gluon.parameter import Parameter

    if on:
        Parameter.__torch_function__ = classmethod(_param_torch_function)
        _graphs._before_run = _before_run
        _random._before_draw = flush_all
    else:
        if "__torch_function__" in Parameter.__dict__:
            del Parameter.__torch_function__
        _graphs._before_run = None
        _random._before_draw = None


def _before_run() -> None:
    from . import _graphs

    if not _graphs.in_body() and not _graphs.capturing():
        flush_all()


def _param_torch_function(cls, func, types, args=(), kwargs=None):
    return _run(func, args, kwargs or {})


def _run(func, args, kwargs):
    """``func`` on the real tensors: open chains flushed first where it
    is no metadata read and touches a chained parameter, deferred
    arguments forced."""
    if func in _PARAM_META:
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **kwargs)
    leaves = pytree.tree_leaves((args, kwargs))
    if _open and any(getattr(a, "_chain_open", None) is not None
                     for a in leaves if isinstance(a, torch.Tensor)
                     and not isinstance(a, Deferred)):
        flush_all()
    if any(isinstance(a, Deferred) for a in leaves):
        args, kwargs = pytree.tree_map(_value_of, (args, kwargs))
    with torch._C.DisableTorchFunctionSubclass():
        return func(*args, **kwargs)


def _value_of(a):
    return a.value() if isinstance(a, Deferred) else a


# -- the deferred tensor --------------------------------------------------- #
class Deferred(torch.Tensor):
    """Output ``pos`` of a `Step` that has not run: shape, dtype and
    device only (see the module docstring for what forces it)."""

    @staticmethod
    def __new__(cls, step, pos, shape, dtype, device):
        t = torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=dtype, device=device,
            requires_grad=dtype.is_floating_point)
        t._step, t._pos, t._value = step, pos, None
        return t

    def value(self) -> torch.Tensor:
        """The real tensor, the step forced first if it has not run."""
        if self._value is None:
            self._step.force()
        if self._value is None:
            raise MXNetError("a deferred output was not produced by its "
                             "step")
        return self._value

    def __repr__(self):
        return repr(self.value())

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        if func is _T.backward and _request_backward(*args, **kwargs):
            return None
        if func in _PARAM_META:     # not metadata of a deferred output
            args, kwargs = pytree.tree_map(_value_of, (args, kwargs))
        return _run(func, args, kwargs)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        def real(a):
            if isinstance(a, Deferred):
                if a._value is None:
                    raise MXNetError(f"{func} reached a deferred output "
                                     f"before its step ran")
                return a._value
            return a
        args, kwargs = pytree.tree_map(real, (args, kwargs or {}))
        return func(*args, **kwargs)


def _request_backward(self, gradient=None, retain_graph=None,
                      create_graph=False, inputs=None) -> bool:
    if gradient is not None or retain_graph or create_graph \
            or inputs is not None or self.numel() != 1:
        return False
    return request([self])


def request(heads) -> bool:
    """Request the backward of deferred ``heads`` (ones as their
    gradients) without running it; False where the heads do not all
    belong to one step whose backward can be deferred."""
    if not heads or not all(isinstance(h, Deferred) for h in heads):
        return False
    step = heads[0]._step
    if any(h._step is not step for h in heads):
        return False
    with _meta():
        return step.request([h._pos for h in heads])


def _lost():
    raise MXNetError("this value belonged to a chained Trainer step whose "
                     "flush failed; the step never executed (see the "
                     "raised flush error)")


# -- the step ------------------------------------------------------------- #
class _Stage:
    """One block's call in a step: its arguments as ``("in", j)`` (the
    step's input ``j``), ``("out", pos)`` (an earlier stage's output)
    or ``("fix", value)``."""

    __slots__ = ("block", "args", "kwargs", "single")

    def __init__(self, block, args, kwargs, single):
        self.block, self.args, self.kwargs = block, args, kwargs
        self.single = single

    def key(self, inputs) -> tuple:
        def k(spec):
            kind, v = spec
            if kind == "in":
                t = inputs[v]
                return ("in", tuple(t.shape), t.dtype, t.device)
            return (kind, v)
        return (id(self.block), tuple(k(a) for a in self.args),
                tuple((n, k(a)) for n, a in sorted(self.kwargs.items())))


class Step:
    """A deferred training step (the JAX package's ``_PendingStep``): the
    recorded call of a hybridized block and the calls spliced onto its
    outputs, over clones of their tensor inputs taken at the call.

    ``state``: ``"open"`` (called), ``"requested"`` (its backward
    requested), ``"queued"`` (in its Trainer's chain), ``"done"``
    (filled by a chain's run), ``"forced"`` (run as outside a chain),
    ``"lost"`` (its chain's flush failed)."""

    def __init__(self, trainer, training: bool):
        self.trainer = trainer
        self.training = training
        self.stages: List[_Stage] = []
        self.inputs: List[torch.Tensor] = []
        self.outs: List[Deferred] = []
        self.heads = None
        self.state = "open"
        self._trainable: dict = {}      # id -> trainable parameter

    # -- building --------------------------------------------------------- #
    def add_stage(self, block, args, kwargs, spec, trainable):
        """Append ``block``'s call (its output spec ``spec``: single flag
        and (shape, dtype, device) per output; ``trainable`` its
        parameters that take a gradient) and return its deferred
        outputs as the call returns them."""
        for p in trainable:
            self._trainable.setdefault(id(p), p)

        def arg(a):
            if isinstance(a, Deferred):
                return ("out", a._pos)
            if isinstance(a, torch.Tensor):
                self.inputs.append(a.detach().clone())
                return ("in", len(self.inputs) - 1)
            return ("fix", a)
        single, shapes = spec
        st = _Stage(block, tuple(arg(a) for a in args),
                    {k: arg(v) for k, v in kwargs.items()}, single)
        self.stages.append(st)
        base = len(self.outs)
        outs = [Deferred(self, base + i, s, dt, dev)
                for i, (s, dt, dev) in enumerate(shapes)]
        self.outs.extend(outs)
        return outs[0] if single else tuple(outs)

    def key(self) -> tuple:
        """What a program running this step depends on besides its input
        values: the stages, their input signatures, the train flag and
        the heads."""
        return (tuple(st.key(self.inputs) for st in self.stages),
                self.training, self.heads)

    def blocks(self) -> list:
        return list(dict.fromkeys(st.block for st in self.stages))

    def params(self) -> list:
        """Every parameter of the step's blocks, once each."""
        return list({id(p): p for b in self.blocks()
                     for p in b.parameters()}.values())

    def trainable(self) -> list:
        """The trainable parameters of the step's blocks, once each."""
        return list(self._trainable.values())

    # -- running ---------------------------------------------------------- #
    def run_stages(self, inputs) -> list:
        """Call every stage on ``inputs`` (this step's or a program's
        static copies), in order: all their outputs, flattened."""
        vals: list = []

        def arg(spec):
            kind, v = spec
            return inputs[v] if kind == "in" else vals[v] if kind == "out" \
                else v
        for st in self.stages:
            out = st.block(*[arg(a) for a in st.args],
                           **{k: arg(a) for k, a in st.kwargs.items()})
            vals.extend([out] if st.single else out)
        return vals

    def request(self, positions) -> bool:
        """Defer the backward of outputs ``positions`` (ones as their head
        gradients): False where it cannot be deferred (not open, a head
        twice, an ``"add"`` parameter)."""
        if self.state != "open" or len(set(positions)) != len(positions):
            return False
        trainable = self.trainable()
        if any(getattr(p, "_req", "write") == "add" for p in trainable):
            return False
        if not trainable:
            return False
        self.heads = tuple(sorted(positions))
        self.state = "requested"
        for p in trainable:
            p._pending = self
        return True

    def fill(self, vals) -> None:
        """The outputs of a program's run of this step."""
        for d, v in zip(self.outs, vals):
            d._value = v
        self.state = "done"
        self.inputs = []

    def lose(self) -> None:
        self.state = "lost"
        self.inputs = []

    def force(self) -> None:
        """Produce the outputs now: flush the chain that queued this step,
        or run the step as it would have run outside a chain."""
        if self.state == "queued":
            self.trainer.flush()
            return
        if self.state == "lost":
            _lost()
        if self.state not in ("open", "requested"):
            return
        from . import autograd

        flush_all()
        with _disarmed(), autograd._Scope(True, self.training):
            vals = self.run_stages(self.inputs)
        for d, v in zip(self.outs, vals):
            d._value = v
        requested = self.state == "requested"
        self.state = "forced"
        for p in self.trainable():
            if getattr(p, "_pending", None) is self:
                p._pending = None
        if self.trainer._open_step is self:
            self.trainer._open_step = None
        if requested:
            heads = [vals[i] for i in self.heads]
            torch.autograd.backward(heads, [torch.ones_like(h)
                                            for h in heads])


# -- the block side -------------------------------------------------------- #
_SPEC_CAP = 64


def _chain_trainer(params):
    """The one Trainer taking the one-program step that owns every
    parameter of ``params`` (None where there is none, or two)."""
    owner = None
    for p in params:
        ref = getattr(p, "_chain_trainer", None)
        t = ref() if ref is not None else None
        if t is None or (owner is not None and t is not owner):
            return None
        owner = t
    return owner if owner is not None and owner._defers() else None


def _out_spec(out):
    """(single, [(shape, dtype, device)]) of a call's output, or None
    where it is not a tensor or a tuple of tensors."""
    if isinstance(out, torch.Tensor):
        return True, [(out.shape, out.dtype, out.device)]
    if isinstance(out, (tuple, list)) and out and all(
            isinstance(t, torch.Tensor) for t in out):
        return False, [(t.shape, t.dtype, t.device) for t in out]
    return None


def _learn(block, key, out) -> None:
    specs = block.__dict__.setdefault("_chain_specs", {})
    if key not in specs and len(specs) >= _SPEC_CAP:
        specs.pop(next(iter(specs)))
    specs[key] = _out_spec(out)


def call_block(block, args, kwargs, call_now):
    """A block's call under ``record()`` while some Trainer takes the
    one-program step: spliced onto the step that made its deferred
    inputs, deferred as a new step, or run now (``call_now()``), its
    output spec learned for the next call of this signature (the first
    call of a signature runs, as JAX's ``eval_shape`` cannot be had).
    A call with tensors inside a list or tuple argument (a recurrent
    layer's states) runs now: a stage holds tensors only at the top
    level.  What decides reads metadata alone, with the parameters' chain hook
    off (`_meta`)."""
    if block._forward_pre_hooks or block._forward_hooks:
        return call_now()
    with _meta():
        key = block._key(args, kwargs, "defer")
        try:
            hash(key)
        except TypeError:           # an argument that no signature holds
            key = None
        leaves = list(itertools.chain(args, kwargs.values()))
        if any(isinstance(a, (list, tuple)) and _holds_tensor(a)
               for a in leaves):
            key = None              # tensors in a list (an RNN's states)
        defer = None
        if key is not None and any(isinstance(a, Deferred) for a in leaves):
            out = _splice(block, args, kwargs, key, leaves)
            if out is not None:
                return out
        elif key is not None:
            defer = _deferrable(block, key, leaves)
    if key is None:
        return call_now()
    if defer is None:
        out = call_now()
        _learn(block, key, out)
        return out
    trainer, spec, own = defer
    prev = trainer._open_step
    if prev is not None and prev.state in ("open", "requested"):
        prev.force()
    step = Step(trainer, _training())
    trainer._open_step = step
    with _meta():
        return step.add_stage(block, args, kwargs, spec, own)


def _holds_tensor(a) -> bool:
    """Whether a list or tuple argument holds a tensor, at any depth."""
    return any(isinstance(e, torch.Tensor)
               or (isinstance(e, (list, tuple)) and _holds_tensor(e))
               for e in a)


def _meta():
    """Torch functions of tensor subclasses off: what runs inside reads
    parameters' metadata only, past the chain hook."""
    return torch._C.DisableTorchFunctionSubclass()


def _deferrable(block, key, leaves):
    """(trainer, output spec, trainable parameters) where ``block``'s
    call can be deferred, else None: a hybridized block, not
    rematerialising, no input needing its gradient, its output spec
    learned, its trainable parameters all of one chaining Trainer."""
    spec = getattr(block, "_chain_specs", {}).get(key)
    if spec is None or not block._hybrid or block._remat_backward \
            or any(isinstance(a, torch.Tensor) and a.requires_grad
                   for a in leaves):
        return None
    own = [p for p in block.parameters() if p.requires_grad]
    trainer = _chain_trainer(own)
    return None if trainer is None else (trainer, spec, own)


def _splice(block, args, kwargs, key, leaves):
    """``block`` called on deferred outputs: join their step (the JAX
    package's ``_try_chain``), or None (``_CHAIN_MISS``) where the
    inputs come from two steps or from a step past its call, an input
    needs its gradient, the block rematerialises, the train flag
    differs, the block's trainable parameters are another Trainer's, or
    the call's output spec is not known yet."""
    steps = {id(a._step): a._step for a in leaves if isinstance(a, Deferred)}
    if len(steps) != 1:
        return None
    step = next(iter(steps.values()))
    if step.state != "open" or step.trainer._open_step is not step \
            or step.training != _training() or block._remat_backward:
        return None
    if any(isinstance(a, torch.Tensor) and not isinstance(a, Deferred)
           and a.requires_grad for a in leaves):
        return None
    own = [p for p in block.parameters() if p.requires_grad]
    if own and _chain_trainer(own) is not step.trainer:
        return None
    spec = getattr(block, "_chain_specs", {}).get(key)
    if spec is None:
        return None
    return step.add_stage(block, args, kwargs, spec, own)


def _training() -> bool:
    from . import autograd

    return autograd.is_training()
