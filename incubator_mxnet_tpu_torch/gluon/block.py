"""Block base of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/block.py`, `Block` and `HybridBlock`).

A block is an `nn.Module`.  Children assigned as attributes make
``named_parameters()`` — and `collect_params()` — give the structural
parameter names of the JAX package's `_collect_params_with_prefix`
(``embed.weight``, ``layer0.attn.qkv.weight``, ``layer0.ln1.gamma``,
...), which are the keys ``save_parameters`` writes — so weights carry
across packages by name (`convert.load_jax_params`).

Calling a block follows `autograd`'s recording flag: outside
``autograd.record()`` the forward runs under `torch.no_grad` and builds
no graph.  A hybridized block's call replays captured programs, its
inference forward and, under ``record()``, its recorded forward and
backward (`HybridBlock.hybridize`).
"""
from __future__ import annotations

import itertools
import os
import re
import weakref
from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from .. import _graphs, autograd
from ..base import MXNetError
from ..telemetry import perf as _perf
from .parameter import Parameter, ParameterDict, new_parameter

# per-block LRU cap of captured programs, one per input signature (the
# JAX package's aval-spec cache cap)
_AVAL_CACHE_CAP = int(os.environ.get("MXTPU_BLOCK_AVAL_CACHE", "64"))


def _lru_hit(cache: "OrderedDict", key):
    """cache[key] refreshing recency, or None."""
    val = cache.get(key)
    if val is not None:
        cache.move_to_end(key)
    return val


def _lru_store(cache: "OrderedDict", key, val, cap: int):
    """Insert and evict least-recently-used entries beyond ``cap``."""
    cache[key] = val
    while len(cache) > cap:
        cache.popitem(last=False)
    return val


def _arg_key(a):
    """An argument's part of a program's signature: a tensor's shape,
    dtype and device, any other value itself."""
    if isinstance(a, torch.Tensor):
        return ("tensor", tuple(a.shape), a.dtype, a.device)
    return ("value", a)

__all__ = ["Block", "HybridBlock", "new_parameter"]


class Block(nn.Module):
    """Base container: `nn.Module` plus Gluon's ``collect_params``,
    ``initialize``, ``cast``, ``zero_grad``, ``hybridize``, the
    ``.params`` files (``save_parameters``/``load_parameters``) and
    Gluon's forward hooks.

    Hooks: ``register_forward_pre_hook(hook)`` calls ``hook(block,
    inputs)`` before each call and ``register_forward_hook(hook)`` calls
    ``hook(block, inputs, output)`` after it (``inputs`` the tuple of
    positional arguments), the signatures Gluon and torch share (torch's
    methods); each returns torch's handle, whose ``remove()`` removes
    that hook alone.  A hybridized block's hooks
    fire around its program's run, outside it; no hook fires inside a
    program's body (a capture, its warm-up or an eager run), so the
    children of a hybridized block fire none while it runs, as the
    children of a compiled block in the JAX package.  ``apply(fn)`` is
    torch's: ``fn`` on every child, then on the block."""

    # hybridized (`HybridBlock.hybridize`), its recorded calls
    # rematerialising, and its captured programs
    _hybrid = False
    _remat_backward = False
    _graph_cache = None

    def __call__(self, *args, **kwargs):
        body = _graphs.in_body()
        if self._hybrid and not body:
            return self._call_hybrid(args, kwargs)
        call = self.forward if body else super().__call__
        if torch.is_grad_enabled() and not autograd.is_recording():
            with torch.no_grad():
                return call(*args, **kwargs)
        return call(*args, **kwargs)

    def _call_hybrid(self, args, kwargs):
        """A hybridized call: the hooks around the program's run."""
        for hook in list(self._forward_pre_hooks.values()):
            got = hook(self, args)
            if got is not None:
                args = got if isinstance(got, tuple) else (got,)
        out = self._call_recorded(args, kwargs) if autograd.is_recording() \
            else self._call_cached_op(args, kwargs)
        for hook in list(self._forward_hooks.values()):
            got = hook(self, args, out)
            if got is not None:
                out = got
        return out

    # -- the .params files --------------------------------------------- #
    def _collect_params_with_prefix(self, prefix: str = "") -> OrderedDict:
        """Structural name -> parameter, walked as the JAX package walks
        it: the block's own parameters first, then each child in order
        under its attribute name, the first name of a key kept.  A
        parameter shared by two children (the `Transformer`'s tied
        embedding) appears under both names, where ``collect_params``
        (``named_parameters``) gives it once."""
        if prefix:
            prefix += "."
        ret: OrderedDict = OrderedDict()
        for name, p in self._parameters.items():
            if p is not None:
                ret[prefix + name] = p
        for key, child in self._modules.items():
            if isinstance(child, Block):
                for k, p in child._collect_params_with_prefix(
                        prefix + key).items():
                    ret.setdefault(k, p)
        return ret

    def save_parameters(self, filename, deduplicate: bool = False) -> None:
        """Write every parameter under its structural name (the JAX
        package's keys and bytes); ``deduplicate`` writes a shared one
        under its first name only."""
        from ..utils import serialization

        arrays, seen = OrderedDict(), set()
        for name, p in self._collect_params_with_prefix().items():
            if deduplicate and id(p) in seen:
                continue
            seen.add(id(p))
            arrays[name] = p
        serialization.save_ndarrays(filename, arrays)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False) -> None:
        """Read a ``.params`` file into the parameters in place, each in
        its own dtype and on its own device (``arg:``/``aux:`` prefixes
        dropped).  A key the block lacks raises `IOError` unless
        ``ignore_extra``, a parameter the file lacks unless
        ``allow_missing``; as in the JAX package, parameters read before
        the error keep their new values."""
        from ..utils import serialization

        loaded = serialization.load_ndarrays(filename)
        loaded = {k.removeprefix("arg:").removeprefix("aux:"): v
                  for k, v in loaded.items()}
        params = self._collect_params_with_prefix()
        for key, arr in loaded.items():
            if key in params:
                params[key].set_data(arr)
            elif not ignore_extra:
                raise IOError(f"Parameter {key} loaded from file is not "
                              f"present in the Block")
        if not allow_missing:
            missing = [k for k in params if k not in loaded]
            if missing:
                raise IOError(f"Parameters missing in file: "
                              f"{sorted(missing)}")

    save_params = save_parameters

    def load_params(self, filename, ctx=None, **kwargs) -> None:
        self.load_parameters(filename, ctx, **kwargs)

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """Structural name -> parameter, all of them or those whose name
        matches the regular expression ``select``."""
        pat = re.compile(select) if select is not None else None
        return ParameterDict((n, p) for n, p in self.named_parameters()
                             if pat is None or pat.match(n))

    def initialize(self, init=None, force_reinit: bool = False) -> "Block":
        """Fill the parameters (default ``Uniform(0.07)``, biases and
        betas 0, gammas 1) from the thread's key stream
        (`random.seed`)."""
        self.collect_params().initialize(init, force_reinit)
        return self

    def zero_grad(self) -> None:
        self.collect_params().zero_grad()

    def cast(self, dtype) -> "Block":
        """Cast every parameter (and its gradient) and buffer
        (``"bfloat16"`` or a torch dtype), as Gluon's ``Block.cast``; the
        parameters stay the same objects, so a `Trainer` built before
        keeps them.  Each parameter's ``_casts`` counts the casts, so a
        cache keyed on it (the int8 decode copies) sees a round trip
        whose new storage reuses the old address."""
        for p in self.parameters():
            if isinstance(p, Parameter):
                p._grad_consumed = False    # a cast reads every gradient
        self.to(dtype=getattr(torch, dtype)
                if isinstance(dtype, str) else dtype)
        for p in self.parameters():
            p._casts = getattr(p, "_casts", 0) + 1
        for m in self.modules():
            if isinstance(m, Block):
                m._invalidate_cached_program()
        return self

    def hybridize(self, active: bool = True, remat_backward: bool = False,
                  **kwargs) -> "Block":
        """Hybridize the child blocks (a plain `Block` is never captured
        itself, as in Gluon); see `HybridBlock.hybridize`."""
        self._remat_backward = bool(remat_backward)
        for c in self.children():
            if isinstance(c, Block):
                c.hybridize(active, remat_backward=remat_backward, **kwargs)
        return self

    def _invalidate_cached_program(self) -> None:
        """Drop every captured program of this block."""
        self._graph_cache = OrderedDict()

    def _key(self, args, kwargs, *flags):
        """A program's key: the input signature (shapes, dtypes, device,
        the other arguments), the training flag and ``flags``."""
        return (tuple(_arg_key(a) for a in args),
                tuple((k, _arg_key(v)) for k, v in sorted(kwargs.items())),
                autograd.is_training()) + flags

    def _cached(self, key, make):
        cache = self._graph_cache
        if cache is None:
            cache = self._graph_cache = OrderedDict()
        entry = _lru_hit(cache, key)
        if entry is None:
            entry = _lru_store(cache, key, make(), _AVAL_CACHE_CAP)
        return entry

    def _sig(self):
        """What a program reads besides its inputs: the weights' and
        buffers' addresses and dtypes."""
        return tuple((t.data_ptr(), t.dtype) for t in
                     itertools.chain(self.parameters(), self.buffers()))

    def _call_cached_op(self, args, kwargs):
        """The hybridized inference call: the program for this input
        signature (shapes, dtypes, device, the other arguments, the
        training flag), from the block's LRU, replayed; outputs are
        copies on every device, since the next run overwrites the
        program's (and on the CPU an output may be a view of its static
        input)."""
        prog = self._cached(self._key(args, kwargs),
                            lambda: self._program(args, kwargs))
        with prog.lock, torch.no_grad():
            out = prog.run(self._sig(), **_inputs(args, kwargs))
            out = tuple(t.clone() for t in out)
        return out[0] if prog.single else out

    def _call_recorded(self, args, kwargs):
        """The hybridized call under ``record()``: a `_Recorded` forward
        program for this signature, its outputs copies tied to the
        autograd graph by one `_RecordedFn` node whose backward replays
        the backward program.  The signature keeps a set of them: a call
        takes one whose earlier call's backward has run or whose graph
        is gone, and captures a new one (its own static buffers and
        graph pool) only while every one awaits a backward, so that no
        replay overwrites activations a pending backward reads.  A
        training loop (call, backward, step) keeps using the first."""
        need = tuple(i for i, a in enumerate(args)
                     if isinstance(a, torch.Tensor) and a.requires_grad)
        need_kw = tuple(sorted(k for k, v in kwargs.items()
                               if isinstance(v, torch.Tensor)
                               and v.requires_grad))
        targets = tuple(p.requires_grad for p in self.parameters())
        recs = self._cached(
            self._key(args, kwargs, "record", need, need_kw, targets), list)
        rec = next((r for r in recs if not r.busy()), None)
        if rec is None:
            rec = (_Remat if self._remat_backward else _Recorded)(
                self, args, kwargs, need, need_kw, own_pool=bool(recs))
            recs.append(rec)
        grad_in = [args[i] for i in need] + [kwargs[k] for k in need_kw]
        with rec.fwd.lock:
            out = _RecordedFn.apply(rec.anchor, rec, self._sig(),
                                    _inputs(args, kwargs), *grad_in)
        rec.node = weakref.ref(out[0].grad_fn)
        return out[0] if rec.fwd.single else out

    def _program(self, args, kwargs, name="raw_fn", need=(), need_kw=(),
                 own_pool=False, **program_kw):
        """A `_graphs.Program` running ``forward`` on static copies of
        the tensor arguments (the others fixed by the signature); the
        static copies at ``need`` and ``need_kw`` require a gradient.
        It captures into the block's graph pool, or with ``own_pool``
        into a new one; ``program_kw`` go to the `_graphs.Program`."""
        dev = next((a.device for a in itertools.chain(args, kwargs.values())
                    if isinstance(a, torch.Tensor)), None)
        if dev is None:
            raise MXNetError("a hybridized block takes at least one tensor "
                             "argument")
        pool = getattr(self, "_graph_pool", None)
        if own_pool:
            pool = _graphs.Pool(dev)
        elif pool is None or pool.device != dev:
            pool = self._graph_pool = _graphs.Pool(dev)
        fixed = [None if isinstance(a, torch.Tensor) else a for a in args]
        fixed_kw = {k: v for k, v in kwargs.items()
                    if not isinstance(v, torch.Tensor)}

        grad_keys = [f"a{i}" for i in need] + [f"k_{k}" for k in need_kw]

        def raw_fn(**static):
            for k in grad_keys:
                static[k].requires_grad_(True)
            call = [static[f"a{i}"] if a is None and f"a{i}" in static
                    else a for i, a in enumerate(fixed)]
            kw = dict(fixed_kw)
            kw.update((k[2:], v) for k, v in static.items()
                      if k.startswith("k_"))
            out = self.forward(*call, **kw)
            prog.single = isinstance(out, torch.Tensor)
            if prog.single:
                return (out,)
            if isinstance(out, (tuple, list)) and all(
                    isinstance(t, torch.Tensor) for t in out):
                return tuple(out)
            raise MXNetError(f"a hybridized {type(self).__name__} must "
                             f"return a tensor or a tuple of tensors")

        prog = _graphs.Program(name, raw_fn, pool, **program_kw)
        prog.single = False             # forward returns one tensor
        prog.grad_keys = grad_keys
        return prog


def _state(block) -> list:
    """The tensors of ``block`` that take no gradient (parameters with
    ``grad_req="null"``, buffers): what its forward may write in place,
    as BatchNorm writes its running stats."""
    return [t for t in itertools.chain(block.parameters(), block.buffers())
            if not t.requires_grad]


def _inputs(args, kwargs) -> dict:
    """A program's tensor inputs by name: ``a<i>`` for positional,
    ``k_<name>`` for keyword arguments."""
    inputs = {f"a{i}": a for i, a in enumerate(args)
              if isinstance(a, torch.Tensor)}
    inputs.update((f"k_{k}", v) for k, v in kwargs.items()
                  if isinstance(v, torch.Tensor))
    return inputs


class _Recorded:
    """A hybridized block's recorded call for one signature: program F
    (``fwd_record``), the forward captured with autograd on, so its
    activations, saved tensors and dropout masks live in the block's
    graph pool; and program B (``bwd_record``), the backward over F's
    autograd graph from static head gradients into static gradient
    buffers (the pattern of `torch.cuda.make_graphed_callables`).

    B differentiates the outputs of the F run it follows: F's captured
    graph on the card (F's capturing call frees its warm-up's graph and
    replays the capture for its result, so one copy of the activations
    lives at a time), which B keeps (``retain_graph``) so that memory
    stays the activations' for every replay; the eager body's graph
    outside graphs.  Parameter gradients stay in B's
    buffers (`Parameter.set_program_grad`): no copy through torch's
    gradient accumulation; ``grad_req="add"`` parameters add them in
    with one foreach add.  Where two recorded calls meet in one
    backward, the second to reach a ``"write"`` parameter adds its
    gradient to the first's, as torch's accumulation does for a block
    never hybridized."""

    def __init__(self, block, args, kwargs, need, need_kw, own_pool=False):
        self.block = block
        self.fwd = self._forward_program(block, args, kwargs, need, need_kw,
                                         own_pool)
        self.params = [p for p in block.parameters() if p.requires_grad]
        self.bwd = None
        self.pending = None         # the outputs B differentiates next
        self.node = None            # a weak reference to their graph node
        self.used = None            # which targets the backward reaches
        # the leaf that ties the outputs to the autograd graph; its own
        # gradient is never written
        self.anchor = torch.empty(0, device=self.fwd.device,
                                  requires_grad=True)

    @staticmethod
    def _forward_program(block, args, kwargs, need, need_kw, own_pool):
        return block._program(args, kwargs, "fwd_record", need, need_kw,
                              own_pool, replay_result=lambda: _state(block))

    def run_forward(self, sig, inputs):
        """F's run for one call: its outputs, carrying F's autograd
        graph."""
        with torch.enable_grad():
            return self.fwd.run(sig, **inputs)

    def busy(self) -> bool:
        """Whether the output of this instance's last call awaits its
        backward: F's next run would overwrite what that backward
        reads."""
        return self.pending is not None and self.node is not None \
            and self.node() is not None

    def _grads(self, outs, cot, retain):
        """The gradients of F's outputs ``outs`` for head gradients
        ``cot`` with respect to the parameters and the inputs that need
        one; the unused ones left out, and ``used`` checked."""
        fwd = self.fwd
        heads = [(o, cot[f"c{i}"]) for i, o in enumerate(outs)
                 if o.requires_grad]
        inputs = [fwd.static_inputs[k] for k in fwd.grad_keys]
        grads = torch.autograd.grad(
            [o for o, _ in heads], self.params + inputs,
            grad_outputs=[c for _, c in heads], allow_unused=True,
            retain_graph=retain)
        used = tuple(g is not None for g in grads)
        if self.used is None:
            self.used = used
        elif used != self.used:
            raise MXNetError("a recorded backward reached other "
                             "parameters than its first run")
        return tuple(g for g in grads if g is not None)

    def backward_program(self):
        """B, made at the first backward: its static inputs are one head
        gradient for each output of F."""
        if self.bwd is not None:
            return self.bwd
        fwd = self.fwd

        def bwd_record(**cot):
            outs = fwd.captured_outputs if _graphs.capturing() \
                else self.pending
            return self._grads(outs, cot, outs is fwd.captured_outputs)

        self.bwd = _graphs.Program("bwd_record", bwd_record, fwd._pool,
                                   static_out=True)
        return self.bwd


class _Remat(_Recorded):
    """A recorded call of a block hybridized with ``remat_backward``: the
    JAX package's `_record_remat`, which keeps no residuals between its
    forward and its backward and whose backward recomputes the forward
    inside.

    F (``fwd_remat``) runs the forward with autograd off: it keeps its
    static inputs and outputs and no activation.  B (``bwd_remat``)
    re-runs the forward with autograd on over F's static inputs and
    differentiates it into static gradient buffers, as `_Recorded`'s B
    does, so the Trainer's update reads them alike.  B reads F's seed
    table without staging it: its recomputed masks are those of the F
    run it follows (which `busy` keeps from being overwritten before the
    backward).  What the recomputed forward writes in place into tensors
    that take no gradient (BatchNorm's running stats) is put back
    (`_graphs.put_back`), as F already wrote it once.  The whole block
    is recomputed at once: B holds the full activation set as
    `_Recorded`'s B does, so the memory freed is that between F and B,
    not the step's peak."""

    @staticmethod
    def _forward_program(block, args, kwargs, need, need_kw, own_pool):
        return block._program(args, kwargs, "fwd_remat", need, need_kw,
                              own_pool)

    def run_forward(self, sig, inputs):
        # the train-mode flag of the recorded call (part of its
        # signature), which the recomputed forward runs under
        self.training = autograd.is_training()
        return self.fwd.run(sig, **inputs)

    def backward_program(self):
        if self.bwd is not None:
            return self.bwd
        fwd, block = self.fwd, self.block
        written = None              # the no-grad tensors F's body writes

        def recompute():
            with autograd.record(train_mode=self.training):
                return fwd._body(**fwd.static_inputs)

        def bwd_remat(**cot):
            nonlocal written
            first = written is None
            outs, wrote = _graphs.put_back(
                _state(block) if first else written, recompute)
            if first:
                written = wrote
            return self._grads(outs, cot, False)

        self.bwd = _graphs.Program("bwd_remat", bwd_remat, fwd._pool,
                                   static_out=True, seeds=fwd.seeds)
        return self.bwd


class _RecordedFn(torch.autograd.Function):
    """One node for a hybridized block's recorded call: the forward runs
    F and returns copies of its outputs; the backward stages the head
    gradients (zeros for an output without one), runs B, leaves the
    parameters' gradients in B's buffers and returns the inputs'."""

    @staticmethod
    def forward(ctx, anchor, rec, sig, inputs, *grad_in):
        outs = rec.run_forward(sig, inputs)
        rec.pending = outs
        ctx.rec, ctx.sig = rec, sig
        # the telemetry scopes B's run joins (autograd may run it on
        # another thread)
        ctx.scopes = _perf.current_scopes()
        ctx.shapes = [(o.shape, o.dtype, o.device) for o in outs]
        return tuple(o.detach().clone() for o in outs)

    @staticmethod
    def backward(ctx, *heads):
        rec = ctx.rec
        bwd = rec.backward_program()
        cot = {f"c{i}": h if h is not None else
               torch.zeros(s, dtype=dt, device=dev)
               for i, (h, (s, dt, dev)) in enumerate(zip(heads, ctx.shapes))}
        # what another recorded call of this backward left (B's body
        # runs the parameters' hooks, which forget it)
        task = torch._C._current_graph_task_id()
        earlier = {id(p): p.take_grad() for p in rec.params
                   if task >= 0 and getattr(p, "_grad_task", -1) == task}
        with bwd.lock, _perf.scopes_of(ctx.scopes):
            grads = bwd.run(ctx.sig, **cot)
        rec.pending = None
        it = iter(grads)
        got = [next(it) if u else None for u in rec.used]
        n_p = len(rec.params)
        adds = []
        for p, g in zip(rec.params, got[:n_p]):
            if g is None:
                continue
            if not isinstance(p, Parameter) or p._req != "write":
                adds.append((p, g))
            elif earlier.get(id(p)) is not None:
                p.grad = earlier[id(p)] + g
                p._grad_task = task
            else:
                p.set_program_grad(g, bwd.pool, task)
        _accumulate(adds)
        return (None, None, None, None) + tuple(
            None if g is None else g.clone() for g in got[n_p:])


def _accumulate(pairs) -> None:
    """``grad_req="add"``: add each program gradient into the
    parameter's own, with one foreach add."""
    have = [(p, g) for p, g in pairs if p.grad is not None]
    if have:
        torch._foreach_add_([p.grad for p, _ in have], [g for _, g in have])
    for p, g in pairs:
        if p.grad is None:
            p.grad = g.clone()


class HybridBlock(Block):
    """Gluon's hybridizable block; see `HybridBlock.hybridize`."""

    def hybridize(self, active: bool = True, remat_backward: bool = False,
                  **kwargs) -> "HybridBlock":
        """Capture this block's forward and, under ``autograd.record()``,
        its backward (the JAX package's `jax.jit` cache, its CachedOp).
        Recurses into the children and drops every program captured
        before; ``cast`` drops them too.

        Hybridized, a call runs `_graphs.Program`s keyed on its input
        signature (shapes, dtypes, device, the non-tensor arguments and
        the training flag), from an LRU of 64 per block: on CUDA each is
        captured into a CUDA graph at its first call and replayed after
        that; on the CPU it runs eagerly on the same static buffers.
        What the forward writes in place into parameters (BatchNorm's
        running stats in train mode, the JAX package's aux state) the
        program writes into their own storage: once at the capturing
        call (its warm-up runs the body; the capture records it without
        running it) and once at each replay; a train-mode program moves
        them, a predict-mode one only reads them.
        Outside ``record()`` that is the forward alone; under it, the
        recorded forward and, at ``backward()``, the backward over it,
        which leaves the parameters' gradients in static buffers that
        the Trainer's update reads (`_Recorded`), and which returns the
        gradients of tensor inputs that require one.  A recorded call
        while an earlier one's output awaits its backward runs programs
        of its own (`_call_recorded`), and the backwards' gradients add
        up.  The children run inside the captured programs, not as
        programs of their own.  Dropout in train mode (under ``record()`` or in
        ``autograd.train_mode()``) draws its seeds from the program's
        seed table, staged before every run: a fresh mask each call, the
        masks of the eager forward for the same ``random.seed``.

        ``remat_backward`` (the JAX package's long-context option): under
        ``record()`` the forward keeps no activations and the backward
        recomputes them (`_Remat`): the same gradients and, with
        dropout, the same masks, for a second forward.  It frees the
        activations only between the forward and the backward (what
        else that span allocates, or a second recorded call, finds
        them gone); the backward recomputes the whole block's set at
        once, so the peak of a step of one recorded call does not
        drop.  Outside ``record()`` it changes nothing.  ``kwargs``
        (static_alloc, static_shape, ...) are accepted for Gluon's
        signature."""
        self._hybrid = bool(active)
        self._invalidate_cached_program()
        super().hybridize(active, remat_backward=remat_backward, **kwargs)
        return self
