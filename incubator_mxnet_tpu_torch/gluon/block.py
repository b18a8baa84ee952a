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
no graph.  A hybridized block's inference call replays a captured
program (`HybridBlock.hybridize`).
"""
from __future__ import annotations

import itertools
import os
import re
from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from .. import _graphs, autograd
from ..base import MXNetError
from .parameter import ParameterDict, new_parameter

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
    ``initialize``, ``cast``, ``zero_grad`` and ``hybridize``."""

    # hybridized (`HybridBlock.hybridize`), and its captured programs
    _hybrid = False
    _graph_cache = None

    def __call__(self, *args, **kwargs):
        if self._hybrid and not autograd.is_recording() \
                and not _graphs.in_body():
            return self._call_cached_op(args, kwargs)
        if torch.is_grad_enabled() and not autograd.is_recording():
            with torch.no_grad():
                return super().__call__(*args, **kwargs)
        return super().__call__(*args, **kwargs)

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
        self.to(dtype=getattr(torch, dtype)
                if isinstance(dtype, str) else dtype)
        for p in self.parameters():
            p._casts = getattr(p, "_casts", 0) + 1
        for m in self.modules():
            if isinstance(m, Block):
                m._invalidate_cached_program()
        return self

    def hybridize(self, active: bool = True, **kwargs) -> "Block":
        """Hybridize the child blocks (a plain `Block` is never captured
        itself, as in Gluon); see `HybridBlock.hybridize`."""
        for c in self.children():
            if isinstance(c, Block):
                c.hybridize(active, **kwargs)
        return self

    def _invalidate_cached_program(self) -> None:
        """Drop every captured program of this block."""
        self._graph_cache = OrderedDict()

    def _call_cached_op(self, args, kwargs):
        """The hybridized inference call: the program for this input
        signature (shapes, dtypes, device, the other arguments, the
        training flag), from the block's LRU, replayed; outputs are
        copies, since the next replay overwrites the program's."""
        key = (tuple(_arg_key(a) for a in args),
               tuple((k, _arg_key(v)) for k, v in sorted(kwargs.items())),
               autograd.is_training())
        cache = self._graph_cache
        if cache is None:
            cache = self._graph_cache = OrderedDict()
        prog = _lru_hit(cache, key)
        if prog is None:
            prog = _lru_store(cache, key, self._program(args, kwargs),
                              _AVAL_CACHE_CAP)
        inputs = {f"a{i}": a for i, a in enumerate(args)
                  if isinstance(a, torch.Tensor)}
        inputs.update((f"k_{k}", v) for k, v in kwargs.items()
                      if isinstance(v, torch.Tensor))
        sig = tuple((t.data_ptr(), t.dtype) for t in
                    itertools.chain(self.parameters(), self.buffers()))
        with prog.lock, torch.no_grad():
            out = prog.run(sig, **inputs)
            if self._graph_pool.device.type == "cuda":
                out = tuple(t.clone() for t in out)
        return out[0] if prog.single else out

    def _program(self, args, kwargs):
        """A `_graphs.Program` running ``forward`` on static copies of
        the tensor arguments (the others fixed by the signature)."""
        dev = next((a.device for a in itertools.chain(args, kwargs.values())
                    if isinstance(a, torch.Tensor)), None)
        if dev is None:
            raise MXNetError("a hybridized block takes at least one tensor "
                             "argument")
        pool = getattr(self, "_graph_pool", None)
        if pool is None or pool.device != dev:
            pool = self._graph_pool = _graphs.Pool(dev)
        fixed = [None if isinstance(a, torch.Tensor) else a for a in args]
        fixed_kw = {k: v for k, v in kwargs.items()
                    if not isinstance(v, torch.Tensor)}

        def raw_fn(**static):
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

        prog = _graphs.Program("raw_fn", raw_fn, pool)
        prog.single = False             # forward returns one tensor
        return prog


class HybridBlock(Block):
    """Gluon's hybridizable block; see `HybridBlock.hybridize`."""

    def hybridize(self, active: bool = True, **kwargs) -> "HybridBlock":
        """Capture this block's inference forward (the JAX package's
        `jax.jit` cache, its CachedOp).  Recurses into the children and
        drops every program captured before; ``cast`` drops them too.

        Hybridized, a call outside ``autograd.record()`` runs a
        `_graphs.Program` keyed on its input signature (shapes, dtypes,
        device, the non-tensor arguments and the training flag), from an
        LRU of 64 per block: on CUDA the program is captured into a CUDA
        graph at its first call and replayed after that; on the CPU it
        runs eagerly on the same static buffers.  The children run
        inside the captured forward, not as programs of their own.
        Under ``record()`` the forward stays eager (captured training
        needs the dropout seed on the card first).  A forward that would
        draw a dropout mask inside a program (train mode without
        ``record()``) raises instead of fixing one mask for every
        replay.  ``kwargs`` (static_alloc, static_shape, ...) are
        accepted for Gluon's signature."""
        self._hybrid = bool(active)
        self._invalidate_cached_program()
        super().hybridize(active, **kwargs)
        return self
