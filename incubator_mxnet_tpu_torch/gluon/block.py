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
no graph.
"""
from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn

from .. import autograd
from .parameter import ParameterDict, new_parameter

__all__ = ["Block", "HybridBlock", "new_parameter"]


class Block(nn.Module):
    """Base container: `nn.Module` plus Gluon's ``collect_params``,
    ``initialize``, ``cast``, ``zero_grad`` and ``hybridize``."""

    def __call__(self, *args, **kwargs):
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
        return self

    def hybridize(self, active: bool = True, **kwargs) -> "Block":
        """Accepted for API parity and does nothing: the port runs
        eagerly, and graph capture (CUDA graphs) is a later slice's."""
        return self


class HybridBlock(Block):
    """Gluon's hybridizable block; see `Block.hybridize`."""
