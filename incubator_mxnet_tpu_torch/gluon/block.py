"""Minimal block base of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/block.py`, `Block` and `HybridBlock`).

A block is an `nn.Module`.  Children assigned as attributes make
``named_parameters()`` give the structural parameter names of the JAX
package's `_collect_params_with_prefix` (``embed.weight``,
``layer0.attn.qkv.weight``, ``layer0.ln1.gamma``, ...), which are the
keys ``save_parameters`` writes — so weights carry across packages by
name (`convert.load_jax_params`).

This slice serves only: parameters are created with
``requires_grad=False``, and ``hybridize()``, deferred initialization
and autograd wait for the training slice.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Block", "HybridBlock", "new_parameter"]


def new_parameter(shape, device, dtype) -> nn.Parameter:
    """An uninitialized inference-only parameter (the owning model
    initializes it)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Block(nn.Module):
    """Base container: `nn.Module` plus the Gluon ``cast`` and the
    structural parameter names."""

    def cast(self, dtype) -> "Block":
        """Cast every parameter and buffer (``"bfloat16"`` or a torch
        dtype), as Gluon's ``Block.cast``."""
        return self.to(dtype=getattr(torch, dtype)
                       if isinstance(dtype, str) else dtype)


class HybridBlock(Block):
    """Gluon's hybridizable block.  PyTorch runs eagerly; graph capture
    comes with a later slice."""
