"""Carry weights from the JAX package into the port (port-only module).

`load_jax_params` fills a port model from numpy arrays keyed by the
JAX package's structural parameter names — the keys its
``Block._collect_params_with_prefix`` gives and ``save_parameters``
writes (``embed.weight``, ``layer0.attn.qkv.weight``,
``layer0.ln1.gamma``, ..., ``head.bias``; a ResNet's
``features.4.0.body.1.running_mean``, ``output.weight``).  The port's
blocks use the same names and layouts (`Dense` weight (out, in),
`LayerNorm` gamma/beta, convolution weights (out, in/groups, *k),
BatchNorm's running stats as parameters), so the copy is one-to-one;
each array is cast to the parameter's dtype and moved to its device.

A parameter shared by two blocks (the `Transformer`'s tied source and
target embedding) has one name in the port (``named_parameters()``
gives it once) and every name in the JAX package's dict: the other
names are aliases, taken when their array equals the parameter's.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .base import MXNetError

__all__ = ["load_jax_params"]


@torch.no_grad()
def load_jax_params(net, arrays: Mapping[str, np.ndarray]):
    """Copy ``arrays`` (structural name -> numpy array) into ``net``'s
    parameters; raises `MXNetError` on a missing key, an extra key, an
    alias of a shared parameter whose array differs from the
    parameter's, or a shape mismatch, before any parameter is written.
    Returns ``net``."""
    params = dict(net.named_parameters())
    owner = {id(p): n for n, p in params.items()}
    aliases = {n: owner[id(p)] for n, p in
               net.named_parameters(remove_duplicate=False)
               if n not in params}
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params) - set(aliases))
    if missing or extra:
        raise MXNetError(f"load_jax_params: missing keys {missing}, "
                         f"extra keys {extra}")
    for name, p in params.items():
        shape = tuple(np.shape(arrays[name]))
        if shape != tuple(p.shape):
            raise MXNetError(f"load_jax_params: {name} has shape {shape}, "
                             f"the model expects {tuple(p.shape)}")
    for alias, name in aliases.items():
        if alias in arrays and not np.array_equal(arrays[alias],
                                                  arrays[name]):
            raise MXNetError(f"load_jax_params: {alias} names the parameter "
                             f"{name}, but its array differs")
    for name, p in params.items():
        src = torch.from_numpy(np.array(arrays[name], np.float32))
        p.copy_(src.to(device=p.device, dtype=p.dtype))
    return net
