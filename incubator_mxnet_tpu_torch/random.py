"""Random streams of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/random.py`).

JAX threads PRNG keys through programs; the port hands explicit
`torch.Generator` objects to whatever draws.  `seed` replaces the
module-global key of the JAX package with a generator the caller owns.
`counter_seed` derives the seed of a counter-based stream (a request's
seed and a token position), the port's counterpart of
``jax.random.fold_in(key, t)``: the draws at one position depend on
that pair alone.
"""
from __future__ import annotations

import torch

from .context import resolve_device

__all__ = ["seed", "counter_seed"]

_MASK64 = (1 << 64) - 1


def seed(seed_state: int, device=None) -> torch.Generator:
    """A generator on ``device`` (default ``cuda``) seeded with
    ``seed_state``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed_state))
    return g


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def counter_seed(seed_state: int, counter: int) -> int:
    """Seed of the stream at ``counter`` of ``seed_state`` — a 63-bit
    hash of the pair, so neighbouring counters give unrelated streams."""
    h = _splitmix64(int(seed_state) & _MASK64)
    return _splitmix64(h ^ (int(counter) & _MASK64)) >> 1
