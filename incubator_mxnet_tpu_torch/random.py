"""Random streams of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/random.py`).

JAX threads PRNG keys through programs; the port hands explicit
`torch.Generator` objects to whatever draws.  The module keeps one
host-side key stream per thread, as the JAX package keeps its global
key: `seed` restarts it, `next_seed` draws the 63-bit seed of one
kernel call from it (the counterpart of ``key_to_seed(next_key())``),
and the initializers draw from it too.  The stream lives on the CPU, so
drawing a seed never waits for the card; ``seed(s)`` then replays the
same dropout masks and the same initial weights.

`counter_seed` derives the seed of a counter-based stream (a request's
seed and a token position), the port's counterpart of
``jax.random.fold_in(key, t)``: the draws at one position depend on
that pair alone.
"""
from __future__ import annotations

import threading

import torch

from .context import resolve_device

__all__ = ["seed", "next_seed", "generator", "counter_seed"]

_MASK64 = (1 << 64) - 1
_SEED_HIGH = (1 << 63) - 1


class _RngState(threading.local):
    """The thread's key stream, created on first use from seed 0 (the
    JAX package's default key)."""

    def __init__(self):
        self.gen = None


_STATE = _RngState()


def generator() -> torch.Generator:
    """The calling thread's host-side key stream."""
    if _STATE.gen is None:
        _STATE.gen = torch.Generator().manual_seed(0)
    return _STATE.gen


def seed(seed_state: int, device=None) -> torch.Generator:
    """Restart the thread's key stream at ``seed_state`` (``mx.random.seed``
    parity) and return a generator on ``device`` (default ``cuda``)
    seeded with the same value, for callers that draw on the card."""
    dev = resolve_device(device)
    _STATE.gen = torch.Generator().manual_seed(int(seed_state))
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed_state))
    return g


def next_seed() -> int:
    """The next 63-bit seed of the thread's key stream — one per kernel
    call that draws (a dropout mask)."""
    return int(torch.randint(0, _SEED_HIGH, (1,), dtype=torch.int64,
                             generator=generator()))


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
