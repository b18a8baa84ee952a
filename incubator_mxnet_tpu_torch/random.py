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

Inside a captured program's body (`_graphs.Program`) `next_seed` gives
no Python int: a seed passed by value would be baked into the capture,
and every replay would draw the same mask.  It gives slot ``i`` of the
program's device seed table (`SeedTable`) instead, the port's
counterpart of the JAX package's ``step_key()`` / ``TraceKeyProvider``
keeping a program key-parametric.  Before each run or replay the program
draws its body's ``n`` seeds from the thread's stream, as the eager body
would draw them (`draw_seeds`), and stages them into the table with one
copy; so ``seed(s)`` gives the same masks in a graph, in the eager body
and in a block that was never hybridized.

`counter_seed` derives the seed of a counter-based stream (a request's
seed and a token position), the port's counterpart of
``jax.random.fold_in(key, t)``: the draws at one position depend on
that pair alone.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device

__all__ = ["seed", "next_seed", "generator", "counter_seed", "draw_seeds",
           "SeedTable", "seed_table"]

_MASK64 = (1 << 64) - 1
_SEED_HIGH = (1 << 63) - 1


class _RngState(threading.local):
    """The thread's key stream, created on first use from seed 0 (the
    JAX package's default key)."""

    def __init__(self):
        self.gen = None
        self.table = None       # the SeedTable of the body running here


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


def next_seed():
    """The next 63-bit seed of the thread's key stream — one per kernel
    call that draws (a dropout mask).  Inside a program's body: the next
    slot of its `SeedTable`, an int64 tensor of one element on the card
    (or on the CPU for a CPU program)."""
    table = _STATE.table
    if table is not None:
        return table.next()
    return _draw_one()


def _draw_one() -> int:
    return int(torch.randint(0, _SEED_HIGH, (1,), dtype=torch.int64,
                             generator=generator()))


def draw_seeds(n: int) -> np.ndarray:
    """The next ``n`` seeds of the thread's key stream, int64 — what
    ``n`` calls of `next_seed` outside a program give, in one draw (the
    CPU generator draws an (n,) randint element by element, as n draws
    of one; `tests/test_torch_train_step.py` holds it to that)."""
    return torch.randint(0, _SEED_HIGH, (n,), dtype=torch.int64,
                         generator=generator()).numpy()


class SeedTable:
    """A program's device seed table: ``n`` int64 slots, one for each
    `next_seed` its body calls, in call order.

    The first run of a body (its warm-up, or its first eager run) learns
    ``n``: each `next_seed` there draws from the thread's stream as an
    eager call would and hands the body that seed in a tensor of its
    own.  After it the table holds ``n`` slots; `stage` draws the next
    ``n`` seeds with `draw_seeds` and copies them in with one copy
    (from pinned memory, non-blocking) before each run or replay, and the body
    reads slot ``i`` at its ``i``-th `next_seed`.  A capture records the
    slots' addresses, so every replay reads the seeds staged for it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.n = None               # slots, once the first run counted
        self._slots = None
        self._i = 0

    def stage(self) -> None:
        """Draw this run's seeds and copy them into the slots."""
        if not self.n:
            return
        src = torch.from_numpy(draw_seeds(self.n))
        if self.device.type == "cuda":
            # a pinned block is not reused before its copy has run
            self._slots.copy_(src.pin_memory(), non_blocking=True)
        else:
            self._slots.copy_(src)

    def next(self) -> torch.Tensor:
        i, self._i = self._i, self._i + 1
        if self.n is None:
            return torch.tensor([_draw_one()], dtype=torch.int64,
                                device=self.device)
        if i >= self.n:
            raise MXNetError(f"a program body drew seed {i + 1}, but its "
                             f"first run drew {self.n}: a body's draws "
                             f"are fixed by its signature")
        return self._slots[i:i + 1]

    def _finish(self) -> None:
        if self.n is None:
            self.n = self._i
            if self.n:
                self._slots = torch.empty(self.n, dtype=torch.int64,
                                          device=self.device)
        elif self._i != self.n:
            raise MXNetError(f"a program body drew {self._i} seeds, its "
                             f"first run {self.n}")


@contextlib.contextmanager
def seed_table(table: "SeedTable"):
    """Run a program body with ``table`` answering `next_seed`."""
    saved, _STATE.table = _STATE.table, table
    table._i = 0
    try:
        yield
    finally:
        _STATE.table = saved
    table._finish()


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
