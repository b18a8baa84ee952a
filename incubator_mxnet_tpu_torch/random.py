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

`get_state`/`set_state` save and restore the thread's stream (its
`torch.Generator` state): since a program's `SeedTable` draws from it
before every run or replay, restoring it restores the dropout masks of
every later step, graphed or not.  `set_state` also takes the JAX
package's ``(threefry key, step counter)`` pair, which no torch stream
can replay: it seeds the stream from the pair deterministically
(`jax_pair_seed`), and `jax_pair` derives a well-formed pair from a
torch state, so that either package restores what the other saved.
Masks after such a cross-package restore do not match the other
package's: the two streams differ anyway.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device

__all__ = ["seed", "next_seed", "generator", "counter_seed", "draw_seeds",
           "SeedTable", "seed_table", "get_state", "set_state", "jax_pair",
           "jax_pair_seed"]

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


def get_state() -> torch.Tensor:
    """The thread's key stream: a copy of its generator's state (a uint8
    tensor)."""
    return generator().get_state().clone()


def set_state(state) -> None:
    """Restart the thread's key stream at ``state``: a `get_state` (a
    uint8 tensor or numpy array), or the JAX package's ``(key,
    counter)`` pair, from which the stream is seeded with
    `jax_pair_seed`."""
    if isinstance(state, tuple) and len(state) == 2:
        _STATE.gen = torch.Generator().manual_seed(jax_pair_seed(*state))
        return
    t = torch.as_tensor(np.asarray(state, dtype=np.uint8)) \
        if not isinstance(state, torch.Tensor) else state
    gen = torch.Generator()
    gen.set_state(t.to(dtype=torch.uint8, device="cpu").contiguous())
    _STATE.gen = gen


def jax_pair_seed(key, counter) -> int:
    """A 63-bit seed for the port's stream from a JAX ``(threefry key
    uint32[2], step counter)`` pair (`counter_seed` of the key's 64
    bits and the counter)."""
    k = np.asarray(key).astype(np.uint64).reshape(-1)
    bits = 0
    for word in k:
        bits = ((bits << 32) | int(word)) & _MASK64
    return counter_seed(bits, int(counter))


def jax_pair(state) -> tuple:
    """A well-formed JAX ``(key, counter)`` pair derived from a torch
    generator state: the key is two uint32 words of a hash of the
    state, the counter 0."""
    raw = np.asarray(state, dtype=np.uint8).tobytes()
    h = 0
    for i in range(0, len(raw), 8):
        h = _splitmix64(h ^ int.from_bytes(raw[i:i + 8], "little"))
    return (np.array([h >> 32, h & 0xFFFFFFFF], dtype=np.uint32), 0)


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
    slots' addresses, so every replay reads the seeds staged for it.
    Until the first `stage` the slots hold the first run's seeds.  A
    second program may read a table it does not stage (a rematerialising
    backward reads its forward's): its body then draws the masks of the
    forward's latest run."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.n = None               # slots, once the first run counted
        self._slots = None
        self._first = []            # the first run's seeds, drawn by value
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
            seed = torch.tensor([_draw_one()], dtype=torch.int64,
                                device=self.device)
            self._first.append(seed)
            return seed
        if i >= self.n:
            raise MXNetError(f"a program body drew seed {i + 1}, but its "
                             f"first run drew {self.n}: a body's draws "
                             f"are fixed by its signature")
        return self._slots[i:i + 1]

    def _finish(self) -> None:
        if self.n is None:
            self.n = self._i
            if self.n:
                # the slots start with the first run's seeds: a replay
                # before the next `stage` redraws that run's masks
                self._slots = torch.cat(self._first)
        elif self._i != self.n:
            raise MXNetError(f"a program body drew {self._i} seeds, its "
                             f"first run {self.n}")


@contextlib.contextmanager
def seed_table(table: "SeedTable"):
    """Run a program body with ``table`` answering `next_seed`."""
    saved, _STATE.table = _STATE.table, table
    table._i = 0
    table._first = []
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
