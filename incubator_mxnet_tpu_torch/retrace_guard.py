"""Runtime guard against recapture storms (the PyTorch/CUDA port of
`incubator_mxnet_tpu/retrace_guard.py`).

A captured program (`_graphs.Program`) recaptures whenever its static
signature changes: a new weight address, a new input shape for a
hybridized block, a new ``generate`` signature.  A capture costs a
device synchronisation and a warm-up run; a loop that perturbs its
signature every call turns into a capture-bound crawl without any
error.  This module makes that failure loud.

:class:`RetraceGuard` counts captures per program name while active and
raises :class:`RetraceError` when any watched name exceeds its budget.
The counts come from `_graphs`, which reports every capture by name; the
JAX package taps JAX's compile log for the same events.

Names are the only identity counted, so counting is coarse: every
engine's step program is ``serving_step``.  Budget accordingly (one
capture per program per engine, per weight signature, is legitimate) or
pass ``watch=`` to restrict counting to the program names you care
about.

Usage::

    with RetraceGuard(budget=1, watch={"serving_step"}):
        engine.submit(prompt, 32).result()
    # raises RetraceError on exit if serving_step captured twice
"""
from __future__ import annotations

import os
import threading
from collections import Counter
from typing import Dict, Iterable, Optional, Set

from . import _graphs
from .base import MXNetError

__all__ = ["RetraceError", "RetraceGuard", "DEFAULT_BUDGET", "PROGRAM_NAMES"]

DEFAULT_BUDGET = int(os.environ.get("MXTPU_RETRACE_BUDGET", "64"))

# The port's captured programs (`_graphs.Program` names)
PROGRAM_NAMES: Set[str] = {
    "raw_fn",                                   # a hybridized block's
                                                # inference forward
    "decode_prefill", "decode_step",            # lm_generate
    "beam_prefill", "beam_step",                # lm_beam_search
    "serving_step", "serving_prefill_chunk",    # continuous-batching decode
    "serving_step_kv8",                         # the int8-KV-pool program
    "serving_prefill_chunk_kv8",                # family (kv_dtype="int8")
    "serving_draft_step",                       # speculative decoding:
    "serving_draft_prefill_chunk",              # draft k-step, draft-pool
    "serving_spec_verify", "serving_spec_verify_kv8",  # chunk, verify
}


class RetraceError(MXNetError):
    """A watched program recaptured more often than its budget allows."""


class RetraceGuard:
    """Context manager that raises when captures exceed a budget.

    Parameters
    ----------
    budget : int
        Max captures allowed per watched name while the guard is active.
        Defaults to ``MXTPU_RETRACE_BUDGET`` (64).
    watch : iterable of str, optional
        If given, only these program names count toward the budget; all
        names are still tallied in :attr:`counts` for diagnosis.
    exempt : iterable of str, optional
        Names never counted toward the budget (applied after ``watch``).
    """

    def __init__(self, budget: Optional[int] = None,
                 watch: Optional[Iterable[str]] = None,
                 exempt: Iterable[str] = ()):
        self.budget = DEFAULT_BUDGET if budget is None else int(budget)
        self.watch = None if watch is None else set(watch)
        self.exempt = set(exempt)
        self.counts: Counter = Counter()
        self._lock = threading.Lock()

    def _record(self, name: str) -> None:
        with self._lock:
            self.counts[name] += 1

    def _counted(self, name: str) -> bool:
        if name in self.exempt:
            return False
        return self.watch is None or name in self.watch

    def violations(self) -> Dict[str, int]:
        """Watched names whose capture count exceeds the budget."""
        with self._lock:
            return {n: c for n, c in self.counts.items()
                    if self._counted(n) and c > self.budget}

    def check(self) -> None:
        """Raise :class:`RetraceError` if any watched name is over
        budget."""
        bad = self.violations()
        if bad:
            detail = ", ".join(f"{n}: {c} captures"
                               for n, c in sorted(bad.items()))
            raise RetraceError(
                f"recapture budget exceeded (budget={self.budget}): "
                f"{detail}. Likely causes: shape-unstable inputs (pad to "
                "fixed shapes, or generate(pad_to_bucket=True)), weights "
                "whose storage moves between calls (cast, re-quantizing), "
                "or new engines built inside the loop.  Raise "
                "MXTPU_RETRACE_BUDGET if the workload legitimately needs "
                "more captures.")

    def __enter__(self) -> "RetraceGuard":
        _graphs.subscribe_captures(self._record)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _graphs.unsubscribe_captures(self._record)
        if exc_type is None:
            self.check()
