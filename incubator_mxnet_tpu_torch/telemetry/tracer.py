"""Step-span tracer: nested host-side spans grouped into per-step traces
(the port of `incubator_mxnet_tpu/telemetry/tracer.py`).

``span("fwd")`` is a context manager *and* a decorator.  Spans nest via
a thread-local stack; each finished span records its parent, depth, and
the step index active when it opened, and lands in a bounded ring
buffer (`MXTPU_TELEMETRY_SPAN_BUF` spans, default 16384) so a long run
never grows host memory unboundedly.

Bridging: while a ``torch.profiler`` session records, span enter/exit
also wraps a ``torch.profiler.record_function(name)`` range, so the host
span appears in the profiler's trace next to the kernels it launched
(the JAX package's ``jax.profiler.TraceAnnotation``).  A span on another
thread than the session's (the serving scheduler's) is recorded when the
session profiles all threads (``experimental_config=
torch._C._profiler._ExperimentalConfig(profile_all_threads=True)``).  The range is
entered only then: it costs a dispatcher call that is not paid
otherwise.  The port has no ``mx.profiler`` yet, so spans are not
mirrored into one.

Disabled path: `span()` returns a fresh no-op context manager — one
module-flag read, no clock read, no stack mutation.
"""
from __future__ import annotations

import functools
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from . import registry as _registry

__all__ = ["span", "spans", "clear", "current_step", "mark_step",
           "SpanRecord"]

_SPAN_BUF = int(os.environ.get("MXTPU_TELEMETRY_SPAN_BUF", "16384"))

_tls = threading.local()
_finished: deque = deque(maxlen=_SPAN_BUF)
_finished_lock = threading.Lock()
_step = 0  # advanced by mark_step (Trainer.step); shared across threads
_step_lock = threading.Lock()
# called on every mark_step; set by telemetry.__init__ for interval dumps
_on_step: Optional[Callable[[int], None]] = None


class SpanRecord:
    """One finished span (times from time.perf_counter, seconds)."""

    __slots__ = ("name", "t0", "dur", "depth", "parent", "step", "tid")

    def __init__(self, name, t0, dur, depth, parent, step, tid):
        self.name = name
        self.t0 = t0
        self.dur = dur
        self.depth = depth
        self.parent = parent
        self.step = step
        self.tid = tid

    def as_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "dur": self.dur,
                "depth": self.depth, "parent": self.parent,
                "step": self.step, "tid": self.tid}

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, step={self.step}, "
                f"depth={self.depth}, dur={self.dur:.6f})")


def _profiler_recording() -> bool:
    """Whether a ``torch.profiler`` session records: on this thread, or
    on another one (a session started on the main thread sets the
    process-wide flag that a serving scheduler thread sees; it records
    that thread's ranges when it profiles all threads)."""
    import torch

    prof = torch.autograd.profiler
    return bool(getattr(prof, "_is_profiler_enabled", False)
                or torch._C._autograd._profiler_enabled())


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _Span:
    __slots__ = ("name", "_t0", "_range", "_active")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0
        self._range = None
        self._active = False

    def __enter__(self):
        # enabled is re-checked HERE (not only in span()) so a span
        # object bound early — e.g. a decorator applied at import while
        # telemetry was off — follows the runtime toggle
        if not _registry._enabled:
            self._active = False
            return self
        self._active = True
        _stack().append(self.name)
        # bridge into a recording torch.profiler session so host spans
        # land in its trace beside the kernels they launched
        if _profiler_recording():
            try:
                import torch

                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
            except Exception:
                self._range = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self._active:
            return False
        self._active = False
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        st = _stack()
        depth = len(st) - 1
        if st and st[-1] == self.name:
            st.pop()
        parent = st[-1] if st else None
        rec = SpanRecord(self.name, self._t0, t1 - self._t0,
                         depth, parent, _step, threading.get_ident())
        with _finished_lock:
            _finished.append(rec)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            if not _registry._enabled:
                return fn(*a, **kw)
            with _Span(name):
                return fn(*a, **kw)

        return wrapped


def span(name: str) -> _Span:
    """Context manager / decorator timing a named nested span.

    Near-zero when disabled: one small object + a flag check, no clock
    read, no stack mutation.

    ::

        with telemetry.span("fwd"):
            loss = net(x)

        @telemetry.span("load_batch")
        def load_batch(...): ...
    """
    return _Span(name)


def spans(step: Optional[int] = None) -> List[SpanRecord]:
    """Finished spans (oldest first), optionally only one step's."""
    with _finished_lock:
        out = list(_finished)
    if step is not None:
        out = [s for s in out if s.step == step]
    return out


def clear() -> None:
    global _step
    with _finished_lock:
        _finished.clear()
    with _step_lock:
        _step = 0


def current_step() -> int:
    return _step


def mark_step() -> int:
    """Advance the step index grouping spans into per-step traces.

    Called by Trainer.step (and anything else that defines a "step").
    Fires the interval-dump hook installed by `telemetry.enable`.
    """
    global _step
    with _step_lock:
        _step += 1
        n = _step
    cb = _on_step
    if cb is not None:
        cb(n)
    return n
