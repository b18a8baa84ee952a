"""Unified telemetry of the PyTorch/CUDA port: metrics registry, step
spans, exporters, and the serving observability plane (the port of
`incubator_mxnet_tpu/telemetry`, framework-free apart from `perf`'s
device reads and `tracer`'s profiler bridge).

* ``telemetry.counter/gauge/histogram(name, labels=)`` — process-wide
  registry handles (create once, update in the hot path);
* ``telemetry.span(name)`` — nested host-side spans grouped into
  per-step traces; while a ``torch.profiler`` session records, each span
  is also a ``torch.profiler.record_function`` range, so it shows beside
  the kernels it launched;
* ``telemetry.dump(dir)`` — Prometheus text + JSONL + chrome trace.

OFF by default: every update checks one module flag and returns, so
instrumented hot paths (the serving scheduler, ``Trainer.step``,
``_graphs.Program.run``) cost one flag read while disabled, and the
registry stays empty.  Enable programmatically (``telemetry.enable()``)
or via env (the JAX package's names):

* ``MXTPU_TELEMETRY=1``          enable collection
* ``MXTPU_TELEMETRY_DUMP=1``     enable + dump on process exit
* ``MXTPU_TELEMETRY_DIR=path``   dump directory (default: cwd)
* ``MXTPU_TELEMETRY_INTERVAL=N`` also dump every N trainer steps
* ``MXTPU_TELEMETRY_SPAN_BUF=N`` span ring-buffer size (default 16384)
* ``MXTPU_FLIGHT_DIR=path``      enable + install the crash/preemption
  flight recorder (telemetry.flight_recorder); bundles land in `path`
* ``MXTPU_FLIGHT_STEPS=N``       flight-recorder ring size (default 16)
* ``MXTPU_TELEMETRY_PORT=N``     serve /metrics /healthz /varz /requestz
  /profilez /stallz over HTTP (telemetry.http; the serving engine
  starts it — 0 = ephemeral port)
* ``MXTPU_REQUESTLOG_RING=N``    recent-request trace ring size
  (telemetry.requestlog, default 256)
* ``MXTPU_SERVING_PROFILER=0``   disable the serving stall ledger
  (telemetry.profiler; on by default — one flag read per phase note)
* ``MXTPU_PROFILER_HICCUP_K=K``  hiccup threshold multiplier over the
  rolling step-wall p50 (default 3.0)
* ``MXTPU_STALLZ_RING=N``        /stallz hiccup ring size (default 64)

``perf`` (FLOP/byte counts of the captured programs, their CUDA-event
device times, MFU and roofline fractions, device-memory watermarks) and
``flight_recorder`` (last-N-steps ring dumped on SIGTERM/SIGINT/fatal
exception) ride the same near-zero disabled path.

THE NO-HOST-SYNC RULE: instrumentation never forces a device sync — it
records host clocks (time.perf_counter), tensor metadata (shape/dtype
byte counts), CUDA events it only ever ``query()``s, allocator
counters, or values that are already host data.  No file of this
package calls ``synchronize(``, ``.item()``, ``.cpu()`` or
``.tolist()`` (tests/test_torch_port_rules.py).
"""
from __future__ import annotations

import atexit
import os
from typing import Dict, Optional

from . import exporters, registry as _registry_mod, tracer
from .registry import (Counter, DEFAULT_BUCKETS, Gauge, Histogram, Registry,
                       log_buckets)
from .tracer import SpanRecord, current_step, mark_step, span, spans

__all__ = ["enabled", "enable", "disable", "counter", "gauge", "histogram",
           "span", "spans", "mark_step", "current_step", "dump", "reset",
           "get_registry", "Counter", "Gauge", "Histogram", "Registry",
           "SpanRecord", "DEFAULT_BUCKETS", "log_buckets", "nbytes_of",
           "exporters", "tracer", "perf", "flight_recorder", "requestlog",
           "slo", "http", "profiler"]

_default_registry = Registry()
_dump_interval = 0
_atexit_registered = False

# the submodules below resolve the default registry lazily; importing
# them after it exists keeps partial-init states out of an interpreter
# that imports them directly (`http` is the package's submodule here,
# not the stdlib package)
from . import flight_recorder, perf  # noqa: E402
from . import http, requestlog, slo  # noqa: E402
# last: its merged capture reads requestlog/tracer/perf
from . import profiler  # noqa: E402


def get_registry() -> Registry:
    return _default_registry


def enabled() -> bool:
    return _registry_mod._enabled


def counter(name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
    return _default_registry.counter(name, labels)


def gauge(name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
    return _default_registry.gauge(name, labels)


def histogram(name: str, labels: Optional[Dict[str, str]] = None,
              buckets=None) -> Histogram:
    return _default_registry.histogram(name, labels, buckets=buckets)


def nbytes_of(t) -> int:
    """Byte size from tensor metadata only (``numel * element_size``) —
    never touches device data.  Anything else with a ``shape`` and a
    numpy-understood ``dtype`` (a host array) is sized the same way."""
    import math as _math

    if hasattr(t, "element_size") and hasattr(t, "numel"):
        return int(t.numel()) * int(t.element_size())
    shape = getattr(t, "shape", None)
    if shape is None:
        return 0
    import numpy as np

    itemsize = int(np.dtype(t.dtype).itemsize)
    return _math.prod(shape) * itemsize if shape else itemsize


def _on_step(step: int) -> None:
    if _dump_interval > 0 and step % _dump_interval == 0:
        dump()
    # one attribute read when the flight recorder is not installed
    flight_recorder._on_step(step)


def enable(dump_interval: Optional[int] = None) -> None:
    """Turn collection on; optionally dump every `dump_interval` steps."""
    global _dump_interval
    _registry_mod._enabled = True
    if dump_interval is not None:
        _dump_interval = int(dump_interval)
    tracer._on_step = _on_step
    # feed program captures (recaptures) into the registry
    from .. import retrace_guard

    retrace_guard.install_telemetry_feed()


def disable() -> None:
    _registry_mod._enabled = False
    tracer._on_step = None
    from .. import retrace_guard

    retrace_guard.remove_telemetry_feed()


def dump(dirpath: Optional[str] = None) -> Dict[str, str]:
    """Write Prometheus + JSONL + chrome trace; returns paths.  Program
    timings whose CUDA events have completed are folded in first."""
    perf.resolve()
    return exporters.dump(_default_registry, dirpath)


def reset() -> None:
    """Zero all metrics and drop collected spans (registrations stay)."""
    _default_registry.reset()
    tracer.clear()


def _atexit_dump() -> None:  # pragma: no cover — runs at interpreter exit
    try:
        if enabled():
            dump()
    except Exception:
        pass


def _configure_from_env() -> None:
    global _dump_interval, _atexit_registered
    env = os.environ
    want_dump = env.get("MXTPU_TELEMETRY_DUMP", "0") == "1"
    flight_dir = env.get("MXTPU_FLIGHT_DIR", "")
    want_on = env.get("MXTPU_TELEMETRY", "0") == "1" or want_dump \
        or bool(flight_dir)
    interval = int(env.get("MXTPU_TELEMETRY_INTERVAL", "0") or 0)
    if want_on:
        enable(dump_interval=interval)
    if flight_dir:
        flight_recorder.install(flight_dir)
    if want_dump and not _atexit_registered:
        _atexit_registered = True
        atexit.register(_atexit_dump)


_configure_from_env()
