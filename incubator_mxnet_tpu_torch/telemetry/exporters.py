"""Telemetry exporters: Prometheus text format, JSONL, chrome trace (the
port of `incubator_mxnet_tpu/telemetry/exporters.py`; the text and JSONL
are byte-identical to the JAX package's for the same registry).

Dump targets (all host-side, no device syncs):

* ``prometheus_text()`` — the Prometheus text exposition format
  (``*_bucket{le=...}`` / ``_sum`` / ``_count`` for histograms); metric
  names are sanitized to the Prometheus grammar (``monitor/fc1/mean``
  → ``monitor_fc1_mean``) with the original name preserved in a
  ``# HELP`` line.
* ``jsonl_lines()`` — one JSON object per metric; histograms carry
  bucket bounds/counts AND p50/p95/p99 so downstream BENCH tooling
  reads percentiles without re-deriving them.
* ``chrome_trace()`` — the tracer's finished spans as chrome://tracing
  ``X`` events (the port has no ``mx.profiler`` whose events the JAX
  package merges in here; `profiler.merged_chrome_trace` is the merged
  timeline).
* ``dump(dirpath)`` — writes all three (telemetry.prom /
  telemetry.jsonl / telemetry_trace.json) and returns the paths.
"""
from __future__ import annotations

import json
import math
import os
import re
import time
from typing import Dict, List, Optional

from . import tracer as _tracer
from .registry import Counter, Gauge, Histogram, Registry

__all__ = ["prometheus_text", "jsonl_lines", "chrome_trace", "dump",
           "PROM_CONTENT_TYPE"]

# the content type a Prometheus scraper negotiates for the text
# exposition format — telemetry/http.py serves /metrics with it
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
# label names are STRICTER than metric names: the exposition grammar
# allows ":" in metric names (recording rules) but not in label names
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_label_name(name: str) -> str:
    name = _LABEL_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_escape(value) -> str:
    """Label-value escaping per the Prometheus text exposition grammar:
    backslash, double-quote and newline must be escaped or the line is
    unparseable (a value like ``he said "hi"\n`` would truncate the
    sample and corrupt every line after it)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels: Dict[str, str], extra: Optional[str] = None) -> str:
    parts = [f'{_prom_label_name(k)}="{_prom_escape(v)}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


def prometheus_text(registry: Registry) -> str:
    lines: List[str] = []
    seen_type = set()
    seen_series = set()
    for m in registry.metrics():
        pname = _prom_name(m.name)
        # duplicate-timeseries guard: two distinct registry names can
        # sanitize to the same exposition name+labels (``a/b`` and
        # ``a_b``) — a second sample for the same series is invalid
        # exposition, so it is dropped with an explanatory comment
        series = (pname, tuple(sorted(m.labels.items())))
        if series in seen_series:
            lines.append(f"# duplicate timeseries dropped: {m.name!r} "
                         f"collides with an earlier metric as {pname}")
            continue
        seen_series.add(series)
        if pname not in seen_type:
            seen_type.add(pname)
            if pname != m.name:
                lines.append(f"# HELP {pname} source metric {m.name!r}")
            lines.append(f"# TYPE {pname} {m.kind}")
        if isinstance(m, Histogram):
            snap = m.snapshot()
            cum = 0
            for bound, c in zip(list(m.bounds) + [math.inf],
                                snap["buckets"]):
                cum += c
                le = _prom_labels(m.labels, f'le="{_fmt(bound)}"')
                lines.append(f"{pname}_bucket{le} {cum}")
            lab = _prom_labels(m.labels)
            lines.append(f"{pname}_sum{lab} {_fmt(snap['sum'])}")
            lines.append(f"{pname}_count{lab} {snap['count']}")
        elif isinstance(m, (Counter, Gauge)):
            lab = _prom_labels(m.labels)
            lines.append(f"{pname}{lab} {_fmt(m.value)}")
    return "\n".join(lines) + "\n"


def jsonl_lines(registry: Registry) -> List[str]:
    now = time.time()
    step = _tracer.current_step()
    out = []
    for m in registry.metrics():
        rec = {"ts": now, "step": step, "name": m.name, "type": m.kind}
        if m.labels:
            rec["labels"] = dict(m.labels)
        rec.update(m.snapshot())
        out.append(json.dumps(rec))
    return out


def chrome_trace() -> dict:
    """chrome://tracing dict of the telemetry spans."""
    events = []
    for s in _tracer.spans():
        events.append({
            "name": s.name, "cat": "telemetry", "ph": "X",
            "ts": s.t0 * 1e6, "dur": s.dur * 1e6,
            "pid": os.getpid(), "tid": s.tid,
            "args": {"step": s.step, "depth": s.depth,
                     **({"parent": s.parent} if s.parent else {})},
        })
    events.sort(key=lambda e: e.get("ts", 0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump(registry: Registry, dirpath: Optional[str] = None) -> Dict[str, str]:
    """Write telemetry.prom + telemetry.jsonl + telemetry_trace.json.

    dirpath defaults to ``MXTPU_TELEMETRY_DIR`` (else the cwd); it is
    created if missing.  Returns {"prom": path, "jsonl": path,
    "trace": path}.
    """
    dirpath = dirpath or os.environ.get("MXTPU_TELEMETRY_DIR", ".")
    os.makedirs(dirpath, exist_ok=True)
    paths = {}

    prom_path = os.path.join(dirpath, "telemetry.prom")
    with open(prom_path, "w") as f:
        f.write(prometheus_text(registry))
    paths["prom"] = prom_path

    jsonl_path = os.path.join(dirpath, "telemetry.jsonl")
    with open(jsonl_path, "w") as f:
        for line in jsonl_lines(registry):
            f.write(line + "\n")
    paths["jsonl"] = jsonl_path

    trace_path = os.path.join(dirpath, "telemetry_trace.json")
    with open(trace_path, "w") as f:
        json.dump(chrome_trace(), f)
    paths["trace"] = trace_path
    return paths
