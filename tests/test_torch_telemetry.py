"""The PyTorch/CUDA port's telemetry (`incubator_mxnet_tpu_torch/telemetry`
and `lock_witness`) held against the JAX package's.

The same inputs — made from a seed with numpy, clocks injected, never
slept — go through both packages' modules:

* registry + exporters: the same counter/gauge/histogram updates give
  byte-identical Prometheus text and JSONL and equal percentiles;
* tracer: the same nested spans give the same names, parents, depths
  and steps;
* slo, requestlog, the stall ledger (`EngineProfiler`): equal outputs
  from the same event streams;
* lock_witness: the same acquisition order gives equal edges and
  cycles;
* flight_recorder: a bundle has the same keys in both; a SIGTERM'd
  process writes its bundle and dies of the signal (128+15 to a shell);
* perf: the port's FLOP count of a product and of a convolution equals
  XLA's ``cost_analysis`` of the same jitted function on the CPU.

Each test leaves both packages' telemetry off and empty, with every
signal handler, GC hook and lock witness uninstalled.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu.telemetry as jtel
from incubator_mxnet_tpu import lock_witness as jlw
from incubator_mxnet_tpu_torch import _graphs
from incubator_mxnet_tpu_torch import lock_witness as tlw
from incubator_mxnet_tpu_torch import telemetry as ttel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean(tel):
    tel.disable()
    tel.get_registry().clear()
    tel.tracer.clear()
    tel.requestlog.clear()
    tel.perf.clear()
    tel.flight_recorder.uninstall()
    tel.profiler.uninstall_gc_hooks()
    for name in list(tel.profiler.profilers()):
        tel.profiler.unregister(name)


@pytest.fixture
def both():
    """Both packages' telemetry enabled on a clean slate; off, empty and
    unhooked after."""
    witnessed = {lw: lw.installed() for lw in (jlw, tlw)}
    for tel in (jtel, ttel):
        _clean(tel)
        tel.enable()
    yield jtel, ttel
    for tel in (jtel, ttel):
        _clean(tel)
    for lw, was in witnessed.items():
        if not was:
            lw.uninstall()
            lw.reset()


# --------------------------------------------------------------------- #
# registry + exporters
# --------------------------------------------------------------------- #
def _drive_registry(reg, seed):
    """A seeded sequence of metric updates: counters, gauges and
    histograms, labelled and not, values across many decades."""
    rs = np.random.RandomState(seed)
    names = ["serving_admitted_total", "a/b", "trainer_step_seconds",
             "program_mfu", "queue_depth"]
    for _ in range(400):
        kind = rs.randint(3)
        name = names[rs.randint(len(names))]
        labels = None if rs.rand() < 0.4 else {
            "path": ["float", "int8", 'he said "hi"\n'][rs.randint(3)]}
        key = f"{kind}:{name}"
        if kind == 0:
            reg.counter("c_" + key.replace(":", "_"), labels).inc(
                float(rs.randint(1, 5)))
        elif kind == 1:
            reg.gauge("g_" + key.replace(":", "_"), labels).set(
                float(rs.randn()))
        else:
            reg.histogram("h_" + key.replace(":", "_"), labels).observe(
                float(10.0 ** rs.uniform(-7, 5)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exports_byte_identical(both, monkeypatch, seed):
    jreg, treg = jtel.Registry(), ttel.Registry()
    _drive_registry(jreg, seed)
    _drive_registry(treg, seed)
    assert ttel.exporters.prometheus_text(treg) == \
        jtel.exporters.prometheus_text(jreg)
    # the JSONL carries a wall-clock stamp and the tracer's step
    monkeypatch.setattr(jtel.exporters.time, "time", lambda: 1234.5)
    monkeypatch.setattr(ttel.exporters.time, "time", lambda: 1234.5)
    assert ttel.exporters.jsonl_lines(treg) == \
        jtel.exporters.jsonl_lines(jreg)
    jm = {(m.name, tuple(sorted(m.labels.items()))): m
          for m in jreg.metrics()}
    hists = [m for m in treg.metrics() if m.kind == "histogram"]
    assert hists
    for m in hists:
        other = jm[(m.name, tuple(sorted(m.labels.items())))]
        assert m.percentiles((0.1, 0.5, 0.9, 0.99)) == \
            other.percentiles((0.1, 0.5, 0.9, 0.99))


def test_log_buckets_and_type_clash_match():
    assert ttel.log_buckets(1e-4, 1e2, 3) == jtel.log_buckets(1e-4, 1e2, 3)
    assert ttel.DEFAULT_BUCKETS == jtel.DEFAULT_BUCKETS
    reg = ttel.Registry()
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")


# --------------------------------------------------------------------- #
# tracer
# --------------------------------------------------------------------- #
def _drive_spans(tel, seed):
    rs = np.random.RandomState(seed)

    def nest(depth):
        for _ in range(rs.randint(1, 3)):
            with tel.span(f"s{depth}_{rs.randint(3)}"):
                if depth < 3 and rs.rand() < 0.7:
                    nest(depth + 1)

    for _ in range(4):
        tel.mark_step()
        nest(0)
    return [(s.name, s.parent, s.depth, s.step) for s in tel.spans()]


@pytest.mark.parametrize("seed", [0, 1])
def test_tracer_nesting_matches(both, seed):
    got = _drive_spans(ttel, seed)
    want = _drive_spans(jtel, seed)
    assert got == want and len(got) > 4
    assert ttel.current_step() == jtel.current_step() == 4


def test_spans_disabled_record_nothing(both):
    ttel.disable()
    with ttel.span("off"):
        pass
    assert ttel.spans() == [] and ttel.get_registry().metrics() == []


def test_span_is_a_record_function_range_while_profiling(both):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttel.span("serving/step"):
            torch.ones(3).add_(1)
    assert "serving/step" in {e.name for e in prof.events()}
    assert [s.name for s in ttel.spans()] == ["serving/step"]


def test_span_on_another_thread_recorded_profiling_all_threads(both):
    """The serving scheduler's spans: a session on this thread that
    profiles all threads records another thread's range."""
    def work():
        with ttel.span("serving/prefill_chunk"):
            torch.ones(3).add_(1)

    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=cfg) as prof:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert "serving/prefill_chunk" in {e.name for e in prof.events()}


# --------------------------------------------------------------------- #
# slo
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 3])
def test_slo_tracker_matches(both, seed):
    rs = np.random.RandomState(seed)
    kw = dict(ttft_target=0.2, tpot_target=0.02, windows=(30.0, 300.0),
              objective=0.95)
    js, ts = jtel.slo.SloTracker(**kw), ttel.slo.SloTracker(**kw)
    now = 1000.0
    for _ in range(300):
        now += float(rs.exponential(2.0))
        if rs.rand() < 0.15:
            js.note_bad(now)
            ts.note_bad(now)
        else:
            ttft = float(rs.exponential(0.15))
            tpot = None if rs.rand() < 0.1 else float(rs.exponential(0.015))
            assert ts.note_done(ttft, tpot, now) == \
                js.note_done(ttft, tpot, now)
        if rs.rand() < 0.2:
            q = now + float(rs.uniform(0, 60))
            assert ts.counts(q) == js.counts(q)
            assert ts.fractions(q) == js.fractions(q)
            assert ts.burn_rates(q) == js.burn_rates(q)
            assert ts.snapshot(q) == js.snapshot(q)
    ts.observe(now=now)
    js.observe(now=now)
    assert ttel.exporters.prometheus_text(ttel.get_registry()) == \
        jtel.exporters.prometheus_text(jtel.get_registry())


# --------------------------------------------------------------------- #
# requestlog
# --------------------------------------------------------------------- #
def _drive_requests(tel, seed):
    rs = np.random.RandomState(seed)
    ring = tel.requestlog.TraceRing(cap=5)
    t = 50.0
    for rid in range(1, 9):
        tr = tel.requestlog.RequestTrace(
            meta={"prompt_len": int(rs.randint(1, 40)), "engine": "e"},
            rid=rid)
        for name in ("submit", "queued", "admitted", "prefill"):
            t += float(rs.exponential(0.01))
            tr.event(name, t=t, lane=int(rs.randint(4)))
        for _ in range(rs.randint(3)):
            t += float(rs.exponential(0.01))
            tr.event("decode", t=t, pos=int(rs.randint(64)))
        t += float(rs.exponential(0.01))
        tr.event(["done", "shed", "evicted"][rs.randint(3)], t=t, tokens=3)
        ring.push(tr)
    traces = ring.recent()
    return (traces, ring.pushed, tel.requestlog.chrome_trace(traces),
            tel.requestlog.jsonl_lines(traces))


@pytest.mark.parametrize("seed", [0, 1])
def test_requestlog_matches(both, seed):
    got, want = _drive_requests(ttel, seed), _drive_requests(jtel, seed)
    assert got == want
    assert len(got[0]) == 5 and got[1] == 8


# --------------------------------------------------------------------- #
# the stall ledger
# --------------------------------------------------------------------- #
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive_ledger(tel, seed):
    """A note/end_step stream with injected durations on an injected
    clock (and GC seconds): a few steps far slower than the rest."""
    rs = np.random.RandomState(seed)
    clock, gc_s = _Clock(), [0.0]
    prof = tel.profiler.EngineProfiler(
        "e", clock=clock, gc_seconds=lambda: gc_s[0], hiccup_k=3.0,
        ring=4, enabled=True)
    slow = set(rs.choice(np.arange(12, 60), 5, replace=False).tolist())
    hics = []
    for step in range(60):
        for cause in ("lock_wait", "bookkeeping", "gather_params"):
            d = float(rs.uniform(1e-5, 2e-4))
            clock.t += d
            prof.note(cause, d)
        d = float(rs.uniform(4e-3, 6e-3)) * (20.0 if step in slow else 1.0)
        clock.t += d
        prof.note("device_step", d)
        if rs.rand() < 0.2:
            g = float(rs.uniform(1e-4, 1e-3))
            gc_s[0] += g
            clock.t += g
        clock.t += float(rs.uniform(0, 1e-4))
        h = prof.end_step(rids=[1, 2], occupancy=2, queue_depth=step % 3,
                          step=step)
        hics.append(h)
    return prof, hics


@pytest.mark.parametrize("seed", [0, 7])
def test_stall_ledger_matches(both, seed):
    tp, th = _drive_ledger(ttel, seed)
    jp, jh = _drive_ledger(jtel, seed)
    assert th == jh
    assert sum(h is not None for h in th) >= 3, "no hiccup was flagged"
    assert tp.stall_table() == jp.stall_table()
    assert tp.stallz() == jp.stallz()
    assert tp.recent_stalls() == jp.recent_stalls()
    assert tp.recent_steps() == jp.recent_steps()
    assert tp.invariant_violations == jp.invariant_violations == 0


def test_merged_trace_validates(both):
    prof, _ = _drive_ledger(ttel, 1)
    ttel.profiler.register(prof)
    _drive_requests(ttel, 1)
    for tr in _drive_requests(ttel, 2)[0]:
        ttel.requestlog.push(tr)
    with ttel.span("x"):
        pass
    trace = ttel.profiler.capture(0)
    assert ttel.profiler.validate_chrome_trace(trace) == []
    assert ttel.profiler.validate_chrome_trace(json.dumps(trace)) == []
    cats = {e.get("cat") for e in trace["traceEvents"]}
    assert {"request", "scheduler", "telemetry"} <= cats
    assert ttel.profiler.validate_chrome_trace({"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 2, "dur": 1},
        {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 1,
         "dur": 1}]}) != []


# --------------------------------------------------------------------- #
# lock witness
# --------------------------------------------------------------------- #
_LOCKS_SRC = """\
import threading
A = threading.Lock()
B = threading.Lock()
C = threading.RLock()
"""


def _drive_witness(lw, tmp_path, tag, cycle):
    path = tmp_path / f"locks_{tag}.py"
    path.write_text(_LOCKS_SRC)
    assert lw.install(force=True, track_roots=[str(tmp_path)])
    try:
        ns = {}
        exec(compile(_LOCKS_SRC, str(path), "exec"), ns)
        A, B, C = ns["A"], ns["B"], ns["C"]
        with A:
            with B:
                with C:
                    pass
        if cycle:
            def other():
                with B:
                    with A:
                        pass
            t = threading.Thread(target=other)
            t.start()
            t.join()
        edges = {(os.path.basename(s[0]), s[1], os.path.basename(d[0]),
                  d[1]): e["count"] for (s, d), e in lw.edges().items()}
        cycles = [[(os.path.basename(f), ln) for f, ln in c]
                  for c in lw.check_acyclic()]
        return edges, cycles
    finally:
        lw.uninstall()
        lw.reset()


@pytest.mark.parametrize("cycle", [False, True])
def test_lock_witness_matches(both, tmp_path, cycle):
    got = _drive_witness(tlw, tmp_path, "t", cycle)
    want = _drive_witness(jlw, tmp_path, "t", cycle)
    assert got == want
    assert len(got[0]) == (4 if cycle else 3)   # + B -> A
    assert bool(got[1]) == cycle


def test_lock_witness_static_graph_scans_the_port():
    graph = tlw.static_lock_graph()
    files = {os.path.relpath(p, ROOT).split(os.sep)[0]
             for p, _ in graph.sites().values()}
    assert files == {"incubator_mxnet_tpu_torch"}


# --------------------------------------------------------------------- #
# flight recorder
# --------------------------------------------------------------------- #
def _bundle(tel, d):
    tel.flight_recorder.install(str(d))
    try:
        tel.flight_recorder.register_section("eng", lambda: {"in_flight": []})
        tel.counter("serving_admitted_total").inc()
        for _ in range(3):
            tel.mark_step()
            with tel.span("trainer/step"):
                pass
        paths = tel.flight_recorder.dump("manual", str(d))
    finally:
        tel.flight_recorder.unregister_section("eng")
        tel.flight_recorder.uninstall()
    lines = [json.loads(ln) for ln in open(paths["jsonl"])]
    with open(paths["trace"]) as f:
        trace = json.load(f)
    return ([sorted(ln) for ln in lines], sorted(lines[0]["flight_meta"]),
            sorted(lines[1]), [ln.get("section") for ln in lines],
            sorted(trace))


def test_flight_bundle_keys_match(both, tmp_path):
    got = _bundle(ttel, tmp_path / "t")
    want = _bundle(jtel, tmp_path / "j")
    assert got == want
    assert "eng" in got[3]


def test_flight_recorder_signals_false_leaves_handlers(both, tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    ttel.flight_recorder.install(str(tmp_path), signals=False)
    try:
        assert signal.getsignal(signal.SIGTERM) is before
        assert ttel.flight_recorder.dump("manual") is not None
    finally:
        ttel.flight_recorder.uninstall()
    assert os.path.exists(tmp_path / "flight.jsonl")


def test_sigterm_writes_bundle_and_exits_by_the_signal(tmp_path):
    code = textwrap.dedent(f"""\
        import sys, time
        sys.modules["jax"] = None
        sys.modules["incubator_mxnet_tpu"] = None
        from incubator_mxnet_tpu_torch import telemetry
        telemetry.enable()
        telemetry.flight_recorder.install({str(tmp_path)!r})
        telemetry.mark_step()
        print("ready", flush=True)
        time.sleep(60)
        """)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        proc.kill()
        proc.stdout.close()
    # killed by the re-delivered signal: a shell reports 128 + 15
    assert rc == -signal.SIGTERM
    meta = json.loads(open(tmp_path / "flight.jsonl").readline())
    assert meta["flight_meta"]["reason"] == "signal:SIGTERM"


# --------------------------------------------------------------------- #
# perf
# --------------------------------------------------------------------- #
def _xla_flops(fn, *args):
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca["flops"])


@pytest.mark.parametrize("shape", [(8, 16, 4), (33, 7, 65)])
def test_matmul_flops_equal_xla(both, shape):
    m, k, n = shape
    rs = np.random.RandomState(0)
    a = rs.randn(m, k).astype(np.float32)
    b = rs.randn(k, n).astype(np.float32)
    out = ttel.perf.capture("mm", torch.matmul, torch.from_numpy(a),
                            torch.from_numpy(b))
    assert out.shape == (m, n)
    assert ttel.perf.programs()["mm"].flops == \
        _xla_flops(jnp.matmul, a, b) == 2 * m * k * n


@pytest.mark.parametrize("case", [((2, 3, 9, 9), (5, 3, 3, 3), 1, 1, 1),
                                  ((1, 4, 8, 10), (6, 2, 3, 1), 2, 0, 2)])
def test_conv_flops_equal_xla(both, case):
    xs, ws, stride, pad, groups = case
    rs = np.random.RandomState(1)
    x = rs.randn(*xs).astype(np.float32)
    w = rs.randn(*ws).astype(np.float32)

    def jconv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (stride, stride), [(pad, pad), (pad, pad)],
            feature_group_count=groups,
            dimension_numbers=("NCHW", "OIHW", "NCHW"))

    ttel.perf.capture("conv", torch.nn.functional.conv2d,
                      torch.from_numpy(x), torch.from_numpy(w),
                      stride=stride, padding=pad, groups=groups)
    assert ttel.perf.programs()["conv"].flops == _xla_flops(jconv, x, w)


def test_kernel_costs_count_only_inside_a_count(both):
    ttel.perf.add_kernel_cost(1e9, 1e9)     # nothing counts: dropped
    with ttel.perf.counting() as outer:
        ttel.perf.add_kernel_cost(10.0, 20.0)
        with ttel.perf.counting() as inner:
            ttel.perf.add_kernel_cost(1.0, 2.0)
    assert (outer.flops, outer.bytes) == (11.0, 22.0)
    assert (inner.flops, inner.bytes) == (1.0, 2.0)


def test_views_move_no_bytes_and_gathers_move_rows(both):
    table = torch.zeros(1000, 8)
    idx = torch.tensor([1, 5])
    with ttel.perf.counting() as c:
        table.view(8000).t()
    assert c.bytes == 0
    with ttel.perf.counting() as c:
        torch.nn.functional.embedding(idx, table)
    assert c.bytes == 2 * (2 * 8 * 4) + 2 * 8


def test_program_counted_once_timed_every_run(both):
    """A `_graphs.Program` on the CPU: counted at its first run, timed
    (host clock) at each; a scope sums its runs; no MFU or roofline
    gauge without peaks (the CPU), and ``/varz`` says why."""
    w = torch.randn(16, 16)
    prog = _graphs.Program("mmprog", lambda x: (x @ w,),
                           _graphs.Pool("cpu"))
    with ttel.perf.scope("two_runs"):
        for _ in range(2):
            prog.run(None, x=np.ones((4, 16), np.float32))
    reg = ttel.get_registry()
    assert prog.cost[0] == 2 * 4 * 16 * 16
    lab = {"program": "mmprog"}
    assert reg.get("program_device_seconds", lab).count == 2
    assert reg.get("program_flops", {"program": "two_runs"}).value == \
        2 * prog.cost[0]
    assert reg.get("program_mfu", lab) is None
    assert reg.get("program_roofline_fraction", lab) is None
    assert "not set" in ttel.perf.varz_section()["note"]
    assert ttel.perf.sample_device_memory() == {}
    ttel.disable()
    prog.run(None, x=np.ones((4, 16), np.float32))
    assert reg.get("program_device_seconds", lab).count == 2


def test_nbytes_of_reads_metadata():
    assert ttel.nbytes_of(torch.zeros(3, 5, dtype=torch.bfloat16)) == 30
    assert ttel.nbytes_of(np.zeros((2, 2), np.float64)) == 32
    assert ttel.nbytes_of(object()) == 0


def _report(name):
    """What `_graphs` tells its capture sinks at a capture (without
    counting one in `_graphs.captures`)."""
    for sink in list(_graphs._sinks):
        sink(name)


def test_retrace_feed_counts_captures(both):
    _report("serving_step")
    _report("serving_step")
    reg = ttel.get_registry()
    assert reg.get("retraces_total").value == 2
    assert reg.get("retrace_compiles",
                   {"program": "serving_step"}).value == 2
    ttel.disable()
    _report("serving_step")
    assert reg.get("retraces_total").value == 2
