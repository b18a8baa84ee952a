"""`incubator_mxnet_tpu_torch.retrace_guard` — the port's counterpart of
`incubator_mxnet_tpu/retrace_guard.py`, counting CUDA-graph captures
per program name from `_graphs` instead of compiles from JAX's log.

Captures happen only on the card, so these tests report captures the
way `_graphs.Program` does (`_graphs._report_capture`).
"""
import pytest

from incubator_mxnet_tpu.retrace_guard import (
    DEFAULT_BUDGET as JAX_DEFAULT_BUDGET)
from incubator_mxnet_tpu_torch import MXNetError, _graphs
from incubator_mxnet_tpu_torch.retrace_guard import (
    DEFAULT_BUDGET, PROGRAM_NAMES, RetraceError, RetraceGuard)


def _captures(name, n=1):
    for _ in range(n):
        _graphs._report_capture(name)


def test_storm_over_budget_raises():
    with pytest.raises(RetraceError, match="serving_step: 3 captures"):
        with RetraceGuard(budget=2):
            _captures("serving_step", 3)


def test_within_budget_passes_and_counts_per_name():
    with RetraceGuard(budget=2) as guard:
        _captures("serving_step", 2)
        _captures("decode_step")
    assert guard.counts == {"serving_step": 2, "decode_step": 1}
    assert guard.violations() == {}


def test_unwatched_names_never_trip():
    with RetraceGuard(budget=1, watch={"serving_step"}) as guard:
        _captures("raw_fn", 5)
        _captures("serving_step")
    assert guard.counts["raw_fn"] == 5


def test_exempt_names_never_trip():
    with RetraceGuard(budget=0, exempt={"raw_fn"}):
        _captures("raw_fn", 2)


def test_check_reports_every_offender():
    guard = RetraceGuard(budget=1)
    with pytest.raises(RetraceError) as err:
        with guard:
            _captures("a", 2)
            _captures("b", 3)
    assert "a: 2 captures" in str(err.value)
    assert "b: 3 captures" in str(err.value)
    assert isinstance(err.value, MXNetError)


def test_body_error_wins_and_guard_unsubscribes():
    guard = RetraceGuard(budget=0)
    with pytest.raises(KeyError):
        with guard:
            _captures("x", 4)
            raise KeyError("body")
    _captures("x")
    assert guard.counts["x"] == 4


def test_nested_guards_both_count():
    with RetraceGuard() as outer:
        with RetraceGuard() as inner:
            _captures("decode_prefill")
        _captures("decode_prefill")
    assert inner.counts["decode_prefill"] == 1
    assert outer.counts["decode_prefill"] == 2


def test_program_names_cover_the_ports_programs():
    from incubator_mxnet_tpu_torch.models import TransformerLM
    from incubator_mxnet_tpu_torch.serving import PagedPrograms

    net = TransformerLM(vocab=11, units=16, hidden_size=32, num_layers=1,
                        num_heads=2, max_len=32, dropout=0.0, device="cpu")
    net.quantize_for_decode()
    names = set()
    for kw in (dict(speculate_k=2, quantized=False),
               dict(kv_dtype="int8", speculate_k=2, quantized=False)):
        progs = PagedPrograms(net, max_batch=2, block_size=8,
                              blocks_per_seq=4, num_blocks=9,
                              temperature=0.0, top_k=0, **kw)
        names |= {p.name for p in progs.programs.values()}
    names |= {"decode_prefill", "decode_step", "beam_prefill", "beam_step",
              "raw_fn"}
    assert names == PROGRAM_NAMES
    assert DEFAULT_BUDGET == JAX_DEFAULT_BUDGET
