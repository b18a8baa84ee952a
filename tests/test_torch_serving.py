"""The PyTorch/CUDA port's paged serving engine
(`incubator_mxnet_tpu_torch/serving/`), mirroring tests/test_serving.py
and tests/test_serving_prefix.py.

The load-bearing contracts, as in the JAX package:

* **Greedy parity** — engine tokens equal the JAX `lm_generate` and the
  port's own `generate` token for token, alone and co-batched, with
  chunked prefill (every prompt here crosses several chunk boundaries).
* **Eviction bit-identity** — cancelling a neighbour mid-batch leaves
  the survivor's tokens identical to an unperturbed run.
* **Prefix cache** — a cache-hit admission is bit-identical to a cold
  one; shared blocks are decref'd exactly.
* **Overload safety** — a full queue sheds, SLO estimates shed late
  requests, deadlines evict mid-batch, abandoned streams release their
  blocks (a `Request.stream` or an `lm_stream` generator), close()
  joins the scheduler thread, and scheduler errors are parked and
  re-raised.
* **int8 KV pages** (``kv_dtype="int8"``) — the port's kv8 engine gives
  the JAX kv8 engine's tokens on the same weights (both take their
  dense attention on the CPU), keeps >= 95% greedy parity with the
  float engine, holds >= 1.8x the sequences per pool byte at bf16 and
  D=64, and a prefix-cache hit stays bit-identical; the int8 weight
  path (``quantize_for_decode``) follows the net into the engine.

Tiny nets (V=61, C=16, one layer), 1 ms polls, one shared engine.
"""
import threading
import time

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.models.generation import lm_generate as jax_generate
from incubator_mxnet_tpu.models.transformer import TransformerLM as JaxLM
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu.serving import ServingEngine as JaxEngine
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import (TransformerLM, lm_generate,
                                              lm_stream)
from incubator_mxnet_tpu_torch.serving import (BlockPool, RequestCancelled,
                                               RequestFailed, RequestShed,
                                               RequestTimedOut, ServingEngine)

V, C, DFF, L, H, MAXLEN = 61, 16, 32, 1, 2, 64
P1 = onp.array([3, 7, 11, 2, 9], onp.int32)
P2 = onp.array([5, 1, 2], onp.int32)
_RS = onp.random.RandomState(42)
PREF = _RS.randint(0, V, size=16).astype(onp.int32)    # 2 full blocks @ 8
PA = onp.concatenate([PREF, _RS.randint(0, V, size=5).astype(onp.int32)])
PB = onp.concatenate([PREF, _RS.randint(0, V, size=5).astype(onp.int32)])
PLONG = _RS.randint(0, V, size=33).astype(onp.int32)
_POLL = 0.001


def _wait(pred, timeout=30.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.002)
    return False


def _slow(phase_wanted, seconds):
    def hook(phase):
        if phase == phase_wanted:
            time.sleep(seconds)
    return hook


@pytest.fixture(scope="module")
def nets():
    mx.random.seed(0)
    jnet = JaxLM(vocab=V, units=C, hidden_size=DFF, num_layers=L,
                 num_heads=H, max_len=MAXLEN, dropout=0.0)
    jnet.initialize()
    jnet(NDArray(jnp.ones((1, 4), jnp.int32)))
    tnet = TransformerLM(vocab=V, units=C, hidden_size=DFF, num_layers=L,
                         num_heads=H, max_len=MAXLEN, dropout=0.0,
                         device="cpu")
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                           jnet._collect_params_with_prefix().items()})
    return jnet, tnet


@pytest.fixture(scope="module")
def net(nets):
    return nets[1]


_REFS = {}


def _ref(nets, prompt, n):
    """JAX `lm_generate` tokens (generated part), cached per request."""
    key = (prompt.tobytes(), n)
    if key not in _REFS:
        _REFS[key] = onp.asarray(
            jax_generate(nets[0], prompt[None, :], n))[0, len(prompt):]
    return _REFS[key].tolist()


@pytest.fixture(scope="module")
def engine(net):
    """The shared engine: prefill_chunk=4 makes every prompt here span
    several chunk boundaries."""
    eng = ServingEngine(net, max_batch=2, block_size=8, prefill_chunk=4,
                        poll_interval=_POLL)
    yield eng
    eng.close()


@pytest.fixture
def clean_engine(engine):
    engine.set_fault_hook(None)
    engine.set_ttft_budget(None)
    yield engine
    assert engine.drain(timeout=30)
    engine.set_fault_hook(None)
    engine.set_ttft_budget(None)


# --------------------------------------------------------------------- #
# block pool (a copy of the JAX package's; the same cases)
# --------------------------------------------------------------------- #
def test_block_pool_deterministic_and_guarded():
    pool = BlockPool(6)
    assert pool.num_free == 5
    assert pool.alloc(3) == [1, 2, 3]
    assert pool.alloc(3) is None
    pool.free([2])
    assert pool.alloc(1) == [2]
    with pytest.raises(ValueError):
        pool.free([2, 2])
    with pytest.raises(ValueError):
        pool.free([0])
    with pytest.raises(ValueError):
        BlockPool(1)


def test_pool_lookup_register_roundtrip():
    pool = BlockPool(8, 4)
    toks = list(range(100, 111))
    ids = pool.alloc(3)
    pool.register(toks, ids)
    assert pool.lookup(toks) == (ids[:2], 8)
    assert pool.lookup(toks[:8]) == (ids[:1], 4)
    assert pool.lookup(toks[:4] + [1, 2, 3, 4, 9]) == (ids[:1], 4)
    assert pool.lookup([9] * 11) == ([], 0)


def test_pool_refcounts_shared_free_and_lru_harvest():
    pool = BlockPool(6, 4)
    toks = list(range(1, 9))
    a = pool.alloc(2)
    pool.register(toks, a)
    hits, clen = pool.lookup(toks + [7])
    assert hits == a and clen == 8
    pool.bind(hits)
    assert pool.num_shared == 2
    pool.free(a)
    assert pool.num_allocated == 2 and pool.num_shared == 0
    pool.free(a)
    assert pool.num_allocated == 0 and pool.num_free == 5
    with pytest.raises(ValueError):
        pool.free(a)
    assert pool.lookup(toks + [7]) == (a, 8)
    assert pool.alloc(3) == [3, 4, 5]
    assert set(pool.alloc(2)) == set(a)
    assert pool.lookup(toks + [7]) == ([], 0)
    assert pool.num_cached == 0


def test_pool_bind_rollback_and_first_registration_wins():
    pool = BlockPool(8, 4)
    toks = list(range(10, 18))
    a = pool.alloc(2)
    b = pool.alloc(2)
    pool.register(toks, a)
    pool.register(toks, b)                 # racing loser: a no-op
    pool.free(b)
    pool.free(a)
    hits, _ = pool.lookup(toks + [3])
    pool.bind(hits)
    pool.unbind(hits)                      # admission rolled back
    assert pool.num_allocated == 0 and pool.num_free == 7
    assert pool.lookup(toks + [3]) == (a, 8)


def test_pool_hash_collision_is_a_miss(monkeypatch):
    pool = BlockPool(8, 4)
    monkeypatch.setattr(BlockPool, "_chain", staticmethod(lambda h, sl: 1))
    t1 = [1, 2, 3, 4, 5, 6, 7, 8]
    a = pool.alloc(2)
    pool.register(t1, a)
    assert pool.lookup([9, 9, 9, 9, 5, 6, 7, 8, 0]) == ([], 0)
    assert pool.lookup(t1 + [0]) == (a, 8)


# --------------------------------------------------------------------- #
# parity with lm_generate (JAX and port), chunked prefill, prefix cache
# --------------------------------------------------------------------- #
def test_greedy_parity_alone_and_cobatched(nets, clean_engine):
    ref1, ref2 = _ref(nets, P1, 8), _ref(nets, P2, 6)
    port1 = lm_generate(nets[1], P1[None, :], 8)[0, len(P1):].tolist()
    assert port1 == ref1
    assert clean_engine.submit(P1, 8).result(timeout=60) == ref1
    r1 = clean_engine.submit(P1, 8)
    r2 = clean_engine.submit(P2, 6)
    assert r1.result(timeout=60) == ref1
    assert r2.result(timeout=60) == ref2


def test_chunked_prefill_and_cache_hit_bit_identical(nets, clean_engine):
    eng = clean_engine
    ref = _ref(nets, PA, 8)
    cold = eng.submit(PA, 8)
    assert cold.result(timeout=60) == ref
    hits0 = eng.stats()["prefix_cache"]["hits"]
    hit = eng.submit(PA, 8)
    assert hit.result(timeout=60) == ref
    assert hit.cached_tokens == 16         # 2 of 3 prompt blocks bound
    st = eng.stats()
    assert st["prefix_cache"]["hits"] == hits0 + 1
    assert st["blocks_free"] == st["blocks_total"]


def test_eos_and_single_token_retire(nets, clean_engine):
    full = _ref(nets, P1, 8)
    assert clean_engine.submit(P1, 1).result(timeout=60) == full[:1]
    old = clean_engine._eos
    clean_engine._eos = full[0]
    try:
        assert clean_engine.submit(P1, 8).result(timeout=60) == full[:1]
    finally:
        clean_engine._eos = old


def test_mid_batch_eviction_leaves_survivor_bit_identical(clean_engine):
    eng = clean_engine
    ra, rb = eng.submit(P1, 10), eng.submit(P2, 10)
    base = ra.result(timeout=60)
    rb.result(timeout=60)
    assert eng.drain(timeout=30)
    eng.set_fault_hook(_slow("step", 0.02))
    ra, rb = eng.submit(P1, 10), eng.submit(P2, 10)
    assert _wait(lambda: len(rb.tokens) >= 3)
    rb.cancel()
    assert ra.result(timeout=60) == base
    with pytest.raises(RequestCancelled):
        rb.result(timeout=60)
    eng.set_fault_hook(None)
    assert eng.submit(P1, 10).result(timeout=60) == base


def test_evict_while_shared_decrefs_exactly(nets, clean_engine):
    eng = clean_engine
    ref_b = _ref(nets, PB, 10)
    # register PREF's 2 blocks here, so the test needs no earlier one
    assert eng.submit(PA, 1).result(timeout=60) == _ref(nets, PA, 1)
    eng.set_fault_hook(_slow("step", 0.02))
    ra = eng.submit(PA, 20)                # both bind PREF's 2 blocks
    rb = eng.submit(PB, 10)
    assert _wait(lambda: len(rb.tokens) >= 2)
    assert eng._pool.num_shared >= 2
    ra.cancel()
    with pytest.raises(RequestCancelled):
        ra.result(timeout=30)
    assert rb.result(timeout=60) == ref_b
    eng.set_fault_hook(None)
    st = eng.stats()
    assert st["blocks_free"] == st["blocks_total"]
    assert eng._pool.num_allocated == 0


def test_cancel_mid_chunked_prefill_releases_only_private(nets,
                                                          clean_engine):
    eng = clean_engine
    ref = _ref(nets, PLONG, 6)
    assert eng.submit(PLONG, 6).result(timeout=60) == ref
    cached_before = eng._pool.num_cached
    assert cached_before >= 4
    pb = onp.concatenate([PLONG[:8],
                          _RS.randint(0, V, size=25).astype(onp.int32)])
    eng.set_fault_hook(_slow("prefill", 0.05))
    req = eng.submit(pb, 6)
    assert _wait(lambda: eng._pool.num_allocated > 0)
    req.cancel()
    with pytest.raises(RequestCancelled):
        req.result(timeout=30)
    eng.set_fault_hook(None)
    assert eng.drain(timeout=30)
    assert eng._pool.num_allocated == 0
    assert eng._pool.num_cached == cached_before
    hits0 = eng.stats()["prefix_cache"]["hits"]
    assert eng.submit(PLONG, 6).result(timeout=60) == ref
    assert eng.stats()["prefix_cache"]["hits"] == hits0 + 1


def test_race_to_admit_same_new_prefix(nets, clean_engine):
    eng = clean_engine
    fresh = _RS.randint(0, V, size=21).astype(onp.int32)
    ref = _ref(nets, fresh, 6)
    r1, r2 = eng.submit(fresh, 6), eng.submit(fresh, 6)
    assert r1.result(timeout=60) == ref
    assert r2.result(timeout=60) == ref
    assert eng._pool.num_allocated == 0
    hits0 = eng.stats()["prefix_cache"]["hits"]
    assert eng.submit(fresh, 6).result(timeout=60) == ref
    assert eng.stats()["prefix_cache"]["hits"] == hits0 + 1


def test_sampling_matches_generate_and_ignores_cobatching(net):
    """A request's draws depend on its seed and positions alone: the
    engine samples what `generate` samples for one prompt, co-batched
    or not."""
    kw = dict(temperature=0.9, top_k=5)
    want = lm_generate(net, P1[None, :], 8, seed=11,
                       **kw)[0, len(P1):].tolist()
    with ServingEngine(net, max_batch=2, block_size=8, prefill_chunk=4,
                       poll_interval=_POLL, **kw) as eng:
        assert eng.submit(P1, 8, seed=11).result(timeout=60) == want
        r1 = eng.submit(P1, 8, seed=11)
        r2 = eng.submit(P2, 8, seed=3)
        assert r1.result(timeout=60) == want
        assert r2.result(timeout=60) == lm_generate(
            net, P2[None, :], 8, seed=3, **kw)[0, len(P2):].tolist()


# --------------------------------------------------------------------- #
# overload and lifecycle
# --------------------------------------------------------------------- #
def test_evicted_blocks_are_reused(clean_engine):
    eng = clean_engine
    eng.set_fault_hook(_slow("step", 0.02))
    r1 = eng.submit(P1, 20)
    assert _wait(lambda: r1.status == "running")
    held = set(r1.block_ids)
    r1.cancel()
    with pytest.raises(RequestCancelled):
        r1.result(timeout=30)
    eng.set_fault_hook(None)
    r3 = eng.submit(P2, 6)
    r3.result(timeout=60)
    assert set(r3.block_ids) & held
    st = eng.stats()
    assert st["blocks_free"] == st["blocks_total"]
    assert st["evicted"].get("cancel", 0) >= 1


def test_deadline_evicts_mid_batch(clean_engine):
    eng = clean_engine
    eng.set_fault_hook(_slow("step", 0.02))
    req = eng.submit(P1, 50, deadline=0.08)
    with pytest.raises(RequestTimedOut):
        req.result(timeout=30)
    assert req.status == "evicted"
    assert 0 < len(req.tokens) < 50
    assert eng.stats()["evicted"].get("timeout", 0) >= 1


def test_queue_saturation_sheds_without_deadlock(net):
    eng = ServingEngine(net, max_batch=1, block_size=8, max_queue=2,
                        poll_interval=_POLL,
                        fault_hook=_slow("step", 0.02))
    try:
        reqs = [eng.submit(P2, 6) for _ in range(8)]
        shed = [r for r in reqs if r.status == "shed"]
        assert shed
        for r in shed:
            with pytest.raises(RequestShed) as ei:
                r.result(timeout=5)
            assert ei.value.reason == "queue_full"
        assert eng.drain(timeout=60)
        done = [r for r in reqs if r.status == "done"]
        assert len(done) + len(shed) == len(reqs)
        assert eng.stats()["shed"]["queue_full"] == len(shed)
        r = eng.submit(P2, 2, block=True, timeout=30)
        assert r.result(timeout=30)
    finally:
        eng.close()


def test_slo_budget_sheds_estimated_late_requests(clean_engine):
    eng = clean_engine
    eng.submit(P2, 2).result(timeout=60)   # seeds the prefill EWMA
    eng.set_fault_hook(_slow("step", 0.05))
    occupants = [eng.submit(P1, 12), eng.submit(P2, 12)]
    assert _wait(lambda: all(r.status == "running" for r in occupants))
    eng.set_ttft_budget(1e-4)
    late = eng.submit(P2, 4)
    with pytest.raises(RequestShed) as ei:
        late.result(timeout=30)
    assert ei.value.reason == "slo"
    eng.set_ttft_budget(None)
    eng.set_fault_hook(None)
    for r in occupants:
        r.result(timeout=60)


def test_abandoned_stream_releases_blocks(clean_engine):
    eng = clean_engine
    eng.set_fault_hook(_slow("step", 0.02))
    req = eng.submit(P1, 30)
    it = req.stream()
    assert isinstance(next(it), int)
    it.close()
    assert _wait(lambda: eng.stats()["blocks_free"]
                 == eng.stats()["blocks_total"])
    assert req.status == "cancelled"
    eng.set_fault_hook(None)


def test_lm_stream_yields_and_finishes(nets, clean_engine):
    toks = list(lm_stream(nets[1], P1, 8, engine=clean_engine))
    assert toks == _ref(nets, P1, 8)


def test_lm_stream_abandoned_releases_blocks(net, clean_engine):
    eng = clean_engine
    cancelled = eng.stats()["evicted"].get("cancel", 0)
    eng.set_fault_hook(_slow("step", 0.02))
    it = lm_stream(net, P1, 30, engine=eng)
    assert isinstance(next(it), int)
    it.close()                             # the caller walks away
    assert _wait(lambda: eng.stats()["blocks_free"]
                 == eng.stats()["blocks_total"])
    assert eng.stats()["evicted"].get("cancel", 0) == cancelled + 1
    eng.set_fault_hook(None)


def test_lm_stream_uses_the_default_engine(nets):
    """Without ``engine=``, `lm_stream` serves through the net's shared
    engine (`default_engine`), configured by its keyword arguments on
    first use and reused after."""
    net = nets[1]
    kw = dict(max_batch=2, block_size=8, poll_interval=_POLL)
    try:
        assert list(lm_stream(net, P2, 6, **kw)) == _ref(nets, P2, 6)
        eng = net._serving_engine
        assert list(lm_stream(net, P1, 8, **kw)) == _ref(nets, P1, 8)
        assert net._serving_engine is eng and not eng.closed
    finally:
        net._serving_engine.close()


def test_close_joins_scheduler_and_rejects_new_work(net):
    eng = ServingEngine(net, max_batch=1, block_size=8, poll_interval=_POLL)
    thread = eng._thread
    eng.close()
    assert not thread.is_alive()
    with pytest.raises(RuntimeError):
        eng.submit(P2, 2)
    eng.close()                            # idempotent


def test_close_aborts_inflight_requests(net):
    eng = ServingEngine(net, max_batch=1, block_size=8, max_queue=4,
                        poll_interval=_POLL,
                        fault_hook=_slow("step", 0.05))
    running = eng.submit(P1, 50)
    queued = eng.submit(P2, 50)
    assert _wait(lambda: running.status == "running")
    eng.close()
    for r in (running, queued):
        assert r.status == "cancelled"
        with pytest.raises(RequestCancelled):
            r.result(timeout=5)


def test_scheduler_error_is_parked_and_reraised(net):
    boom = RuntimeError("injected scheduler fault")

    def hook(phase):
        if phase == "step":
            raise boom

    eng = ServingEngine(net, max_batch=1, block_size=8,
                        poll_interval=_POLL, fault_hook=hook)
    req = eng.submit(P2, 8)
    with pytest.raises(RequestFailed):
        req.result(timeout=30)
    assert req.status == "failed"
    with pytest.raises(RequestFailed):
        eng.submit(P2, 2)
    with pytest.raises(RequestFailed) as ei:
        eng.close()
    assert ei.value.__cause__ is boom
    eng.close()


def test_submit_validation(clean_engine):
    with pytest.raises(ValueError):
        clean_engine.submit(onp.zeros((0,), onp.int32), 2)
    with pytest.raises(ValueError):
        clean_engine.submit(P1, 0)
    with pytest.raises(ValueError):
        clean_engine.submit(P1, MAXLEN)
    with pytest.raises(ValueError):
        ServingEngine(clean_engine._net, max_batch=0)
    with pytest.raises(ValueError):
        ServingEngine(clean_engine._net, block_size=12)


def test_concurrent_submitters_are_thread_safe(nets, clean_engine):
    ref = _ref(nets, P2, 4)
    results = [None] * 6

    def worker(i):
        results[i] = clean_engine.submit(P2, 4, block=True,
                                         timeout=60).result(timeout=60)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(results))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert all(r == ref for r in results)


def test_serve_caches_the_engine(nets):
    net = nets[1]
    ref = _ref(nets, P2, 6)
    with net.serve(max_batch=2, block_size=8, poll_interval=_POLL) as eng:
        assert eng.submit(torch.from_numpy(P2), 6).result(timeout=60) == ref
        assert net.serve() is eng
    assert eng.closed


# --------------------------------------------------------------------- #
# int8 KV pages and int8 weights
# --------------------------------------------------------------------- #
KV8_PROMPTS = (P1, P2, PA, PLONG)


def _kv8_engine(net, **kw):
    return ServingEngine(net, max_batch=2, block_size=8, prefill_chunk=4,
                         kv_dtype="int8", poll_interval=_POLL, **kw)


def test_kv8_engine_tokens_equal_jax_kv8_engine(nets):
    jeng = JaxEngine(nets[0], max_batch=2, block_size=8, prefill_chunk=4,
                     kv_dtype="int8", poll_interval=_POLL)
    try:
        want = [jeng.submit(p, 8).result(timeout=120) for p in KV8_PROMPTS]
    finally:
        jeng.close()
    with _kv8_engine(nets[1]) as eng:
        assert eng.kv_dtype == "int8" and eng.path == "float"
        st = eng.stats()
        assert st["kv_dtype"] == "int8" and st["path"] == "float"
        alone = [eng.submit(p, 8).result(timeout=60) for p in KV8_PROMPTS]
        reqs = [eng.submit(p, 8) for p in KV8_PROMPTS]
        cobatched = [r.result(timeout=60) for r in reqs]
    assert alone == want
    assert cobatched == want


def test_kv8_engine_greedy_parity_vs_float(nets, clean_engine):
    base = [clean_engine.submit(p, 12).result(timeout=60)
            for p in KV8_PROMPTS]
    with _kv8_engine(nets[1]) as eng:
        got = [eng.submit(p, 12).result(timeout=60) for p in KV8_PROMPTS]
    tot = sum(len(t) for t in base)
    hits = sum(a == b for ta, tb in zip(base, got) for a, b in zip(ta, tb))
    assert hits / tot >= 0.95, f"int8-KV greedy parity {hits}/{tot}"
    st = clean_engine.stats()
    assert st["kv_dtype"] == "model" and clean_engine.kv_dtype is None


def test_kv8_prefix_cache_hit_bit_identical(nets):
    """A kv8 request that binds cached int8 blocks (its own prompt's, or
    another prompt's shared prefix) decodes the bits of a cold one."""
    with _kv8_engine(nets[1]) as fresh:
        cold_b = fresh.submit(PB, 8).result(timeout=60)
    with _kv8_engine(nets[1]) as eng:
        cold = eng.submit(PA, 8).result(timeout=60)
        hit = eng.submit(PA, 8)
        assert hit.result(timeout=60) == cold
        assert hit.cached_tokens == 16
        shared = eng.submit(PB, 8)              # binds PA's PREF blocks
        assert shared.result(timeout=60) == cold_b
        assert shared.cached_tokens == 16
        st = eng.stats()
        assert st["prefix_cache"]["hits"] == 2
        assert st["blocks_free"] == st["blocks_total"]


def test_kv8_capacity_vs_bf16_at_equal_bytes():
    """At equal pool bytes the int8 pool holds >= 1.8x the resident
    sequences of the bf16 pool (D=64: 128 B against 64 + 4 B per head
    and token)."""
    net = TransformerLM(vocab=31, units=128, hidden_size=64, num_layers=1,
                        num_heads=2, max_len=64, dropout=0.0, device="cpu")
    net.cast("bfloat16")
    bf = ServingEngine(net, max_batch=1, block_size=8)
    q8 = ServingEngine(net, max_batch=1, block_size=8, kv_dtype="int8")
    try:
        assert bf.kv_bytes_per_token == 1 * 2 * 2 * 64 * 2
        assert q8.kv_bytes_per_token == 1 * 2 * 2 * (64 + 4)
        assert q8.kv_pool_bytes == q8.kv_block_bytes * (q8.max_seq_len // 8
                                                        + 1)
        budget = bf.kv_pool_bytes
        nbps = bf.max_seq_len // 8
        res_bf = bf.stats()["blocks_total"] // nbps
        res_q8 = (budget // q8.kv_block_bytes) // nbps
        assert res_q8 / res_bf >= 1.8
        assert bf.kv_bytes_per_token / q8.kv_bytes_per_token >= 1.8
    finally:
        bf.close()
        q8.close()


def test_kv_dtype_validation(net):
    for bad in ("fp8", "int4", "bfloat16"):
        with pytest.raises(ValueError):
            ServingEngine(net, max_batch=1, block_size=8, kv_dtype=bad)


def test_quantized_engine_follows_the_pass():
    """With ``quantize_for_decode`` applied (``quantized=None``), the
    engine runs the int8 weights: its greedy tokens are the quantized
    `generate`'s, with float or int8 KV pages; ``quantized=False``
    forces float weights, and ``quantized=True`` needs the pass."""
    qnet = TransformerLM(vocab=V, units=C, hidden_size=DFF, num_layers=L,
                         num_heads=H, max_len=MAXLEN, dropout=0.0,
                         device="cpu", seed=3)
    with pytest.raises(ValueError):
        ServingEngine(qnet, max_batch=1, block_size=8, quantized=True)
    float_want = lm_generate(qnet, P1[None, :], 8)[0, len(P1):].tolist()
    qnet.quantize_for_decode(act_quant="dynamic")
    want = lm_generate(qnet, P1[None, :], 8)[0, len(P1):].tolist()
    with ServingEngine(qnet, max_batch=2, block_size=8, prefill_chunk=4,
                       poll_interval=_POLL) as eng:
        assert eng.path == "int8" and eng.stats()["path"] == "int8"
        assert eng.submit(P1, 8).result(timeout=60) == want
    with ServingEngine(qnet, max_batch=2, block_size=8, prefill_chunk=4,
                       poll_interval=_POLL, quantized=False) as eng:
        assert eng.path == "float"
        assert eng.submit(P1, 8).result(timeout=60) == float_want
    with qnet.serve(max_batch=2, block_size=8, prefill_chunk=4,
                    poll_interval=_POLL, kv_dtype="int8") as eng:
        assert eng.path == "int8" and eng.kv_dtype == "int8"
        got = eng.submit(P1, 8).result(timeout=60)
    assert sum(a == b for a, b in zip(got, want)) / len(want) >= 0.95


# --------------------------------------------------------------------- #
# CUDA engines refuse, at construction, shapes the paged kernel refuses
# --------------------------------------------------------------------- #
def _net_on(device, units, heads):
    """The attributes the engine's shape check reads, on ``device`` (a
    CPU-only build of torch cannot build a CUDA net)."""
    from types import SimpleNamespace as NS
    return NS(embed=NS(weight=NS(device=torch.device(device))),
              _units=units, _max_len=MAXLEN,
              _layers=[NS(attn=NS(_num_heads=heads))])


@pytest.mark.parametrize("block_size, units, heads", [
    (128, 128, 2),          # block 128 > the kernel's 64, D = 64
    (16, 160, 2),           # D = 80
    (16, 192, 2),           # D = 96
    (8, 16, 2),             # D = 8
])
def test_cuda_engine_refuses_paged_kernel_shapes_at_construction(
        block_size, units, heads):
    with pytest.raises(ValueError, match="paged-attention kernel"):
        ServingEngine(_net_on("cuda", units, heads), max_batch=1,
                      block_size=block_size)


def test_engine_shape_check_reads_the_kernel_sets(monkeypatch):
    """Every head dim and block size the kernel takes passes on CUDA;
    the CPU (the plain version) takes any; and the sets are the paged
    attention module's own, not a copy."""
    import importlib

    from incubator_mxnet_tpu_torch.serving import engine as eng_mod
    pa = importlib.import_module("incubator_mxnet_tpu_torch.ops."
                                 "paged_attention")

    for D in pa._HEAD_DIMS:
        bs = 1
        while bs <= pa._MAX_BLOCK:
            eng_mod._check_kernel_shapes(_net_on("cuda", 2 * D, 2), bs)
            bs *= 2
    eng_mod._check_kernel_shapes(_net_on("cpu", 160, 2), 128)
    with pytest.raises(ValueError):
        eng_mod._check_kernel_shapes(_net_on("cuda", 128, 2), 128)
    monkeypatch.setattr(pa, "_MAX_BLOCK", 128)
    monkeypatch.setattr(pa, "_HEAD_DIMS", pa._HEAD_DIMS + (80,))
    eng_mod._check_kernel_shapes(_net_on("cuda", 128, 2), 128)
    eng_mod._check_kernel_shapes(_net_on("cuda", 160, 2), 16)


def test_engine_and_generate_record_no_graph(net):
    """The net's parameters are trainable, yet decoding records no
    autograd graph: `generate` and the engine run under no_grad."""
    assert all(p.requires_grad for p in net.parameters())
    out = net.generate(P1[None, :], 3)
    assert out.grad_fn is None and not out.requires_grad
    eng = ServingEngine(net, max_batch=1, block_size=8, poll_interval=_POLL)
    try:
        toks = eng.submit(P1, max_new_tokens=3).result(timeout=60)
        pools = eng._programs.pool_k + eng._programs.pool_v
        assert pools and all(t.grad_fn is None and not t.requires_grad
                             for t in pools)
    finally:
        eng.close()
    assert toks == out[0, len(P1):].tolist()
