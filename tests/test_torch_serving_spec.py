"""Speculative decoding in the PyTorch/CUDA port's serving engine
(`incubator_mxnet_tpu_torch/serving/`), mirroring
tests/test_serving_spec.py and holding the port to the JAX package.

The load-bearing contracts, as in the JAX package:

* **Greedy bit-identity** — with ``speculate_k > 0`` and any draft (a
  deliberately bad one included), every lane's tokens equal the
  non-speculative engine's and `lm_generate`'s, across a mid-burst
  eviction, a window running off the sequence cap, the int8 KV pool
  and a prefix-cache hit; and the port's speculative engine gives the
  JAX speculative engine's tokens.
* **Program parity** — the draft step's tokens and logits and the
  verify's logits, emitted tokens and accepted lengths equal the JAX
  programs' on the same pools (both on their dense CPU attention),
  logits within 1e-5 in f32, the pages they write too.
* **Stochastic exactness** — sampled speculation keeps the target's
  distribution: a chi-squared test over a tiny vocabulary holds the
  first speculatively emitted token's marginal to the analytic one of
  the port's own net.
* **Accounting** — one block allocation covers the target and the
  draft pools, every block returns, and the reservation covers the k
  in-flight positions.

Tiny nets (V=61, C=16, one layer), weights carried from the JAX nets by
`convert.load_jax_params`, 1 ms polls.
"""
import time
from types import SimpleNamespace as NS

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.contrib.quantization import quantize_kv as jax_qkv
from incubator_mxnet_tpu.models import generation as JG
from incubator_mxnet_tpu.models.generation import lm_generate as jax_generate
from incubator_mxnet_tpu.models.transformer import TransformerLM as JaxLM
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu.serving import ServingEngine as JaxEngine
from incubator_mxnet_tpu.serving import programs as JP
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import TransformerLM, lm_generate
from incubator_mxnet_tpu_torch.models import generation as TG
from incubator_mxnet_tpu_torch.serving import (BlockPool, PagedPrograms,
                                               RequestCancelled,
                                               ServingEngine)

V, C, DFF, L, H, MAXLEN = 61, 16, 32, 1, 2, 64
P1 = onp.array([3, 7, 11, 2, 9], onp.int32)
P2 = onp.array([5, 1, 2], onp.int32)
_RS = onp.random.RandomState(7)
PREF = _RS.randint(0, V, size=16).astype(onp.int32)    # 2 full blocks @ 8
PA = onp.concatenate([PREF, _RS.randint(0, V, size=5).astype(onp.int32)])
PB = onp.concatenate([PREF, _RS.randint(0, V, size=4).astype(onp.int32)])
_POLL = 0.001


def _wait(pred, timeout=30.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.002)
    return False


def _slow_step(seconds):
    def hook(phase):
        if phase == "step":
            time.sleep(seconds)
    return hook


def _pair(seed, vocab=V, units=C, hidden=DFF, layers=L, heads=H,
          max_len=MAXLEN):
    """A JAX TransformerLM and the port's, with the JAX net's weights."""
    mx.random.seed(seed)
    jnet = JaxLM(vocab=vocab, units=units, hidden_size=hidden,
                 num_layers=layers, num_heads=heads, max_len=max_len,
                 dropout=0.0)
    jnet.initialize()
    jnet(NDArray(jnp.ones((1, 4), jnp.int32)))
    tnet = TransformerLM(vocab=vocab, units=units, hidden_size=hidden,
                         num_layers=layers, num_heads=heads, max_len=max_len,
                         dropout=0.0, device="cpu")
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                           jnet._collect_params_with_prefix().items()})
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    return _pair(0)


@pytest.fixture(scope="module")
def net(nets):
    return nets[1]


@pytest.fixture(scope="module")
def bad_drafts():
    """A deliberately bad draft (another random net, narrower, one
    head) whose greedy proposals almost never match the target."""
    return _pair(1234, units=8, hidden=16, heads=1)


@pytest.fixture(scope="module")
def bad_draft(bad_drafts):
    return bad_drafts[1]


@pytest.fixture(scope="module")
def spec_engine(net, bad_draft):
    """The shared greedy speculative engine (bad draft, k=3)."""
    eng = ServingEngine(net, max_batch=2, block_size=8, poll_interval=_POLL,
                        speculate_k=3, draft_net=bad_draft)
    yield eng
    eng.close()


@pytest.fixture
def clean_spec_engine(spec_engine):
    spec_engine.set_fault_hook(None)
    yield spec_engine
    assert spec_engine.drain(timeout=30)
    spec_engine.set_fault_hook(None)


def _gen(net, prompt, n, **kw):
    return lm_generate(net, prompt[None, :], n, **kw)[0, len(prompt):].tolist()


# --------------------------------------------------------------------- #
# greedy bit-identity
# --------------------------------------------------------------------- #
def test_spec_greedy_bit_identical_bad_draft(nets, clean_spec_engine):
    eng = clean_spec_engine
    ref1, ref2 = _gen(nets[1], P1, 8), _gen(nets[1], P2, 6)
    assert ref1 == onp.asarray(
        jax_generate(nets[0], P1[None, :], 8))[0, len(P1):].tolist()
    assert eng.submit(P1, 8).result(timeout=60) == ref1
    # co-batched lanes stay independent and exact
    r1, r2 = eng.submit(P1, 8), eng.submit(P2, 6)
    assert r1.result(timeout=60) == ref1
    assert r2.result(timeout=60) == ref2
    # mid-window truncation: max_new below / not a multiple of k+1
    for n in (1, 2, 5):
        assert eng.submit(P1, n).result(timeout=60) == ref1[:n]


def test_spec_mid_batch_eviction_bit_identity(clean_spec_engine):
    eng = clean_spec_engine
    ra, rb = eng.submit(P1, 10), eng.submit(P2, 10)
    base = ra.result(timeout=60)
    rb.result(timeout=60)
    assert eng.drain(timeout=30)
    # the neighbour cancelled mid-generation, mid speculative burst
    eng.set_fault_hook(_slow_step(0.02))
    ra, rb = eng.submit(P1, 10), eng.submit(P2, 10)
    assert _wait(lambda: len(rb.tokens) >= 3)
    rb.cancel()
    assert ra.result(timeout=60) == base
    with pytest.raises(RequestCancelled):
        rb.result(timeout=60)
    eng.set_fault_hook(None)
    # solo: rejected-position garbage and the evicted lane's scratch
    # writes never reach the survivor
    assert eng.submit(P1, 10).result(timeout=60) == base


def test_spec_full_length_window_runs_off_the_end(net, bad_draft):
    """A lane at max_seq_len: the window's trailing positions pass the
    sequence cap and must land in scratch (and clamp their positional
    encoding), never in a neighbour's pages."""
    with ServingEngine(net, max_batch=2, block_size=8, max_seq_len=32,
                       poll_interval=_POLL, speculate_k=4,
                       draft_net=bad_draft) as eng:
        assert eng.submit(P1, 27).result(timeout=60) == _gen(net, P1, 27)
        st = eng.stats()
        assert st["blocks_free"] == st["blocks_total"]


def test_spec_tokens_equal_jax_spec_engine(nets, bad_drafts):
    """The port's speculative engine against the JAX package's, greedy,
    on the same weights: the same tokens, alone and co-batched."""
    prompts = (P1, P2, PA)
    jeng = JaxEngine(nets[0], max_batch=2, block_size=8, prefill_chunk=4,
                     poll_interval=_POLL, speculate_k=3,
                     draft_net=bad_drafts[0])
    try:
        want = [jeng.submit(p, 9).result(timeout=120) for p in prompts]
    finally:
        jeng.close()
    with ServingEngine(nets[1], max_batch=2, block_size=8, prefill_chunk=4,
                       poll_interval=_POLL, speculate_k=3,
                       draft_net=bad_drafts[1]) as eng:
        alone = [eng.submit(p, 9).result(timeout=60) for p in prompts]
        reqs = [eng.submit(p, 9) for p in prompts]
        cobatched = [r.result(timeout=60) for r in reqs]
    assert alone == want
    assert cobatched == want


def test_spec_prefix_cache_hit_bit_identical(net, bad_draft):
    """A speculative request that binds cached blocks — target AND draft
    K/V live in them — decodes the tokens of a cold one."""
    kw = dict(max_batch=2, block_size=8, prefill_chunk=4,
              poll_interval=_POLL, speculate_k=3, draft_net=bad_draft)
    with ServingEngine(net, **kw) as fresh:
        cold_b = fresh.submit(PB, 8).result(timeout=60)
    with ServingEngine(net, **kw) as eng:
        cold = eng.submit(PA, 8).result(timeout=60)
        hit = eng.submit(PA, 8)
        assert hit.result(timeout=60) == cold == _gen(net, PA, 8)
        assert hit.cached_tokens == 16
        shared = eng.submit(PB, 8)              # binds PA's PREF blocks
        assert shared.result(timeout=60) == cold_b
        assert shared.cached_tokens == 16
        st = eng.stats()
        assert st["prefix_cache"]["hits"] == 2
        assert st["blocks_free"] == st["blocks_total"]


# --------------------------------------------------------------------- #
# accounting and stats
# --------------------------------------------------------------------- #
def test_spec_blocks_returned_and_stats_surface(clean_spec_engine):
    eng = clean_spec_engine
    req = eng.submit(P1, 8)
    assert req.result(timeout=60)
    assert eng.drain(timeout=30)
    st = eng.stats()
    assert st["blocks_free"] == st["blocks_total"]
    spec = st["speculate"]
    assert spec["k"] == 3 and eng.speculate_k == 3
    assert spec["greedy"] is True and "net[" in spec["draft"]
    assert spec["proposed"] >= spec["accepted"] >= 0
    assert spec["steps"] >= 1
    # the bad draft guarantees rejections (rollback attribution)
    assert spec["rollback"].get("rejected", 0) >= 1
    assert req.spec_proposed > 0
    assert 0.0 <= req.spec_accept_rate <= 1.0
    # the draft's pages count in the pool's bytes
    pg = eng._programs
    draft_bytes = sum(t.numel() * t.element_size()
                      for t in pg.dpool_k + pg.dpool_v)
    assert draft_bytes > 0
    assert eng.kv_pool_bytes == draft_bytes + sum(
        t.numel() * t.element_size() for t in pg.pool_k + pg.pool_v)


def test_spec_reservation_covers_window(net, bad_draft):
    """`_blocks_needed` grows by the k in-flight positions: a request
    whose last token sits flush on a block boundary needs one more
    block under speculation than without, never past the cap."""
    args = dict(max_batch=1, block_size=8, max_seq_len=64,
                poll_interval=_POLL)
    with ServingEngine(net, **args) as plain, \
            ServingEngine(net, speculate_k=4, draft_net=bad_draft,
                          **args) as spec:
        # P+N = 16: 2 blocks plain; the window writes up to position
        # P+N-2+k = 18: 3 blocks under speculation
        assert plain._blocks_needed(8, 8) == 2
        assert spec._blocks_needed(8, 8) == 3
        assert spec._blocks_needed(8, 56) == 8
    assert BlockPool.covers(3, 8, 18)
    assert not BlockPool.covers(2, 8, 18)
    assert not BlockPool.covers(2, 8, -1)


def test_spec_config_validation(net, bad_draft):
    with pytest.raises(ValueError):
        ServingEngine(net, speculate_k=-1)
    with pytest.raises(ValueError):
        ServingEngine(net, max_seq_len=16, block_size=8, speculate_k=16,
                      draft_net=bad_draft)
    with pytest.raises(ValueError):        # self-draft needs the int8 mark
        ServingEngine(net, speculate_k=2)
    small = _pair(7, vocab=V + 2, units=8, hidden=16, heads=1)[1]
    with pytest.raises(ValueError):        # vocab mismatch
        ServingEngine(net, speculate_k=2, draft_net=small)
    shorty = _pair(8, units=8, hidden=16, heads=1, max_len=16)[1]
    with pytest.raises(ValueError):        # draft can't cover max_seq_len
        ServingEngine(net, speculate_k=2, draft_net=shorty)
    qnet = TransformerLM(vocab=V, units=C, hidden_size=DFF, num_layers=L,
                         num_heads=H, max_len=MAXLEN, dropout=0.0,
                         device="cpu", seed=5).quantize_for_decode()
    with pytest.raises(ValueError, match="already int8"):
        ServingEngine(qnet, speculate_k=2)  # an int8 target can't self-draft


def _net_on(device, units, heads, vocab=V):
    """A stand-in net object that reports ``device`` (no tensors)."""
    return NS(embed=NS(weight=NS(device=torch.device(device),
                                 shape=(vocab, units))),
              _units=units, _max_len=MAXLEN,
              _layers=[NS(attn=NS(_num_heads=heads))])


def test_cuda_engine_refuses_draft_the_paged_kernel_refuses():
    """On CUDA the draft's head dim must suit the paged kernel too (its
    pool runs through it), checked when the engine is built."""
    with pytest.raises(ValueError, match="draft net"):
        ServingEngine(_net_on("cuda", 128, 2), max_batch=1, block_size=16,
                      speculate_k=2, draft_net=_net_on("cuda", 160, 2))
    with pytest.raises(ValueError, match="draft_net is on"):
        ServingEngine(_net_on("cuda", 128, 2), max_batch=1, block_size=16,
                      speculate_k=2, draft_net=_net_on("cpu", 128, 2))


# --------------------------------------------------------------------- #
# the int8 self-draft
# --------------------------------------------------------------------- #
def test_spec_int8_self_draft_exact_with_high_acceptance():
    net2 = TransformerLM(vocab=V, units=C, hidden_size=DFF, num_layers=L,
                         num_heads=H, max_len=MAXLEN, dropout=0.0,
                         device="cpu", seed=3)
    net2.quantize_for_decode(act_quant="none")
    ref = _gen(net2, P1, 12, quantized=False)
    with ServingEngine(net2, max_batch=2, block_size=8, poll_interval=_POLL,
                       speculate_k=4, quantized=False) as eng:
        assert eng.path == "float"
        assert eng.submit(P1, 12).result(timeout=60) == ref
        spec = eng.stats()["speculate"]
    assert spec["draft"] == "self-int8"
    # int8 argmax tracks the float target closely: the premise of
    # self-speculation
    assert spec["accepted"] > 0
    assert spec["accept_rate"] > 0.5


# --------------------------------------------------------------------- #
# stochastic exactness: chi-squared against the analytic marginal
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("temp", [1.0, 0.1])
def test_spec_stochastic_matches_target_distribution(temp):
    """Tiny vocab, fixed seeds: the marginal of the FIRST speculatively
    produced token (index 1; index 0 comes from the prefill) over many
    seeds must match sum_t0 p(t0) p(t1 | prompt+t0) of the port's net
    forward.  The bad draft forces the rejection and residual-resample
    path to carry real probability mass; at temperature 0.1 p and q
    are peaked on different tokens, so most of it goes through the
    residual (the JAX test's temperature 1.0 leaves both near-uniform,
    where a correction drawn from p instead of max(p - q, 0) passes)."""
    vv, n_seeds = 13, 600
    tnet = TransformerLM(vocab=vv, units=C, hidden_size=DFF, num_layers=L,
                         num_heads=H, max_len=32, dropout=0.0, device="cpu",
                         seed=0)
    tdraft = TransformerLM(vocab=vv, units=8, hidden_size=16, num_layers=1,
                           num_heads=1, max_len=32, dropout=0.0,
                           device="cpu", seed=999)
    prompt = onp.array([3, 7, 2], onp.int32)

    def probs_after(prefix):
        with torch.no_grad():
            lg = tnet(torch.as_tensor(prefix[None, :], dtype=torch.long))
        z = lg[0, -1].double().numpy() / temp
        p = onp.exp(z - z.max())
        return p / p.sum()

    p0 = probs_after(prompt)
    marg = sum(p0[t0] * probs_after(onp.concatenate([prompt, [t0]]))
               for t0 in range(vv))

    counts = onp.zeros(vv)
    with ServingEngine(tnet, max_batch=4, block_size=8, poll_interval=_POLL,
                       temperature=temp, top_k=0, speculate_k=3,
                       draft_net=tdraft) as eng:
        pending = []
        for s in range(n_seeds):
            pending.append(eng.submit(prompt, 2, seed=s))
            if len(pending) >= 16:
                for r in pending:
                    counts[r.result(timeout=120)[1]] += 1
                pending = []
        for r in pending:
            counts[r.result(timeout=120)[1]] += 1
        spec = eng.stats()["speculate"]
    assert spec["greedy"] is False
    assert spec["rollback"].get("rejected", 0) >= 1   # residual exercised
    exp = marg * n_seeds
    mask = exp >= 5
    chi2 = ((counts[mask] - exp[mask]) ** 2 / exp[mask]).sum()
    dof = int(mask.sum()) - 1
    lump_exp, lump_obs = exp[~mask].sum(), counts[~mask].sum()
    if lump_exp > 0:
        chi2 += (lump_obs - lump_exp) ** 2 / lump_exp
        dof += 1
    # the JAX test's bound: the 99.9th percentile of chi2(12) is ~32.9,
    # a wrong acceptance rule lands in the hundreds
    assert chi2 < 40.0, f"chi2={chi2:.1f} (dof={dof}), counts={counts}"


def test_spec_sampling_is_seeded_and_in_range(net, bad_draft):
    """Sampled speculation draws from per-request streams: a seed
    replays its tokens whoever it is co-batched with, and top_k keeps
    every token among the target's top k at its position."""
    with ServingEngine(net, max_batch=2, block_size=8, poll_interval=_POLL,
                       temperature=0.8, top_k=5, speculate_k=3,
                       draft_net=bad_draft) as eng:
        alone = eng.submit(P1, 10, seed=11).result(timeout=60)
        r1, r2 = eng.submit(P1, 10, seed=11), eng.submit(P2, 10, seed=4)
        assert r1.result(timeout=60) == alone
        r2.result(timeout=60)
    seq = onp.concatenate([P1, alone])
    with torch.no_grad():
        lg = net(torch.as_tensor(seq[None, :], dtype=torch.long))[0]
    top5 = lg[len(P1) - 1:-1].topk(5, dim=-1).indices
    assert all(int(t) in top5[i].tolist() for i, t in enumerate(alone))


# --------------------------------------------------------------------- #
# int8 KV pool composes with speculation
# --------------------------------------------------------------------- #
def test_spec_kv8_matches_nonspec_kv8(net, bad_draft):
    kw = dict(max_batch=2, block_size=8, poll_interval=_POLL,
              kv_dtype="int8")
    with ServingEngine(net, speculate_k=3, draft_net=bad_draft,
                       **kw) as spec_eng:
        assert spec_eng._programs.dpool_k[0].dtype == torch.float32
        got = [spec_eng.submit(p, 12).result(timeout=60) for p in (P1, PA)]
    with ServingEngine(net, **kw) as plain_eng:
        ref = [plain_eng.submit(p, 12).result(timeout=60) for p in (P1, PA)]
    # the verify quantizes window K/V with the step's per-head recipe
    assert got == ref


# --------------------------------------------------------------------- #
# program-level parity with the JAX programs
# --------------------------------------------------------------------- #
K_SPEC, BS, NBPS = 3, 8, 4
MSL = BS * NBPS


def _program_inputs():
    """Three lanes: one mid-sequence, one whose window runs past the
    cap, one idle (scratch tables)."""
    tables = onp.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], onp.int32)
    pos = onp.array([10, MSL - 2, 0], onp.int32)
    active = onp.array([True, True, False])
    toks = onp.array([4, 9, 0], onp.int32)
    return tables, toks, pos, active, onp.zeros(3, onp.int64)


def _fill(port_pools, rs, kv8):
    """Random pool contents, written into the port's pools; returns the
    same arrays for the JAX programs (a page value per slot, for int8
    pools per-head-vector quantized with the JAX package's recipe)."""
    out = []
    for t in port_pools:
        x = rs.standard_normal(t.shape).astype(onp.float32)
        if kv8:
            q, s = jax_qkv(jnp.asarray(x))
            q, s = onp.array(q), onp.array(s)
            t.copy_(torch.from_numpy(q))
            out.append((q, s))
        else:
            t.copy_(torch.from_numpy(x))
            out.append((x, None))
    return out


def _capture_logits(monkeypatch, module, sink):
    real = module._logits_of

    def wrapper(params, h):
        out = real(params, h)
        sink.append(onp.asarray(out))
        return out

    monkeypatch.setattr(module, "_logits_of", wrapper)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_draft_and_verify_programs_match_jax(nets, bad_drafts, monkeypatch,
                                             kv_dtype):
    (jnet, tnet), (jdraft, tdraft) = nets, bad_drafts
    kv8 = kv_dtype == "int8"
    progs = PagedPrograms(tnet, max_batch=3, block_size=BS,
                          blocks_per_seq=NBPS, num_blocks=13,
                          temperature=0.0, top_k=0, kv_dtype=kv_dtype,
                          speculate_k=K_SPEC, draft_net=tdraft)
    rs = onp.random.RandomState(3)
    target = _fill(progs.pool_k + progs.pool_v, rs, kv8)
    if kv8:
        for t, (_, s) in zip(progs.scale_k + progs.scale_v, target):
            t.copy_(torch.from_numpy(s))
    draft = _fill(progs.dpool_k + progs.dpool_v, rs, False)
    tables, toks, pos, active, seeds = _program_inputs()
    jargs = (jnp.asarray(tables), jnp.asarray(toks), jnp.asarray(pos),
             jnp.asarray(active), jnp.zeros((3, 2), jnp.uint32))

    t_logits, j_logits = [], []
    _capture_logits(monkeypatch, TG, t_logits)
    _capture_logits(monkeypatch, JG, j_logits)
    d_toks, q = progs.draft_step(tables, toks, pos, active, seeds)
    assert q is None
    jdraft_step = JP._build_draft_step(
        1, ("gelu",), BS, K_SPEC, 0.0, 0, True, "dense", MSL, "draft")
    dnl = len(tdraft._layers)
    jdk, jdv, jd_toks, _ = jdraft_step(
        tuple(jnp.asarray(x) for x, _ in draft[:dnl]),
        tuple(jnp.asarray(x) for x, _ in draft[dnl:]), *jargs,
        JG._gather_params(jdraft, MSL))
    onp.testing.assert_array_equal(d_toks[:2].numpy(),
                                   onp.asarray(jd_toks)[:2])
    assert len(t_logits) == len(j_logits) == K_SPEC
    for a, b in zip(t_logits, j_logits):
        onp.testing.assert_allclose(a[:2], b[:2], atol=1e-5, rtol=0)
    # the draft's pages, the scratch block aside
    for t, j in zip(progs.dpool_k + progs.dpool_v, jdk + jdv):
        onp.testing.assert_allclose(t[1:].numpy(), onp.asarray(j)[1:],
                                    atol=1e-5, rtol=0)

    jverify = JP._build_spec_verify(
        H, ("gelu",), BS, K_SPEC, 0.0, 0, True, kv_dtype, "dense", MSL,
        "verify")
    nl = len(tnet._layers)
    jpools = [tuple(jnp.asarray(x) for x, _ in target[:nl]),
              tuple(jnp.asarray(x) for x, _ in target[nl:]),
              tuple(jnp.asarray(s) for _, s in target[:nl]) if kv8 else (),
              tuple(jnp.asarray(s) for _, s in target[nl:]) if kv8 else ()]
    jparams = JG._gather_params(jnet, MSL)
    # round 1 verifies the bad draft's tokens; round 2 (over the pools
    # round 1 left) a window whose first draft is the target's argmax
    for rnd in range(2):
        t_logits.clear()
        j_logits.clear()
        out, alen = progs.spec_verify(tables, toks, pos, active, seeds,
                                      d_toks, q)
        *jpools, jout, jalen = jverify(
            *jpools, *jargs, jnp.asarray(d_toks.numpy(), jnp.int32),
            jnp.zeros((3, K_SPEC, 1), jnp.float32), jparams)
        onp.testing.assert_array_equal(out[:2], onp.asarray(jout)[:2])
        onp.testing.assert_array_equal(alen[:2], onp.asarray(jalen)[:2])
        assert (alen[:2] >= rnd).all()
        onp.testing.assert_allclose(
            t_logits[0].reshape(3, K_SPEC + 1, V)[:2], j_logits[0][:2],
            atol=1e-5, rtol=0)
        # the target's pages (and int8 scales) the windows wrote
        for t, j in zip(progs.pool_k + progs.pool_v + progs.scale_k
                        + progs.scale_v, [a for tup in jpools for a in tup]):
            tol = 1 if t.dtype == torch.int8 else 1e-5
            onp.testing.assert_allclose(
                t[1:].numpy().astype(onp.float32),
                onp.asarray(j)[1:].astype(onp.float32), atol=tol, rtol=0)
        d_toks = d_toks.clone()
        d_toks[:, 0] = torch.from_numpy(out[:, 0])
