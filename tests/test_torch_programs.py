"""The captured programs of the PyTorch/CUDA port (`_graphs`,
`models.generation`'s program cache, `HybridBlock.hybridize`) on the
CPU, held against the JAX package.

On the CPU a `_graphs.Program` runs its body eagerly on its static
buffers: these tests hold that body — the one a CUDA graph captures —
to the JAX package (the device-position decode step, the bucketed
prompt, the beam step over static caches), and check the host side of
the programs: staging, the program-cache keys and LRU cap, the weight
fingerprint, hybridize's cache and its invalidation.  The capture and
replay themselves need the card (`chip_smoke.py` phase 20).
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.models import generation as JG
from incubator_mxnet_tpu.models.transformer import TransformerLM as JaxLM
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import MXNetError, _graphs, autograd
from incubator_mxnet_tpu_torch import random as mxt_random
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import block as TB
from incubator_mxnet_tpu_torch.models import TransformerLM
from incubator_mxnet_tpu_torch.models import generation as TG
from incubator_mxnet_tpu_torch.serving import PagedPrograms, programs as TP

CFG = dict(vocab=61, units=32, hidden_size=64, num_layers=2, num_heads=4,
           max_len=64, dropout=0.0)


def _pair(seed=0):
    mx.random.seed(seed)
    jnet = JaxLM(**CFG)
    jnet.initialize()
    jnet(NDArray(jnp.ones((1, 4), jnp.int32)))
    tnet = TransformerLM(**CFG, device="cpu")
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                           jnet._collect_params_with_prefix().items()})
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    return _pair(0)


def _prompt(B=2, P=5, seed=3):
    return onp.random.RandomState(seed).randint(
        0, CFG["vocab"], (B, P)).astype(onp.int32)


def _fresh(tnet):
    """A new net with ``tnet``'s weights and nothing cached."""
    net = TransformerLM(**CFG, device="cpu")
    with torch.no_grad():
        for p, q in zip(net.parameters(), tnet.parameters()):
            p.copy_(q)
    return net.cast(tnet.embed.weight.dtype) \
        if tnet.embed.weight.dtype != torch.float32 else net


# ------------------------------------------------------ the decode step
@pytest.mark.parametrize("t", [5, 11, 30])
def test_device_position_decode_token_matches_jax(nets, t):
    """`_decode_token` with the position as a (1,) int64 tensor (what
    a captured step reads from the card) against the JAX
    `_decode_token` on the same caches: logits and the cache slot it
    writes."""
    jnet, tnet = nets
    B, W, H = 3, 32, CFG["num_heads"]
    D = CFG["units"] // H
    rs = onp.random.RandomState(t)
    ks = [rs.standard_normal((B, H, W, D)).astype(onp.float32)
          for _ in range(2)]
    vs = [rs.standard_normal((B, H, W, D)).astype(onp.float32)
          for _ in range(2)]
    tok = rs.randint(0, CFG["vocab"], (B,)).astype(onp.int32)
    acts = ("gelu",) * CFG["num_layers"]
    jk, jv, jlog = JG._decode_token(
        JG._gather_params(jnet, CFG["max_len"]), acts,
        [jnp.asarray(k) for k in ks], [jnp.asarray(v) for v in vs],
        jnp.asarray(tok), jnp.int32(t), H)
    tk = [torch.from_numpy(k.copy()) for k in ks]
    tv = [torch.from_numpy(v.copy()) for v in vs]
    with torch.no_grad():
        tlog = TG._decode_token(TG._gather_params(tnet), acts, tk, tv,
                                torch.from_numpy(tok).long(),
                                torch.tensor([t]), H)
    onp.testing.assert_allclose(tlog.numpy(), onp.asarray(jlog), atol=1e-5,
                                rtol=0)
    for a, b in zip(tk + tv, list(jk) + list(jv)):
        onp.testing.assert_allclose(a.numpy(), onp.asarray(b), atol=1e-6,
                                    rtol=0)


# ------------------------------------------------------ generate's cache
@pytest.mark.parametrize("n", [0, 1, 5, 16, 17, 31, 32, 33, 100, 1000])
def test_bucket_length_matches_jax(n):
    assert TG.bucket_length(n) == JG.bucket_length(n)
    assert TG.bucket_length(n, floor=4) == JG.bucket_length(n, floor=4)


def test_bucket_length_refuses_negative():
    with pytest.raises(ValueError):
        TG.bucket_length(-1)


@pytest.mark.parametrize("P", [3, 5, 9, 17])
def test_pad_to_bucket_equals_unpadded_and_jax(nets, P):
    """One program per prompt bucket with the true length carried in:
    the tokens of the unpadded call and of the JAX package's bucketed
    call, at 2 layers in f32 on the CPU.  (On the card in bf16 the
    contract is weaker, `lm_generate`'s docstring: the prefill and the
    first token are bit-identical, and the decode steps' attention sums
    over the longer padded cache in another order; `chip_smoke.py`
    phase 22 prints the op and the agreement, 0.9640 of the tokens at
    its 12-layer net.)"""
    jnet, tnet = nets
    prompt = _prompt(P=P, seed=P)
    got = TG.lm_generate(tnet, prompt, 8, pad_to_bucket=True)
    onp.testing.assert_array_equal(
        got.numpy(), TG.lm_generate(tnet, prompt, 8).numpy())
    onp.testing.assert_array_equal(
        got.numpy(),
        onp.asarray(JG.lm_generate(jnet, prompt, 8, pad_to_bucket=True)))
    Pp = TG.bucket_length(P)
    assert (2, Pp, 8, 0.0, 0, -1, None, True) in TG._program_cache(tnet)


def test_bucketed_sampling_equals_unpadded(nets):
    _, tnet = nets
    prompt = _prompt(P=7, seed=11)
    kw = dict(temperature=0.9, top_k=5, seed=4)
    assert torch.equal(TG.lm_generate(tnet, prompt, 8, pad_to_bucket=True,
                                      **kw),
                       TG.lm_generate(tnet, prompt, 8, **kw))


def test_one_program_serves_a_bucket_of_lengths():
    _, tnet = _pair(1)
    for P in (3, 9, 12, 16):
        TG.lm_generate(tnet, _prompt(P=P, seed=P), 4, pad_to_bucket=True)
    assert list(TG._program_cache(tnet)) == [
        (2, 16, 4, 0.0, 0, -1, None, True)]


def test_program_cache_keys_follow_jax_signature(nets):
    _, tnet = nets
    prompt = _prompt(seed=8)
    cache = TG._program_cache(tnet)
    TG.lm_generate(tnet, prompt, 6, temperature=0.5, top_k=3, eos_id=2,
                   seed=9)
    key = (2, 5, 6, 0.5, 3, 2, None, False)
    assert key in cache and isinstance(cache[key], TG._GenerateProgram)
    before = cache[key]
    # the seed is not part of the key: the draws happen outside the graph
    TG.lm_generate(tnet, prompt, 6, temperature=0.5, top_k=3, eos_id=2,
                   seed=10)
    assert cache[key] is before and next(reversed(cache)) == key
    TG.lm_beam_search(tnet, prompt, 4, beam_size=3, alpha=0.6)
    assert ("beam", 2, 5, 4, 3, -1, 0.6, None) in cache


def test_program_cache_lru_cap_and_override():
    _, tnet = _pair(2)
    assert TG._PROGRAM_CACHE_CAP == JG._PROGRAM_CACHE_CAP == 32
    tnet._gen_program_cache_cap = 2
    for N in (2, 3, 4):
        TG.lm_generate(tnet, _prompt(seed=N), N)
    assert [k[2] for k in TG._program_cache(tnet)] == [3, 4]
    # a hit refreshes recency: 3 survives the next insert, 4 does not
    TG.lm_generate(tnet, _prompt(), 3)
    TG.lm_generate(tnet, _prompt(), 5)
    assert [k[2] for k in TG._program_cache(tnet)] == [3, 5]


def test_program_reuse_restarts_its_state(nets):
    """A cached program's static caches and counters carry nothing from
    one call into the next: different prompts of one signature, each
    equal to the JAX package's tokens, and the first call's result left
    as it was."""
    jnet, tnet = nets
    outs = []
    for seed in (20, 21, 20):
        prompt = _prompt(seed=seed)
        got = TG.lm_generate(tnet, prompt, 8)
        onp.testing.assert_array_equal(
            got.numpy(), onp.asarray(JG.lm_generate(jnet, prompt, 8)))
        outs.append(got)
    assert torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("eos", [False, True])
def test_beam_program_matches_jax_on_reuse(nets, eos):
    """The beam step over static caches (reordered in place by parent)
    against the JAX `lm_beam_search`, twice through one cached program
    with different prompts."""
    jnet, tnet = nets
    for seed in (30, 31):
        prompt = _prompt(seed=seed)
        e = -1
        if eos:
            e = int(TG.lm_generate(tnet, prompt, 6)[0, 7])
        seqs, scores = TG.lm_beam_search(tnet, prompt, 6, beam_size=3,
                                         eos_id=e, alpha=0.6)
        js, jsc = JG.lm_beam_search(jnet, prompt, 6, beam_size=3,
                                    eos_id=e, alpha=0.6)
        onp.testing.assert_array_equal(seqs.numpy(), onp.asarray(js))
        onp.testing.assert_allclose(scores.numpy(), onp.asarray(jsc),
                                    atol=1e-4, rtol=0)


# ------------------------------------------------- the weight fingerprint
def _flip_set_data(net):
    net.head.weight.set_data(-net.head.weight.detach())


def _flip_in_place(net):
    with torch.no_grad():
        net.head.weight.mul_(-1)


def _cast_round_trip(net):
    net.cast("bfloat16")
    net.cast("float32")


WRITES = {"set_data": _flip_set_data, "in_place": _flip_in_place,
          "cast_round_trip": _cast_round_trip,
          "quantize_for_decode": lambda net: net.quantize_for_decode(),
          "dequantize_decode": lambda net: net.dequantize_decode()}


@pytest.mark.parametrize("kind", sorted(WRITES))
def test_weight_write_regathers_and_rebinds(kind):
    """Each kind of write moves `_params_fingerprint`, the next call
    gathers a new tree and rebinds the program to it (a recapture on
    the card when an address moved), and its tokens equal a fresh net's
    on the new weights."""
    _, tnet = _pair(3)
    if kind == "dequantize_decode":
        tnet.quantize_for_decode()
    prompt = _prompt(seed=40)
    TG.lm_generate(tnet, prompt, 6)
    qc = TG._quant_config(tnet, None)
    fp0 = TG._params_fingerprint(tnet, qc)
    params0, psig0 = TG._gathered(tnet, qc)
    WRITES[kind](tnet)
    qc = TG._quant_config(tnet, None)
    assert TG._params_fingerprint(tnet, qc) != fp0
    got = TG.lm_generate(tnet, prompt, 6)
    params1, psig1 = TG._gathered(tnet, qc)
    assert params1 is not params0
    prog = TG._lru_touch(TG._program_cache(tnet), (
        2, 5, 6, 0.0, 0, -1, None if qc is None else qc.cache_key(), False))
    assert prog._psig == psig1
    if kind in ("cast_round_trip", "quantize_for_decode"):
        assert psig1 != psig0                   # the card recaptures
    ref = _fresh(tnet)
    if qc is not None:
        ref.quantize_for_decode(act_quant=qc.act_quant)
    assert torch.equal(got, TG.lm_generate(ref, prompt, 6))


def test_fingerprint_walk_covers_every_parameter():
    _, tnet = _pair(4)
    walked = TG._param_tensors(tnet)
    assert len(walked) == len({id(t) for t in walked})
    assert {id(t) for t in walked} == {id(p) for p in tnet.parameters()} \
        | {id(tnet._pe)}


def test_unchanged_weights_gather_once():
    _, tnet = _pair(4)
    a = TG._gathered(tnet, None)
    assert TG._gathered(tnet, None)[0] is a[0]


def test_write_through_data_keeps_the_fingerprint():
    """``param.data`` writes bump no version: the float tree reads them
    in place, and the int8 copies follow at the next
    `quantize_for_decode` (a new `cache_key`)."""
    _, tnet = _pair(5)
    tnet.quantize_for_decode()
    qc = tnet._decode_quant
    fp = TG._params_fingerprint(tnet, qc)
    tnet._layers[0].ffn.ffn_dense1.weight.data.mul_(-1)
    assert TG._params_fingerprint(tnet, qc) == fp
    tnet.quantize_for_decode()
    qc2 = tnet._decode_quant
    assert qc2.cache_key() != qc.cache_key()
    assert TG._params_fingerprint(tnet, qc2) != fp


# ------------------------------------------------------------- Program
def test_program_stages_host_inputs_into_static_buffers():
    seen = []

    def body(x, y):
        seen.append((x, y))
        return (x.float() * 2 + y,)

    prog = _graphs.Program("t", body, _graphs.Pool("cpu"))
    x = onp.arange(6, dtype=onp.int32).reshape(2, 3)
    (out,) = prog.run(x=x, y=torch.ones(3))
    static = prog._static
    assert static["x"].dtype == torch.int32
    onp.testing.assert_array_equal(static["x"].numpy(), x)
    (out2,) = prog.run(x=x + 1, y=torch.zeros(3))
    # the same static tensors every call; a call's result outlives the
    # next
    assert seen[0][0] is seen[1][0] is static["x"]
    assert torch.equal(out, torch.from_numpy(x).float() * 2 + 1)
    assert torch.equal(out2, torch.from_numpy(x + 1).float() * 2)
    assert prog.last is not None and not prog.captured
    with pytest.raises(MXNetError):
        prog.run(x=onp.zeros((3, 3), onp.int32), y=torch.ones(3))
    with pytest.raises(MXNetError):
        prog.run(x=x)


def test_generate_results_survive_later_calls(nets):
    _, tnet = nets
    a = TG.lm_generate(tnet, _prompt(seed=50), 6)
    keep = a.clone()
    TG.lm_generate(tnet, _prompt(seed=51), 6)
    assert torch.equal(a, keep)


def test_eager_scope_and_in_body():
    flags = []
    prog = _graphs.Program(
        "t", lambda x: (flags.append(_graphs.in_body()) or x + 1,),
        _graphs.Pool("cpu"))
    assert not _graphs.in_body()
    with _graphs.eager():
        prog.run(x=torch.zeros(2))
    prog.run(x=torch.zeros(2))
    assert flags == [True, True] and not _graphs.in_body()


def test_note_launch_counts_direct_launches_and_replays():
    def fn():
        pass

    fn.launches = 0
    _graphs.note_launch(fn)
    assert fn.launches == 1 and _graphs.launches(fn) == 1
    _graphs.replayed_launches[fn] += 12
    assert _graphs.launches(fn) == 13
    _graphs.reset_counts()
    assert _graphs.launches(fn) == 1


# ------------------------------------------------------ serving programs
@pytest.mark.parametrize("kw,names", [
    (dict(), {"step": "serving_step",
              "prefill_chunk": "serving_prefill_chunk"}),
    (dict(kv_dtype="int8"), {"step": "serving_step_kv8",
                             "prefill_chunk": "serving_prefill_chunk_kv8"}),
    (dict(speculate_k=2, quantized=False),
     {"step": "serving_step", "prefill_chunk": "serving_prefill_chunk",
      "draft_step": "serving_draft_step",
      "draft_prefill_chunk": "serving_draft_prefill_chunk",
      "spec_verify": "serving_spec_verify"}),
])
def test_paged_programs_are_named_per_family(kw, names):
    _, tnet = _pair(6)
    tnet.quantize_for_decode()
    builds = TP.program_builds.copy()
    progs = PagedPrograms(tnet, max_batch=2, block_size=8,
                          blocks_per_seq=4, num_blocks=9, temperature=0.0,
                          top_k=0, **kw)
    assert {k: p.name for k, p in progs.programs.items()} == names
    for k in names:
        assert TP.program_builds[k] == builds[k] + 1
    assert all(p._pool is progs._graph_pool
               for p in progs.programs.values())


def test_draft_tokens_are_copies():
    _, tnet = _pair(7)
    tnet.quantize_for_decode()
    progs = PagedPrograms(tnet, max_batch=2, block_size=8, blocks_per_seq=4,
                          num_blocks=9, temperature=0.0, top_k=0,
                          speculate_k=2, quantized=False)
    tables = onp.array([[1, 2, 3, 4], [5, 6, 7, 8]], onp.int32)
    args = (onp.array([3, 4], onp.int32), onp.array([6, 9], onp.int32),
            onp.array([True, True]), onp.zeros(2, onp.int64))
    d1, _ = progs.draft_step(tables, *args)
    keep = d1.clone()
    progs.draft_step(tables, onp.array([5, 1], onp.int32), *args[1:])
    assert torch.equal(d1, keep)
    assert d1 is not progs.programs["draft_step"].last[0]


# ---------------------------------------------------------- hybridize
def _lm(dropout=0.0, seed=0):
    return TransformerLM(**dict(CFG, dropout=dropout), device="cpu",
                         seed=seed)


def test_hybridize_equals_eager_and_caches_per_signature():
    net = _lm()
    x = torch.from_numpy(_prompt(B=2, P=7))
    want = net(x)
    net.hybridize()
    got = net(x)
    assert torch.equal(got, want) and not got.requires_grad
    assert torch.equal(net(x), want)
    assert len(net._graph_cache) == 1
    net(x[:1])
    assert len(net._graph_cache) == 2
    # the children run inside the parent's program, not as their own
    assert all(m._graph_cache in (None, {}) or m is net
               for m in net.modules())
    prog = next(iter(net._graph_cache.values()))
    assert prog.name == "raw_fn"


def test_hybridize_lru_cap(monkeypatch):
    monkeypatch.setattr(TB, "_AVAL_CACHE_CAP", 2)
    net = _lm().hybridize()
    for P in (3, 4, 5, 4, 6):
        net(torch.from_numpy(_prompt(P=P)))
    assert [k[0][0][1] for k in net._graph_cache] == [(2, 4), (2, 6)]


def test_cast_and_hybridize_invalidate():
    net = _lm().hybridize()
    x = torch.from_numpy(_prompt())
    net(x)
    assert len(net._graph_cache) == 1
    net.cast("bfloat16")
    assert len(net._graph_cache) == 0
    got = net(x)
    assert got.dtype == torch.bfloat16
    net.cast("float32")
    net(x)
    net.hybridize()
    assert len(net._graph_cache) == 0
    net.hybridize(False)
    assert not net._hybrid and not net.layer0._hybrid
    net(x)
    assert len(net._graph_cache) == 0


def test_hybridize_under_record_runs_recorded_programs_and_trains():
    """Under ``record()`` a hybridized block runs its recorded forward
    and backward programs, which on the CPU run their bodies eagerly:
    the same loss and gradients as the block never hybridized, with
    the same seed (dropout on)."""
    x = torch.from_numpy(_prompt())
    grads = []
    for hybrid in (False, True):
        net = _lm(dropout=0.1)
        if hybrid:
            net.hybridize()
        mxt_random.seed(4, device="cpu")
        with autograd.record():
            loss = net(x).float().mean()
        loss.backward()
        grads.append((loss.detach(), [p.grad for p in net.parameters()]))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    (key, (rec,)), = net._graph_cache.items()
    assert "record" in key and rec.fwd.name == "fwd_record" \
        and rec.bwd.name == "bwd_record"


def test_hybridize_train_mode_draws_a_fresh_mask_each_call():
    """A hybridized block in train mode outside ``record()`` runs as a
    program whose dropout reads its seed table: each call draws a fresh
    mask, and re-seeding gives the first mask again (the masks of the
    block never hybridized)."""
    net = _lm(dropout=0.1).hybridize()
    x = torch.from_numpy(_prompt())
    with autograd.train_mode():
        mxt_random.seed(9, device="cpu")
        first, second = net(x), net(x)
        mxt_random.seed(9, device="cpu")
        again = net(x)
    assert not torch.equal(first, second)
    assert torch.equal(first, again)
    with autograd.train_mode():
        mxt_random.seed(9, device="cpu")
        assert torch.equal(_lm(dropout=0.1)(x), first)
    # predict mode: dropout is off
    assert torch.equal(net(x), _lm(dropout=0.1)(x))


def test_hybridize_outputs_do_not_alias_static_buffers():
    """A hybridized call returns fresh tensors on every device: a
    forward that returns a view of its input (the program's static
    input buffer on the CPU) does not change under the next call."""

    class Flat(TB.HybridBlock):
        def forward(self, x):
            return x.view(-1)

    net = Flat().hybridize()
    first = net(torch.ones(2, 2))
    second = net(torch.zeros(2, 2))
    assert torch.equal(first, torch.ones(4))
    assert torch.equal(second, torch.zeros(4))
    assert first.data_ptr() != second.data_ptr()
