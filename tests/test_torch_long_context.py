"""Long-context TransformerLM training of the PyTorch/CUDA port, held
against the JAX package (`benchmark/longctx_bench.py`'s path at a small
size: V=61, D=32, H=4, L=2, T <= 64).

* The positional table: above `_PE_TABLE_MAX` the port keeps none and
  computes the encoding in the forward, as the JAX package does; decode
  takes tables from a width-keyed LRU on the net (`_pe_table`).
* ``hybridize(remat_backward=True)`` (`gluon.block._Remat`): a recorded
  forward that keeps no activations and a backward that recomputes
  them, against the JAX package's remat step and against the port's own
  recorded step (dropout on: the recomputed masks are the forward's).
* The chunked plain attention (`attention_chunked`,
  `flash_bwd_chunked`), the oracle of the flash kernels at long T.
* `lm_score` as one program per signature.

On the CPU a `_graphs.Program` runs its body eagerly on its static
buffers; the captures and replays run on the card (``chip_smoke.py``'s
long-context phases).
"""
import importlib
import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.gluon import Trainer as JTrainer
from incubator_mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from incubator_mxnet_tpu.models import generation as JG
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import _graphs, autograd
from incubator_mxnet_tpu_torch import random as mxr
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import HybridBlock, Trainer
from incubator_mxnet_tpu_torch.gluon import block as TB
from incubator_mxnet_tpu_torch.gluon.nn import BatchNorm, Dense
from incubator_mxnet_tpu_torch.models import generation as TG
from incubator_mxnet_tpu_torch.models import transformer as ttr

fa = importlib.import_module("incubator_mxnet_tpu_torch.ops.flash_attention")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab=61, units=32, hidden_size=64, num_layers=2, num_heads=4,
           max_len=64, dropout=0.0)
BIG = dict(CFG, max_len=ttr._PE_TABLE_MAX + 1)
SGD = {"learning_rate": 1e-2, "momentum": 0.9, "multi_precision": True}
B, T = 2, 16


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LMWithLoss = _chip_smoke().LMWithLoss


class JLMWithLoss(JHybridBlock):
    """benchmark/longctx_bench.py:58-65."""

    def __init__(self, net_, **kw):
        super().__init__(**kw)
        self.net = net_
        self.loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward(self, tokens, labels):
        return self.loss(self.net(tokens), labels).mean()


def _jax_net(seed, **cfg):
    mx.random.seed(seed)
    net = jtr.TransformerLM(**cfg)
    net.initialize()
    net(NDArray(jnp.ones((1, 4), jnp.int32)))
    return net


def _arrays(jnet):
    return {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}


def _tokens(seed, shape):
    return onp.random.RandomState(seed).randint(
        0, CFG["vocab"], shape).astype(onp.int32)


def _batch(seed):
    return (torch.from_numpy(_tokens(seed, (B, T))).long(),
            torch.from_numpy(_tokens(seed + 50, (B, T))).long())


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------- positional table
@pytest.fixture(scope="module")
def big_pair():
    """The JAX package's long-max_len net (in-program encoding) and the
    port's, with the same weights, and the port's small-max_len twin."""
    jbig = _jax_net(4, **BIG)
    arrays = _arrays(jbig)
    tbig = load_jax_params(ttr.TransformerLM(**BIG, device="cpu"), arrays)
    tsmall = load_jax_params(ttr.TransformerLM(**CFG, device="cpu"), arrays)
    return jbig, tbig, tsmall


def test_long_max_len_keeps_no_table_and_matches_jax(big_pair):
    jbig, tbig, tsmall = big_pair
    assert jbig._pe is None and tbig._pe is None
    assert tsmall._pe is not None
    assert "_pe" not in dict(tbig.named_buffers())
    toks = _tokens(8, (2, 9))
    got = tbig(torch.from_numpy(toks))
    ref = onp.asarray(jbig(NDArray(jnp.asarray(toks))).asnumpy())
    onp.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    twin = tsmall(torch.from_numpy(toks))
    onp.testing.assert_allclose(got.numpy(), twin.numpy(), atol=1e-5,
                                rtol=0)
    # the hybridized forward (a program) computes the encoding inside
    net = ttr.TransformerLM(**BIG, device="cpu")
    net.load_state_dict(tbig.state_dict())
    net.hybridize()
    assert torch.equal(net(torch.from_numpy(toks)), got)


def test_generate_on_a_long_net_matches_jax_through_one_width(big_pair):
    jbig, tbig, tsmall = big_pair
    toks = _tokens(9, (2, 5))
    for cache in ("_pe_cache", "_gen_programs", "_gen_params"):
        tbig.__dict__.pop(cache, None)
    out = tbig.generate(torch.from_numpy(toks), 3)
    want = onp.asarray(JG.lm_generate(jbig, toks, 3))
    onp.testing.assert_array_equal(out.numpy(), want)
    assert torch.equal(out, tsmall.generate(torch.from_numpy(toks), 3))
    assert set(tbig._pe_cache) == {8}       # only the P + N rows
    onp.testing.assert_allclose(
        tbig._pe_cache[8].numpy(), onp.asarray(jtr.positional_encoding(8, 32)),
        atol=1e-6, rtol=0)
    # beam search and the score read their own widths
    seqs, _ = tbig.beam_search(torch.from_numpy(toks), 2, beam_size=2)
    assert torch.equal(seqs, tsmall.beam_search(torch.from_numpy(toks), 2,
                                                beam_size=2)[0])
    assert set(tbig._pe_cache) == {7, 8}


def test_pe_cache_keeps_the_two_most_recent_widths():
    """tests/test_generation.py's `test_pe_cache_lru_cap`, on the port."""
    net = ttr.TransformerLM(**dict(BIG, num_layers=1), device="cpu", seed=5)
    assert net._pe is None
    net._pe_cache_cap = 2
    for P in (3, 4, 5, 6):
        net.generate(onp.ones((1, P), "int32"), 2)
    assert len(net._pe_cache) == 2
    assert set(net._pe_cache) == {7, 8}


def test_serving_engine_runs_a_long_net(big_pair):
    _, tbig, tsmall = big_pair
    toks = _tokens(10, (1, 6))[0].tolist()
    kw = dict(max_batch=2, block_size=8, max_seq_len=32, temperature=0.0)
    from incubator_mxnet_tpu_torch.serving import ServingEngine

    outs = []
    for net in (tbig, tsmall):
        with ServingEngine(net, **kw) as eng:
            outs.append(eng.submit(toks, 4).result(timeout=120))
    assert outs[0] == outs[1] and len(outs[0]) == 4
    assert 32 in tbig._pe_cache


# ------------------------------------------------------------------ remat
def test_remat_step_matches_jax_remat_step():
    """longctx_bench.py's loop with ``remat_backward=True``, dropout 0,
    three SGD-momentum steps from the same weights: the JAX package's
    `_record_remat` and the port's `_Remat` — each loss within 1e-5, the
    weights within 1e-6."""
    jnet = _jax_net(0, **CFG)
    tnet = load_jax_params(ttr.TransformerLM(**CFG, device="cpu"),
                           _arrays(jnet))
    jmodel, tmodel = JLMWithLoss(jnet), LMWithLoss(tnet)
    jmodel.hybridize(remat_backward=True)
    tmodel.hybridize(remat_backward=True)
    jtr_ = JTrainer(jmodel.collect_params(), "sgd", dict(SGD),
                    keep_grads=False)
    ttr_ = Trainer(tmodel.collect_params(), "sgd", dict(SGD),
                   keep_grads=False)
    for s in range(3):
        toks, labels = _batch(s)
        with jag.record():
            jloss = jmodel(NDArray(jnp.asarray(toks.numpy(), jnp.int32)),
                           NDArray(jnp.asarray(labels.numpy(), jnp.int32)))
        jloss.backward()
        jtr_.step(1)
        with autograd.record():
            tloss = tmodel(toks, labels)
        tloss.backward()
        ttr_.step(1)
        assert abs(float(tloss.detach()) - float(jloss.asnumpy())) <= 1e-5
    (recs,) = tmodel._graph_cache.values()
    assert [type(r) for r in recs] == [TB._Remat]
    assert recs[0].fwd.name == "fwd_remat" and recs[0].bwd.name == "bwd_remat"
    assert ttr_._updates is not None, "the update did not read the buffers"
    jw = _arrays(jnet)
    for k, p in tnet.named_parameters():
        onp.testing.assert_allclose(p.detach().numpy(), jw[k], atol=1e-6,
                                    rtol=0, err_msg=k)


def _train(mode, steps=3, dropout=0.1, seed=5):
    """Three steps of the port's LM loop: ``mode`` "remat", "recorded"
    (hybridized without remat) or "eager" (never hybridized)."""
    net = ttr.TransformerLM(**dict(CFG, dropout=dropout), device="cpu",
                            seed=1)
    model = LMWithLoss(net)
    if mode != "eager":
        model.hybridize(remat_backward=mode == "remat")
    tr = Trainer(model.collect_params(), "sgd", dict(SGD), keep_grads=False)
    mxr.seed(seed, device="cpu")
    losses = []
    for s in range(steps):
        toks, labels = _batch(s)
        with autograd.record():
            loss = model(toks, labels)
        loss.backward()
        tr.step(1)
        losses.append(loss.detach())
    states = [t for st in tr._states.values() if st is not None
              for t in (st if isinstance(st, tuple) else (st,))]
    return model, losses, [p.detach().clone() for p in
                           model.collect_params().values()], states


@pytest.mark.parametrize("other", ["recorded", "eager"])
def test_remat_step_equals_the_ports_step_bit_for_bit(other):
    """Dropout 0.1, one seed: remat against the recorded step without
    it and against the block never hybridized — the same losses, f32
    masters and momenta, bit for bit, over three steps.  The recomputed
    forward reads the seed table of the forward it follows."""
    model, *want = _train("remat")
    _, *got = _train(other)
    assert all(_same(w, g) for w, g in zip(want, got))
    (recs,) = model._graph_cache.values()
    rec = recs[0]
    assert rec.bwd.seeds is rec.fwd.seeds
    # a layer's draws: its two DropoutAdds and the FFN's dropout
    assert rec.fwd.seeds.n == 3 * CFG["num_layers"]
    # without dropout's draws the same steps land elsewhere
    _, losses, *_ = _train("remat", seed=6)
    assert not _same(losses, want[0])


def test_remat_flag_recurses_and_toggling_drops_programs():
    """The flag reaches every child with Gluon's other keywords, a
    change drops the captured programs, and outside ``record()`` remat
    changes nothing."""
    net = ttr.TransformerLM(**dict(CFG, dropout=0.1), device="cpu", seed=2)
    model = LMWithLoss(net)
    model.hybridize(static_alloc=True, static_shape=True,
                    remat_backward=True)
    blocks = [m for m in model.modules() if isinstance(m, TB.Block)]
    assert len(blocks) > 10 and all(b._remat_backward for b in blocks)
    toks, labels = _batch(0)
    with autograd.record():
        model(toks, labels).backward()
    (recs,) = model._graph_cache.values()
    assert isinstance(recs[0], TB._Remat)
    model.hybridize(remat_backward=False)
    assert not model._graph_cache
    assert not any(b._remat_backward for b in blocks)
    with autograd.record():
        model(toks, labels).backward()
    (recs,) = model._graph_cache.values()
    assert type(recs[0]) is TB._Recorded
    # outside record(): the inference program, whatever the flag
    outs = []
    for remat in (True, False):
        model.hybridize(remat_backward=remat)
        outs.append(model(toks, labels))
    assert torch.equal(*outs)
    assert all(k[3:] == () for k in model._graph_cache)


def test_two_recorded_calls_before_one_backward_under_remat():
    """Two recorded calls, the second while the first awaits its
    backward, then one backward over both: the second call takes a
    `_Remat` of its own (its own static inputs, seed table and pool),
    and the losses and gradients equal the block never hybridized, bit
    for bit, dropout on."""
    a, b = _batch(1)
    c, d = _batch(2)
    runs = []
    for hybrid in (True, False):
        net = ttr.TransformerLM(**dict(CFG, dropout=0.1), device="cpu",
                                seed=3)
        model = LMWithLoss(net)
        if hybrid:
            model.hybridize(remat_backward=True)
        mxr.seed(7, device="cpu")
        with autograd.record():
            l1 = model(a, b)
            l2 = model(c, d)
            total = l1 + 2 * l2
        total.backward()
        runs.append((model, [l1.detach(), l2.detach()],
                     {k: p.grad for k, p in model.collect_params().items()}))
    (model, lh, gh), (_, lp, gp) = runs
    assert _same(lh, lp)
    assert gh.keys() == gp.keys()
    for k in gp:
        assert torch.equal(gh[k], gp[k]), k
    (recs,) = model._graph_cache.values()
    assert len(recs) == 2 and all(isinstance(r, TB._Remat) for r in recs)
    assert recs[0].fwd.pool is not recs[1].fwd.pool
    assert recs[0].fwd.seeds is not recs[1].fwd.seeds


class _BNNet(HybridBlock):
    """Dense, BatchNorm (running stats written in train mode), Dense."""

    def __init__(self):
        super().__init__()
        self.d = Dense(8, 6, device="cpu")
        self.bn = BatchNorm(in_channels=8, device="cpu")
        self.o = Dense(1, 8, device="cpu")

    def forward(self, x):
        return (self.o(torch.relu(self.bn(self.d(x)))) ** 2).mean()


def test_remat_writes_running_stats_once_a_step():
    """The recomputed forward writes BatchNorm's running stats again;
    the backward puts them back, so after three steps they, and the
    weights, equal the recorded step's bit for bit."""
    runs = []
    for remat in (True, False):
        mxr.seed(4, device="cpu")
        net = _BNNet().initialize()
        net.hybridize(remat_backward=remat)
        tr = Trainer(net.collect_params(), "sgd", dict(SGD),
                     keep_grads=False)
        for s in range(3):
            x = torch.from_numpy(onp.random.RandomState(s).uniform(
                -1, 1, (5, 6)).astype(onp.float32))
            with autograd.record():
                net(x).backward()
            tr.step(1)
        runs.append([p.detach().clone()
                     for p in net._collect_params_with_prefix().values()])
    assert _same(*runs)
    assert not torch.equal(runs[0][-4], torch.zeros(8))    # moved


def test_seed_table_slots_start_with_the_first_runs_seeds():
    """A replay right after a capture (the recorded forward's result,
    and a remat backward's recompute) reads the seeds its warm-up drew
    by value."""
    mxr.seed(11, device="cpu")
    want = [mxr.next_seed() for _ in range(3)]
    mxr.seed(11, device="cpu")
    table = mxr.SeedTable("cpu")
    with mxr.seed_table(table):
        got = [int(mxr.next_seed()) for _ in range(3)]
    assert got == want and table._slots.tolist() == want
    with mxr.seed_table(table):         # a reader that does not stage
        assert [int(mxr.next_seed()) for _ in range(3)] == want


def test_put_back_restores_only_what_the_body_wrote():
    """`_graphs.put_back`, which the recorded forward's capture and the
    remat backward share: the body's result, the tensor it wrote in
    place put back (and named), the one it did not write left alone."""
    a, b = torch.arange(4.0), torch.ones(3)
    vb = b._version

    def body():
        a.add_(1)
        return a * 2

    out, written = _graphs.put_back([a, b], body)
    assert torch.equal(out, torch.arange(4.0) * 2 + 2)
    assert len(written) == 1 and written[0] is a
    assert torch.equal(a, torch.arange(4.0)) and b._version == vb
    assert _graphs.put_back([a, b], lambda: 7) == (7, [])


def test_failed_update_capture_restores_the_long_context_state(monkeypatch):
    """longctx_bench.py's update (bf16 weights over f32 masters, SGD
    momentum): a capture of the update that fails after its warm-up
    stepped puts the bf16 weights, masters and momenta back bit for bit
    from the snapshot the Trainer took on the host, and the update
    count stays."""
    model, _, _, _ = _train("recorded", steps=0)
    model.cast(torch.bfloat16)
    tr = Trainer(model.collect_params(), "sgd", dict(SGD), keep_grads=False)
    for s in range(2):
        toks, labels = _batch(s)
        with autograd.record():
            model(toks, labels).backward()
        if s == 0:
            tr.step(1)
    states = [t.clone() for st in tr._states.values() for t in st]
    weights = [p.detach().clone() for p in model.collect_params().values()]
    assert weights[0].dtype == torch.bfloat16 \
        and states[0].dtype == torch.float32
    count = tr._optimizer.num_update
    run = _graphs.Program.run

    def fail_capture(self, sig=None, **inputs):
        run(self, sig, **inputs)            # the warm-up steps
        raise MXNetError(f"capturing program {self.name!r} failed")

    monkeypatch.setattr(_graphs.Program, "will_capture",
                        lambda self, sig: True)
    monkeypatch.setattr(_graphs.Program, "run", fail_capture)
    with pytest.raises(MXNetError, match="capturing"):
        tr.step(1)
    assert tr._optimizer.num_update == count
    assert _same([t for st in tr._states.values() for t in st], states)
    assert _same([p.detach() for p in model.collect_params().values()],
                 weights)


# ------------------------------------------------- chunked plain attention
@pytest.mark.parametrize("T", [1024, 4096])
def test_long_t_out_check_holds_the_late_rows(T):
    """chip_smoke.py's check of the flash forward's out at long causal T
    (`_row_excess` by `FWD_ROW_TOL` against `attention_chunked`): the
    bf16 out of the port's forward passes it, and an out with its later
    half of rows zeroed or halved, or its last eighth scaled by 0.9,
    fails it.  A late row's scale falls as 1/sqrt(t), so by T=4096 the
    absolute bound TOL passes that last eighth."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(T)
    q, k, v = (torch.randn(1, 2, T, 64, generator=g).to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / 8
    out, _ = fa.flash_attention_with_lse(q, k, v, True, scale)
    ref, _ = fa.attention_chunked(q, k, v, True, scale, rows=256)
    assert out.dtype == torch.bfloat16
    assert cs._row_excess(out, ref, cs.FWD_ROW_TOL) <= 1.0
    for first, factor in ((T // 2, 0.0), (T // 2, 0.5), (T - T // 8, 0.9)):
        wrong = out.clone()
        wrong[:, :, first:] *= factor
        assert cs._row_excess(wrong, ref, cs.FWD_ROW_TOL) > 1.0, factor
    err = (wrong.float() - ref.float()).abs().max().item()
    if T >= 4096:
        assert err <= cs.TOL[torch.bfloat16]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(37, 37), (20, 50), (50, 20)])
def test_chunked_attention_matches_the_reference(causal, tq, tk):
    """out, lse and dQ, dK, dV of the chunked plain version (8 query rows
    a block) against `attention_reference` and its autograd gradients,
    f32, ragged lengths (at tq > tk causal, rows that see no key)."""
    g = torch.Generator().manual_seed(tq * 100 + tk)
    q = torch.randn(2, 3, tq, 16, generator=g)
    k = torch.randn(2, 3, tk, 16, generator=g)
    v = torch.randn(2, 3, tk, 16, generator=g)
    do = torch.randn(2, 3, tq, 16, generator=g)
    scale = 1.0 / math.sqrt(16)
    out, lse = fa.attention_chunked(q, k, v, causal, scale, rows=8)
    ref_out, ref_lse = fa._reference_attention_lse(q, k, v, causal, scale)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ref = fa.attention_reference(qr, kr, vr, causal, scale)
    torch.testing.assert_close(out, ref.detach(), atol=1e-6, rtol=0)
    dead = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), dead)
    assert (dead.any().item()) == (causal and tq > tk)
    torch.testing.assert_close(lse[~dead], ref_lse[~dead], atol=1e-5, rtol=0)
    assert torch.all(out[dead] == 0)
    want = torch.autograd.grad(ref, (qr, kr, vr), do)
    delta = (do * out).sum(-1)
    got = fa.flash_bwd_chunked(q, k, v, do, lse, delta, causal, scale,
                               rows=8)
    plain = fa.flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    for name, gt, w, p in zip("qkv", got, want, plain):
        torch.testing.assert_close(gt, w, atol=1e-5, rtol=0,
                                   msg=lambda m: f"d{name}: {m}")
        # the same terms; dK and dV summed a block at a time
        torch.testing.assert_close(gt, p, atol=1e-6, rtol=1e-6,
                                   msg=lambda m: f"d{name}: {m}")


# ---------------------------------------------------------------- lm_score
def test_lm_score_is_one_program_a_signature():
    """`lm_score`'s program against its eager body (the pass it ran
    before: bits) and the JAX package's `lm_score` (1e-5); one program
    per (B, T, weight path) in the net's LRU."""
    jnet = _jax_net(1, **CFG)
    tnet = load_jax_params(ttr.TransformerLM(**CFG, device="cpu"),
                           _arrays(jnet))
    toks = _tokens(12, (2, 20))
    got = TG.lm_score(tnet, toks)
    with torch.no_grad():
        params = TG._gather_params(tnet)
        acts = tuple(lyr.ffn._act for lyr in tnet._layers)
        h, _, _ = TG._prefill(params, torch.from_numpy(toks).long(), acts,
                              CFG["num_heads"], 20, return_h=True)
        logits = TG._dense(TG._ln(h, *params["ln"]), *params["head"],
                           out_dtype=torch.float32)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        body = logp.gather(2, torch.from_numpy(toks).long()[:, 1:, None])
    assert torch.equal(got, body[..., 0])
    ref = onp.asarray(JG.lm_score(jnet, toks))
    onp.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    progs = {s: p for s, p in tnet._gen_programs.items() if s[0] == "score"}
    assert list(progs) == [("score", 2, 20, None)]
    assert isinstance(progs[("score", 2, 20, None)], TG._ScoreProgram)
    assert torch.equal(TG.lm_score(tnet, toks), got)
    TG.lm_score(tnet, toks[:, :12])
    scores = [s for s in tnet._gen_programs if s[0] == "score"]
    assert scores == [("score", 2, 20, None), ("score", 2, 12, None)]
    assert tnet._gen_programs[scores[0]] is progs[scores[0]]


def test_lm_score_on_a_long_net_equals_its_twin(big_pair):
    _, tbig, tsmall = big_pair
    toks = _tokens(13, (1, 30))
    torch.testing.assert_close(TG.lm_score(tbig, toks),
                               TG.lm_score(tsmall, toks), atol=1e-6, rtol=0)
    assert 30 in tbig._pe_cache
