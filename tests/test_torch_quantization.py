"""int8 decode quantization of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/contrib/quantization.py` and the int8 path
of `models/generation.py`) held against the JAX package's.

* `quantize_kv` / `quantize_weight`: the same numpy inputs give
  bit-identical f32 scales; the int8 values are identical, and any that
  differ must be off by exactly 1 at a rounding tie of the f32 quotient
  (the count is named in the assertion; it is 0 on these inputs).
* `_dense`'s int8 branches against the JAX `_dense` in f32: the
  dynamic branch (exact int32 products, the same f32 epilogue) within
  1e-6, the weight-only branch (f32 sums in another order) within
  1e-5.
* quantized `lm_generate` tokens equal the JAX package's for both
  strategies, where every step's top-2 logit gap under the quantized
  numerics is above 1e-3; `lm_score` matches JAX's within 1e-5.
* The quality contract of tests/test_quantized_decode.py: greedy parity
  >= 95% against the float path and a perplexity delta <= 0.5% through
  `lm_score`.
* The staleness key: PyTorch updates parameters in place and ``cast()``
  swaps their storage, and both are re-quantized lazily.

Tiny nets (V=97, C=32, two layers, four heads), f32 on the CPU.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.contrib import quantization as jq
from incubator_mxnet_tpu.models import generation as JG
from incubator_mxnet_tpu.models.transformer import TransformerLM as JaxLM
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch.contrib import quantization as tq
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon.nn import Dense
from incubator_mxnet_tpu_torch.models import (BERTForPretraining,
                                              TransformerLM, lm_generate,
                                              lm_score)
from incubator_mxnet_tpu_torch.models import generation as TG

CFG = dict(vocab=97, units=32, hidden_size=64, num_layers=2, num_heads=4,
           max_len=64, dropout=0.0)
STRATEGIES = ["none", "dynamic"]
DENSE_TOL = {"none": 1e-5, "dynamic": 1e-6}


def _pair(seed=0):
    mx.random.seed(seed)
    jnet = JaxLM(**CFG)
    jnet.initialize()
    jnet(NDArray(jnp.ones((1, 4), jnp.int32)))
    tnet = TransformerLM(**CFG, device="cpu")
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                           jnet._collect_params_with_prefix().items()})
    return jnet, tnet


def _tokens(seed, shape):
    return onp.random.RandomState(seed).randint(
        0, CFG["vocab"], shape).astype(onp.int32)


def _assert_int8_match(x, q_port, s_port, q_jax, s_jax):
    """Scales bit-identical; int8 values identical except, at most, by 1
    where the f32 quotient x / scale sits exactly on a .5 tie."""
    s_port, s_jax = s_port.numpy(), onp.asarray(s_jax)
    assert s_port.dtype == onp.float32 and s_port.shape == s_jax.shape
    assert onp.array_equal(s_port, s_jax)
    diff = q_port.numpy().astype(onp.int32) - onp.asarray(q_jax, onp.int32)
    where = onp.argwhere(diff != 0)
    quot = onp.float32(x) / s_port.reshape(
        s_port.shape + (1,) * (x.ndim - s_port.ndim))
    frac = onp.abs(quot - onp.floor(quot))
    ties = [tuple(i) for i in where if frac[tuple(i)] == 0.5]
    assert onp.abs(diff).max(initial=0) <= 1 and len(ties) == len(where), \
        f"{len(where)} int8 values differ, {len(ties)} at ties: " \
        f"{[tuple(i) for i in where][:10]}"


@pytest.mark.parametrize("shape, mag, dtype", [
    ((5, 2, 8, 16), 4.0, "float32"),
    ((3, 4, 64), 1.0, "float32"),
    ((7, 2, 32), 30.0, "bfloat16"),
])
def test_quantize_kv_matches_jax(shape, mag, dtype):
    x = (onp.random.RandomState(3).randn(*shape) * mag).astype(onp.float32)
    x[0, 0] = 0.0                       # an all-zero vector: the clamp
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s = tq.quantize_kv(xt)
    assert q.dtype == torch.int8 and q.shape == xt.shape
    assert s.shape == xt.shape[:-1]
    assert torch.all(q[0, 0] == 0) and torch.isfinite(s).all()
    qj, sj = jq.quantize_kv(xj)
    _assert_int8_match(xt.float().numpy(), q, s, qj, sj)
    # symmetric per-vector int8: within half a step of the input
    back = q.float() * s[..., None]
    assert torch.all((back - xt.float()).abs() <= s[..., None] * 0.5 + 1e-7)


@pytest.mark.parametrize("shape, dtype", [((48, 32), "float32"),
                                          ((96, 64), "float32"),
                                          ((40, 24), "bfloat16")])
def test_quantize_weight_matches_jax(shape, dtype):
    w = (onp.random.RandomState(4).randn(*shape) * 0.05).astype(onp.float32)
    wt = torch.from_numpy(w).to(getattr(torch, dtype))
    q, s = tq.quantize_weight(wt, axis=0)
    assert q.dtype == torch.int8 and s.shape == (shape[0], 1)
    qj, sj = jq.quantize_weight(jnp.asarray(w).astype(getattr(jnp, dtype)),
                                axis=0)
    _assert_int8_match(wt.float().numpy(), q, s[:, 0], qj,
                       onp.asarray(sj)[:, 0])


def _packed(w, act_quant, port):
    if port:
        q, s = tq.quantize_weight(torch.from_numpy(w))
        out = {"w8": q, "s": s.reshape(-1)}
    else:
        q, s = jq.quantize_weight(jnp.asarray(w))
        out = {"w8": q, "s": s.reshape(-1)}
    if act_quant == "dynamic":
        out["dyn"] = ()
    return out


@pytest.mark.parametrize("act_quant", STRATEGIES)
@pytest.mark.parametrize("xshape", [(5, 32), (2, 3, 32)])
def test_dense_int8_branches_match_jax(act_quant, xshape):
    rs = onp.random.RandomState(5)
    x = rs.randn(*xshape).astype(onp.float32)
    w = (rs.randn(48, 32) * 0.1).astype(onp.float32)
    b = rs.randn(48).astype(onp.float32)
    got = TG._dense(torch.from_numpy(x), _packed(w, act_quant, True),
                    torch.from_numpy(b))
    ref = JG._dense(jnp.asarray(x), _packed(w, act_quant, False),
                    jnp.asarray(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref),
                                atol=DENSE_TOL[act_quant], rtol=0)
    # f32 logits out of a bf16 activation, as the logits head asks
    xb = torch.from_numpy(x).bfloat16()
    yb = TG._dense(xb, _packed(w, act_quant, True), None,
                   out_dtype=torch.float32)
    assert yb.dtype == torch.float32
    assert TG._dense(xb, _packed(w, act_quant, True), None).dtype \
        == torch.bfloat16


def test_int_product_is_exact():
    """Both exact forms of the dynamic product (``torch._int_mm`` and
    the f64 matmul used off its CUDA shape limits) give the int32 sums
    exactly, at the largest magnitudes int8 allows."""
    rs = onp.random.RandomState(6)
    xq = torch.from_numpy(rs.randint(-127, 128, (20, 1024)).astype(onp.int8))
    w8 = torch.from_numpy(rs.randint(-127, 128, (24, 1024)).astype(onp.int8))
    xq[0] = 127
    w8[0] = 127
    want = xq.long() @ w8.long().t()
    assert torch.equal(TG._int_product(xq, w8), want.float())
    assert torch.equal((xq.double() @ w8.double().t()).float(), want.float())
    assert int(want[0, 0]) == 127 * 127 * 1024


@torch.no_grad()
def _quantized_gaps(tnet, seq, P):
    """Top-2 logit gap at every generated position, teacher-forced
    through the quantized decode numerics (`lm_score`'s pass, which
    runs under no_grad like every decode entry point)."""
    toks = torch.from_numpy(onp.array(seq)).long()
    params = TG._gather_params(tnet, TG._quant_config(tnet, True))
    H = CFG["num_heads"]
    acts = tuple(lyr.ffn._act for lyr in tnet._layers)
    h, _, _ = TG._prefill(params, toks, acts, H, toks.shape[1],
                          return_h=True)
    logits = TG._dense(TG._ln(h, *params["ln"]), *params["head"],
                       out_dtype=torch.float32)
    top2 = logits[:, P - 1:-1].topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


@pytest.mark.parametrize("act_quant", STRATEGIES)
def test_quantized_generate_matches_jax(act_quant):
    jnet, tnet = _pair(0)
    prompt = _tokens(7, (2, 5))
    jnet.quantize_for_decode(act_quant=act_quant)
    tnet.quantize_for_decode(act_quant=act_quant)
    assert tnet._decode_quant.act_quant == act_quant
    got = lm_generate(tnet, prompt, 8, quantized=True)
    ref = onp.asarray(JG.lm_generate(jnet, prompt, 8, quantized=True))
    assert (_quantized_gaps(tnet, ref, 5) > 1e-3).all()
    onp.testing.assert_array_equal(got.numpy(), ref)
    # the net method follows the pass (quantized=None)
    assert torch.equal(tnet.generate(torch.from_numpy(prompt), 8), got)


@pytest.mark.parametrize("quantized", [False, True])
def test_score_matches_jax(quantized):
    jnet, tnet = _pair(1)
    if quantized:
        jnet.quantize_for_decode(act_quant="dynamic")
        tnet.quantize_for_decode(act_quant="dynamic")
    toks = _tokens(8, (3, 20))
    got = lm_score(tnet, toks)
    ref = onp.asarray(JG.lm_score(jnet, toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 19)
    onp.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    assert torch.equal(tnet.score(toks), got)
    with pytest.raises(ValueError):
        lm_score(tnet, toks[:, :1])


# ------------------------------------------------------------------ #
# the quality contract (tests/test_quantized_decode.py)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("act_quant", STRATEGIES)
def test_greedy_parity_vs_float(act_quant):
    _, net = _pair(0)
    prompt = _tokens(3, (2, 5))
    base = net.generate(prompt, 20).numpy()
    net.quantize_for_decode(act_quant=act_quant)
    q = net.generate(prompt, 20).numpy()
    parity = (q[:, 5:] == base[:, 5:]).mean()
    assert parity >= 0.95, f"{act_quant}: greedy parity {parity} < 0.95"
    onp.testing.assert_array_equal(q[:, :5], prompt)
    # quantized=False on a marked net is the float path
    onp.testing.assert_array_equal(
        net.generate(prompt, 20, quantized=False).numpy(), base)


@pytest.mark.parametrize("act_quant, head", [("none", False),
                                             ("dynamic", False),
                                             ("none", True)])
def test_perplexity_delta_within_tolerance(act_quant, head):
    _, net = _pair(0)
    held_out = _tokens(17, (4, 32))
    ppl_f = float(torch.exp(-lm_score(net, held_out).mean()))
    net.quantize_for_decode(act_quant=act_quant, quantize_head=head)
    ppl_q = float(torch.exp(-lm_score(net, held_out).mean()))
    delta = abs(ppl_q - ppl_f) / ppl_f
    assert delta <= 0.005, \
        f"{act_quant}: perplexity delta {delta:.4%} > 0.5% " \
        f"(float {ppl_f:.3f}, int8 {ppl_q:.3f})"
    assert ppl_q != ppl_f                 # the int8 path really ran


# ------------------------------------------------------------------ #
# configuration and the staleness key
# ------------------------------------------------------------------ #
def test_quantized_true_requires_the_pass():
    _, net = _pair(0)
    with pytest.raises(ValueError):
        lm_generate(net, _tokens(1, (2, 5)), 2, quantized=True)
    with pytest.raises(ValueError):
        lm_score(net, _tokens(1, (2, 5)), quantized=True)


def test_bad_act_quant_rejected_and_auto_follows_the_device():
    with pytest.raises(ValueError):
        tq.DecodeQuantConfig(act_quant="int4")
    assert tq.DecodeQuantConfig(device="cpu").act_quant == "dynamic"
    assert tq.DecodeQuantConfig(device="cuda").act_quant == "none"
    assert tq.DecodeQuantConfig().act_quant == "none"   # cuda by default
    _, net = _pair(0)
    assert net.quantize_for_decode()._decode_quant.act_quant == "dynamic"
    assert net.dequantize_decode()._decode_quant is None


def test_unsupported_net_rejected():
    with pytest.raises(TypeError):
        tq.quantize_for_decode(Dense(4, 4, device="cpu"))
    bert = BERTForPretraining(vocab_size=50, units=16, hidden_size=32,
                              num_layers=1, num_heads=2, device="cpu")
    with pytest.raises(TypeError):
        tq.quantize_for_decode(bert)


def test_targets_and_weight_bytes():
    _, net = _pair(0)
    net.quantize_for_decode(act_quant="none")
    qc = net._decode_quant
    lyr = net._layers[1]
    for dense in (lyr.attn.qkv, lyr.attn.proj, lyr.ffn.ffn_dense1,
                  lyr.ffn.ffn_dense2):
        assert qc.packed(dense)["w8"].dtype == torch.int8
    assert qc.packed(net.head) is None
    n = sum(d.weight.numel() for lyr in net._layers
            for d in (lyr.attn.qkv, lyr.attn.proj, lyr.ffn.ffn_dense1,
                      lyr.ffn.ffn_dense2))
    n_out = sum(d.weight.shape[0] for lyr in net._layers
                for d in (lyr.attn.qkv, lyr.attn.proj, lyr.ffn.ffn_dense1,
                          lyr.ffn.ffn_dense2))
    assert qc.weight_bytes() == n + 4 * n_out


def _twin_after(update):
    """A net with ``update`` applied before `quantize_for_decode`."""
    _, twin = _pair(0)
    update(twin)
    return twin.quantize_for_decode(act_quant="none")


def _in_place_update(net):
    with torch.no_grad():
        net.head.weight.mul_(-1.0)
        w = net._layers[0].ffn.ffn_dense1.weight
        w.copy_(w * 0.5)


def test_weight_update_requantizes_lazily():
    """An in-place update keeps the Parameter object and its storage
    (same data_ptr): the version counter tells the cached int8 copy it
    is stale, and the next call re-quantizes it."""
    _, net = _pair(0)
    prompt = _tokens(13, (2, 5))
    net.quantize_for_decode(act_quant="none")
    dense = net._layers[0].ffn.ffn_dense1
    before = net._decode_quant.packed(dense)
    ptr = dense.weight.data_ptr()
    net.generate(prompt, 4)
    _in_place_update(net)
    assert dense.weight.data_ptr() == ptr
    out = net.generate(prompt, 4)
    after = net._decode_quant.packed(dense)
    # symmetric int8 is scale-free: halving the weight halves the scale
    assert torch.equal(after["s"], before["s"] * 0.5)
    twin = _twin_after(_in_place_update)
    want = twin._decode_quant.packed(twin._layers[0].ffn.ffn_dense1)
    assert torch.equal(after["w8"], want["w8"])
    assert torch.equal(after["s"], want["s"])
    assert torch.equal(out, twin.generate(prompt, 4))


def test_cast_requantizes_lazily():
    """``cast()`` keeps the Parameter objects and swaps their storage
    and dtype: the int8 copies follow the bf16 weights."""
    _, net = _pair(0)
    prompt = _tokens(14, (2, 5))
    net.quantize_for_decode(act_quant="none")
    net.generate(prompt, 4)
    net.cast("bfloat16")
    out = net.generate(prompt, 4)
    twin = _twin_after(lambda n: n.cast("bfloat16"))
    for lyr, tl in zip(net._layers, twin._layers):
        for d, td in ((lyr.attn.qkv, tl.attn.qkv),
                      (lyr.ffn.ffn_dense2, tl.ffn.ffn_dense2)):
            assert torch.equal(net._decode_quant.packed(d)["w8"],
                               twin._decode_quant.packed(td)["w8"])
    assert torch.equal(out, twin.generate(prompt, 4))


# every weight write the port's surface offers reaches the int8 copies:
# after it, `generate` equals a net given the same write before its
# `quantize_for_decode`, and the copies changed
def _set_data(net):
    w = net._layers[0].attn.qkv.weight
    rs = onp.random.RandomState(21)
    w.set_data(rs.standard_normal(tuple(w.shape)).astype(onp.float32) * 0.3)


def _force_reinit(net):
    from incubator_mxnet_tpu_torch import random as mx_random

    mx_random.seed(22, device="cpu")
    net.initialize(force_reinit=True)


_OTHER = {}


def _load_other(net):
    if "arrays" not in _OTHER:
        jnet, _ = _pair(1)
        _OTHER["arrays"] = {k: p.data().asnumpy() for k, p in
                            jnet._collect_params_with_prefix().items()}
    load_jax_params(net, _OTHER["arrays"])


def _trainer_step(net):
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.gluon import Trainer

    toks = torch.from_numpy(_tokens(23, (2, 6)).astype(onp.int64))
    trainer = Trainer(net.collect_params(), "sgd", {"learning_rate": 5.0})
    with autograd.record():
        logits = net(toks)
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, CFG["vocab"]), toks[:, 1:].reshape(-1))
    loss.backward()
    trainer.step(1)


def _cast_round_trip(net):
    net.cast("bfloat16")
    net.cast("float32")


@pytest.mark.parametrize("update", [_set_data, _force_reinit, _load_other,
                                    _trainer_step, _cast_round_trip],
                         ids=["set_data", "initialize_force_reinit",
                              "load_jax_params", "trainer_step",
                              "cast_round_trip"])
def test_every_weight_write_requantizes(update):
    _, net = _pair(0)
    prompt = _tokens(24, (2, 5))
    net.quantize_for_decode(act_quant="none")
    targets = tq._decode_target_denses(net, False)
    before = [net._decode_quant.packed(d)["w8"].clone() for d in targets]
    net.generate(prompt, 4)
    update(net)
    out = net.generate(prompt, 4)
    twin = _twin_after(update)
    moved = 0
    for d, td, old in zip(targets, tq._decode_target_denses(twin, False),
                          before):
        got, want = net._decode_quant.packed(d), twin._decode_quant.packed(td)
        assert torch.equal(got["w8"], want["w8"])
        assert torch.equal(got["s"], want["s"])
        moved += not torch.equal(got["w8"], old)
    assert moved > 0, "the write changed no int8 weight"
    assert torch.equal(out, twin.generate(prompt, 4))


def test_write_through_data_serves_after_requantizing():
    """A write through ``param.data`` bumps neither the version counter
    nor the storage: the cheap key cannot see it (the documented limit
    of `quantize_for_decode`), and calling `quantize_for_decode` again
    serves the new weights."""
    def write(n):
        for lyr in n._layers:
            w = lyr.ffn.ffn_dense1.weight
            w.data.copy_(w.data * -2.0)

    _, net = _pair(0)
    prompt = _tokens(25, (2, 5))
    net.quantize_for_decode(act_quant="none")
    net.generate(prompt, 4)
    write(net)
    net.quantize_for_decode(act_quant="none")
    twin = _twin_after(write)
    dense = net._layers[1].ffn.ffn_dense1
    assert torch.equal(net._decode_quant.packed(dense)["w8"],
                       twin._decode_quant.packed(
                           twin._layers[1].ffn.ffn_dense1)["w8"])
    assert torch.equal(net.generate(prompt, 4), twin.generate(prompt, 4))
