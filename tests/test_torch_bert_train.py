"""The BERT training step of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/models/bert.py` with `autograd`, the loss,
the Trainer and `convert.load_jax_params`) held against the JAX
package's, as bench.py drives it.

A 2-layer BERT (D=64, H=4, V=1000, T=16, B=4), f32, dropout 0, is
built in the JAX package with ``use_flash=False`` — the attention the
JAX package runs at the flagship's shape off the CPU — and its
structural parameter arrays are loaded into the port's model.  The
same numpy batch then goes through both: forward logits within 1e-5,
the MLM+NSP loss of bench.py's PretrainWithLoss within 1e-5, every
parameter gradient within 1e-4 of its largest entry, and the weights
after one ``Trainer.step`` within 1e-6.  The same step again with
attention on the flash route in both packages (the JAX Pallas kernels
in interpret mode; the port's flash autograd Function, forced with
``kernel_active``), at the same tolerances.  Also: the attention
routing, the autograd scopes, initialization from a seed and bf16
training.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.gluon import Trainer as JTrainer
from incubator_mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from incubator_mxnet_tpu.models import bert as jbert
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import MXNetError, autograd
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.models import bert as tbert
from incubator_mxnet_tpu_torch.models import transformer as ttr

tfa = importlib.import_module("incubator_mxnet_tpu_torch.ops.flash_attention")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=1000, units=64, hidden_size=128, num_layers=2,
           num_heads=4)
B, T = 4, 16
SGD = {"learning_rate": 1e-3, "momentum": 0.9, "multi_precision": True}


def _chip_smoke():
    """chip_smoke.py's PretrainWithLoss is the port's counterpart of
    bench.py's; load the script as a module (it runs nothing when
    imported)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class JPretrainWithLoss(JHybridBlock):
    """bench.py:130-145."""

    def __init__(self, net_, **kw):
        super().__init__(**kw)
        self.net = net_
        self.mlm_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward(self, tokens, labels):
        mlm_logits, nsp_logits = self.net(tokens)
        mlm = self.mlm_loss(mlm_logits, labels).mean()
        nsp_logp = mx.nd.log_softmax(nsp_logits.astype("float32"))
        nsp = -(nsp_logp[:, 0].mean())
        return mlm + nsp


def _batch(seed):
    rs = onp.random.RandomState(seed)
    return (rs.randint(0, CFG["vocab_size"], (B, T)).astype(onp.int32),
            rs.randint(0, CFG["vocab_size"], (B, T)).astype(onp.int32))


def _jax_net(seed=0, use_flash=False):
    mx.random.seed(seed)
    net = jbert.BERTForPretraining(**CFG, dropout=0.0, use_flash=use_flash)
    net.initialize()
    net(NDArray(jnp.ones((B, T), jnp.int32)))
    return net


def _arrays(jnet):
    return {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}


def _port_net(arrays, **kw):
    net = tbert.BERTForPretraining(**CFG, dropout=0.0, device="cpu", **kw)
    return load_jax_params(net, arrays)


def _step_both(jnet, seed=1):
    """Both packages from the JAX net's weights after one recorded
    forward, backward and Trainer step on the same batch."""
    tnet = _port_net(_arrays(jnet))
    toks, labels = _batch(seed)
    jmodel = JPretrainWithLoss(jnet)
    tmodel = _chip_smoke().PretrainWithLoss(tnet)
    jtr = JTrainer(jmodel.collect_params(), "sgd", dict(SGD),
                   keep_grads=True)
    ttr_ = Trainer(tmodel.collect_params(), "sgd", dict(SGD),
                   keep_grads=True)
    with jag.record():
        jloss = jmodel(NDArray(jnp.asarray(toks)), NDArray(jnp.asarray(labels)))
    jloss.backward()
    with autograd.record():
        tloss = tmodel(torch.from_numpy(toks), torch.from_numpy(labels))
    tloss.backward()
    jparams = jnet._collect_params_with_prefix()
    jgrads = {k: p.grad().asnumpy() for k, p in jparams.items()}
    tgrads = {k: p.grad for k, p in tnet.named_parameters()}
    jtr.step(1)
    ttr_.step(1)
    return {"jloss": float(jloss.asnumpy()), "tloss": float(tloss.detach()),
            "jgrads": jgrads, "tgrads": tgrads,
            "jw": {k: p.data().asnumpy() for k, p in jparams.items()},
            "tw": {k: p.detach().numpy() for k, p in tnet.named_parameters()}}


@pytest.fixture(scope="module")
def stepped():
    """Both packages after one recorded forward, backward and step."""
    return _step_both(_jax_net())


def _check_grads(jg, tg):
    """Every gradient within 1e-4 of its largest entry."""
    assert jg.keys() == tg.keys()
    for k, ref in jg.items():
        got = tg[k].numpy() if tg[k] is not None else onp.zeros_like(ref)
        scale = max(float(onp.abs(ref).max()), 1e-30)
        assert float(onp.abs(got - ref).max()) <= 1e-4 * scale, k
    # the forward does not read the token-type table (no token types)
    assert tg["bert.token_type_embed.weight"] is None
    assert not onp.any(jg["bert.token_type_embed.weight"])


def test_structural_parameter_names_match_jax():
    jkeys = {k: a.shape for k, a in _arrays(_jax_net(2)).items()}
    tnet = tbert.BERTForPretraining(**CFG, device="cpu")
    tkeys = {k: tuple(p.shape) for k, p in tnet.collect_params().items()}
    assert len(tkeys) == 5 + 12 * CFG["num_layers"] + 2 + 8
    assert list(tkeys) == list(jkeys) and tkeys == jkeys


@pytest.mark.parametrize("seed", [3, 4])
def test_forward_logits_match_jax(seed):
    jnet = _jax_net()
    tnet = _port_net(_arrays(jnet))
    toks, _ = _batch(seed)
    jm, jn = jnet(NDArray(jnp.asarray(toks)))
    tm, tn = tnet(torch.from_numpy(toks))
    assert tm.shape == (B, T, CFG["vocab_size"]) and tn.shape == (B, 2)
    onp.testing.assert_allclose(tm.numpy(), jm.asnumpy(), atol=1e-5)
    onp.testing.assert_allclose(tn.numpy(), jn.asnumpy(), atol=1e-5)


def test_pretrain_loss_matches_jax(stepped):
    assert abs(stepped["tloss"] - stepped["jloss"]) <= 1e-5


def test_every_gradient_matches_jax(stepped):
    _check_grads(stepped["jgrads"], stepped["tgrads"])


def test_weights_after_trainer_step_match_jax(stepped):
    for k, ref in stepped["jw"].items():
        onp.testing.assert_allclose(stepped["tw"][k], ref, atol=1e-6,
                                    err_msg=k)


def test_kernel_active_is_the_jax_crossover():
    assert tfa.kernel_active(512, 512, "cuda")
    assert tfa.kernel_active(1024, 256, torch.device("cuda", 0))
    assert not tfa.kernel_active(511, 512, "cuda")
    assert not tfa.kernel_active(128, 128, "cuda")   # the flagship's T
    assert not tfa.kernel_active(4096, 4096, "cpu")


def test_bert_attention_below_crossover_skips_flash(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("flash_attention called below the crossover")

    monkeypatch.setattr(tbert, "flash_attention", refuse)
    tnet = _port_net(_arrays(_jax_net()))
    toks, _ = _batch(5)
    with autograd.record():
        tnet(torch.from_numpy(toks))[0].sum().backward()


def test_bert_attention_at_crossover_takes_flash(monkeypatch):
    tnet = _port_net(_arrays(_jax_net()))
    toks = torch.from_numpy(_batch(6)[0])
    want = tnet(toks)[0]
    calls = []

    def fake_flash(q, k, v, causal=False, scale=None):
        calls.append((tuple(q.shape), causal))
        return tfa.attention_reference(q, k, v, causal, scale)

    monkeypatch.setattr(tbert, "kernel_active", lambda tq, tk, dev: True)
    monkeypatch.setattr(tbert, "flash_attention", fake_flash)
    got = tnet(toks)[0]
    assert len(calls) == CFG["num_layers"]
    assert calls[0] == ((B, CFG["num_heads"], T, 16), False)
    # the two routes compute the same attention (f32, 1e-5)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def flash_stepped():
    """The training step with attention on the flash route in both
    packages: the JAX model at T=16 on the CPU takes the Pallas forward
    and backward kernels in interpret mode; the port's attention is
    forced onto its flash autograd Function (the plain forward and
    backward on the CPU).  Returns what `_step_both` returns, plus the
    port's flash calls."""
    calls = []

    def spy(q, k, v, causal=False, scale=None):
        calls.append(q.requires_grad)
        return tfa.flash_attention(q, k, v, causal, scale)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbert, "kernel_active", lambda tq, tk, dev: True)
        mp.setattr(tbert, "flash_attention", spy)
        out = _step_both(_jax_net(use_flash=True), seed=7)
    return dict(out, calls=calls)


def test_flash_route_loss_matches_jax(flash_stepped):
    st = flash_stepped
    # forward and backward went through the Function in every layer
    assert st["calls"] == [True] * CFG["num_layers"]
    assert tfa.flash_attention.launches == 0       # the CPU launches nothing
    assert abs(st["tloss"] - st["jloss"]) <= 1e-5


def test_flash_route_gradients_match_jax(flash_stepped):
    _check_grads(flash_stepped["jgrads"], flash_stepped["tgrads"])


def test_flash_route_stepped_weights_match_jax(flash_stepped):
    for k, ref in flash_stepped["jw"].items():
        onp.testing.assert_allclose(flash_stepped["tw"][k], ref, atol=1e-6,
                                    err_msg=k)


def test_causal_lm_attention_still_takes_flash(monkeypatch):
    calls = []

    def spy(q, k, v, causal=False, scale=None):
        calls.append(causal)
        return tfa.flash_attention(q, k, v, causal, scale)

    monkeypatch.setattr(ttr, "flash_attention", spy)
    net = ttr.TransformerLM(vocab=11, units=16, hidden_size=32, num_layers=2,
                            num_heads=2, max_len=32, device="cpu")
    net(torch.arange(9)[None, :])
    assert calls == [True, True]


def test_padding_mask_is_not_ported():
    """Named for what it held before the padding mask was ported (a
    raise); it now holds the masked path's contract: with
    ``valid_length`` the tokens past a row's length change no output at
    the positions before it (f32, within 1e-6), and without it they do.
    The masked outputs against the JAX model's are in
    `test_torch_nmt.py::test_bert_valid_length_matches_jax`."""
    tnet = tbert.BERTForPretraining(**CFG, dropout=0.0,
                                    device="cpu").initialize()
    a = torch.from_numpy(onp.random.RandomState(0).randint(
        0, CFG["vocab_size"], (2, 6)))
    b = a.clone()
    b[:, 3:] = (b[:, 3:] + 1) % CFG["vocab_size"]
    vl = torch.tensor([3, 3])
    (ma, _), (mb, _) = tnet(a, valid_length=vl), tnet(b, valid_length=vl)
    assert torch.allclose(ma[:, :3], mb[:, :3], atol=1e-6)
    assert not torch.allclose(tnet(a)[0][:, :3], tnet(b)[0][:, :3],
                              atol=1e-6)


SCOPES = {
    "none": [],
    "record": ["record"],
    "record_pause": ["record", "pause"],
    "record_predict": ["record", "predict_mode"],
    "pause_train": ["pause", "train_mode"],
    "record_pause_record": ["record", "pause", "record"],
    "record_no_train": ["record(False)"],
}


def _enter(mod, names, stack):
    for n in names:
        scope = mod.record(False) if n == "record(False)" \
            else getattr(mod, n)()
        stack.enter_context(scope)


@pytest.mark.parametrize("scopes", sorted(SCOPES))
def test_autograd_scopes_match_jax(scopes):
    import contextlib

    with contextlib.ExitStack() as st:
        _enter(jag, SCOPES[scopes], st)
        want = (jag.is_recording(), jag.is_training())
    with contextlib.ExitStack() as st:
        _enter(autograd, SCOPES[scopes], st)
        got = (autograd.is_recording(), autograd.is_training())
        assert torch.is_grad_enabled() == got[0] or not SCOPES[scopes]
    assert got == want
    assert (autograd.is_recording(), autograd.is_training()) == (False, False)


def test_forward_outside_record_builds_no_graph():
    tnet = tbert.BERTForPretraining(**CFG, device="cpu").initialize()
    mlm, _ = tnet(torch.zeros((1, 4), dtype=torch.long))
    assert not mlm.requires_grad
    with autograd.record():
        mlm, _ = tnet(torch.zeros((1, 4), dtype=torch.long))
        with autograd.pause():
            assert not tnet(torch.zeros((1, 4), dtype=torch.long))[0] \
                .requires_grad
    assert mlm.requires_grad


def test_initialize_draws_from_the_seed():
    def build():
        mxt.random.seed(11, device="cpu")
        return tbert.BERTForPretraining(**CFG, device="cpu").initialize()

    a, b = build(), build()
    pa, pb = a.collect_params(), b.collect_params()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    w = pa["bert.encoder.layer0.attention.qkv.weight"]
    assert float(w.abs().max()) <= 0.07 and float(w.std()) > 0.03
    assert torch.equal(pa["bert.embed_ln.gamma"], torch.ones(64))
    assert not pa["bert.pooler.bias"].any()
    before = pa["nsp.weight"].clone()
    a.initialize()                       # already filled: kept
    assert torch.equal(pa["nsp.weight"], before)


def test_bf16_cast_keeps_training():
    mxt.random.seed(12, device="cpu")
    tnet = tbert.BERTForPretraining(**CFG, dropout=0.1,
                                    device="cpu").initialize()
    params = tnet.collect_params()
    tr = Trainer(params, "sgd", dict(SGD), keep_grads=False)
    tnet.cast("bfloat16")
    assert all(p.dtype == torch.bfloat16 and p.requires_grad
               for p in params.values())
    toks, labels = _batch(8)
    model = _chip_smoke().PretrainWithLoss(tnet)
    before = params["mlm_decoder.bias"].clone()
    with autograd.record():
        loss = model(torch.from_numpy(toks), torch.from_numpy(labels))
    loss.backward()
    assert torch.isfinite(loss)
    assert params["mlm_decoder.weight"].grad.dtype == torch.bfloat16
    tr.step(1)
    assert tr._states[0][0].dtype == torch.float32
    assert not torch.equal(params["mlm_decoder.bias"], before)
    assert all(p.grad is None for p in params.values())
