"""The PyTorch/CUDA port's TransformerLM
(`incubator_mxnet_tpu_torch/models/transformer.py`) and its weight
converter (`incubator_mxnet_tpu_torch/convert.py`) held against the JAX
package's TransformerLM.

A JAX model is built from a seed; its structural parameter arrays (the
keys ``save_parameters`` writes) are loaded into a port model with
`load_jax_params`, and the same numpy tokens go through both: the f32
logits agree within 1e-4.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import MXNetError, autograd
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import transformer as ttr

CFG = dict(vocab=61, units=32, hidden_size=64, num_layers=2, num_heads=4,
           max_len=64, dropout=0.0)


def _jax_net(seed, **cfg):
    mx.random.seed(seed)
    net = jtr.TransformerLM(**cfg)
    net.initialize()
    net(NDArray(jnp.ones((1, 4), jnp.int32)))
    return net


def _arrays(jnet):
    return {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def nets():
    jnet = _jax_net(0, **CFG)
    tnet = ttr.TransformerLM(**CFG, device="cpu")
    load_jax_params(tnet, _arrays(jnet))
    return jnet, tnet


def test_structural_parameter_names_match_jax():
    cfg = dict(CFG, num_layers=1)
    jkeys = {k: a.shape for k, a in _arrays(_jax_net(1, **cfg)).items()}
    tnet = ttr.TransformerLM(**cfg, device="cpu")
    tkeys = {k: tuple(p.shape)
             for k, p in tnet.named_parameters()}
    assert len(tkeys) == 17
    assert list(tkeys) == list(jkeys) and tkeys == jkeys


@pytest.mark.parametrize("T", [1, 9, 40])
def test_forward_logits_match_jax(nets, T):
    jnet, tnet = nets
    toks = onp.random.RandomState(T).randint(0, CFG["vocab"], (2, T))
    ref = jnet(NDArray(jnp.asarray(toks, jnp.int32))).asnumpy()
    got = tnet(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    onp.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_positional_encoding_matches_jax():
    got = ttr.positional_encoding(37, 24)
    onp.testing.assert_allclose(got.numpy(),
                                onp.asarray(jtr.positional_encoding(37, 24)),
                                atol=1e-6)


def test_cast_bfloat16_keeps_structure(nets):
    _, tnet = nets
    net = ttr.TransformerLM(**CFG, device="cpu", seed=3)
    load_jax_params(net, {k: p.detach().numpy()
                          for k, p in tnet.named_parameters()})
    net.cast("bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    toks = torch.arange(10)[None, :]
    lg = net(toks)
    assert lg.dtype == torch.bfloat16 and torch.isfinite(lg.float()).all()
    # bf16 rounds weights and activations; the argmax of a well-separated
    # row survives it
    ref = tnet(toks)
    agree = (lg.float().argmax(-1) == ref.argmax(-1)).float().mean()
    assert agree >= 0.8


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_converter_rejects_mismatched_arrays(nets, fault):
    jnet, tnet = nets
    arrays = _arrays(jnet)
    if fault == "missing":
        del arrays["layer1.ffn.ffn_dense2.bias"]
    elif fault == "extra":
        arrays["layer2.ln1.gamma"] = onp.ones((32,), onp.float32)
    else:
        arrays["head.weight"] = arrays["head.weight"][:, :16]
    before = {k: p.clone() for k, p in tnet.named_parameters()}
    with pytest.raises(MXNetError):
        load_jax_params(tnet, arrays)
    # nothing was written before the error
    assert all(torch.equal(before[k], p)
               for k, p in tnet.named_parameters())


def test_sequence_longer_than_max_len_raises(nets):
    _, tnet = nets
    with pytest.raises(ValueError):
        tnet(torch.zeros((1, CFG["max_len"] + 1), dtype=torch.long))


def test_gradients_match_jax_grad():
    """The port's TransformerLM is trainable, as the JAX package's: the
    gradient of one scalar loss (mean cross-entropy of next-token
    logits, numpy tokens) with respect to every parameter matches
    `jax.grad` of the JAX model's pure function (`functionalize`), f32,
    dropout 0, two layers: |g - ref| <= 1e-4·|ref| + 1e-5·max|ref| per
    tensor (f32 sums in another order; the causal attention's backward
    is the flash backward's plain version here, the JAX package's own
    on its side)."""
    import jax
    from incubator_mxnet_tpu.gluon.block import functionalize

    jnet = _jax_net(7, **CFG)
    tnet = ttr.TransformerLM(**CFG, device="cpu")
    load_jax_params(tnet, _arrays(jnet))
    toks = onp.random.RandomState(8).randint(0, CFG["vocab"], (2, 12))
    V = CFG["vocab"]

    apply_fn, train, aux = functionalize(jnet)
    names = {id(p): k for k, p in jnet._collect_params_with_prefix().items()}
    order = [names[id(p)] for p in apply_fn.trainable_params]
    assert len(order) == len(list(tnet.parameters()))

    def loss_fn(train_raws):
        logits, _ = apply_fn(train_raws, aux, jax.random.PRNGKey(0),
                             jnp.asarray(toks, jnp.int32))
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(toks[:, 1:])[..., None],
                                   -1)
        return jnp.mean(nll)

    jloss, jgrads = jax.value_and_grad(loss_fn)(train)

    assert all(p.requires_grad for p in tnet.parameters())
    t = torch.from_numpy(toks)
    with autograd.record():
        logits = tnet(t)
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, V), t[:, 1:].reshape(-1))
    loss.backward()
    onp.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    tparams = dict(tnet.named_parameters())
    for name, ref in zip(order, jgrads):
        ref = onp.asarray(ref)
        got = tparams[name].grad
        assert got is not None, name
        got = got.numpy()
        allow = 1e-4 * onp.abs(ref) + 1e-5 * onp.abs(ref).max()
        assert onp.all(onp.abs(got - ref) <= allow), \
            (name, float(onp.abs(got - ref).max()), float(onp.abs(ref).max()))
