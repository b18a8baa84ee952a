"""KV-cache generation of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/models/generation.py`) held against the JAX
package's `lm_generate`.

Greedy tokens are equal token for token: the port's prefill (the flash
path) and cached decode steps (f32 scores and softmax) repeat the JAX
math, and every step's top-2 logit gap is asserted above 1e-3 so a
near-tie cannot decide the comparison.  Sampling draws from the port's
own counter-based streams (torch's generator is not JAX's, so sampled
tokens are compared with the port itself): deterministic per seed,
inside the top-k set, and frozen after eos.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.models.generation import lm_generate as jax_generate
from incubator_mxnet_tpu.models.transformer import TransformerLM as JaxLM
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import TransformerLM, lm_generate

CFG = dict(vocab=61, units=32, hidden_size=64, num_layers=2, num_heads=4,
           max_len=64, dropout=0.0)
N = 8


def _pair(seed):
    mx.random.seed(seed)
    jnet = JaxLM(**CFG)
    jnet.initialize()
    jnet(NDArray(jnp.ones((1, 4), jnp.int32)))
    tnet = TransformerLM(**CFG, device="cpu")
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                           jnet._collect_params_with_prefix().items()})
    return jnet, tnet


@pytest.fixture(scope="module", params=[0, 1])
def nets(request):
    return _pair(request.param)


def _prompt(seed, B=2, P=5):
    return onp.random.RandomState(100 + seed).randint(
        0, CFG["vocab"], (B, P)).astype(onp.int32)


def _top2_gaps(tnet, seq, P):
    """Top-2 logit gap at every generated position, from the forward
    over the whole output sequence."""
    logits = tnet(torch.tensor(onp.asarray(seq), dtype=torch.long))
    top2 = logits[:, P - 1:-1].topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


def test_greedy_tokens_equal_jax(nets):
    jnet, tnet = nets
    prompt = _prompt(0)
    got = lm_generate(tnet, prompt, N)
    ref = onp.asarray(jax_generate(jnet, prompt, N))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 5 + N)
    assert (_top2_gaps(tnet, ref, 5) > 1e-3).all()
    onp.testing.assert_array_equal(got.numpy(), ref)
    # the net method and the bucketed call give the same tokens
    assert torch.equal(tnet.generate(torch.from_numpy(prompt), N), got)
    assert torch.equal(lm_generate(tnet, prompt, N, pad_to_bucket=True), got)


def test_eos_freezes_rows_like_jax(nets):
    jnet, tnet = nets
    prompt = _prompt(1)
    free = lm_generate(tnet, prompt, N).numpy()
    eos = int(free[0, 5 + 2])                 # row 0's third token
    got = lm_generate(tnet, prompt, N, eos_id=eos).numpy()
    ref = onp.asarray(jax_generate(jnet, prompt, N, eos_id=eos))
    onp.testing.assert_array_equal(got, ref)
    first = list(got[0, 5:]).index(eos)
    assert (got[0, 5 + first:] == eos).all()


def test_sampling_is_deterministic_and_respects_top_k(nets):
    _, tnet = nets
    prompt = _prompt(2)
    kw = dict(temperature=0.8, top_k=3)
    a = lm_generate(tnet, prompt, N, seed=5, **kw)
    assert torch.equal(a, lm_generate(tnet, prompt, N, seed=5, **kw))
    seeds = [lm_generate(tnet, prompt, N, seed=s, **kw) for s in range(4)]
    assert any(not torch.equal(seeds[0], s) for s in seeds[1:])
    # every sampled token is among the 3 largest logits of its step
    logits = tnet(a.long())[:, 4:-1]
    top3 = logits.topk(3, dim=-1).indices
    assert (top3 == a[:, 5:, None].long()).any(-1).all()
    # top_k=1 is greedy whatever the temperature
    assert torch.equal(lm_generate(tnet, prompt, N, temperature=2.0,
                                   top_k=1, seed=9),
                       lm_generate(tnet, prompt, N))


def test_generate_validation(nets):
    _, tnet = nets
    with pytest.raises(ValueError):
        lm_generate(tnet, _prompt(3), 0)
    with pytest.raises(ValueError):
        lm_generate(tnet, _prompt(3), CFG["max_len"])
