"""Beam search of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/models/generation.py` `lm_beam_search`),
mirroring tests/test_generation.py's beam cases and holding the port to
the JAX package's `lm_beam_search` on the same weights: sequences
equal, scores within 1e-5 in f32, with eos on and off, with and
without the GNMT length penalty, and on the int8 weight path.

The oracle of a beam's score is the cumulative log-probability of its
tokens under the training forward (`TransformerLM.forward`).
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.models.generation import lm_beam_search as jax_beam
from incubator_mxnet_tpu.models.transformer import TransformerLM as JaxLM
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import TransformerLM, lm_beam_search
from incubator_mxnet_tpu_torch.models.generation import _top_k_by_index

V, C, DFF, L, H, MAXLEN = 97, 32, 64, 2, 4, 64


def _pair(seed=0):
    """A JAX TransformerLM and the port's, with the JAX net's weights."""
    cfg = dict(vocab=V, units=C, hidden_size=DFF, num_layers=L, num_heads=H,
               max_len=MAXLEN, dropout=0.0)
    mx.random.seed(seed)
    jnet = JaxLM(**cfg)
    jnet.initialize()
    jnet(NDArray(jnp.ones((1, 4), jnp.int32)))
    tnet = TransformerLM(**cfg, device="cpu")
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                           jnet._collect_params_with_prefix().items()})
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    return _pair(0)


@pytest.fixture(scope="module")
def net(nets):
    return nets[1]


def _seq_logprob(net, seq, P):
    """Cumulative log-prob of seq[P:] under the training forward."""
    with torch.no_grad():
        logits = net(torch.as_tensor(onp.asarray(seq)[None], dtype=torch.long))
    logp = torch.log_softmax(logits[0].double(), dim=-1)
    return float(sum(logp[t - 1, int(seq[t])] for t in range(P, len(seq))))


# --------------------------------------------------------------------- #
# the JAX package's beam cases
# --------------------------------------------------------------------- #
def test_beam1_equals_greedy(net):
    prompt = onp.array([[5, 9, 2]], "int32")
    seqs, scores = net.beam_search(prompt, 6, beam_size=1)
    greedy = net.generate(prompt, 6)
    assert seqs.dtype == torch.int32 and tuple(seqs.shape) == (1, 1, 9)
    assert torch.equal(seqs[:, 0], greedy)
    assert tuple(scores.shape) == (1, 1) and scores.dtype == torch.float32


def test_beam_finds_global_best_exhaustive():
    """K = V, N = 2: the K·V candidates at the second step cover the
    whole length-2 continuation space, so the top beam must be the
    global argmax, found here by brute force over all V² continuations
    with the training forward as the oracle."""
    small_v = 9
    tiny = TransformerLM(vocab=small_v, units=16, hidden_size=32,
                         num_layers=1, num_heads=2, max_len=16, dropout=0.0,
                         device="cpu", seed=1)
    prompt = onp.array([[3, 7]], "int32")
    seqs, scores = tiny.beam_search(prompt, 2, beam_size=small_v)
    best, best_lp = None, -1e30
    for a in range(small_v):
        for b in range(small_v):
            seq = onp.array([3, 7, a, b], "int32")
            lp = _seq_logprob(tiny, seq, 2)
            if lp > best_lp:
                best, best_lp = seq, lp
    onp.testing.assert_array_equal(seqs[0, 0].numpy(), best)
    assert abs(float(scores[0, 0]) - best_lp) < 1e-4


def test_beam_scores_sorted_and_match_oracle(net):
    prompt = onp.array([[1, 2, 3, 4]], "int32")
    K, N = 4, 5
    seqs, scores = net.beam_search(prompt, N, beam_size=K)
    assert tuple(seqs.shape) == (1, K, 4 + N) and tuple(scores.shape) == (1, K)
    s = scores[0].numpy()
    assert (s[:-1] >= s[1:] - 1e-6).all(), "beams not sorted best-first"
    # every beam's score is the cumulative log-prob of its sequence
    for j in range(K):
        lp = _seq_logprob(net, seqs[0, j].numpy(), 4)
        assert abs(lp - float(s[j])) < 1e-3, (j, lp, float(s[j]))
    onp.testing.assert_array_equal(seqs[0, :, :4].numpy(),
                                   onp.tile(prompt, (K, 1)))


def test_beam_eos_freezing_and_length_penalty(net):
    prompt = onp.array([[2, 4, 6]], "int32")
    # eos = the greedy first token, so the top beam finishes at once
    eos = int(net.generate(prompt, 1)[0, -1])
    seqs, _ = net.beam_search(prompt, 5, beam_size=3, eos_id=eos)
    for j in range(3):
        gen = seqs[0, j, 3:].numpy()
        hits = onp.where(gen == eos)[0]
        if hits.size:                 # after the first eos, only eos
            assert (gen[hits[0]:] == eos).all()
    # alpha only reorders and normalizes: shapes and order hold
    _, scores2 = net.beam_search(prompt, 5, beam_size=3, eos_id=eos,
                                 alpha=1.0)
    s2 = scores2[0].numpy()
    assert (s2[:-1] >= s2[1:] - 1e-6).all()


def test_beam_validation(net):
    zeros = onp.zeros((1, 3), "int32")
    with pytest.raises(ValueError):
        net.beam_search(zeros, 4, beam_size=0)
    with pytest.raises(ValueError):
        net.beam_search(zeros, 4, beam_size=V + 1)
    with pytest.raises(ValueError):
        net.beam_search(zeros, 0, beam_size=2)
    with pytest.raises(ValueError):
        net.beam_search(onp.zeros((1, 60), "int32"), 10)     # 70 > 64
    with pytest.raises(ValueError):            # quantized needs the pass
        net.beam_search(zeros, 2, quantized=True)


# --------------------------------------------------------------------- #
# the port against the JAX package
# --------------------------------------------------------------------- #
def _prompt(B=2, P=5, seed=3):
    return onp.random.RandomState(seed).randint(0, V, (B, P)).astype("int32")


def _assert_same(jres, tres):
    js, jsc = jres
    ts, tsc = tres
    onp.testing.assert_array_equal(ts.numpy(), onp.asarray(js))
    onp.testing.assert_allclose(tsc.numpy(), onp.asarray(jsc), atol=1e-5,
                                rtol=0)


@pytest.mark.parametrize("eos", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_beam_matches_jax(nets, eos, alpha):
    jnet, tnet = nets
    prompt = _prompt()
    # eos = row 0's greedy second token: some beams finish mid-search
    eos_id = int(tnet.generate(prompt, 2)[0, -1]) if eos else -1
    kw = dict(beam_size=4, eos_id=eos_id, alpha=alpha)
    _assert_same(jax_beam(jnet, prompt, 7, **kw),
                 lm_beam_search(tnet, prompt, 7, **kw))


def test_beam_single_token_matches_jax(nets):
    jnet, tnet = nets
    prompt = _prompt(seed=4)
    _assert_same(jax_beam(jnet, prompt, 1, beam_size=3),
                 lm_beam_search(tnet, prompt, 1, beam_size=3))


@pytest.mark.parametrize("act_quant", ["none", "dynamic"])
def test_quantized_beam_matches_jax(act_quant):
    """The int8 weight path: `quantize_for_decode` on both nets, the
    same beams and scores; ``quantized=False`` goes back to float."""
    jnet, tnet = _pair(2)
    prompt = _prompt(seed=5)
    float_res = lm_beam_search(tnet, prompt, 6, beam_size=3)
    jnet.quantize_for_decode(act_quant=act_quant)
    tnet.quantize_for_decode(act_quant=act_quant)
    _assert_same(jax_beam(jnet, prompt, 6, beam_size=3),
                 lm_beam_search(tnet, prompt, 6, beam_size=3))
    unq = lm_beam_search(tnet, prompt, 6, beam_size=3, quantized=False)
    assert torch.equal(unq[0], float_res[0])
    assert torch.equal(unq[1], float_res[1])


def test_top_k_breaks_ties_by_index():
    """Equal candidates rank by index, as `jax.lax.top_k` ranks them:
    finished beams tie at the frozen score by the thousand."""
    x = torch.tensor([[0.5, -1e9, 0.5, -1e9, -1e9, 0.7]])
    vals, idx = _top_k_by_index(x, 5)
    assert idx.tolist() == [[5, 0, 2, 1, 3]]
    assert torch.equal(vals, x[:, [5, 0, 2, 1, 3]])
