"""Translation with the port's encoder-decoder Transformer
(`models.generation.nmt_translate`, `_TranslateProgram`) held against
the JAX package's `nmt_translate` on the CPU.

A 2+2-layer Transformer (D=32, H=4, FFN 64, V=600), f32, weights from
the JAX model by `convert.load_jax_params`; B=2, S=8.  Greedy, masked,
eos-frozen, beam and int8-decoder tokens are equal token for token, and
a greedy row may differ only after a position where the JAX model's
top-2 logit gap (teacher-forced) is below 1e-3, where a near-tie may
go either way; beam scores within 1e-5.  Sampling draws from
the port's own counter-based streams (torch's generator is not JAX's):
deterministic per seed, each token among the JAX model's top-k logits
at its position, and greedy at ``top_k=1``.  On the CPU the two
programs run their bodies eagerly on their static buffers; the card
captures them (``chip_smoke.py`` phases 27-28).
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.contrib import quantization as jq
from incubator_mxnet_tpu.models import generation as jgen
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import _graphs
from incubator_mxnet_tpu_torch.contrib import quantization as tq
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.models import generation as tgen
from incubator_mxnet_tpu_torch.models import transformer as ttr

CFG = dict(units=32, hidden_size=64, num_layers=2, num_heads=4,
           max_length=32)
V = 600
B, S, N = 2, 8, 6


@pytest.fixture(scope="module", params=[0, 1])
def nets(request):
    mx.random.seed(request.param)
    jnet = jtr.Transformer(V, V, dropout=0.0, **CFG)
    jnet.initialize()
    tnet = load_jax_params(
        ttr.Transformer(V, V, dropout=0.0, device="cpu", **CFG),
        {k: p.data().asnumpy()
         for k, p in jnet._collect_params_with_prefix().items()})
    return jnet, tnet


def _src(seed):
    return onp.random.RandomState(50 + seed).randint(
        1, V, (B, S)).astype(onp.int32)


VL = onp.array([5, S], onp.int32)


def _teacher_logits(jnet, src, gen, bos=0, vl=None):
    """The JAX model's logits at every generated position, the decoder
    fed BOS and the generated tokens."""
    tgt = onp.concatenate([onp.full((src.shape[0], 1), bos, onp.int32),
                           onp.asarray(gen, onp.int32)[:, :-1]], axis=1)
    args = (NDArray(jnp.asarray(src)), NDArray(jnp.asarray(tgt)))
    if vl is not None:
        args += (NDArray(jnp.asarray(vl)),)
    return jnet(*args).asnumpy()


def _gaps(logits):
    top2 = onp.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


GAP = 1e-3


def _assert_same_tokens(got, ref, gaps):
    """Each row equal to the reference, or equal up to a position where
    the reference's top-2 logit gap is below `GAP` (a near-tie that f32
    sums in another order may decide either way; after it the rows
    follow other prefixes)."""
    for b, (g, r) in enumerate(zip(got, ref)):
        diff = onp.nonzero(g != r)[0]
        if len(diff):
            assert gaps[b, diff[0]] < GAP, (b, diff[0], g, r, gaps[b])


@pytest.mark.parametrize("masked", [False, True])
def test_greedy_tokens_equal_jax(nets, masked):
    jnet, tnet = nets
    src = _src(0)
    kw = dict(src_valid_length=VL) if masked else {}
    ref = onp.asarray(jgen.nmt_translate(jnet, src, N, **kw))
    got = tgen.nmt_translate(tnet, src, N, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, N)
    _assert_same_tokens(got.numpy(), ref, _gaps(_teacher_logits(
        jnet, src, ref, vl=VL if masked else None)))
    # the net method gives the same tokens
    assert torch.equal(tnet.translate(torch.from_numpy(src), N, **kw), got)


def test_eos_freezes_rows_like_jax(nets):
    jnet, tnet = nets
    src = _src(1)
    free = tgen.nmt_translate(tnet, src, N).numpy()
    eos = int(free[0, 2])
    got = tgen.nmt_translate(tnet, src, N, eos_id=eos, bos_id=3).numpy()
    ref = onp.asarray(jgen.nmt_translate(jnet, src, N, eos_id=eos, bos_id=3))
    onp.testing.assert_array_equal(got, ref)
    for row in got:
        if eos in row:
            assert (row[list(row).index(eos):] == eos).all()


@pytest.mark.parametrize("kw", [dict(beam_size=3),
                                dict(beam_size=4, alpha=0.6),
                                dict(beam_size=2, src_valid_length=VL),
                                dict(beam_size=3, eos_id=7, alpha=1.0)],
                         ids=["k3", "k4_alpha", "k2_masked", "k3_eos"])
def test_beam_equals_jax(nets, kw):
    """Sequences (B, K, N) equal, best-first, and the length-normalised
    scores within 1e-5."""
    jnet, tnet = nets
    src = _src(2)
    jseq, jsc = jgen.nmt_translate(jnet, src, N, **kw)
    seq, sc = tgen.nmt_translate(tnet, src, N, **kw)
    K = kw["beam_size"]
    assert seq.dtype == torch.int32 and tuple(seq.shape) == (B, K, N)
    onp.testing.assert_array_equal(seq.numpy(), onp.asarray(jseq))
    onp.testing.assert_allclose(sc.numpy(), onp.asarray(jsc), atol=1e-5)
    assert (sc[:, :-1] >= sc[:, 1:]).all()


def test_beam_of_one_is_greedy_and_beams_score_at_least_greedy(nets):
    """``beam_size=1`` is the greedy program (tokens, no scores); the best
    of 3 beams (alpha 0) scores at least the greedy path's summed
    log-probability (the port's teacher-forced forward), within 1e-5."""
    _, tnet = nets
    src = _src(3)
    greedy = tgen.nmt_translate(tnet, src, N)
    assert torch.equal(tgen.nmt_translate(tnet, src, N, beam_size=1), greedy)
    _, scores = tgen.nmt_translate(tnet, src, N, beam_size=3)
    tgt = torch.cat([torch.zeros((B, 1), dtype=torch.long),
                     greedy[:, :-1].long()], dim=1)
    logp = torch.log_softmax(tnet(torch.from_numpy(src), tgt), dim=-1)
    path = logp.gather(-1, greedy.long()[..., None])[..., 0].sum(-1)
    assert (scores[:, 0] >= path - 1e-5).all()


def test_sampling_is_seeded_and_stays_in_jax_top_k(nets):
    jnet, tnet = nets
    src = _src(4)
    kw = dict(temperature=0.8, top_k=3)
    a = tgen.nmt_translate(tnet, src, N, seed=5, **kw)
    assert torch.equal(a, tgen.nmt_translate(tnet, src, N, seed=5, **kw))
    runs = [tgen.nmt_translate(tnet, src, N, seed=s, **kw) for s in range(4)]
    assert any(not torch.equal(runs[0], r) for r in runs[1:])
    logits = _teacher_logits(jnet, src, a.numpy())
    top3 = onp.argsort(logits, axis=-1)[..., -3:]
    assert (top3 == a.numpy()[..., None]).any(-1).all()
    # top_k=1 is the JAX package's greedy pick whatever the temperature
    ref = onp.asarray(jgen.nmt_translate(jnet, src, N))
    onp.testing.assert_array_equal(
        tgen.nmt_translate(tnet, src, N, temperature=2.0, top_k=1,
                           seed=9).numpy(), ref)


@pytest.mark.parametrize("act_quant", ["none", "dynamic"])
def test_int8_decoder_tokens_equal_jax(nets, act_quant):
    """`quantize_for_decode` on both nets (the decoder's seven Dense
    layers a layer and the head int8, the encoder float): greedy and
    beam tokens equal the JAX package's int8 translation."""
    jnet, tnet = nets
    src = _src(5)
    jq.quantize_for_decode(jnet, act_quant=act_quant, quantize_head=True)
    tnet.quantize_for_decode(act_quant=act_quant, quantize_head=True)
    try:
        ref = onp.asarray(jgen.nmt_translate(jnet, src, N))
        got = tgen.nmt_translate(tnet, src, N)
        onp.testing.assert_array_equal(got.numpy(), ref)
        jseq, _ = jgen.nmt_translate(jnet, src, N, beam_size=2)
        seq, _ = tgen.nmt_translate(tnet, src, N, beam_size=2)
        onp.testing.assert_array_equal(seq.numpy(), onp.asarray(jseq))
        qc = tnet._decode_quant
        L = CFG["num_layers"]
        assert len(qc._targets) == 7 * L + 1
        assert all(id(d) not in qc._targets
                   for d in tnet.encoder.modules())
        params, _ = tgen._gathered(tnet, qc, tgen._gather_nmt_params,
                                   tgen._nmt_param_tensors)
        assert isinstance(params["layers"][0]["xkv"][0], dict)
        fparams = tgen._gather_nmt_params(tnet)
        assert tgen._weight_nbytes(params) < tgen._weight_nbytes(fparams)
    finally:
        jq.dequantize_decode(jnet)
        tnet.dequantize_decode()
    assert tnet._decode_quant is None


def test_int8_decoder_changes_the_logits_path(nets):
    """The int8 programs are cached under their own key beside the
    float ones; ``quantized=False`` takes the float path back and
    ``quantized=True`` without the state raises."""
    _, tnet = nets
    src = _src(6)
    with pytest.raises(ValueError, match="quantize_for_decode"):
        tgen.nmt_translate(tnet, src, N, quantized=True)
    float_tokens = tgen.nmt_translate(tnet, src, N)
    tnet.quantize_for_decode(act_quant="none")
    try:
        tgen.nmt_translate(tnet, src, N)
        keys = [k for k in tnet._gen_programs if k[0] == "nmt"]
        assert any(k[-1] is None for k in keys) and \
            any(k[-1] is not None for k in keys)
        assert torch.equal(tgen.nmt_translate(tnet, src, N, quantized=False),
                           float_tokens)
    finally:
        tnet.dequantize_decode()


def test_a_repeated_signature_reuses_its_program(nets):
    """One `_TranslateProgram` per signature, in the net's LRU under
    the JAX package's key: a second call with the same signature takes
    it again (no capture on the CPU), another max_len makes another."""
    _, tnet = nets
    src = _src(7)
    tnet._gen_programs = None
    _graphs.reset_counts()
    a = tgen.nmt_translate(tnet, src, N)
    (sig, prog), = tnet._gen_programs.items()
    assert sig == ("nmt", B, S, N, 1, -1, 0, 0.0, (0.0, 0), False, None)
    assert prog._start_prog.name == "nmt_start" \
        and prog._step_prog.name == "nmt_step"
    assert torch.equal(tgen.nmt_translate(tnet, src, N), a)
    assert len(tnet._gen_programs) == 1
    tgen.nmt_translate(tnet, src, N - 1)
    # sampling arguments stay out of a beam's key
    tgen.nmt_translate(tnet, src, N, beam_size=2)
    assert len(tnet._gen_programs) == 3
    assert not _graphs.captures and not _graphs.replays


def test_hybridized_encoder_gives_the_same_tokens(nets):
    _, tnet = nets
    src = _src(8)
    want = tgen.nmt_translate(tnet, src, N, src_valid_length=VL)
    tnet.encoder.hybridize()
    try:
        got = tgen.nmt_translate(tnet, src, N, src_valid_length=VL)
    finally:
        tnet.encoder.hybridize(False)
    assert torch.equal(want, got)


@pytest.mark.parametrize("kw, match", [
    (dict(max_len=0), "max_len"),
    (dict(beam_size=0), "beam_size"),
    (dict(max_len=CFG["max_length"] + 1), "max_length"),
    (dict(beam_size=V + 1), "exceeds vocab"),
    (dict(beam_size=2, temperature=0.5), "deterministic"),
    (dict(beam_size=2, top_k=5), "deterministic"),
])
def test_translate_checks_its_arguments_like_jax(nets, kw, match):
    jnet, tnet = nets
    src = _src(9)
    kw = dict(kw)
    max_len = kw.pop("max_len", N)
    with pytest.raises(ValueError, match=match):
        tgen.nmt_translate(tnet, src, max_len, **kw)
    with pytest.raises(ValueError, match=match):
        jgen.nmt_translate(jnet, src, max_len, **kw)


def test_long_source_is_refused_like_jax(nets):
    jnet, tnet = nets
    src = onp.ones((1, CFG["max_length"] + 1), onp.int32)
    with pytest.raises(ValueError, match="src length"):
        tgen.nmt_translate(tnet, src, N)
    with pytest.raises(ValueError, match="src length"):
        jgen.nmt_translate(jnet, src, N)


def test_quantize_for_decode_marks_the_decoder_only(nets):
    _, tnet = nets
    tq.quantize_for_decode(tnet, act_quant="none")
    try:
        qc = tnet._decode_quant
        dec = {id(m) for m in tnet.decoder.modules()}
        assert all(i in dec for i in qc._targets)
        assert id(tnet.out_proj) not in qc._targets
    finally:
        tq.dequantize_decode(tnet)
