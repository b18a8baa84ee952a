"""The encoder-decoder Transformer of the PyTorch/CUDA port
(`models/transformer.py`: `Transformer`, `LabelSmoothedCELoss`), its
optimizer (`optimizer.Adam`, `lr_scheduler`) and BERT's padding mask,
held against the JAX package on the CPU.

A 2+2-layer Transformer (D=32, H=4, FFN 64, V=600, so `should_fuse`
takes the streamed smoothed cross-entropy, its plain version here),
B=2, S=T=8, f32, dropout 0 wherever it is compared with JAX; weights
cross by `convert.load_jax_params`, including the JAX package's second
name of the tied embedding.  JAX runs as its own tests run it on the
CPU (its causal attention through `flash_attention`'s CPU path, its
loss through ``log_softmax``: the JAX package fuses only on a TPU).
Each tolerance is stated where it is asserted.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import lr_scheduler as jls
from incubator_mxnet_tpu.gluon import Trainer as JTrainer
from incubator_mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from incubator_mxnet_tpu.gluon.block import functionalize
from incubator_mxnet_tpu.models import bert as jbert
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import MXNetError, autograd
from incubator_mxnet_tpu_torch import lr_scheduler as tls
from incubator_mxnet_tpu_torch import random as mxr
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.models import bert as tbert
from incubator_mxnet_tpu_torch.models import transformer as ttr
from incubator_mxnet_tpu_torch.optimizer import Adam, create

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(units=32, hidden_size=64, num_layers=2, num_heads=4,
           max_length=64)
V = 600
B, S, T = 2, 8, 8
EPS = 0.1
IGNORE = -1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NMTWithLoss = _chip_smoke().NMTWithLoss


class JNMTWithLoss(JHybridBlock):
    """`chip_smoke.NMTWithLoss` in the JAX package."""

    def __init__(self, net, smoothing=EPS, **kw):
        super().__init__(**kw)
        self.net = net
        self.loss = jtr.LabelSmoothedCELoss(smoothing)

    def forward(self, src, tgt_in, tgt_out, src_valid_length):
        return self.loss(self.net(src, tgt_in, src_valid_length), tgt_out)


def _jax_net(seed=0, vocab=V):
    mx.random.seed(seed)
    jnet = jtr.Transformer(vocab, vocab, dropout=0.0, **CFG)
    jnet.initialize()
    return jnet


def _arrays(jnet):
    return {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}


def _pair(seed=0, vocab=V):
    jnet = _jax_net(seed, vocab)
    tnet = load_jax_params(ttr.Transformer(vocab, vocab, dropout=0.0,
                                           device="cpu", **CFG),
                           _arrays(jnet))
    return jnet, tnet


def _batch(seed, vocab=V):
    """Source, shifted target in and out (the first row's last three
    labels ignored) and source lengths, int32 numpy."""
    rs = onp.random.RandomState(seed)
    src = rs.randint(1, vocab, (B, S)).astype(onp.int32)
    tgt = rs.randint(1, vocab, (B, T + 1)).astype(onp.int32)
    out = tgt[:, 1:].copy()
    out[0, -3:] = IGNORE
    vl = onp.array([5, S], onp.int32)
    return src, tgt[:, :-1].copy(), out, vl


def _j(a):
    return NDArray(jnp.asarray(a))


def _t(a):
    return torch.from_numpy(a)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(masked):
    """Logits of the port's Transformer against the JAX model's, with
    and without ``src_valid_length``: within 1e-5 (f32, sums in another
    order)."""
    jnet, tnet = _pair(0)
    src, tin, _, vl = _batch(1)
    jargs = (_j(src), _j(tin)) + ((_j(vl),) if masked else ())
    targs = (_t(src), _t(tin)) + ((_t(vl),) if masked else ())
    ref = jnet(*jargs).asnumpy()
    got = tnet(*targs)
    assert got.shape == (B, T, V) and got.dtype == torch.float32
    onp.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    if masked:
        # the mask changes the logits: the padded source positions are
        # not attended to
        assert not onp.allclose(ref, jnet(_j(src), _j(tin)).asnumpy(),
                                atol=1e-4)


def _stream_dtypes(enc, dec, dtype_of):
    """Forward hooks on every encoder and decoder layer and on the
    encoder: the dtypes of the residual stream after each layer and of
    the encoder memory, in call order."""
    seen = []
    blocks = [(f"encoder.layer{i}", b) for i, b in enumerate(enc._layers)] \
        + [("memory", enc)] \
        + [(f"decoder.layer{i}", b) for i, b in enumerate(dec._layers)]
    for name, blk in blocks:
        blk.register_forward_hook(
            lambda b, args, out, name=name: seen.append(
                (name, dtype_of(out))))
    return seen


def test_bf16_residual_stream_takes_the_jax_dtypes():
    """A bf16 2+2-layer Transformer, dropout off, the JAX model's
    weights: the f32 positional table makes the residual stream after
    every layer and the encoder memory f32 in both packages (the
    sublayers compute in bf16 behind each Dense's cast), the table stays
    f32 under ``cast``, and the logits are bf16 within 2^-6 of the
    largest |logit| (4 bf16 steps at its exponent: the two packages
    round LayerNorm, the products and the softmax sums in other orders).
    The cached decode step's embedding stays bf16, as the JAX
    ``_nmt_decode_token``'s (pe cast to the parameters' dtype)."""
    from incubator_mxnet_tpu_torch.models import generation as tgen

    jnet = _jax_net(0)
    jnet.cast("bfloat16")
    tnet = load_jax_params(ttr.Transformer(V, V, dropout=0.0, device="cpu",
                                           **CFG), _arrays(jnet))
    tnet.cast("bfloat16")
    want = _stream_dtypes(jnet.encoder, jnet.decoder,
                          lambda o: onp.dtype(o.dtype).name)
    got = _stream_dtypes(tnet.encoder, tnet.decoder,
                         lambda o: str(o.dtype).removeprefix("torch."))
    src, tin, _, vl = _batch(1)
    ref = jnet(_j(src), _j(tin), _j(vl))
    out = tnet(_t(src), _t(tin), _t(vl))
    assert want == [(n, "float32") for n, _ in want] and len(want) == 5
    assert got == want
    assert tnet._pe.dtype == torch.float32
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    r = onp.asarray(ref.asnumpy(), onp.float32)
    onp.testing.assert_allclose(out.float().numpy(), r,
                                atol=2.0 ** -6 * onp.abs(r).max(), rtol=0)
    params = tgen._gather_nmt_params(tnet, None)
    h = tgen._embed(params, _t(tin[:, 0]), torch.tensor([0]))
    assert h.dtype == torch.bfloat16


def test_the_tied_embedding_is_one_parameter():
    jnet, tnet = _pair(0)
    assert tnet.tgt_embed is tnet.src_embed
    names = [n for n, _ in tnet.named_parameters()]
    assert "src_embed.weight" in names and "tgt_embed.weight" not in names
    arrays = _arrays(jnet)
    assert "tgt_embed.weight" in arrays      # the JAX package's second name
    # the alias may be absent, and must equal the parameter when present
    del arrays["tgt_embed.weight"]
    load_jax_params(ttr.Transformer(V, V, dropout=0.0, device="cpu", **CFG),
                    arrays)
    arrays["tgt_embed.weight"] = arrays["src_embed.weight"] + 1.0
    with pytest.raises(MXNetError, match="tgt_embed.weight"):
        load_jax_params(ttr.Transformer(V, V, dropout=0.0, device="cpu",
                                        **CFG), arrays)
    untied = ttr.Transformer(V, V + 1, dropout=0.0, device="cpu", **CFG)
    assert untied.tgt_embed is not untied.src_embed


def test_ffn_output_is_dropped_twice():
    """The NMT layers drop the FFN's output in the FFN and again in the
    residual add, as the JAX package's layers do: 2 + 3 a encoder layer
    + 4 a decoder layer dropout sites a step."""
    net = ttr.Transformer(V, V, dropout=0.1, device="cpu", **CFG)
    lyr = net.encoder.layer0
    assert lyr.ffn._drop_output and net.decoder.layer1.ffn._drop_output
    counted = []
    from incubator_mxnet_tpu_torch import random as mxrandom

    draw = mxrandom.next_seed

    def count():
        counted.append(1)
        return draw()

    src, tin, _, vl = _batch(2)
    mxr.seed(0, device="cpu")
    mxrandom.next_seed = count
    try:
        with autograd.record():
            net.initialize()(_t(src), _t(tin), _t(vl))
    finally:
        mxrandom.next_seed = draw
    L = CFG["num_layers"]
    assert len(counted) == 2 + 3 * L + 4 * L


# ------------------------------------------------------------- the loss
@pytest.mark.parametrize("vocab", [V, 100])
@pytest.mark.parametrize("eps", [0.0, EPS])
def test_label_smoothed_loss_matches_jax(vocab, eps):
    """`LabelSmoothedCELoss` against the JAX one on the same logits, with
    ignored rows (label -1): the streamed path at V=600 (its plain
    version here) and ``log_softmax`` at V=100, within 1e-6 relative.
    Ignored rows contribute nothing and get a zero gradient."""
    rs = onp.random.RandomState(3)
    logits = rs.randn(B, T, vocab).astype(onp.float32) * 3
    labels = rs.randint(0, vocab, (B, T)).astype(onp.int32)
    labels[0, 2:] = IGNORE
    labels[1, -1] = IGNORE
    ref = jtr.LabelSmoothedCELoss(eps)(_j(logits), _j(labels)).asnumpy()
    x = _t(logits).requires_grad_()
    with autograd.record():
        loss = ttr.LabelSmoothedCELoss(eps)(x, _t(labels))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    onp.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
    ignored = _t(labels == IGNORE)
    assert torch.count_nonzero(x.grad[ignored]) == 0
    assert torch.count_nonzero(x.grad[~ignored]) > 0


def test_loss_gradient_matches_jax_grad():
    """d loss / d logits against `jax.grad` of the JAX loss's math, the
    streamed path with ignored rows: |g - ref| <= 1e-5·max|ref|."""
    rs = onp.random.RandomState(4)
    logits = rs.randn(B, T, V).astype(onp.float32)
    labels = rs.randint(0, V, (B, T)).astype(onp.int32)
    labels[1, :3] = IGNORE

    def jloss(lg):
        return jtr.LabelSmoothedCELoss(EPS)(NDArray(lg),
                                            _j(labels))._data

    ref = onp.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    x = _t(logits).requires_grad_()
    with autograd.record():
        loss = ttr.LabelSmoothedCELoss(EPS)(x, _t(labels))
    loss.backward()
    assert onp.abs(x.grad.numpy() - ref).max() <= 1e-5 * onp.abs(ref).max()


# -------------------------------------------------------- the gradients
@pytest.mark.parametrize("masked", [False, True])
def test_gradients_match_jax_grad(masked):
    """The gradient of the step's loss (smoothed cross-entropy over the
    non-ignored rows) with respect to every parameter against
    `jax.grad` of the JAX model's pure function (`functionalize`):
    |g - ref| <= 1e-4·|ref| + 1e-5·max|ref| per tensor.  The shared
    embedding's gradient is the sum of its source and target uses on
    both sides."""
    jnet, tnet = _pair(0)
    src, tin, tout, vl = _batch(5)
    apply_fn, train, aux = functionalize(jnet)
    names = {}
    for k, p in jnet._collect_params_with_prefix().items():
        names.setdefault(id(p), k)
    order = [names[id(p)] for p in apply_fn.trainable_params]
    assert len(order) == len(list(tnet.parameters()))
    extra = (jnp.asarray(vl),) if masked else ()
    valid = jnp.asarray(tout != IGNORE, jnp.float32)
    lab = jnp.asarray(onp.where(tout == IGNORE, 0, tout))

    def loss_fn(train_raws):
        logits, _ = apply_fn(train_raws, aux, jax.random.PRNGKey(0),
                             jnp.asarray(src), jnp.asarray(tin), *extra)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, lab[..., None], axis=-1)[..., 0]
        loss = (1 - EPS) * nll + EPS * -jnp.mean(logp, axis=-1)
        return jnp.sum(loss * valid) / jnp.maximum(jnp.sum(valid), 1.0)

    jloss, jgrads = jax.value_and_grad(loss_fn)(train)
    with autograd.record():
        logits = tnet(_t(src), _t(tin), _t(vl) if masked else None)
        loss = ttr.LabelSmoothedCELoss(EPS)(logits, _t(tout))
    loss.backward()
    onp.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    params = dict(tnet.named_parameters())
    for name, ref in zip(order, jgrads):
        ref = onp.asarray(ref)
        got = params[name].grad.numpy()
        allow = 1e-4 * onp.abs(ref) + 1e-5 * onp.abs(ref).max()
        assert onp.all(onp.abs(got - ref) <= allow), \
            (name, float(onp.abs(got - ref).max()), float(onp.abs(ref).max()))
    assert "src_embed.weight" in order


# ------------------------------------------------------ Adam + InvSqrt
ADAM = {"learning_rate": 0.01, "beta1": 0.9, "beta2": 0.98}
WARMUP = 4


def _adam(**extra):
    return dict(ADAM, lr_scheduler=tls.InvSqrtScheduler(WARMUP), **extra)


def _jadam(**extra):
    return dict(ADAM, lr_scheduler=jls.InvSqrtScheduler(WARMUP), **extra)


def _batches(n=3):
    return [_batch(10 + i) for i in range(n)]


@pytest.mark.parametrize("hybrid", [False, True])
def test_adam_invsqrt_steps_match_jax(hybrid):
    """Three steps of Adam (β 0.9/0.98) under the inverse-sqrt schedule
    (warm-up 4, so the rate moves every step) on the NMT step, against
    the JAX package's Trainer from the same weights, dropout 0: the port
    eager (a block never hybridized, the eager rule) or hybridized (the
    recorded programs and the fused update with staged scalars) against
    the JAX hybridized fused step.  Each loss within 1e-5 relative, the
    weights within 1e-5 after 3 (Adam divides by √v, so float noise in a
    gradient near 0 moves its weight; the weights move by up to 7.5e-3
    in the 3 steps)."""
    jnet, tnet = _pair(0)
    jmodel, tmodel = JNMTWithLoss(jnet), NMTWithLoss(tnet, EPS)
    jmodel.hybridize()
    # the loss hybridizes itself: the block never hybridized is all eager
    tmodel.hybridize(hybrid)
    jtr_ = JTrainer(jmodel.collect_params(), "adam", _jadam(),
                    keep_grads=False)
    ttr_ = Trainer(tmodel.collect_params(), "adam", _adam(),
                   keep_grads=False)
    lrs = []
    for src, tin, tout, vl in _batches():
        with jag.record():
            jl = jmodel(_j(src), _j(tin), _j(tout), _j(vl))
        jl.backward()
        jtr_.step(1)
        with autograd.record():
            tl = tmodel(_t(src), _t(tin), _t(tout), _t(vl))
        tl.backward()
        ttr_.step(1)
        lrs.append(ttr_.learning_rate)
        onp.testing.assert_allclose(float(tl.detach()), float(jl.asnumpy()),
                                    rtol=1e-5)
    assert len(set(lrs)) == 3 and ttr_.optimizer.num_update == 3
    assert jtr_._fullstep_ctx is not None, "the JAX step was not fused"
    assert (ttr_._updates is not None) == hybrid
    jw = _arrays(jnet)
    for k, p in tnet.named_parameters():
        onp.testing.assert_allclose(p.detach().numpy(), jw[k], atol=1e-5,
                                    err_msg=k)


def _train(hybrid=True, fuse=True, dtype=torch.float32, mp=True, steps=3):
    mxr.seed(3, device="cpu")
    net = ttr.Transformer(V, V, dropout=0.1, device="cpu", **CFG)
    net.initialize()
    if dtype != torch.float32:
        net.cast(dtype)
    model = NMTWithLoss(net, EPS)
    # the loss hybridizes itself: the block never hybridized is all eager
    model.hybridize(hybrid)
    tr = Trainer(model.collect_params(), "adam",
                 _adam(multi_precision=mp, wd=1e-4), keep_grads=False,
                 fuse_step=fuse)
    mxr.seed(5, device="cpu")
    losses = []
    for src, tin, tout, vl in _batches(steps):
        with autograd.record():
            loss = model(_t(src), _t(tin), _t(tout), _t(vl))
        loss.backward()
        tr.step(1)
        losses.append(loss.detach())
    states = [t.clone() for s in tr._states.values()
              for t in (s[0], *s[1]) if mp] if mp else \
        [t.clone() for s in tr._states.values() for t in s]
    return (losses, [p.detach().clone() for p in model.collect_params()
                     .values()], states, tr)


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("other", ["unfused", "unhybridized"])
def test_captured_adam_steps_equal_eager_steps(other):
    """Dropout on, one seed, three steps whose learning rate and bias
    corrections change every step: the fused update program (its
    scalars staged each step) against ``fuse_step=False``, and the
    hybridized block against the block never hybridized: the same
    losses, weights, f32 masters and Adam moments bit for bit."""
    want = _train()
    assert want[3]._updates is not None
    got = _train(fuse=False) if other == "unfused" else _train(hybrid=False)
    assert got[3]._updates is None
    assert _same(want[0], got[0])
    assert _same(want[1], got[1])
    assert _same(want[2], got[2])


def test_captured_adam_equals_unfused_in_bf16_without_masters():
    """A bf16 model without f32 masters: the update program's staged
    f32 scalars give the eager rule's bits over three steps."""
    fused = _train(dtype=torch.bfloat16, mp=False)
    unfused = _train(dtype=torch.bfloat16, mp=False, fuse=False)
    assert all(w.dtype == torch.bfloat16 for w in fused[1])
    assert _same(fused[0], unfused[0]) and _same(fused[1], unfused[1])
    assert _same(fused[2], unfused[2])


def test_update_program_stages_this_steps_scalars():
    """One update program over three steps: its staged ``lr`` and
    ``lr_t`` are each step's (the schedule's rate at t, and
    lr·√(1-β2ᵗ)/(1-β1ᵗ)), not the first step's."""
    _, _, _, tr = _train()
    opt = tr.optimizer
    assert isinstance(opt, Adam) and opt.num_update == 3
    hyper = dict(zip(opt.HYPER, tr._updates.prog.static_inputs["hyper"]
                     .tolist()))
    sched = tls.InvSqrtScheduler(WARMUP)
    sched.base_lr = ADAM["learning_rate"]
    lr = sched(3)
    assert hyper["lr"] == pytest.approx(lr, rel=1e-6)
    assert hyper["lr_t"] == pytest.approx(
        lr * (1 - 0.98 ** 3) ** 0.5 / (1 - 0.9 ** 3), rel=1e-6)


def test_adam_reference_update_matches_jax():
    """`Optimizer.update_multi_precision` (the reference API, one
    parameter, f32 master of a bf16 weight) against the JAX Adam's over
    three updates with weight decay and a clip: within 1e-6."""
    rs = onp.random.RandomState(7)
    w0 = rs.randn(5, 3).astype(onp.float32)
    grads = [rs.randn(5, 3).astype(onp.float32) for _ in range(3)]
    kw = dict(learning_rate=0.05, beta1=0.8, beta2=0.95, wd=0.01,
              clip_gradient=1.0, multi_precision=True, rescale_grad=0.5)
    jopt = mx.optimizer.create("adam", **kw)
    topt = create("adam", **kw)
    jw = NDArray(jnp.asarray(w0, jnp.bfloat16))
    tw = torch.from_numpy(w0).to(torch.bfloat16)
    js = jopt.create_state_multi_precision(0, jw)
    ts = topt.create_state_multi_precision(0, tw)
    for g in grads:
        js = jopt.update_multi_precision(0, jw, NDArray(jnp.asarray(g)), js)
        topt.update_multi_precision(0, tw, torch.from_numpy(g), ts)
    onp.testing.assert_allclose(ts[0].numpy(), onp.asarray(js[0]), atol=1e-6)
    assert topt.num_update == jopt.num_update == 3


# -------------------------------------------------------- the schedules
SCHEDULES = {
    "factor": lambda m: m.FactorScheduler(step=3, factor=0.5, base_lr=0.1),
    "factor_warmup": lambda m: m.FactorScheduler(
        step=4, factor=0.7, base_lr=0.1, warmup_steps=5,
        warmup_begin_lr=0.01),
    "multifactor": lambda m: m.MultiFactorScheduler(
        step=[3, 7, 12], factor=0.5, base_lr=0.2),
    "poly": lambda m: m.PolyScheduler(max_update=15, base_lr=0.1, pwr=2,
                                      final_lr=0.001, warmup_steps=3),
    "cosine": lambda m: m.CosineScheduler(max_update=15, base_lr=0.1,
                                          final_lr=0.01, warmup_steps=4,
                                          warmup_mode="constant",
                                          warmup_begin_lr=0.02),
    "linear": lambda m: m.LinearScheduler(max_update=12, base_lr=0.1,
                                          warmup_steps=2),
    "invsqrt": lambda m: m.InvSqrtScheduler(warmup_steps=6, base_lr=0.5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_scheduler_matches_jax(name):
    """Each schedule's rate over 20 updates (0..19) equals the JAX
    module's exactly (the same Python arithmetic)."""
    jsch, tsch = SCHEDULES[name](jls), SCHEDULES[name](tls)
    assert [tsch(t) for t in range(20)] == [jsch(t) for t in range(20)]


def test_scheduler_drives_the_optimizer():
    """The optimizer sets the schedule's base rate to its learning rate,
    reads it at ``num_update``, and refuses ``set_learning_rate`` while
    a schedule is set, as the JAX package's does."""
    sched = tls.InvSqrtScheduler(warmup_steps=4000)
    opt = create("adam", learning_rate=2.0, lr_scheduler=sched)
    assert sched.base_lr == 2.0
    opt.num_update = 10
    assert opt.learning_rate == 2.0 * 10 * 4000 ** -1.5
    with pytest.raises(UserWarning):
        opt.set_learning_rate(0.1)
    with pytest.raises(ValueError):
        tls.LRScheduler(warmup_mode="cubic")
    with pytest.raises(NotImplementedError):
        tls.LRScheduler()(1)


# ------------------------------------------------ BERT's padding mask
BERT_CFG = dict(vocab_size=100, units=32, hidden_size=64, num_layers=2,
                num_heads=4)


def test_bert_valid_length_matches_jax():
    """BERT with ``valid_length`` (the masked attention at every T, as
    the JAX package's XLA path): the sequence output and pooled output
    against the JAX model's within 1e-5, and the gradient of their sum
    with respect to every parameter against the JAX package's own
    backward within 1e-4·|ref| + 1e-5·max|ref|."""
    mx.random.seed(1)
    jnet = jbert.BERTModel(**BERT_CFG, dropout=0.0, use_flash=False)
    jnet.initialize()
    toks = onp.random.RandomState(2).randint(0, 100, (3, 8)).astype(
        onp.int32)
    vl = onp.array([3, 8, 1], onp.int32)
    jnet(_j(toks))
    tnet = load_jax_params(tbert.BERTModel(**BERT_CFG, dropout=0.0,
                                           device="cpu"), _arrays(jnet))
    with jag.record():
        jseq, jpool = jnet(_j(toks), None, _j(vl))
        jsum = (jseq * jseq).sum() + jpool.sum()
    jsum.backward()
    with autograd.record():
        tseq, tpool = tnet(_t(toks), None, _t(vl))
        tsum = (tseq * tseq).sum() + tpool.sum()
    tsum.backward()
    onp.testing.assert_allclose(tseq.detach().numpy(), jseq.asnumpy(),
                                atol=1e-5)
    onp.testing.assert_allclose(tpool.detach().numpy(), jpool.asnumpy(),
                                atol=1e-5)
    jg = {k: p.grad().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    for k, p in tnet.named_parameters():
        ref = jg[k]
        got = p.grad.numpy() if p.grad is not None else onp.zeros_like(ref)
        allow = 1e-4 * onp.abs(ref) + 1e-5 * onp.abs(ref).max()
        assert onp.all(onp.abs(got - ref) <= allow), k
    unmasked = tnet(_t(toks))[0]
    assert not torch.allclose(unmasked, tseq.detach(), atol=1e-4)
