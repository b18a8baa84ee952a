"""The captured training step of the PyTorch/CUDA port: a hybridized
block under ``autograd.record()`` (`gluon.block._Recorded`: the recorded
forward and backward programs), the Trainer's update program
(`gluon.trainer._Update`), the seed tables that keep dropout fresh
inside a program (`random.SeedTable`) and the device-seed dropout
entries (`ops.dropout_kernel.dropout_fwd_dev`, `dropout_mask_dev`).

On the CPU a `_graphs.Program` runs its body eagerly on its static
buffers, so these tests hold the bodies that the card captures — the
recorded forward, the backward over its autograd graph into the
gradient buffers, the update over those buffers with staged scalars —
against the JAX package's hybridized fused step and against the port's
own eager path.  A 2-layer BERT (D=32, H=4, V=100, T=8, B=2), f32, as
bench.py drives it (`chip_smoke.PretrainWithLoss`).  The capture and
replay themselves need the card (``chip_smoke.py``'s captured-training
phase).
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
from incubator_mxnet_tpu_torch import MXNetError, _graphs, autograd
from incubator_mxnet_tpu_torch import random as mxr
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import HybridBlock, Trainer
from incubator_mxnet_tpu_torch.gluon import block as TB
from incubator_mxnet_tpu_torch.gluon.nn import Dense
from incubator_mxnet_tpu_torch.models import bert as tbert
from incubator_mxnet_tpu_torch.ops import dropout_kernel as tdk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=100, units=32, hidden_size=64, num_layers=2,
           num_heads=4)
B, T = 2, 8
SGD = {"learning_rate": 1e-3, "momentum": 0.9, "multi_precision": True}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PretrainWithLoss = _chip_smoke().PretrainWithLoss


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
        return mlm - nsp_logp[:, 0].mean()


def _batch(seed):
    rs = onp.random.RandomState(seed)
    return (rs.randint(0, CFG["vocab_size"], (B, T)).astype(onp.int32),
            rs.randint(0, CFG["vocab_size"], (B, T)).astype(onp.int32))


def _model(dropout=0.1, hybrid=True, seed=3, **trainer_kw):
    mxr.seed(seed, device="cpu")
    net = tbert.BERTForPretraining(**CFG, dropout=dropout,
                                   device="cpu").initialize()
    model = PretrainWithLoss(net)
    if hybrid:
        model.hybridize()
    kw = dict(keep_grads=False)
    kw.update(trainer_kw)
    return model, Trainer(model.collect_params(), "sgd", dict(SGD), **kw)


def _train(model, trainer, steps=3, seed=5, batches=None):
    mxr.seed(seed, device="cpu")
    losses = []
    for s in range(steps):
        toks, labels = batches[s] if batches else _batch(0)
        with autograd.record():
            loss = model(torch.from_numpy(toks), torch.from_numpy(labels))
        loss.backward()
        trainer.step(1)
        losses.append(loss.detach())
    return losses


def _weights(model):
    return [p.detach().clone() for p in model.collect_params().values()]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------- JAX parity
def test_captured_step_matches_jax_fused_step():
    """bench.py's step, hybridized, ``keep_grads=False``, three steps:
    the JAX package's one fused program and the port's recorded
    programs plus its update program, from the same weights, dropout
    0: each loss within 1e-5, the weights within 1e-6 (the tolerances
    of `test_torch_bert_train.py`)."""
    mx.random.seed(0)
    jnet = jbert.BERTForPretraining(**CFG, dropout=0.0, use_flash=False)
    jnet.initialize()
    jnet(NDArray(jnp.ones((B, T), jnp.int32)))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tnet = load_jax_params(tbert.BERTForPretraining(
        **CFG, dropout=0.0, device="cpu"), arrays)
    jmodel, tmodel = JPretrainWithLoss(jnet), PretrainWithLoss(tnet)
    jmodel.hybridize()
    tmodel.hybridize()
    jtr = JTrainer(jmodel.collect_params(), "sgd", dict(SGD),
                   keep_grads=False)
    ttr = Trainer(tmodel.collect_params(), "sgd", dict(SGD),
                  keep_grads=False)
    batches = [_batch(s) for s in (1, 2, 3)]
    for toks, labels in batches:
        with jag.record():
            jloss = jmodel(NDArray(jnp.asarray(toks)),
                           NDArray(jnp.asarray(labels)))
        jloss.backward()
        jtr.step(1)
        with autograd.record():
            tloss = tmodel(torch.from_numpy(toks), torch.from_numpy(labels))
        tloss.backward()
        ttr.step(1)
        assert abs(float(tloss.detach()) - float(jloss.asnumpy())) <= 1e-5
    assert jtr._fullstep_ctx is not None, "the JAX step was not fused"
    assert ttr._updates is not None, "the update did not read the buffers"
    jw = {k: p.data().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    for k, p in tnet.named_parameters():
        onp.testing.assert_allclose(p.detach().numpy(), jw[k], atol=1e-6,
                                    err_msg=k)


# --------------------------------------------------------- port's own paths
@pytest.mark.parametrize("other", ["unfused", "unhybridized"])
def test_fused_step_equals_unfused_and_unhybridized(other):
    """Dropout on, one seed: ``fuse_step=True`` against
    ``fuse_step=False``, and the hybridized block against the block
    never hybridized — the same losses and the same weights, bit for
    bit, after three steps."""
    model, tr = _model()
    want = _train(model, tr)
    if other == "unfused":
        model2, tr2 = _model(fuse_step=False)
    else:
        model2, tr2 = _model(hybrid=False)
    got = _train(model2, tr2)
    assert _same(want, got)
    assert _same(_weights(model), _weights(model2))
    assert not _same(_weights(model), _weights(_model()[0]))


def test_fused_step_equals_unfused_in_bf16_without_multi_precision():
    """A bf16 model without f32 masters: the update program's staged
    scalars (0-d f32 tensors) give the bits of the eager rule's Python
    floats (momentum 0.9 is not rounded to bf16's 0.8984375), over
    three steps with dropout on."""
    runs = []
    for fuse in (True, False):
        mxr.seed(3, device="cpu")
        net = tbert.BERTForPretraining(**CFG, dropout=0.1,
                                       device="cpu").initialize()
        model = PretrainWithLoss(net)
        model.cast("bfloat16")
        model.hybridize()
        tr = Trainer(model.collect_params(), "sgd",
                     {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-2},
                     keep_grads=False, fuse_step=fuse)
        losses = _train(model, tr)
        if fuse:
            assert tr._updates is not None
        runs.append((losses, _weights(model),
                     [s for s in tr._states.values() if s is not None]))
    (l0, w0, s0), (l1, w1, s1) = runs
    assert all(w.dtype == torch.bfloat16 for w in w0)
    assert _same(l0, l1) and _same(w0, w1) and _same(s0, s1)


def test_recorded_step_runs_the_programs():
    model, tr = _model()
    _train(model, tr, steps=2)
    (key, (rec,)), = model._graph_cache.items()
    assert rec.fwd.name == "fwd_record" and rec.bwd.name == "bwd_record"
    # the embedding dropout and two DropoutAdds a layer draw from the
    # forward program's seed table
    assert rec.fwd.seeds.n == 2 * CFG["num_layers"] + 1
    assert tr._updates.prog.name == "update"
    # the update captures into the backward's pool (replayed after it)
    assert tr._updates.prog.pool is rec.bwd.pool is rec.fwd.pool
    # the backward left the gradients in its buffers: the update read
    # them there, and no parameter holds a gradient of its own
    assert all(p._grad_src is None for p in model.collect_params().values())


def test_keep_grads_false_gradient_read_raises():
    model, tr = _model()
    _train(model, tr, steps=1)
    p = model.collect_params()["net.mlm_decoder.weight"]
    with pytest.raises(MXNetError, match="keep_grads"):
        p.grad
    # the token-type table is not reached: it never had a gradient
    assert model.collect_params()[
        "net.bert.token_type_embed.weight"].grad is None
    # a cast reads every gradient; it must not raise
    model.cast("float32")


def test_keep_grads_true_gradients_equal_eager_and_survive_a_step():
    model, tr = _model(keep_grads=True)
    eager, etr = _model(hybrid=False, keep_grads=True)
    _train(model, tr, steps=1)
    _train(eager, etr, steps=1)
    params = model.collect_params()
    got = {k: p.grad for k, p in params.items()}
    want = {k: p.grad for k, p in eager.collect_params().items()}
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert torch.equal(got[k], want[k]), k
    keep = {k: g.clone() for k, g in got.items() if g is not None}
    _train(model, tr, steps=1, seed=6)
    for k, g in keep.items():
        assert torch.equal(got[k], g), f"{k} changed under the next step"
    assert not torch.equal(params["net.mlm_decoder.weight"].grad,
                           keep["net.mlm_decoder.weight"])


def test_gradient_read_between_backward_and_step_is_a_copy():
    model, tr = _model()
    toks, labels = (torch.from_numpy(a) for a in _batch(0))
    with autograd.record():
        model(toks, labels).backward()
    p = model.collect_params()["net.nsp.weight"]
    g = p.grad
    assert g is not p._grad_src and torch.equal(g, p._grad_src)
    before = g.clone()
    with autograd.record():
        (2 * model(toks, labels)).backward()
    assert torch.equal(g, before)
    tr.step(1)


class _Affine(HybridBlock):
    def __init__(self):
        super().__init__()
        self.dense = Dense(3, 4, device="cpu")

    def forward(self, x):
        return (self.dense(x) ** 2).sum()


def test_input_gradients_through_the_recorded_node():
    """An input that requires a gradient gets it from the backward
    program, returned through the node (tests/test_trainer.py:177):
    three steps, each with a fresh input, its gradient and the weights
    after the step equal to the never-hybridized block's (the second
    call stages its input into a buffer that required a gradient at
    the first)."""
    runs = []
    for hybrid in (False, True):
        mxr.seed(1, device="cpu")
        net = _Affine().initialize()
        if hybrid:
            net.hybridize()
        tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05,
                                                   "momentum": 0.9})
        steps = []
        for s in range(3):
            x = torch.from_numpy(onp.random.RandomState(2 + s).uniform(
                -1, 1, (5, 4)).astype(onp.float32)).requires_grad_()
            with autograd.record():
                loss = net(x)
            loss.backward()
            tr.step(1)
            steps.append((x.grad, net.dense.weight.detach().clone()))
        runs.append(steps)
    for (gx0, w0), (gx1, w1) in zip(*runs):
        assert gx1 is not None and torch.count_nonzero(gx1) > 0
        assert torch.equal(gx0, gx1) and torch.equal(w0, w1)
    assert any("record" in k for k in net._graph_cache)


class _TwoBlocks(TB.Block):
    """A plain block over two hybridized children: two recorded
    programs, each with its own graph pool."""

    def __init__(self):
        super().__init__()
        self.a = Dense(6, 4, device="cpu")
        self.b = Dense(3, 6, device="cpu")

    def forward(self, x):
        return (self.b(torch.relu(self.a(x))) ** 2).sum()


def test_update_reads_the_buffers_of_two_recorded_blocks():
    """Two hybridized children, each its recorded backward's buffers:
    the update program reads both (in a pool of its own) and gives the
    eager rule's weights bit for bit over three steps."""
    runs = []
    for fuse in (True, False):
        mxr.seed(4, device="cpu")
        net = _TwoBlocks().initialize()
        net.hybridize()
        tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05,
                                                   "momentum": 0.9},
                     keep_grads=False, fuse_step=fuse)
        for s in range(3):
            x = torch.from_numpy(onp.random.RandomState(7 + s).uniform(
                -1, 1, (5, 4)).astype(onp.float32))
            with autograd.record():
                loss = net(x)
            loss.backward()
            tr.step(1)
        if fuse:
            pools = {id(c._graph_pool) for c in (net.a, net.b)}
            assert len(pools) == 2 and id(tr._updates.prog.pool) not in pools
        runs.append(_weights(net))
    assert _same(*runs)


def test_set_learning_rate_needs_no_new_update_program():
    model, tr = _model()
    eager, etr = _model(fuse_step=False)
    toks, labels = (torch.from_numpy(a) for a in _batch(0))
    progs = []
    for m, t in ((model, tr), (eager, etr)):
        mxr.seed(5, device="cpu")
        for lr in (1e-3, 5e-2, 2e-3):
            t.set_learning_rate(lr)
            assert t.learning_rate == lr
            with autograd.record():
                loss = m(toks, labels)
            loss.backward()
            t.step(1)
            if t is tr:
                progs.append(tr._updates.prog)
    # one update program, its scalars staged each step
    assert all(p is progs[0] for p in progs)
    assert _same(_weights(model), _weights(eager))


def test_new_batch_shape_records_anew_and_cast_drops_programs():
    model, tr = _model()
    _train(model, tr, steps=1)
    toks, labels = (torch.from_numpy(a[:1]) for a in _batch(1))
    with autograd.record():
        model(toks, labels).backward()
    tr.step(1)
    keys = [k for k in model._graph_cache if "record" in k]
    assert len(keys) == 2
    model.cast("bfloat16")
    assert len(model._graph_cache) == 0
    with autograd.record():
        loss = model(toks, labels)
    loss.backward()
    assert loss.dtype == torch.float32 and len(model._graph_cache) == 1
    assert model.collect_params()["net.nsp.weight"].grad.dtype \
        == torch.bfloat16


def test_two_recorded_calls_before_one_backward():
    """Two recorded calls, the second while the first call's output
    still awaits its backward, then ``(l1 + l2).backward()``: the second
    call runs programs of its own (a second `_Recorded`, its own graph
    pool), both backwards' gradients add up in each parameter, and a
    third call after the backward takes the first programs again.  The
    losses and gradients equal the block never hybridized bit for bit
    (dropout on, one seed), and the JAX package's hybridized block
    within 1e-5 (dropout off, weights carried across)."""
    a, b = (torch.from_numpy(t) for t in _batch(1))
    c, d = (torch.from_numpy(t) for t in _batch(2))
    runs = []
    for hybrid in (True, False):
        model, _ = _model(hybrid=hybrid)
        mxr.seed(5, device="cpu")
        with autograd.record():
            l1 = model(a, b)
            l2 = model(c, d)
            total = l1 + l2
        total.backward()
        runs.append((model, [l1.detach(), l2.detach()], {
            k: p.grad for k, p in model.collect_params().items()}))
    (model, lh, gh), (_, lp, gp) = runs
    assert _same(lh, lp)
    assert gh.keys() == gp.keys()
    for k in gp:
        assert (gh[k] is None and gp[k] is None) \
            or torch.equal(gh[k], gp[k]), k
    (key, recs), = model._graph_cache.items()
    assert "record" in key and len(recs) == 2
    assert recs[0].fwd.pool is not recs[1].fwd.pool
    with autograd.record():
        model(a, b).backward()
    assert len(model._graph_cache[key]) == 2

    mx.random.seed(0)
    jnet = jbert.BERTForPretraining(**CFG, dropout=0.0, use_flash=False)
    jnet.initialize()
    jnet(NDArray(jnp.ones((B, T), jnp.int32)))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    tmodel = PretrainWithLoss(load_jax_params(tbert.BERTForPretraining(
        **CFG, dropout=0.0, device="cpu"), arrays))
    jmodel = JPretrainWithLoss(jnet)
    jmodel.hybridize()
    tmodel.hybridize()
    with jag.record():
        j1 = jmodel(NDArray(jnp.asarray(a.numpy())),
                    NDArray(jnp.asarray(b.numpy())))
        j2 = jmodel(NDArray(jnp.asarray(c.numpy())),
                    NDArray(jnp.asarray(d.numpy())))
        jtotal = j1 + j2
    jtotal.backward()
    with autograd.record():
        t1 = tmodel(a, b)
        t2 = tmodel(c, d)
        ttotal = t1 + t2
    ttotal.backward()
    for jl, tl in ((j1, t1), (j2, t2)):
        assert abs(float(tl.detach()) - float(jl.asnumpy())) <= 1e-5
    jg = {k: p.grad().asnumpy()
          for k, p in jmodel._collect_params_with_prefix().items()}
    for k, p in tmodel.collect_params().items():
        if p.grad is None:
            assert not onp.any(jg[k]), k
        else:
            onp.testing.assert_allclose(p.grad.numpy(), jg[k], atol=1e-5,
                                        err_msg=k)


def test_failed_update_capture_leaves_count_and_states(monkeypatch):
    """The update program's first call on the card runs its body (the
    warm-up), then records it; a capture that fails raises and puts the
    weights and the states back, and the update count stays."""
    model, tr = _model()
    _train(model, tr, steps=1)
    toks, labels = (torch.from_numpy(a) for a in _batch(0))
    with autograd.record():
        model(toks, labels).backward()
    opt = tr._optimizer
    count = opt.num_update
    states = [t.clone() for s in tr._states.values() for t in s]
    weights = _weights(model)
    run = _graphs.Program.run

    def fail_capture(self, sig=None, **inputs):
        run(self, sig, **inputs)            # the warm-up updates
        raise MXNetError(f"capturing program {self.name!r} failed")

    monkeypatch.setattr(_graphs.Program, "will_capture",
                        lambda self, sig: True)
    monkeypatch.setattr(_graphs.Program, "run", fail_capture)
    with pytest.raises(MXNetError, match="capturing"):
        tr.step(1)
    assert opt.num_update == count
    assert _same([t for s in tr._states.values() for t in s], states)
    assert _same(_weights(model), weights)


# ---------------------------------------------------------------- seeds
def test_seed_table_draws_what_the_eager_body_draws():
    mxr.seed(11, device="cpu")
    want = [mxr.next_seed() for _ in range(5)]
    mxr.seed(11, device="cpu")
    table = mxr.SeedTable("cpu")
    with mxr.seed_table(table):                # the first run counts
        got = [int(mxr.next_seed()) for _ in range(3)]
    assert table.n == 3 and got == want[:3]
    table.stage()                              # the next run's draws
    with mxr.seed_table(table):
        slots = [mxr.next_seed() for _ in range(3)]
    assert [int(s) for s in slots] == want[3:5] + [int(slots[2])]
    assert all(s.dtype == torch.int64 and s.numel() == 1 for s in slots)
    with pytest.raises(MXNetError):
        with mxr.seed_table(table):
            for _ in range(4):
                mxr.next_seed()


def test_one_draw_of_n_seeds_equals_n_draws_of_one():
    mxr.seed(12, device="cpu")
    one = mxr.draw_seeds(49)
    mxr.seed(12, device="cpu")
    many = [mxr.next_seed() for _ in range(49)]
    assert one.tolist() == many


def test_hybridized_masks_are_the_eager_masks():
    """The masks a program's body draws from its seed table equal those
    the block never hybridized draws from the same ``random.seed``."""
    net, _ = _model(hybrid=False)
    toks, labels = (torch.from_numpy(a) for a in _batch(0))
    with autograd.train_mode():
        mxr.seed(8, device="cpu")
        want = [net(toks, labels) for _ in range(2)]
        net.hybridize()
        mxr.seed(8, device="cpu")
        got = [net(toks, labels) for _ in range(2)]
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_seed_plain_versions_equal_by_value(dtype, with_residual):
    rs = onp.random.RandomState(3)
    x = torch.from_numpy(rs.randn(37, 11).astype(onp.float32)).to(dtype)
    res = torch.from_numpy(rs.randn(37, 11).astype(onp.float32)).to(dtype) \
        if with_residual else None
    seed = 987654321987
    slot = torch.tensor([seed], dtype=torch.int64)
    y0, m0 = tdk.dropout_fwd(x, res, seed, 0.3)
    y1, m1 = tdk.dropout_fwd_dev(x, res, slot, 0.3)
    assert torch.equal(m0, m1) and torch.equal(y0, y1)
    assert torch.equal(tdk.dropout_mask(x, seed, 0.3),
                       tdk.dropout_mask_dev(x, slot, 0.3))
    assert torch.equal(tdk.mask_reference(x.numel(), seed, 0.3),
                       tdk.mask_reference(x.numel(), slot, 0.3))
    with pytest.raises(MXNetError):
        tdk.dropout_fwd_dev(x, res, slot.to(torch.int32), 0.3)
