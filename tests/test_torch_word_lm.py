"""The word-level LSTM language model of the PyTorch/CUDA port
(`models.WordLM`, the loop of `examples/gluon/word_language_model.py`)
against the JAX example's ``build_model``, f32 on the CPU.

At vocab 600 (so the streamed cross-entropy's plain path is the one
taken), emsize = nhid = 16, 2 layers, bptt 5, batch 3, tied and untied,
with dropout off: the weights carried by structural name
(``embed.weight``, ``lstm.parameters``, ``decoder.*`` or
``decoder_bias``), both models hybridized, three windows of the
example's step, the hidden state carried across windows and detached,
``clip_global_norm(grads, 0.25 * batch)`` between ``backward()`` and
``Trainer.step(1)`` (SGD, lr 1, momentum 0, so the update sees the
clipped gradients).  Each window's loss and returned norm within
1e-5 relative, the weights and the carried states after three
windows within 1e-5·|ref| + 1e-6·max|ref| per element (three
updates of lr 1 compound the roundings of single ops).

With dropout 0.5 the port's hybridized loop (its captured programs
run eagerly on the CPU) is held bit for bit to the same loop never
hybridized, from the same seed: losses, weights and states.
"""
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.gluon import Trainer as JTrainer
from incubator_mxnet_tpu.gluon import loss as jloss
from incubator_mxnet_tpu.gluon import utils as jutils
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch import random as mxr
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.gluon import loss as tloss
from incubator_mxnet_tpu_torch.gluon import utils
from incubator_mxnet_tpu_torch.models import WordLM
from incubator_mxnet_tpu_torch.ops import xent_kernel as xk

torch.set_num_threads(1)  # six xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, EM, LAYERS, BPTT, BATCH, STEPS = 600, 16, 2, 5, 3, 3
LR, CLIP = 1.0, 0.25
LOSS_RTOL = 1e-5
WEIGHT_TOL = (1e-5, 1e-6)


def _example():
    spec = importlib.util.spec_from_file_location(
        "word_language_model",
        os.path.join(ROOT, "examples", "gluon", "word_language_model.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXAMPLE = _example()


def _windows():
    data = EXAMPLE.batchify(EXAMPLE.synthetic_corpus(V, 400), BATCH)
    return [(data[i * BPTT:(i + 1) * BPTT],
             data[i * BPTT + 1:(i + 1) * BPTT + 1]) for i in range(STEPS)]


def _jax_run(tied):
    """The example's model and step (its own code) over the windows:
    (losses, norms, weights by name, final states, initial weights)."""
    args = types.SimpleNamespace(emsize=EM, nhid=EM, nlayers=LAYERS,
                                 dropout=0.0, tied=tied)
    model = EXAMPLE.build_model(args, V)
    model.initialize(mx.init.Zero())
    model.hybridize()
    states = model.lstm.begin_state(BATCH)
    model(NDArray(jnp.asarray(_windows()[0][0])), states)
    # the example's Uniform(0.1) weights, drawn with numpy (the JAX
    # package's draws compile one program a shape)
    rs = onp.random.RandomState(0)
    for name, p in model._collect_params_with_prefix().items():
        if not name.endswith("bias"):
            p.set_data(NDArray(jnp.asarray(
                rs.uniform(-0.1, 0.1, p.shape).astype(onp.float32))))
    init = {k: onp.asarray(p.data()._data) for k, p in
            model._collect_params_with_prefix().items()}
    loss_fn = jloss.SoftmaxCrossEntropyLoss()
    trainer = JTrainer(model.collect_params(), "sgd",
                       {"learning_rate": LR, "momentum": 0.0})
    losses, norms = [], []
    for x, y in _windows():
        states = EXAMPLE.detach_states(states)
        with jag.record():
            logits, states = model(NDArray(jnp.asarray(x)), states)
            loss = loss_fn(logits, NDArray(jnp.asarray(y))).mean()
        loss.backward()
        grads = [p.grad() for p in model.collect_params().values()
                 if p.grad_req != "null"]
        norms.append(jutils.clip_global_norm(grads, CLIP * BATCH))
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    weights = {k: onp.asarray(p.data()._data) for k, p in
               model._collect_params_with_prefix().items()}
    return losses, norms, weights, [s.asnumpy() for s in states], init


def _port_run(model, hybrid):
    """The same loop through the port: (losses, norms, final states)."""
    if hybrid:
        model.hybridize()
    loss_fn = tloss.SoftmaxCrossEntropyLoss()
    trainer = Trainer(model.collect_params(), "sgd",
                      {"learning_rate": LR, "momentum": 0.0})
    states = model.begin_state(BATCH)
    losses, norms = [], []
    for x, y in _windows():
        states = [s.detach() for s in states]
        with autograd.record():
            logits, states = model(torch.from_numpy(x), states)
            loss = loss_fn(logits, torch.from_numpy(y)).mean()
        loss.backward()
        grads = [p.grad for p in model.collect_params().values()
                 if p.grad_req != "null"]
        norms.append(utils.clip_global_norm(grads, CLIP * BATCH))
        trainer.step(1)
        losses.append(float(loss.detach()))
    return losses, norms, [s.detach() for s in states]


def _close(got, ref, tol, what):
    got = got.detach().numpy()
    big = onp.abs(ref).max(initial=1e-30)
    err = onp.abs(got - ref)
    assert onp.all(err <= tol[0] * onp.abs(ref) + tol[1] * big), \
        (what, float(err.max()), float(big))


@pytest.mark.parametrize("tied", [False, True])
def test_word_lm_matches_jax_over_three_windows(tied):
    """Tied and untied: the losses, the clipped norms, every weight and
    the carried states after three windows equal the JAX example's
    within the stated bounds; the tied decoder is the one embedding
    weight (aliases checked by `load_jax_params`); the loss stays on
    the plain path of the streamed cross-entropy (no launch)."""
    jl, jn, jw, jst, init = _jax_run(tied)
    model = WordLM(V, EM, EM, LAYERS, 0.0, tied, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(init)
    assert ("decoder_bias" in names) == tied
    load_jax_params(model, init)
    launches = xk.xent_forward.launches
    tl, tn, tst = _port_run(model, hybrid=True)
    assert xk.xent_forward.launches == launches
    for a, b in zip(tl + tn, jl + jn):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (tl, jl, tn, jn)
    for name, p in model.named_parameters():
        _close(p, jw[name], WEIGHT_TOL, name)
        assert not onp.array_equal(jw[name], init[name]), name
    for a, b in zip(tst, jst):
        _close(a, b, WEIGHT_TOL, "carried state")


def test_hybridized_word_lm_with_dropout_equals_its_eager_body():
    """Dropout 0.5 (the two dropout sites and the LSTM's inter-layer
    dropout): the hybridized loop (captured programs, eager on the CPU,
    the seeds from their seed tables) and the loop never hybridized,
    from the same seed, give the same bits: losses, norms, weights and
    states; and the dropout did act (the loss differs from dropout
    off)."""
    runs = []
    for hybrid, p in ((True, 0.5), (False, 0.5), (False, 0.0)):
        mxr.seed(4, device="cpu")
        model = WordLM(V, EM, EM, LAYERS, p, True, device="cpu")
        model.initialize()
        runs.append(_port_run(model, hybrid) + (list(model.parameters()),))
    (hl, hn, hs, hw), (el, en, es, ew), (pl, _, _, _) = runs
    assert hl == el and hn == en, (hl, el)
    assert all(torch.equal(a, b) for a, b in zip(hw, ew))
    assert all(torch.equal(a, b) for a, b in zip(hs, es))
    assert hl[0] != pl[0]


def test_word_lm_under_a_chaining_trainer_runs_its_calls_now():
    """A call whose states come in a list holds tensors that a chained
    stage cannot keep (it keeps tensors at the top level only): under
    ``Trainer(chain_steps=2, keep_grads=False)`` a block taking the word
    LM's states and returning its loss runs each call as it comes (no
    `engine.Deferred`), with the same losses and weights as under
    ``chain_steps=1``."""
    from incubator_mxnet_tpu_torch import engine
    from incubator_mxnet_tpu_torch.gluon import HybridBlock

    class LMLoss(HybridBlock):
        def __init__(self, lm):
            super().__init__()
            self.lm = lm
            self.loss = tloss.SoftmaxCrossEntropyLoss()

        def forward(self, x, y, states):
            return self.loss(self.lm(x, states)[0], y).mean()

    runs = []
    for chain in (2, 1):
        mxr.seed(6, device="cpu")
        model = WordLM(V, EM, EM, LAYERS, 0.5, True, device="cpu")
        model.initialize()
        net = LMLoss(model)
        net.hybridize()
        trainer = Trainer(net.collect_params(), "sgd",
                          {"learning_rate": LR}, keep_grads=False,
                          chain_steps=chain)
        states, losses = model.begin_state(BATCH), []
        for x, y in _windows():
            with autograd.record():
                loss = net(torch.from_numpy(x), torch.from_numpy(y), states)
            assert not isinstance(loss, engine.Deferred)
            loss.backward()
            trainer.step(1)
            losses.append(float(loss.detach()))
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
