"""SGD with momentum and the single-device Trainer of the PyTorch/CUDA
port (`incubator_mxnet_tpu_torch/optimizer/optimizer.py`,
`incubator_mxnet_tpu_torch/gluon/trainer.py`) held against the JAX
package's Trainer.

Both sides get the same weights and, every step, the same gradients:
the backward of ``sum(w * G)`` over each parameter writes exactly ``G``
(bf16-exact numbers, so the bf16 case gets identical gradients too).
After one and after three steps the f32 weights agree within 1e-6; in
bf16 with ``multi_precision`` the f32 masters agree within 1e-6 and the
bf16 weights within one bf16 step.
"""
import threading

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.gluon import Trainer as JTrainer
from incubator_mxnet_tpu.gluon.parameter import Parameter as JParameter
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import MXNetError, autograd
from incubator_mxnet_tpu_torch.gluon import Parameter, Trainer
from incubator_mxnet_tpu_torch.optimizer import SGD, create

SHAPES = [(5, 3), (4,), (2, 3, 2)]
OPTS = {"plain": {"learning_rate": 1e-2, "momentum": 0.9,
                  "multi_precision": True},
        "wd_clip": {"learning_rate": 5e-2, "momentum": 0.8, "wd": 1e-2,
                    "clip_gradient": 0.5, "multi_precision": True},
        "no_momentum": {"learning_rate": 1e-2}}


def _bf16_exact(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _weights(seed):
    rs = onp.random.RandomState(seed)
    return [_bf16_exact(rs.uniform(-1, 1, s).astype(onp.float32))
            for s in SHAPES]


def _grads(rs):
    return [_bf16_exact(rs.uniform(-2, 2, s).astype(onp.float32))
            for s in SHAPES]


def _jax_side(ws, dtype, opt):
    ps = []
    for i, w in enumerate(ws):
        p = JParameter(f"p{i}", shape=w.shape)
        p.initialize()
        p.set_data(NDArray(jnp.asarray(w)))
        if dtype == "bfloat16":
            p.cast("bfloat16")
        ps.append(p)
    return ps, JTrainer(ps, "sgd", dict(opt))


def _port_side(ws, dtype, opt, keep_grads=True):
    ps = [Parameter(torch.tensor(w, dtype=getattr(torch, dtype)))
          for w in ws]
    return ps, Trainer(ps, "sgd", dict(opt), keep_grads=keep_grads)


def _jax_backward(ps, gs, dtype):
    with jag.record():
        loss = None
        for p, g in zip(ps, gs):
            term = (p.data() * NDArray(jnp.asarray(g).astype(dtype))).sum()
            loss = term if loss is None else loss + term
    loss.backward()


def _port_backward(ps, gs):
    with autograd.record():
        loss = sum((p * torch.from_numpy(g).to(p.dtype)).sum()
                   for p, g in zip(ps, gs))
    loss.backward()


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_f32_steps_match_jax(steps, opt):
    ws = _weights(1)
    jps, jtr = _jax_side(ws, "float32", OPTS[opt])
    tps, ttr = _port_side(ws, "float32", OPTS[opt])
    rs = onp.random.RandomState(2)
    for _ in range(steps):
        gs = _grads(rs)
        _jax_backward(jps, gs, "float32")
        _port_backward(tps, gs)
        jtr.step(4)
        ttr.step(4)
    for jp, tp in zip(jps, tps):
        onp.testing.assert_allclose(tp.detach().numpy(),
                                    jp.data().asnumpy(), atol=1e-6)


@pytest.mark.parametrize("steps", [1, 3])
def test_bf16_multi_precision_matches_jax(steps):
    ws = _weights(3)
    opt = OPTS["plain"]
    jps, jtr = _jax_side(ws, "bfloat16", opt)
    tps, ttr = _port_side(ws, "bfloat16", opt)
    rs = onp.random.RandomState(4)
    for _ in range(steps):
        gs = _grads(rs)
        _jax_backward(jps, gs, jnp.bfloat16)
        _port_backward(tps, gs)
        assert all(p.grad.dtype == torch.bfloat16 for p in tps)
        jtr.step(1)
        ttr.step(1)
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        jmaster = onp.asarray(jtr._states[i][0])
        tmaster = ttr._states[i][0]
        assert tmaster.dtype == torch.float32
        onp.testing.assert_allclose(tmaster.numpy(), jmaster, atol=1e-6)
        jw = onp.asarray(jp.data()._data.astype(jnp.float32))
        tw = tp.detach().float().numpy()
        ulp = onp.abs(jw) * 2.0 ** -7 + 1e-30
        assert onp.all(onp.abs(tw - jw) <= ulp), onp.abs(tw - jw).max()
        assert tp.dtype == torch.bfloat16


@pytest.mark.parametrize("keep", [False, True])
def test_keep_grads(keep):
    tps, ttr = _port_side(_weights(5), "float32", OPTS["plain"],
                          keep_grads=keep)
    _port_backward(tps, _grads(onp.random.RandomState(6)))
    ttr.step(1)
    assert all((p.grad is not None) == keep for p in tps)


def test_null_and_unreached_parameters():
    ws = _weights(7)
    tps, ttr = _port_side(ws, "float32", OPTS["plain"])
    tps[1].grad_req = "null"
    assert tps[1].grad_req == "null" and not tps[1].requires_grad
    gs = _grads(onp.random.RandomState(8))
    with autograd.record():
        loss = (tps[0] * torch.from_numpy(gs[0])).sum()
    loss.backward()
    ttr.step(1)
    # grad_req null: never updated; unreached: a zero-gradient step
    assert torch.equal(tps[1].detach(), torch.from_numpy(ws[1]))
    assert torch.equal(tps[2].detach(), torch.from_numpy(ws[2]))
    assert not torch.equal(tps[0].detach(), torch.from_numpy(ws[0]))


def test_write_overwrites_and_add_accumulates():
    from incubator_mxnet_tpu_torch.gluon.nn import Dense

    layer = Dense(2, 3, device="cpu").initialize()
    x = torch.ones(1, 3)
    for _ in range(2):
        with autograd.record():
            layer(x).sum().backward()
    torch.testing.assert_close(layer.weight.grad, torch.ones(2, 3))
    layer.collect_params().setattr("grad_req", "add")
    for _ in range(2):
        with autograd.record():
            layer(x).sum().backward()
    torch.testing.assert_close(layer.weight.grad, 3 * torch.ones(2, 3))


def test_write_replaces_per_backward():
    """Each backward writes the gradients it reaches, also twice in one
    record() scope; a parameter it does not reach keeps its own."""
    a, b = Parameter(torch.ones(3)), Parameter(torch.ones(2))
    with autograd.record():
        (2 * a).sum().backward()
        (3 * b).sum().backward()
        (5 * a).sum().backward()
    torch.testing.assert_close(a.grad, torch.full((3,), 5.0))
    torch.testing.assert_close(b.grad, torch.full((2,), 3.0))


def test_write_grads_of_two_models_on_two_threads():
    """Thread B's recorded forward and backward on its own model leave
    thread A's gradients alone between A's backward and A's step."""
    from incubator_mxnet_tpu_torch.gluon.nn import Dense

    models = [Dense(2, 3, device="cpu").initialize() for _ in range(2)]
    trainer_a = Trainer(models[0].collect_params(), "sgd",
                        {"learning_rate": 1.0})
    w_a = models[0].weight.detach().clone()
    x = torch.ones(1, 3)
    a_done, b_done = threading.Event(), threading.Event()
    errors = []

    def run_a():
        try:
            with autograd.record():
                models[0](x).sum().backward()
            a_done.set()
            assert b_done.wait(30)
            torch.testing.assert_close(models[0].weight.grad,
                                       torch.ones(2, 3))
            trainer_a.step(1)
        except BaseException as e:        # reported on the main thread
            errors.append(e)

    def run_b():
        try:
            assert a_done.wait(30)
            for _ in range(2):
                with autograd.record():
                    (2 * models[1](x)).sum().backward()
            b_done.set()
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (run_a, run_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    torch.testing.assert_close(models[0].weight.detach(),
                               w_a - torch.ones(2, 3))
    torch.testing.assert_close(models[1].weight.grad, 2 * torch.ones(2, 3))


@pytest.mark.parametrize("kw", [{"chain_steps": 2}, {"kvstore": "dist_sync"},
                                {"zero_stage": 1}])
def test_unported_trainer_options_raise(kw):
    with pytest.raises(MXNetError):
        Trainer([Parameter(torch.zeros(2))], "sgd", {}, **kw)


def test_optimizer_registry():
    assert isinstance(create("sgd", momentum=0.5), SGD)
    with pytest.raises(MXNetError):
        create("lamb")
