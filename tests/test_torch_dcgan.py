"""DCGAN in the PyTorch/CUDA port (`models.dcgan_nets`, the loop of
`examples/gluon/dc_gan.py`) against the JAX example's ``build_nets``
and loop, f32 on the CPU.

At ngf = ndf = 4, latent 8, batch 4: the weights carried by
structural name (``0.weight``, ``1.gamma``, ``1.running_mean``, ...),
both pairs of nets hybridized, two iterations of the example's loop
with the same z and the same real images injected as numpy arrays:
G's output outside ``record()`` (inference BatchNorm), D called twice
in one ``record()`` (real, then fake) and stepped by its own Adam
Trainer, then G's loss through D and G stepped by its own.  Both losses
of each iteration within 1e-5 relative; every weight of both nets and
the running statistics of every BatchNorm after two iterations within
1e-4·|ref| + 1e-5·max|ref| per element (Adam's first steps move each
weight by about the learning rate whatever the gradient's size, so a
gradient's roundings show in full there).
"""
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as onp
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.gluon import Trainer as JTrainer
from incubator_mxnet_tpu.gluon import loss as jloss
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.gluon import loss as tloss
from incubator_mxnet_tpu_torch.models import dcgan_nets

torch.set_num_threads(1)  # six xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NGF, NDF, LATENT, BATCH, ITERS = 4, 4, 8, 4, 2
ADAM = {"learning_rate": 2e-4, "beta1": 0.5}
LOSS_RTOL = 1e-5
WEIGHT_TOL = (1e-4, 1e-5)


def _example():
    spec = importlib.util.spec_from_file_location(
        "dc_gan", os.path.join(ROOT, "examples", "gluon", "dc_gan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches():
    rs = onp.random.RandomState(0)
    return [(onp.tanh(rs.randn(BATCH, 3, 32, 32)).astype(onp.float32),
             rs.randn(BATCH, LATENT, 1, 1).astype(onp.float32),
             rs.randn(BATCH, LATENT, 1, 1).astype(onp.float32))
            for _ in range(ITERS)]


def _params(net):
    return {k: onp.asarray(p.data()._data) for k, p in
            net._collect_params_with_prefix().items()}


def _close(got, ref, tol, what):
    got = got.detach().numpy()
    big = onp.abs(ref).max(initial=1e-30)
    err = onp.abs(got - ref)
    assert onp.all(err <= tol[0] * onp.abs(ref) + tol[1] * big), \
        (what, float(err.max()), float(big))


def test_dcgan_matches_jax_over_two_iterations():
    args = types.SimpleNamespace(ngf=NGF, ndf=NDF, latent=LATENT)
    jG, jD = _example().build_nets(args)
    jG.initialize(mx.init.Zero())
    jD.initialize(mx.init.Zero())
    jD(jG(NDArray(jnp.zeros((BATCH, LATENT, 1, 1), jnp.float32))))
    # the example's Normal(0.02) weights, drawn with numpy (the JAX
    # package's draws compile one program a shape: seconds here)
    rs = onp.random.RandomState(1)
    for net in (jG, jD):
        for name, p in net._collect_params_with_prefix().items():
            if name.endswith("weight"):
                p.set_data(NDArray(jnp.asarray(
                    (0.02 * rs.randn(*p.shape)).astype(onp.float32))))
    jG.hybridize()
    jD.hybridize()
    tG, tD = dcgan_nets(NGF, NDF, LATENT, device="cpu")
    init = [_params(jG), _params(jD)]
    for net, arrays in zip((tG, tD), init):
        assert sorted(n for n, _ in net.named_parameters()) == sorted(arrays)
        load_jax_params(net, arrays)
        net.hybridize()
    jloss_fn = jloss.SigmoidBinaryCrossEntropyLoss()
    tloss_fn = tloss.SigmoidBinaryCrossEntropyLoss()
    jtG = JTrainer(jG.collect_params(), "adam", dict(ADAM))
    jtD = JTrainer(jD.collect_params(), "adam", dict(ADAM))
    ttG = Trainer(tG.collect_params(), "adam", dict(ADAM))
    ttD = Trainer(tD.collect_params(), "adam", dict(ADAM))
    ones = onp.ones((BATCH, 1), onp.float32)
    zeros = onp.zeros((BATCH, 1), onp.float32)

    def J(a):
        return NDArray(jnp.asarray(a))

    T = torch.from_numpy
    for real, z1, z2 in _batches():
        fake = jG(J(z1)).detach()
        with jag.record():
            jlD = (jloss_fn(jD(J(real)), J(ones))
                   + jloss_fn(jD(fake), J(zeros))).mean()
        jlD.backward()
        jtD.step(1)
        with jag.record():
            jlG = jloss_fn(jD(jG(J(z2))), J(ones)).mean()
        jlG.backward()
        jtG.step(1)

        fake = tG(T(z1)).detach()
        with autograd.record():
            tlD = (tloss_fn(tD(T(real)), T(ones))
                   + tloss_fn(tD(fake), T(zeros))).mean()
        tlD.backward()
        ttD.step(1)
        with autograd.record():
            tlG = tloss_fn(tD(tG(T(z2))), T(ones)).mean()
        tlG.backward()
        ttG.step(1)
        for t, j in ((tlD, jlD), (tlG, jlG)):
            ref = float(j.asnumpy())
            assert abs(float(t.detach()) - ref) <= LOSS_RTOL * abs(ref), \
                (float(t.detach()), ref)
    for net, jnet, start in ((tG, jG, init[0]), (tD, jD, init[1])):
        want = _params(jnet)
        for name, p in net.named_parameters():
            _close(p, want[name], WEIGHT_TOL, name)
            if "running" in name or p.grad_req != "null":
                # every weight and running statistic moved
                assert not onp.array_equal(want[name], start[name]), name
