"""The vision model zoo's ResNets in the PyTorch/CUDA port
(`gluon.model_zoo.vision`) against the JAX package's, f32 on the CPU
(ResNet-50's names and shapes and ``get_model``'s routing:
`test_torch_resnet_zoo.py`).

Two small nets with weights (and running stats) from a numpy seed,
carried by `convert.load_jax_params`: chip_smoke.py's bottleneck v1
``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
classes=600)`` (the loss takes the streamed cross-entropy's plain
version) and a basic-block v2 ``ResNetV2(BasicBlockV2, [1, 1, 1, 1],
[8, 8, 16, 32, 64], classes=10)`` (the log-softmax loss), B=2 at 64x64,
so that the last stage's BatchNorms still see 2x2 positions (at 32x32
they normalize two values a channel, and the gradient through their
variance is ill-conditioned):

* the train-mode logits, the per-sample loss and every gradient of its
  sum against `jax.value_and_grad` of the JAX net's pure function
  (`functionalize`), each element within 1e-4·|ref| + 1e-4·max|ref|
  with max|ref| taken over the layer's gradients (`_by_layer`; why
  1e-4 at `GRAD_TOL`), and the running stats that forward writes;
* three hybridized steps with the fused SGD Trainer (momentum 0.9, wd
  1e-4) against the JAX package's hybridized fused step from the same
  weights: losses, weights, momenta and running stats;
* hybridized against never hybridized, bit for bit over three steps.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.gluon import Trainer as JTrainer
from incubator_mxnet_tpu.gluon.block import functionalize
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

# rtol·|ref| + atol·(the layer's max|ref|), f32.  The atol is 1e-4, not
# 1e-5: the JAX package's BatchNorm statistics are f32 sums whose E[x²]
# - mean² cancels, so its own jitted gradients differ from an f64
# evaluation of the same net by up to 1.6e-4 of a tensor's max here
# (the port's by up to 4e-5)
GRAD_TOL = (1e-4, 1e-4)
# lr 0.005, not train.py's 0.05: at 0.05 these tiny nets (B=2, random
# labels) move their stem weights by 0.15 a step and the f32 noise of
# one step grows 1000-fold over the next two, so that the JAX package's
# own hybridized and eager steps differ by 1.4e-2 of a tensor's max after
# three (v1); at 0.005 they agree within 1e-5
SGD = {"learning_rate": 0.005, "momentum": 0.9, "wd": 1e-4}
B, HW = 2, 64
SMALL = {
    "v1": ("ResNetV1", "BottleneckV1", [1, 1, 1, 1], [8, 16, 32, 64, 128],
           600),
    "v2": ("ResNetV2", "BasicBlockV2", [1, 1, 1, 1], [8, 8, 16, 32, 64],
           10),
}


def _within(got, ref, tol, what):
    ref = onp.asarray(ref)
    allow = tol[0] * onp.abs(ref) + tol[1] * onp.abs(ref).max()
    err = onp.abs(got - ref)
    assert onp.all(err <= allow), (what, float(err.max()),
                                   float(onp.abs(ref).max()))


def _by_layer(got, ref, tol, what):
    """`_within` for dicts of tensors by structural name, the atol term
    relative to the largest |ref| of the tensor's layer (its name less
    the last part: a convolution's weight and bias, a BatchNorm's gamma
    and beta).  A layer's gradients sum the same terms (the gradient at
    the layer's output positions): a beta or bias gradient is their
    plain sum, which cancels down to rounding noise -- exactly 0 for a
    convolution bias that feeds a train-mode BatchNorm, whose batch
    mean removes it -- while the gamma or weight gradient weights them,
    so the rounding error of each scales with the layer's largest
    gradient, not with its own."""
    scale = {}
    for k, r in ref.items():
        layer = k.rsplit(".", 1)[0]
        scale[layer] = max(scale.get(layer, 0.0), float(onp.abs(r).max()))
    for k, r in ref.items():
        r = onp.asarray(r)
        allow = tol[0] * onp.abs(r) + tol[1] * scale[k.rsplit(".", 1)[0]]
        err = onp.abs(got[k] - r)
        assert onp.all(err <= allow), (what, k, float(err.max()),
                                       float(onp.abs(r).max()))


# ----------------------------------------------------------- small nets
def _new_port_net(kind):
    net_cls, block, layers, channels, classes = SMALL[kind]
    return getattr(vision, net_cls)(getattr(vision, block), layers,
                                    channels, classes=classes, device="cpu")


def _pair(kind, seed):
    """The small net of ``kind`` in both packages with the same weights
    from ``seed`` (He-scaled convolution and dense weights, gammas near
    1, small betas and biases, running means near 0 and variances near
    1), returned with the arrays by structural name.  The JAX net takes
    its shapes from these arrays (``set_data`` on its deferred
    parameters) instead of a first forward, whose per-op compiles would
    take most of this file's time; its forward then checks them."""
    tnet = _new_port_net(kind)
    rs = onp.random.RandomState(seed)
    arrays = {}
    for k, p in tnet.named_parameters():
        shape = tuple(p.shape)
        if k.endswith("running_var"):
            a = 1.0 + 0.2 * onp.abs(rs.randn(*shape))
        elif k.endswith("gamma"):
            a = 1.0 + 0.1 * rs.randn(*shape)
        elif k.endswith(("beta", "bias", "running_mean")):
            a = 0.1 * rs.randn(*shape)
        else:
            a = rs.randn(*shape) * onp.sqrt(2.0 / onp.prod(shape[1:]))
        arrays[k] = a.astype(onp.float32)
    net_cls, block, layers, channels, classes = SMALL[kind]
    jnet = getattr(jvision, net_cls)(getattr(jvision.resnet, block), layers,
                                     channels, classes=classes)
    jparams = jnet._collect_params_with_prefix()
    assert list(jparams) == list(arrays)
    for k, p in jparams.items():
        p.set_data(jnp.asarray(arrays[k]))
    return jnet, load_jax_params(tnet, arrays), arrays


def _batch(kind, seed):
    rs = onp.random.RandomState(seed)
    return (rs.randn(B, 3, HW, HW).astype(onp.float32),
            rs.randint(0, SMALL[kind][4], (B,)).astype(onp.int32))


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_small_resnet_gradients_match_jax(kind):
    """Train mode, one forward and backward: logits, per-sample loss,
    every gradient (ResNet v1 bottleneck: its 1x1 biases too) and the
    running stats the forward wrote, against the JAX net's pure
    function under `jax.value_and_grad`."""
    jnet, tnet, _ = _pair(kind, 11)
    x, y = _batch(kind, 12)
    apply_fn, train, aux = functionalize(jnet)
    names = {id(p): k for k, p in jnet._collect_params_with_prefix().items()}

    def loss_fn(train_raws):
        logits, new_aux = apply_fn(train_raws, aux, jax.random.PRNGKey(0),
                                   jnp.asarray(x), training=True)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], -1)[:, 0]
        return nll.sum(), (logits, nll, new_aux)

    (_, (jlogits, jnll, jaux)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(train)
    with autograd.record():
        logits = tnet(torch.from_numpy(x))
        loss = SoftmaxCrossEntropyLoss()(logits, torch.from_numpy(y))
    autograd.backward(loss)
    _within(logits.detach().numpy(), jlogits, (1e-5, 1e-5), "logits")
    _within(loss.detach().numpy(), jnll, (1e-5, 1e-6), "loss")
    params = dict(tnet.named_parameters())
    assert len(jgrads) == sum(p.requires_grad for p in params.values())
    ref = {names[id(p)]: g for p, g in zip(apply_fn.trainable_params, jgrads)}
    _by_layer({k: params[k].grad.numpy() for k in ref}, ref, GRAD_TOL,
              "gradient")
    for p, a in zip(apply_fn.aux_params, jaux):
        name = names[id(p)]
        _within(params[name].detach().numpy(), a, (1e-5, 1e-5), name)


def _port_steps(net, kind, hybrid, steps=3):
    if hybrid:
        net.hybridize()
    tr = Trainer(net.collect_params(), "sgd", dict(SGD), keep_grads=False)
    loss_fn = SoftmaxCrossEntropyLoss()
    losses = []
    for s in range(steps):
        x, y = _batch(kind, 20 + s)
        with autograd.record():
            loss = loss_fn(net(torch.from_numpy(x)), torch.from_numpy(y))
        autograd.backward(loss)
        tr.step(B)
        losses.append(loss.detach().clone())
    return tr, losses


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_small_resnet_sgd_steps_match_jax(kind):
    """Three hybridized steps, ``loss_fn(net(x), y)`` then
    ``backward()`` then ``Trainer.step(B)``, SGD with momentum and weight
    decay (every trainable parameter decays, BatchNorm's and the biases
    too): the port's recorded programs and fused update against the JAX
    package's hybridized fused step from the same weights (the rate:
    `SGD`).  Each per-sample loss within 1e-5 relative, then every
    weight, momentum and running stat within `GRAD_TOL` of its
    layer."""
    jnet, tnet, _ = _pair(kind, 13)
    jnet.hybridize()
    jtr = JTrainer(jnet.collect_params(), "sgd", dict(SGD), keep_grads=False)
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    jlosses = []
    for s in range(3):
        x, y = _batch(kind, 20 + s)
        with jag.record():
            jl = jloss_fn(jnet(NDArray(jnp.asarray(x))),
                          NDArray(jnp.asarray(y)))
        jl.backward()
        jtr.step(B)
        jlosses.append(jl.asnumpy())
    assert jtr._fullstep_ctx is not None, "the JAX step was not fused"
    ttr, tlosses = _port_steps(tnet, kind, hybrid=True)
    assert ttr._updates is not None, "the update did not read the buffers"
    for tl, jl in zip(tlosses, jlosses):
        _within(tl.numpy(), jl, (1e-5, 0.0), "loss")
    jw = {k: p.data().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    _by_layer({k: p.detach().numpy() for k, p in tnet.named_parameters()},
              jw, GRAD_TOL, "weight")
    jtr._sync_states()
    names = {id(p): k for k, p in jnet._collect_params_with_prefix().items()}
    jmom = {names[id(p)]: onp.asarray(jtr._states[i])
            for i, p in enumerate(jtr._params) if i in jtr._states}
    tmom = {k: ttr._states[i].numpy()
            for i, k in enumerate(tnet.collect_params()) if i in ttr._states}
    assert jmom.keys() == tmom.keys() and jmom
    _by_layer(tmom, jmom, GRAD_TOL, "momentum")


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_small_resnet_hybridized_equals_never_hybridized(kind):
    """The recorded programs and the fused update against the block never
    hybridized with the eager rule: the same losses, weights, momenta
    and running stats, bit for bit, after three steps."""
    _, _, arrays = _pair(kind, 14)
    runs = []
    for hybrid in (True, False):
        net = load_jax_params(_new_port_net(kind), arrays)
        tr, losses = _port_steps(net, kind, hybrid)
        runs.append((losses, {k: p.detach().clone()
                              for k, p in net.named_parameters()},
                     [s.clone() for s in tr._states.values()]))
    (l0, w0, s0), (l1, w1, s1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert w0.keys() == w1.keys()
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    assert len(s0) == len(s1) and all(torch.equal(a, b)
                                      for a, b in zip(s0, s1))
    stats = [k for k in w0 if k.endswith(("running_mean", "running_var"))]
    assert stats and all(not torch.equal(w0[k], torch.from_numpy(arrays[k]))
                         for k in stats)
