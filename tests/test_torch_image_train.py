"""`examples/image_classification/train.py`'s loop in the PyTorch/CUDA
port against the JAX package's, on the CPU: a .rec of JPEG class
templates plus noise, `ImageRecordIter(shuffle, rand_mirror, mean/std,
device_normalize=True)` (the port's behind
`PrefetchingIter(prefetch_to_device=True)`), `wrap_net` around a small
ResNet v1 (bottleneck blocks, [1, 1, 1, 1] layers, widths 8-128, 10
classes) with the same weights (`convert.load_jax_params`), hybridized,
SGD with momentum and weight decay through the Trainer, `Accuracy` and
the `Speedometer`: three steps of B=4 at 64x64.  Each per-sample loss
within 1e-5 relative, then every weight, running stat and momentum
within 1e-4·|ref| + 1e-4·(the layer's max|ref|), the tolerance and rate
of tests/test_torch_resnet.py (which says why).
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import callback as jcb
from incubator_mxnet_tpu import metric as jmetric
from incubator_mxnet_tpu import recordio as jrio
from incubator_mxnet_tpu.gluon import Trainer as JTrainer
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu_torch import autograd, callback, io, metric
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

B, HW, CLASSES, STEPS = 4, 64, 10, 3
NET = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
SGD = {"learning_rate": 0.005, "momentum": 0.9, "wd": 1e-4}
TOL = (1e-4, 1e-4)
ITER = dict(shuffle=True, rand_mirror=True, mean_r=123.68, mean_g=116.78,
            mean_b=103.94, std_r=58.4, std_g=57.1, std_b=57.4,
            device_normalize=True, preprocess_threads=2)


def _rec(path, n=B * STEPS):
    """train.py's `make_synthetic_rec` at this size."""
    rng = onp.random.RandomState(7)
    templates = rng.randint(0, 255, (CLASSES, HW, HW, 3), dtype=onp.uint8)
    order = onp.random.RandomState(1).randint(0, CLASSES, n)
    w = jrio.MXRecordIO(path, "w")
    for i, cls in enumerate(order):
        noise = rng.randint(-20, 20, templates[cls].shape).astype(onp.int16)
        img = onp.clip(templates[cls].astype(onp.int16) + noise, 0,
                       255).astype(onp.uint8)
        w.write(jrio.pack_img(jrio.IRHeader(0, float(cls), i, 0), img,
                              quality=90))
    w.close()
    return path


def _arrays(tnet, seed=13):
    rs = onp.random.RandomState(seed)
    out = {}
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
        out[k] = a.astype(onp.float32)
    return out


def _by_layer(got, ref, what):
    scale = {}
    for k, r in ref.items():
        layer = k.rsplit(".", 1)[0]
        scale[layer] = max(scale.get(layer, 0.0), float(onp.abs(r).max()))
    for k, r in ref.items():
        allow = TOL[0] * onp.abs(r) + TOL[1] * scale[k.rsplit(".", 1)[0]]
        err = onp.abs(got[k] - r)
        assert onp.all(err <= allow), (what, k, float(err.max()))


def _jax_loop(path, arrays):
    body = jvision.ResNetV1(jvision.resnet.BottleneckV1, *NET,
                            classes=CLASSES)
    params = body._collect_params_with_prefix()
    for k, p in params.items():
        p.set_data(jnp.asarray(arrays[k]))
    it = mx.io.ImageRecordIter(path, (3, HW, HW), B, **ITER)
    net = it.wrap_net(body, "float32")
    net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tr = JTrainer(net.collect_params(), "sgd", dict(SGD), keep_grads=False)
    acc, speed = jmetric.Accuracy(), jcb.Speedometer(B, 2)
    losses = []
    for nbatch, batch in enumerate(it):
        with jag.record():
            out = net(batch.data[0])
            L = loss_fn(out, batch.label[0])
        L.backward()
        tr.step(B)
        acc.update([batch.label[0]], [out])
        speed(jcb.BatchEndParam(0, nbatch, acc, None))
        losses.append(L.asnumpy())
    tr._sync_states()
    names = {id(p): k for k, p in params.items()}
    moms = {names[id(p)]: onp.asarray(tr._states[i])
            for i, p in enumerate(tr._params) if i in tr._states}
    weights = {k: p.data().asnumpy() for k, p in params.items()}
    return losses, weights, moms, acc.get_global()[1]


def _port_loop(path, arrays):
    body = load_jax_params(vision.ResNetV1(vision.BottleneckV1, *NET,
                                           classes=CLASSES, device="cpu"),
                           arrays)
    it = io.ImageRecordIter(path, (3, HW, HW), B, device="cpu", **ITER)
    assert it.decoder == "libjpeg"
    feed = io.PrefetchingIter(it, prefetch_to_device=True, device="cpu")
    net = it.wrap_net(body, "float32")
    net.hybridize()
    loss_fn = SoftmaxCrossEntropyLoss()
    tr = Trainer(net.collect_params(), "sgd", dict(SGD), keep_grads=False)
    acc, speed = metric.Accuracy(), callback.Speedometer(B, 2)
    losses = []
    for nbatch, batch in enumerate(feed):
        x, y = batch.data[0], batch.label[0]
        assert x.dtype == torch.uint8 and x.shape == (B, 3, HW, HW)
        with autograd.record():
            out = net(x)
            L = loss_fn(out, y)
        autograd.backward(L)
        tr.step(B)
        acc.update([y], [out])
        speed(callback.BatchEndParam(0, nbatch, acc, None))
        losses.append(L.detach().numpy().copy())
    feed.close()
    assert tr._updates is not None, "the update did not read the buffers"
    names = list(body.collect_params())
    moms = {names[i]: s.numpy() for i, s in tr._states.items()}
    weights = {k: p.detach().numpy() for k, p in body.named_parameters()}
    return losses, weights, moms, acc.get_global()[1]


def test_train_py_loop_matches_jax(tmp_path):
    path = _rec(str(tmp_path / "train.rec"))
    arrays = _arrays(vision.ResNetV1(vision.BottleneckV1, *NET,
                                     classes=CLASSES, device="cpu"))
    jl, jw, jm, jacc = _jax_loop(path, arrays)
    tl, tw, tm, tacc = _port_loop(path, arrays)
    assert len(jl) == len(tl) == STEPS
    for a, b in zip(tl, jl):
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    assert tw.keys() == jw.keys()
    _by_layer(tw, jw, "weight")
    assert tm.keys() == jm.keys() and tm
    _by_layer(tm, jm, "momentum")
    assert 0.0 <= tacc == pytest.approx(jacc, abs=1e-12)
    moved = [k for k in tw if k.endswith("running_mean")]
    assert moved and all(not onp.array_equal(tw[k], arrays[k])
                         for k in moved)
