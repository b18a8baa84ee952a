"""The convolution, pooling and BatchNorm ops and layers of the
PyTorch/CUDA port (`ndarray.nn_ops`, `gluon.nn.conv_layers`,
`gluon.nn.basic_layers`, `gluon.nn.activations`) against the JAX
package's, on the same numpy inputs from a seed, f32 on the CPU.

Forward values within rtol 1e-5 of |ref| + 1e-5 of max|ref|; gradients
(`jax.vjp` of the JAX op against torch's autograd, one cotangent drawn
from the seed) within 1e-4·|ref| + 1e-5·max|ref| per element.  Then the
running statistics' convention (m·old + (1-m)·batch with the biased
variance, at a batch small enough that n and n-1 differ), their writes
inside the hybridized programs (once per call or replay; read only in
predict mode), ``cast``, the containers' structural names and
``Dense(flatten=True)``.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch
import torch.nn.functional as F

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.ndarray import nn_ops as jops
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import MXNetError, autograd, nd
from incubator_mxnet_tpu_torch import random as mxr
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import nn

FWD_TOL = (1e-5, 1e-5)
GRAD_TOL = (1e-4, 1e-5)


def _close(got, ref, tol, what):
    """Elementwise within tol[0]·|ref| + tol[1]·max|ref| (the finite
    entries' max); equal entries (-inf of a window wholly in padding)
    match."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = onp.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    big = onp.abs(ref[onp.isfinite(ref)]).max(initial=1e-30)
    allow = tol[0] * onp.abs(ref) + tol[1] * big
    err = onp.where(got == ref, 0.0, onp.abs(got - ref))
    assert onp.all(err <= allow), (what, float(err.max()),
                                   float(onp.abs(ref).max()))


def _vjp_pair(jfn, tfn, arrays, seed):
    """Forward and every input gradient of ``jfn`` (JAX arrays in, one
    JAX array out) and ``tfn`` (tensors in) on ``arrays``, with one
    cotangent from ``seed``."""
    args = [jnp.asarray(a) for a in arrays]
    shape = jax.eval_shape(jfn, *args).shape
    ct = onp.random.RandomState(seed).randn(*shape).astype(onp.float32)
    # one compiled program (op-by-op dispatch compiles every primitive)
    out, jgrads = jax.jit(lambda *a: (jfn(*a), jax.vjp(jfn, *a)[1](
        jnp.asarray(ct))))(*args)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = tfn(*ts)
    tout.backward(torch.from_numpy(ct))
    _close(tout, out, FWD_TOL, "forward")
    for i, (t, g) in enumerate(zip(ts, jgrads)):
        _close(t.grad, g, GRAD_TOL, f"gradient of input {i}")


def _randn(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(onp.float32)


# --------------------------------------------------------------- the ops
CONV_CASES = [
    # (x shape, w shape, bias, kwargs)
    ((2, 4, 11), (6, 4, 3), True, dict(stride=2, pad=1, dilate=2)),
    ((2, 4, 9, 8), (6, 2, 3, 3), True,
     dict(stride=(2, 1), pad=(1, 1), dilate=(1, 2), num_group=2)),
    ((2, 3, 16, 16), (8, 3, 7, 7), False, dict(stride=2, pad=3)),
    ((2, 6, 7, 7), (6, 1, 3, 3), True, dict(pad=1, num_group=6)),
    ((2, 4, 5, 6, 5), (4, 2, 3, 1, 3), True,
     dict(stride=(1, 2, 1), pad=(1, 0, 1), num_group=2)),
]


@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_convolution_matches_jax(case):
    """`nd.Convolution` (1-, 2- and 3-D; stride, padding, dilation,
    groups, depthwise, the 7x7 stride-2 stem) against the JAX op:
    output and the gradients of input, weight and bias."""
    xs, ws, bias, kw = CONV_CASES[case]
    rs = onp.random.RandomState(case)
    arrays = [_randn(rs, *xs), _randn(rs, *ws, scale=0.3)]
    if bias:
        arrays.append(_randn(rs, ws[0]))
    kernel = ws[2:]

    def jfn(x, w, *b):
        return jops.Convolution(NDArray(x), NDArray(w),
                                NDArray(b[0]) if b else None, kernel=kernel,
                                no_bias=not b, **kw)._data

    def tfn(x, w, *b):
        return nd.Convolution(x, w, b[0] if b else None, kernel=kernel,
                              no_bias=not b, **kw)

    _vjp_pair(jfn, tfn, arrays, 100 + case)


POOL_CASES = [
    # (x shape, kwargs)
    ((2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    ((2, 3, 8, 7), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="avg")),
    ((2, 3, 8, 7), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="avg", count_include_pad=False)),
    ((2, 3, 6, 7), dict(kernel=(3, 3), stride=(2, 2),
                        pooling_convention="full")),
    ((2, 3, 5, 5), dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1),
                        pooling_convention="full")),
    ((2, 3, 6, 7), dict(kernel=(3, 2), stride=(2, 2), pad=(1, 0),
                        pool_type="avg", pooling_convention="full")),
    ((2, 3, 6, 7), dict(kernel=(3, 2), stride=(2, 2), pad=(1, 0),
                        pool_type="avg", pooling_convention="full",
                        count_include_pad=False)),
    ((2, 3, 7, 6), dict(kernel=(3, 3), stride=(1, 2), pad=(1, 1),
                        pool_type="sum")),
    ((2, 3, 7, 7), dict(kernel=(3, 3), stride=(2, 2), pad=(2, 2))),
    ((2, 3, 11), dict(kernel=(3,), stride=(2,), pooling_convention="full")),
    ((2, 3, 11), dict(kernel=(3,), stride=(2,), pad=(1,), pool_type="avg",
                      pooling_convention="full", count_include_pad=False)),
    ((2, 3, 5, 6, 5), dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                           pool_type="avg")),
    ((2, 3, 5, 6, 5), dict(kernel=(3, 3, 3), stride=(2, 2, 2),
                           pad=(1, 1, 1))),
    ((2, 3, 5, 6), dict(global_pool=True)),
    ((2, 3, 5, 6), dict(global_pool=True, pool_type="avg")),
    ((2, 3, 5, 6, 4), dict(global_pool=True, pool_type="sum")),
]


@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pooling_matches_jax(case):
    """`nd.Pooling`: max, avg and sum in 1-, 2- and 3-D, valid and
    ``"full"`` (ceil, partial windows counted), padding above half the
    window, ``count_include_pad`` on and off, global pooling: output
    and input gradient against the JAX op's ``lax.reduce_window``."""
    xs, kw = POOL_CASES[case]
    x = _randn(onp.random.RandomState(case), *xs)
    _vjp_pair(lambda a: jops.Pooling(NDArray(a), **kw)._data,
              lambda a: nd.Pooling(a, **kw), [x], 200 + case)


def _bn_arrays(rs, shape, axis=1):
    C = shape[axis]
    return [_randn(rs, *shape, scale=2.0) + 0.5,
            1.0 + _randn(rs, C, scale=0.2), _randn(rs, C, scale=0.2),
            _randn(rs, C, scale=0.3), 1.0 + onp.abs(_randn(rs, C))]


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("shape,axis", [((4, 3, 5, 6), 1), ((6, 5), 1),
                                        ((2, 4, 3, 5), 3), ((2, 3, 4, 5), 2)])
def test_batch_norm_matches_jax(shape, axis, training):
    """`nd.BatchNorm` in train mode (batch statistics) and predict mode
    (the running ones): output, the gradients of x, gamma and beta, and
    the new running stats (equal to the old ones in predict mode)."""
    rs = onp.random.RandomState(len(shape) + axis)
    x, g, b, mm, mv = _bn_arrays(rs, shape, axis)
    kw = dict(axis=axis, training=training, momentum=0.9, eps=1e-5)

    def jfn(x_, g_, b_):
        return jops.BatchNorm(NDArray(x_), NDArray(g_), NDArray(b_),
                              NDArray(jnp.asarray(mm)),
                              NDArray(jnp.asarray(mv)), **kw)[0]._data

    def tfn(x_, g_, b_):
        return nd.BatchNorm(x_, g_, b_, torch.from_numpy(mm),
                            torch.from_numpy(mv), **kw)[0]

    _vjp_pair(jfn, tfn, [x, g, b], 300 + axis)
    _, jm, jv = jops.BatchNorm(*[NDArray(jnp.asarray(a))
                                 for a in (x, g, b, mm, mv)], **kw)
    _, tm, tv = nd.BatchNorm(*[torch.from_numpy(a) for a in (x, g, b, mm, mv)],
                             **kw)
    _close(tm, jm._data, FWD_TOL, "new running mean")
    _close(tv, jv._data, FWD_TOL, "new running var")
    if not training:
        assert onp.array_equal(tm.numpy(), mm)


def test_running_stats_take_mxnet_convention():
    """At n = B·H·W = 4 a channel's biased variance is 3/4 of the
    unbiased one: the layer's running variance after one train-mode
    forward is 0.9·1 + 0.1·biased (the JAX package's, and MXNet's),
    not torch's ``F.batch_norm`` update (momentum 0.1 of the new value,
    unbiased variance)."""
    rs = onp.random.RandomState(7)
    x = _randn(rs, 2, 3, 1, 2, scale=3.0)
    layer = nn.BatchNorm(in_channels=3, device="cpu").initialize()
    jlayer = jnn.BatchNorm(in_channels=3)
    jlayer.initialize()
    with autograd.train_mode():
        layer(torch.from_numpy(x))
    with mx.autograd.train_mode():
        jlayer(NDArray(jnp.asarray(x)))
    biased = x.transpose(1, 0, 2, 3).reshape(3, -1).var(1)
    unbiased = x.transpose(1, 0, 2, 3).reshape(3, -1).var(1, ddof=1)
    want = 0.9 * 1.0 + 0.1 * biased
    _close(layer.running_var, jlayer.running_var.data().asnumpy(), FWD_TOL,
           "running var against the JAX layer")
    _close(layer.running_var, want, FWD_TOL, "running var")
    _close(layer.running_mean, 0.1 * x.mean((0, 2, 3)), FWD_TOL,
           "running mean")
    assert not onp.allclose(layer.running_var.numpy(),
                            0.9 + 0.1 * unbiased, rtol=1e-3)
    rm, rv = torch.zeros(3), torch.ones(3)
    F.batch_norm(torch.from_numpy(x), rm, rv, training=True, momentum=0.1)
    assert not torch.allclose(layer.running_var, rv, rtol=1e-3)


@pytest.mark.parametrize("act", sorted(jops._ACTS))
def test_activation_matches_jax(act):
    """Every ``act_type`` of the JAX package's `Activation`, forward and
    gradient; an unknown one raises `MXNetError`."""
    x = _randn(onp.random.RandomState(1), 3, 17, scale=3.0)
    _vjp_pair(lambda a: jops.Activation(NDArray(a), act)._data,
              lambda a: nd.Activation(a, act), [x], 400)
    with pytest.raises(MXNetError):
        nd.Activation(torch.from_numpy(x), "nope")


# ------------------------------------------------------------ the layers
def _jax_stack():
    net = jnn.HybridSequential()
    net.add(jnn.Conv2D(6, 3, padding=1, in_channels=3),
            jnn.BatchNorm(in_channels=6), jnn.Activation("relu"),
            jnn.MaxPool2D(3, 2, 1),
            jnn.Conv2D(8, (3, 1), strides=(1, 2), groups=2, dilation=(2, 1),
                       use_bias=False, in_channels=6),
            jnn.BatchNorm(in_channels=8, scale=False, center=False),
            jnn.AvgPool2D(2, ceil_mode=True, count_include_pad=False),
            jnn.GlobalAvgPool2D(), jnn.Dense(5, in_units=8))
    return net


def _port_stack(**kw):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(6, 3, padding=1, in_channels=3, **kw),
            nn.BatchNorm(in_channels=6, **kw), nn.Activation("relu"),
            nn.MaxPool2D(3, 2, 1),
            nn.Conv2D(8, (3, 1), strides=(1, 2), groups=2, dilation=(2, 1),
                      use_bias=False, in_channels=6, **kw),
            nn.BatchNorm(in_channels=8, scale=False, center=False, **kw),
            nn.AvgPool2D(2, ceil_mode=True, count_include_pad=False),
            nn.GlobalAvgPool2D(), nn.Dense(5, in_units=8, **kw))
    return net


def _stack_pair(seed=0):
    mx.random.seed(seed)
    jnet = _jax_stack()
    jnet.initialize()
    arrays = {}
    rs = onp.random.RandomState(seed)
    for k, p in jnet._collect_params_with_prefix().items():
        a = p.data().asnumpy()
        if k.endswith("running_mean"):
            a = _randn(rs, *a.shape, scale=0.2)
        elif k.endswith("running_var"):
            a = 1.0 + onp.abs(_randn(rs, *a.shape, scale=0.2))
        p.set_data(jnp.asarray(a))
        arrays[k] = a
    return jnet, load_jax_params(_port_stack(device="cpu"), arrays)


@pytest.mark.parametrize("hybrid", [False, True])
def test_layers_match_jax(hybrid):
    """A HybridSequential of Conv2D (bias; grouped, dilated, strided, no
    bias), BatchNorm (and one with scale and center off), Activation,
    MaxPool2D, AvgPool2D (ceil, padding not counted), GlobalAvgPool2D and
    Dense (flattening its (N, C, 1, 1) input): the same structural names
    as the JAX layers', weights carried by `load_jax_params`; predict
    mode, then two train-mode forwards (the running stats written in
    place, as the JAX layers rebind theirs), then predict mode on the new
    stats: outputs and running stats; hybridized (programs on the CPU)
    and not."""
    jnet, tnet = _stack_pair()
    assert list(dict(tnet.named_parameters())) \
        == list(jnet._collect_params_with_prefix())
    if hybrid:
        tnet.hybridize()
    rs = onp.random.RandomState(3)
    for mode in ("predict", "train", "train", "predict"):
        x = _randn(rs, 2, 3, 10, 9)
        if mode == "train":
            with mx.autograd.train_mode():
                jout = jnet(NDArray(jnp.asarray(x)))
            with autograd.train_mode():
                tout = tnet(torch.from_numpy(x))
        else:
            jout = jnet(NDArray(jnp.asarray(x)))
            tout = tnet(torch.from_numpy(x))
        _close(tout, jout.asnumpy(), FWD_TOL, f"{mode} output")
    jstats = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    for k, p in tnet.named_parameters():
        _close(p, jstats[k], FWD_TOL, k)


def _bn_block(hybrid):
    mxr.seed(0, device="cpu")
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, in_channels=2, device="cpu"),
            nn.BatchNorm(in_channels=4, device="cpu"))
    net.initialize()
    if hybrid:
        net.hybridize()
    return net


def _stats(net):
    return [net[1].running_mean.detach().clone(),
            net[1].running_var.detach().clone()]


def test_batch_norm_writes_inside_programs():
    """Hybridized, the running stats are written by the programs' bodies:
    an inference program called in train mode moves them once a call,
    the same as the block never hybridized; in predict mode it only
    reads them; a recorded call (``record()``) moves them once; a second
    recorded call before the first one's backward (its own programs)
    moves the same parameters again."""
    x = [torch.from_numpy(_randn(onp.random.RandomState(s), 3, 2, 6, 6))
         for s in range(3)]
    runs = []
    for hybrid in (False, True):
        net = _bn_block(hybrid)
        seen = [_stats(net)]
        with autograd.train_mode():
            net(x[0])
        seen.append(_stats(net))
        net(x[1])                               # predict mode
        seen.append(_stats(net))
        with autograd.record():
            a = net(x[1])
        seen.append(_stats(net))
        with autograd.record():
            b = net(x[2])
            (a.sum() + b.sum()).backward()
        seen.append(_stats(net))
        runs.append(seen)
        if hybrid:
            recs = [v for k, v in net._graph_cache.items() if "record" in k]
            assert len(recs) == 1 and len(recs[0]) == 2
            assert recs[0][0].fwd.pool is not recs[0][1].fwd.pool
    plain, hyb = runs
    for s0, s1 in zip(plain, hyb):
        assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    for i in (0, 2, 3):
        assert not torch.equal(plain[i][1], plain[i + 1][1])
    assert all(torch.equal(a, b) for a, b in zip(plain[1], plain[2]))


def test_cast_carries_running_stats():
    """``cast("bfloat16")`` casts the running stats with the weights (as
    the JAX package's cast does); a train-mode forward in bf16 writes
    them in bf16, the factors 0.9 and 0.1 taken in bf16 (the JAX
    package's weakly-typed Python floats)."""
    net = _bn_block(False)
    net.cast("bfloat16")
    bn = net[1]
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.bfloat16
    x = torch.from_numpy(_randn(onp.random.RandomState(0), 3, 2, 6, 6))
    with autograd.train_mode():
        out = net(x.bfloat16())
    assert out.dtype == torch.bfloat16
    h = net[0](x.bfloat16()).reshape(3, 4, -1)
    mean32 = h.sum(2, dtype=torch.float32).sum(0) / h[:, 0].numel()
    m = torch.tensor(0.9, dtype=torch.bfloat16)
    want = torch.zeros(4, dtype=torch.bfloat16) * m \
        + mean32.bfloat16() * torch.tensor(1 - 0.9, dtype=torch.bfloat16)
    assert bn.running_mean.dtype == torch.bfloat16
    torch.testing.assert_close(bn.running_mean, want, rtol=0, atol=0)


def test_initialize_fills_running_stats():
    """The name rules of the JAX initializer: running means 0, running
    variances 1, gammas 1, betas and biases 0."""
    net = _bn_block(False)
    bn = net[1]
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert torch.equal(bn.running_var, torch.ones(4))
    assert torch.equal(bn.gamma, torch.ones(4))
    assert torch.equal(net[0].bias, torch.zeros(4))
    assert bn.running_mean.grad_req == bn.running_var.grad_req == "null"


def test_containers_and_dense_flatten():
    """Sequential children are named "0", "1", ...; indexing, slicing,
    len; `Dense` flattens by default and takes the last axis with
    ``flatten=False``; `Flatten`; layers refuse a missing input width
    or a channels-last layout."""
    seq = nn.Sequential()
    seq.add(nn.Dense(4, 12, device="cpu"), nn.Activation("tanh"))
    assert [n for n, _ in seq.named_children()] == ["0", "1"]
    assert len(seq) == 2 and isinstance(seq[1], nn.Activation)
    assert len(seq[:1]) == 1 and seq[:1][0] is seq[0]
    seq.initialize()
    x = torch.randn(2, 3, 2, 2)
    torch.testing.assert_close(seq(x), torch.tanh(
        x.reshape(2, 12) @ seq[0].weight.T + seq[0].bias))
    d = nn.Dense(4, 12, flatten=False, device="cpu").initialize()
    assert d(torch.randn(2, 5, 12)).shape == (2, 5, 4)
    assert nn.Flatten()(x).shape == (2, 12)
    with pytest.raises(MXNetError):
        nn.Conv2D(4, 3)
    with pytest.raises(MXNetError):
        nn.BatchNorm()
    with pytest.raises(MXNetError):
        nn.Conv2D(4, 3, layout="NHWC", in_channels=3)


def test_backward_of_a_per_sample_loss_takes_ones():
    """`autograd.backward` of a non-scalar head without head gradients
    takes ones, as the JAX package's does."""
    w = torch.randn(3, requires_grad=True)
    with autograd.record():
        loss = w * torch.arange(3.0)
    autograd.backward(loss)
    torch.testing.assert_close(w.grad, torch.arange(3.0))
