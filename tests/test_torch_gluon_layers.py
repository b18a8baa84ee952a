"""The Gluon layers, ops, initializers and utilities of the PyTorch/CUDA
port that the recurrent and generative slice adds, against the JAX
package's, on the same numpy inputs from a seed, f32 on the CPU:

* `initializer`: the deterministic initializers (Zero, One, Constant,
  Bilinear, LSTMBias) and the name rules exactly; the random ones by
  their defining property (bounds, moments, QᵀQ = scale²·I), since
  torch's and JAX's streams differ; Mixed, `create` and a parameter's
  own initializer;
* `ndarray.nn_ops`: Deconvolution, UpSampling, LeakyReLU (every
  act_type), the softmaxes, SoftmaxOutput, smooth_l1, GroupNorm,
  InstanceNorm, L2Normalization, and Dropout's ``axes`` form (its mask
  shared along the axes);
* the blocks: the activations, GroupNorm, InstanceNorm, Identity,
  Lambda, HybridLambda, Conv1D/2D/3DTranspose and ReflectionPad2D,
  weights carried by structural name;
* `gluon.utils`: split_data, split_and_load, clip_global_norm (both
  return forms), check_sha1, download's local mirror, shape_is_known.

Forward values within 1e-5·|ref| + 1e-5·max|ref|; gradients within
1e-4·|ref| + 1e-5·max|ref| per element (`test_torch_conv_layers`).
"""
import hashlib
import math

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import initializer as jinit
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon import utils as jutils
from incubator_mxnet_tpu.ndarray import nn_ops as jops
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import MXNetError, autograd, initializer, nd
from incubator_mxnet_tpu_torch import random as mxr
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import nn, utils
from incubator_mxnet_tpu_torch.ops import dropout_kernel as dk
from test_torch_conv_layers import (FWD_TOL, GRAD_TOL, _close, _randn,
                                    _vjp_pair)

torch.set_num_threads(1)  # six xdist workers share the cores


# ---------------------------------------------------------- initializers
def _jax_init(ini, name, shape):
    arr = NDArray(jnp.zeros(shape, jnp.float32))
    ini(name, arr)
    return onp.asarray(arr._data)


def _port_init(ini, name, shape):
    t = torch.empty(shape)
    ini(name, t)
    return t.numpy()


DETERMINISTIC = [
    ("Zero", {}, (3, 4)), ("One", {}, (3, 4)),
    ("Constant", {"value": 0.3}, (2, 5)),
    ("Bilinear", {}, (2, 3, 4, 4)), ("Bilinear", {}, (1, 1, 3, 5)),
    ("LSTMBias", {"forget_bias": 1.5}, (12,)),
]


@pytest.mark.parametrize("case", range(len(DETERMINISTIC)))
def test_deterministic_initializers_equal_jax(case):
    """Zero, One, Constant, Bilinear and LSTMBias give the JAX
    package's arrays exactly (a weight's name, so the name rules keep
    out of the way)."""
    cls, kw, shape = DETERMINISTIC[case]
    want = _jax_init(getattr(jinit, cls)(**kw), "w", shape)
    got = _port_init(getattr(initializer, cls)(**kw), "w", shape)
    assert onp.array_equal(got, want), (cls, got, want)


@pytest.mark.parametrize("name", ["fc.bias", "ln.gamma", "ln.beta",
                                  "bn.running_mean", "bn.running_var",
                                  "bn.moving_var", "lstm_i2h_bias"])
def test_name_rules_come_first(name):
    """A parameter's name decides before the initializer: biases and
    betas and running means 0, gammas and running variances 1 (LSTMBias
    on a ``*bias`` too), as in the JAX package."""
    for cls, kw in (("Normal", {"sigma": 1.0}), ("LSTMBias", {})):
        want = _jax_init(getattr(jinit, cls)(**kw), name, (8,))
        got = _port_init(getattr(initializer, cls)(**kw), name, (8,))
        assert onp.array_equal(got, want), (name, cls)


def test_random_initializers_by_their_properties():
    """Uniform, Normal, Xavier (uniform and gaussian, each fan) and
    MSRAPrelu: every draw within its bound and mean and deviation
    within 5 standard errors of the distribution the JAX package draws
    from (its formulas, written out here)."""
    mxr.seed(3, device="cpu")
    shape = (64, 32, 3, 3)
    fan_in, fan_out = 32 * 9, 64 * 9
    cases = [
        ("Uniform", {"scale": 0.2}, "uniform", 0.2),
        ("Normal", {"sigma": 0.05}, "normal", 0.05),
        ("Xavier", {}, "uniform", math.sqrt(3 / ((fan_in + fan_out) / 2))),
        ("Xavier", {"factor_type": "in", "magnitude": 2}, "uniform",
         math.sqrt(2 / fan_in)),
        ("Xavier", {"rnd_type": "gaussian", "factor_type": "out"}, "normal",
         math.sqrt(3 / fan_out)),
        ("MSRAPrelu", {"slope": 0.1}, "normal",
         math.sqrt(2 / (1 + 0.01) / ((fan_in + fan_out) / 2))),
    ]
    n = math.prod(shape)
    for cls, kw, kind, scale in cases:
        w = _port_init(getattr(initializer, cls)(**kw), "w", shape)
        std = scale / math.sqrt(3) if kind == "uniform" else scale
        if kind == "uniform":
            assert onp.abs(w).max() <= scale, cls
        assert abs(w.mean()) < 5 * std / math.sqrt(n), (cls, w.mean())
        assert abs(w.std() / std - 1) < 5 / math.sqrt(2 * n) + 1e-3, \
            (cls, kw, w.std(), std)


@pytest.mark.parametrize("shape", [(8, 12), (12, 8), (6, 2, 3)])
def test_orthogonal_is_orthogonal(shape):
    """Orthogonal(scale) gives orthonormal rows (out <= in) or columns
    times scale: QQᵀ or QᵀQ = scale²·I within 1e-5, the JAX package's
    construction (QR of a normal draw)."""
    scale = 1.414
    w = _port_init(initializer.Orthogonal(scale), "w", shape)
    q = w.reshape(shape[0], -1).astype(onp.float64)
    g = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
    assert onp.allclose(g, scale ** 2 * onp.eye(len(g)), atol=1e-5), g


def test_mixed_create_and_a_parameters_own_initializer():
    """Mixed picks by the first matching pattern and raises on none;
    `create` takes names case-insensitively and the aliases; InitDesc
    keeps its attributes; a parameter's own initializer (PReLU's
    Constant(0.25)) wins over the one ``initialize`` is given."""
    mixed = initializer.Mixed(["fc.*", ".*"], [initializer.Constant(2.0),
                                               initializer.One()])
    jmixed = jinit.Mixed(["fc.*", ".*"], [jinit.Constant(2.0), jinit.One()])
    for name in ("fc1.weight", "conv.weight"):
        assert onp.array_equal(_port_init(mixed, name, (3,)),
                               _jax_init(jmixed, name, (3,)))
    with pytest.raises(ValueError):
        _port_init(initializer.Mixed(["a"], [initializer.One()]), "b", (1,))
    assert isinstance(initializer.create("zeros"), initializer.Zero)
    assert isinstance(initializer.create("ONES"), initializer.One)
    assert initializer.create("normal", sigma=0.5).sigma == 0.5
    assert initializer.create("xavier", magnitude=2).magnitude == 2.0
    with pytest.raises(MXNetError):
        initializer.create("nope")
    d = initializer.InitDesc("w", attrs={"lr_mult": 2})
    assert d == "w" and d.attrs == {"lr_mult": 2}
    p = nn.PReLU(in_channels=3, device="cpu")
    p.initialize(initializer.Normal(1.0))
    assert torch.equal(p.alpha.detach(), torch.full((3,), 0.25))


# ------------------------------------------------------------------- ops
DECONV_CASES = [
    ((2, 4, 7), (4, 3, 3), True, dict(stride=2, pad=1, adj=1)),
    ((2, 4, 5, 6), (4, 3, 4, 4), False, dict(stride=2, pad=1)),
    ((2, 4, 5, 5), (4, 2, 3, 2), True,
     dict(stride=(2, 1), pad=(1, 0), dilate=(1, 2), adj=(1, 0),
          num_group=2)),
    ((1, 2, 3, 4, 3), (2, 2, 2, 3, 2), True, dict(stride=(1, 2, 2))),
]


@pytest.mark.parametrize("case", range(len(DECONV_CASES)))
def test_deconvolution_matches_jax(case):
    """`nd.Deconvolution` (1-, 2- and 3-D; stride, padding, ``adj``,
    dilation, groups): output and the gradients of input, weight and
    bias against the JAX op's dilated convolution."""
    xs, ws, bias, kw = DECONV_CASES[case]
    rs = onp.random.RandomState(case)
    arrays = [_randn(rs, *xs), _randn(rs, *ws, scale=0.3)]
    if bias:
        arrays.append(_randn(rs, ws[1] * kw.get("num_group", 1)))
    kernel = ws[2:]

    def jfn(x, w, *b):
        return jops.Deconvolution(NDArray(x), NDArray(w),
                                  NDArray(b[0]) if b else None,
                                  kernel=kernel, no_bias=not b, **kw)._data

    def tfn(x, w, *b):
        return nd.Deconvolution(x, w, b[0] if b else None, kernel=kernel,
                                no_bias=not b, **kw)

    _vjp_pair(jfn, tfn, arrays, 500 + case)


@pytest.mark.parametrize("sample_type,scale", [("nearest", 2),
                                               ("nearest", 3),
                                               ("bilinear", 2)])
def test_upsampling_matches_jax(sample_type, scale):
    x = _randn(onp.random.RandomState(scale), 2, 3, 4, 5)
    _vjp_pair(lambda a: jops.UpSampling(NDArray(a), scale,
                                        sample_type)._data,
              lambda a: nd.UpSampling(a, scale, sample_type), [x], 510)


@pytest.mark.parametrize("act", ["leaky", "rrelu", "elu", "selu", "gelu"])
def test_leaky_relu_matches_jax(act):
    """Every ``act_type`` of `nd.LeakyReLU` at slope 0.3 (prelu below);
    an unknown one raises `MXNetError`."""
    x = _randn(onp.random.RandomState(2), 4, 9, scale=2.0)
    _vjp_pair(lambda a: jops.LeakyReLU(NDArray(a), act_type=act,
                                       slope=0.3)._data,
              lambda a: nd.LeakyReLU(a, act_type=act, slope=0.3), [x], 520)
    with pytest.raises(MXNetError):
        nd.LeakyReLU(torch.from_numpy(x), act_type="nope")


@pytest.mark.parametrize("shape", [(3, 4, 2, 2), (5, 4)])
def test_prelu_matches_jax(shape):
    """``prelu``: the per-channel slope on axis 1 (or the last of 2-D),
    with its gradient."""
    rs = onp.random.RandomState(len(shape))
    x, g = _randn(rs, *shape, scale=2.0), _randn(rs, 4, scale=0.3)
    _vjp_pair(lambda a, b: jops.LeakyReLU(NDArray(a), gamma=NDArray(b),
                                          act_type="prelu")._data,
              lambda a, b: nd.LeakyReLU(a, gamma=b, act_type="prelu"),
              [x, g], 530)


SOFTMAX_CASES = [
    ("softmax", dict(axis=1)), ("softmax", dict(axis=-1, temperature=2.0)),
    ("log_softmax", dict(axis=0, temperature=0.5)), ("softmin", dict()),
    ("SoftmaxOutput", dict()), ("SoftmaxOutput", dict(multi_output=True)),
    ("smooth_l1", dict(scalar=2.0)), ("smooth_l1", dict()),
]


@pytest.mark.parametrize("case", range(len(SOFTMAX_CASES)))
def test_softmax_family_matches_jax(case):
    """softmax (axis, temperature), log_softmax, softmin, SoftmaxOutput
    (its forward the softmax, over axis 1 with ``multi_output``) and
    smooth_l1, forward and gradient."""
    name, kw = SOFTMAX_CASES[case]
    x = _randn(onp.random.RandomState(case), 3, 5, 4, scale=2.0)
    _vjp_pair(lambda a: getattr(jops, name)(NDArray(a), **kw)._data,
              lambda a: getattr(nd, name)(a, **kw), [x], 540 + case)


def test_masked_softmaxes_and_lengths_match_jax():
    """masked_softmax (with temperature), masked_log_softmax and softmax
    with ``length`` (each row's first steps): forward and gradient; the
    masked entries of masked_softmax are exactly 0."""
    rs = onp.random.RandomState(9)
    x = _randn(rs, 3, 6, scale=2.0)
    mask = (rs.rand(3, 6) > 0.4).astype(onp.float32)
    mask[:, 0] = 1
    length = onp.array([2, 6, 4], onp.int32)
    _vjp_pair(lambda a: jops.masked_softmax(NDArray(a), NDArray(mask),
                                            temperature=0.7)._data,
              lambda a: nd.masked_softmax(a, torch.from_numpy(mask),
                                          temperature=0.7), [x], 550)
    _vjp_pair(lambda a: jops.masked_log_softmax(NDArray(a),
                                                NDArray(mask))._data,
              lambda a: nd.masked_log_softmax(a, torch.from_numpy(mask)),
              [x], 551)
    _vjp_pair(lambda a: jops.softmax(NDArray(a), axis=1,
                                     length=NDArray(length))._data,
              lambda a: nd.softmax(a, axis=1,
                                   length=torch.from_numpy(length)), [x], 552)
    got = nd.masked_softmax(torch.from_numpy(x), torch.from_numpy(mask))
    assert torch.all(got[torch.from_numpy(mask) == 0] == 0)


NORM_CASES = [
    ("GroupNorm", (2, 6, 3, 4), dict(num_groups=3)),
    ("GroupNorm", (2, 4, 5), dict(num_groups=1, eps=1e-3)),
    ("InstanceNorm", (2, 3, 4, 5), dict()),
    ("InstanceNorm", (3, 2, 7), dict(eps=1e-3)),
]


@pytest.mark.parametrize("case", range(len(NORM_CASES)))
def test_group_and_instance_norm_match_jax(case):
    """`nd.GroupNorm` and `nd.InstanceNorm`: output and the gradients of
    x, gamma and beta."""
    name, shape, kw = NORM_CASES[case]
    rs = onp.random.RandomState(case)
    C = shape[1]
    arrays = [_randn(rs, *shape, scale=2.0) + 1.0,
              1.0 + _randn(rs, C, scale=0.2), _randn(rs, C, scale=0.2)]
    _vjp_pair(lambda x, g, b: getattr(jops, name)(
        NDArray(x), NDArray(g), NDArray(b), **kw)._data,
        lambda x, g, b: getattr(nd, name)(x, g, b, **kw), arrays, 560 + case)


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization_matches_jax(mode):
    x = _randn(onp.random.RandomState(4), 2, 3, 4, 5)
    _vjp_pair(lambda a: jops.L2Normalization(NDArray(a), mode=mode)._data,
              lambda a: nd.L2Normalization(a, mode=mode), [x], 570)


@pytest.mark.parametrize("axes", [(1,), (0, 2)])
def test_dropout_with_axes_shares_its_mask(axes):
    """`nd.Dropout(axes=...)` in train mode: one keep-mask along
    ``axes`` (the port's mask kernel's plain version on the CPU, drawn
    at the reduced shape), each element 0 or x·1/(1-p) in f32, the keep
    fraction near 1-p, the gradient the same mask; identity outside
    train mode and at p = 0 (as the JAX op is there); no kernel
    launched on the CPU."""
    p = 0.4
    x = torch.from_numpy(_randn(onp.random.RandomState(5), 8, 16, 12)) + 3.0
    mxr.seed(11, device="cpu")
    before = dk.dropout_mask.launches
    xr = x.clone().requires_grad_()
    with autograd.record():
        y = nd.Dropout(xr, p=p, axes=axes)
    y.backward(torch.ones_like(y))
    keep = y != 0
    red = keep.all(dim=axes, keepdim=True)
    assert torch.equal(keep, red.expand_as(keep)), "mask not shared"
    assert torch.equal(keep, keep.any(dim=axes, keepdim=True).expand_as(
        keep))
    scale = dk._scale(p, torch.float32)
    assert torch.equal(y[keep], x[keep] * scale)
    assert torch.equal(xr.grad, keep.float() * scale)
    frac = red.float().mean().item()
    n = red.numel()
    assert abs(frac - (1 - p)) < 4 * math.sqrt(p * (1 - p) / n), frac
    assert dk.dropout_mask.launches == before
    assert torch.equal(nd.Dropout(x, p=p, axes=axes), x)
    with autograd.record():
        assert torch.equal(nd.Dropout(x, p=0.0, axes=axes), x)
    jx = NDArray(jnp.asarray(x.numpy()))
    assert onp.array_equal(onp.asarray(jops.Dropout(jx, p=p,
                                                    axes=axes)._data),
                           x.numpy())


# ---------------------------------------------------------------- blocks
def _carry(jnet, tnet):
    load_jax_params(tnet, {k: onp.asarray(p.data()._data) for k, p in
                           jnet._collect_params_with_prefix().items()})
    return tnet


def _block_pair(jnet, tnet, x, seed):
    """Forward of both blocks on ``x`` (weights carried), and the
    gradients of the input and of every parameter for one cotangent."""
    _carry(jnet, tnet)
    jnet.hybridize()
    ct = onp.random.RandomState(seed)
    jx = NDArray(jnp.asarray(x))
    jx.attach_grad()
    with mx.autograd.record():
        jy = jnet(jx)
    ct = ct.randn(*jy.shape).astype(onp.float32)
    jy.backward(NDArray(jnp.asarray(ct)))
    tx = torch.tensor(x, requires_grad=True)
    with autograd.record():
        ty = tnet(tx)
    ty.backward(torch.from_numpy(ct))
    _close(ty, jy.asnumpy(), FWD_TOL, "forward")
    _close(tx.grad, jx.grad.asnumpy(), GRAD_TOL, "input gradient")
    jp = jnet._collect_params_with_prefix()
    for name, p in tnet.named_parameters():
        if p.requires_grad:
            _close(p.grad, jp[name].grad().asnumpy(), GRAD_TOL, name)


ACT_BLOCKS = [
    (lambda m: m.LeakyReLU(0.2), None), (lambda m: m.ELU(0.7), None),
    (lambda m: m.SELU(), None), (lambda m: m.GELU(), None),
    (lambda m: m.GELU("tanh"), None), (lambda m: m.Swish(1.5), None),
    (lambda m: m.Identity(), None),
    (None, "prelu"),
]


@pytest.mark.parametrize("case", range(len(ACT_BLOCKS)))
def test_activation_blocks_match_jax(case):
    """LeakyReLU, ELU, SELU, GELU (erf and tanh), Swish (SiLU is its
    alias), Identity, and PReLU with a learned per-channel slope:
    forward and the input's and alpha's gradients."""
    assert nn.SiLU is nn.Swish
    make, kind = ACT_BLOCKS[case]
    x = _randn(onp.random.RandomState(case), 2, 3, 4, scale=2.0)
    if kind == "prelu":
        jnet = jnn.PReLU(in_channels=3)
        tnet = nn.PReLU(in_channels=3, device="cpu")
        jnet.initialize()
        with torch.no_grad():
            jnet.alpha.set_data(NDArray(jnp.asarray([0.1, -0.2, 0.3])))
    else:
        jnet, tnet = make(jnn), make(nn)
        jnet.initialize()
    _block_pair(jnet, tnet, x, 600 + case)


@pytest.mark.parametrize("kind", ["group", "instance"])
def test_group_and_instance_norm_blocks_match_jax(kind):
    """GroupNorm (gamma and beta learned) and InstanceNorm (beta only,
    gamma held at 1 with ``grad_req="null"``), hybridized."""
    rs = onp.random.RandomState(8)
    if kind == "group":
        jnet = jnn.GroupNorm(num_groups=2, in_channels=4)
        tnet = nn.GroupNorm(num_groups=2, in_channels=4, device="cpu")
    else:
        jnet = jnn.InstanceNorm(in_channels=4)
        tnet = nn.InstanceNorm(in_channels=4, device="cpu")
        assert tnet.gamma.grad_req == "null"
    jnet.initialize()
    tnet.hybridize()
    jnet.gamma.set_data(NDArray(jnp.asarray(1 + _randn(rs, 4, scale=0.2))))
    jnet.beta.set_data(NDArray(jnp.asarray(_randn(rs, 4, scale=0.2))))
    _block_pair(jnet, tnet, _randn(rs, 2, 4, 3, 5) + 0.5, 610)


TRANSPOSE_CASES = [
    ("Conv1DTranspose", (2, 4, 6), dict(channels=3, kernel_size=3,
                                        strides=2, padding=1,
                                        output_padding=1)),
    ("Conv2DTranspose", (2, 4, 3, 3), dict(channels=6, kernel_size=4,
                                           strides=2, padding=1, groups=2,
                                           activation="relu")),
    ("Conv3DTranspose", (1, 2, 2, 3, 2), dict(channels=2, kernel_size=2,
                                              strides=2)),
]


@pytest.mark.parametrize("case", range(len(TRANSPOSE_CASES)))
def test_transposed_convolution_layers_match_jax(case):
    """Conv1D/2D/3DTranspose (stride, padding, output padding, groups,
    an activation; DCGAN's stem, without a bias, in test_torch_dcgan):
    the (in, out/g,
    *k) weight carried by name, forward and the input's, weight's and
    bias's gradients."""
    name, xs, kw = TRANSPOSE_CASES[case]
    jnet = getattr(jnn, name)(in_channels=xs[1], **kw)
    jnet.initialize(mx.init.Normal(0.3))
    jnet.bias.set_data(NDArray(jnp.asarray(
        _randn(onp.random.RandomState(1), kw["channels"]))))
    tnet = getattr(nn, name)(in_channels=xs[1], device="cpu", **kw)
    assert tuple(tnet.weight.shape) == (xs[1], kw["channels"]
                                        // kw.get("groups", 1)) \
        + (kw["kernel_size"],) * (len(xs) - 2)
    _block_pair(jnet, tnet, _randn(onp.random.RandomState(case), *xs),
                620 + case)


@pytest.mark.parametrize("padding", [2, (0, 0, 0, 0, 1, 2, 2, 1)])
def test_reflection_pad_matches_jax(padding):
    """ReflectionPad2D by an int and by MXNet's eight widths, forward and
    gradient; widths on N or C raise."""
    x = _randn(onp.random.RandomState(3), 2, 3, 4, 5)
    _block_pair(jnn.ReflectionPad2D(padding), nn.ReflectionPad2D(padding),
                x, 630)
    with pytest.raises(MXNetError):
        nn.ReflectionPad2D((1, 1, 0, 0, 1, 1, 1, 1))


def test_lambda_blocks():
    """Lambda over a callable and over an `nd` op's name (else torch's),
    HybridLambda hybridized (a captured program on the CPU) equal to its
    eager call; an unknown name raises."""
    x = torch.from_numpy(_randn(onp.random.RandomState(2), 3, 4))
    assert torch.equal(nn.Lambda(lambda a: a * 2)(x), x * 2)
    assert torch.equal(nn.Lambda("flatten")(x.reshape(3, 2, 2)), x)
    assert torch.equal(nn.Lambda("tanh")(x), torch.tanh(x))
    hl = nn.HybridLambda(lambda a, b: a * b + 1)
    want = hl(x, x)
    hl.hybridize()
    assert torch.equal(hl(x, x), want) and torch.equal(hl(x, x), want)
    with pytest.raises(MXNetError):
        nn.Lambda("no_such_op")


# ----------------------------------------------------------- gluon.utils
def test_split_data_and_split_and_load():
    """split_data: even slices, or the remainder on the last; an uneven
    split with ``even_split`` raises; split_and_load puts each slice on
    its device, the whole batch for one, and refuses ``mesh``."""
    x = torch.arange(30.0).reshape(10, 3)
    parts = utils.split_data(x, 3, even_split=False)
    want = jutils.split_data(NDArray(jnp.asarray(x.numpy())), 3,
                             even_split=False)
    assert [tuple(p.shape) for p in parts] == [tuple(w.shape) for w in want]
    assert all(onp.array_equal(p.numpy(), w.asnumpy())
               for p, w in zip(parts, want))
    with pytest.raises(ValueError):
        utils.split_data(x, 3)
    cols = utils.split_data(x, 3, batch_axis=1)
    assert all(c.shape == (10, 1) for c in cols)
    loaded = utils.split_and_load(x.numpy(), ["cpu", torch.device("cpu")])
    assert [p.shape[0] for p in loaded] == [5, 5]
    assert torch.equal(torch.cat(loaded), x)
    assert torch.equal(utils.split_and_load(x, [torch.device("cpu")])[0], x)
    with pytest.raises(ValueError):
        utils.split_and_load(x)
    with pytest.raises(MXNetError):
        utils.split_and_load(x, mesh=object())


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(max_norm):
    """The joint norm returned (a float, or with ``check_isfinite=False``
    a tensor, no sync) and the arrays scaled in place as the JAX
    package's are (nothing changes below the bound)."""
    rs = onp.random.RandomState(1)
    arrays = [_randn(rs, 4, 5), _randn(rs, 7), _randn(rs, 2, 3, 2)]
    jarr = [NDArray(jnp.asarray(a)) for a in arrays]
    jn = jutils.clip_global_norm(jarr, max_norm)
    tarr = [torch.from_numpy(a.copy()) for a in arrays]
    tn = utils.clip_global_norm(tarr, max_norm)
    assert isinstance(tn, float) and abs(tn - jn) <= 1e-6 * jn
    for t, j in zip(tarr, jarr):
        _close(t, j.asnumpy(), FWD_TOL, "clipped")
    if max_norm > 10:
        assert all(onp.array_equal(t.numpy(), a)
                   for t, a in zip(tarr, arrays))
    tarr = [torch.from_numpy(a.copy()) for a in arrays]
    t2 = utils.clip_global_norm(tarr, max_norm, check_isfinite=False)
    assert isinstance(t2, torch.Tensor) and t2.dim() == 0
    assert abs(float(t2) - jn) <= 1e-6 * jn
    assert utils.clip_global_norm([None, tarr[0]], max_norm) > 0
    with pytest.raises(ValueError):
        utils.clip_global_norm([], 1.0)


def test_clip_global_norm_warns_on_nan():
    """A NaN norm warns and leaves the scale at 1 (the arrays keep their
    values, NaN included)."""
    a = torch.tensor([1.0, float("nan")])
    with pytest.warns(UserWarning):
        n = utils.clip_global_norm([a], 1.0)
    assert math.isnan(n) and a[0].item() == 1.0


def test_check_sha1_download_mirror_and_shape_is_known(tmp_path,
                                                       monkeypatch):
    """check_sha1 on a file; download keeps a file that is there, copies
    one from ``$MXNET_GLUON_REPO`` (the only source), and raises
    `IOError` where the mirror lacks it; shape_is_known."""
    f = tmp_path / "a.bin"
    f.write_bytes(b"abc" * 1000)
    sha = hashlib.sha1(b"abc" * 1000).hexdigest()
    assert utils.check_sha1(str(f), sha)
    assert not utils.check_sha1(str(f), "0" * 40)
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    (mirror / "w.params").write_bytes(b"weights")
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.setenv("MXNET_GLUON_REPO", str(mirror))
    got = utils.download("https://example.invalid/models/w.params",
                         path=str(out))
    assert got == str(out / "w.params")
    assert (out / "w.params").read_bytes() == b"weights"
    assert utils.download("https://example.invalid/w.params",
                          path=got) == got
    with pytest.raises(IOError):
        utils.download("https://example.invalid/missing.params",
                       path=str(out))
    monkeypatch.delenv("MXNET_GLUON_REPO")
    with pytest.raises(IOError):
        utils.download("https://example.invalid/w2.params", path=str(out))
    for shape in [None, (2, 0), (3, 4), ()]:
        assert utils.shape_is_known(shape) == jutils.shape_is_known(shape)
