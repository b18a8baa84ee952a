"""The ``.params`` codec of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/utils/serialization.py`, ``nd.save`` /
``nd.load``, ``ParameterDict.save``/``load``, ``Block.save_parameters``
/ ``load_parameters``) against the JAX package's, on the CPU: the same
arrays and names give byte-identical files, each package reads the
other's, and the error cases raise or pass as in the JAX package.
Values are equal bit for bit; logits after a cross-load are held within
1e-5 of the largest |logit| (f32: the packages' sums run in other
orders)."""
import importlib

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch import random as mxr
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.models import transformer as ttr

jser = importlib.import_module("incubator_mxnet_tpu.utils.serialization")

DTYPES = ["float32", "float16", "bfloat16", "int8", "int32", "int64",
          "uint8", "bool"]


def _arrays(dtype, seed=0):
    """Three numpy arrays of ``dtype`` (bf16 as f32 values exactly
    representable in bf16): 2-D, 1-D and 0-D."""
    rs = onp.random.RandomState(seed)
    out = []
    for shape in ((3, 5), (7,), ()):
        v = onp.asarray(rs.randn(*shape) * 50)
        if dtype == "bool":
            out.append(v > 0)
        elif dtype == "bfloat16":
            out.append(torch.from_numpy(v.astype(onp.float32))
                       .to(torch.bfloat16).float().numpy())
        else:
            out.append(v.astype(dtype))
    return out


def _jax_side(a, dtype):
    """What the JAX package saves for array ``a``: an NDArray, or the
    numpy array itself for int64 (JAX holds 64-bit integers as int32
    unless x64 is on)."""
    if dtype == "int64":
        return a
    return NDArray(jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16"
                               else a.dtype))


def _torch_side(a, dtype):
    return torch.from_numpy(onp.array(a)).to(getattr(torch, dtype))


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    return onp.asarray(v.asnumpy(), onp.float32) if v._data.dtype \
        == jnp.bfloat16 else v.asnumpy()


@pytest.mark.parametrize("form", ["list", "dict"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_nd_save_is_byte_identical_and_loads_across(tmp_path, dtype, form):
    arrays = _arrays(dtype)
    names = ["arg:w", "aux:running_mean", "b"]
    jdata = [_jax_side(a, dtype) for a in arrays]
    tdata = [_torch_side(a, dtype) for a in arrays]
    if form == "dict":
        jdata, tdata = dict(zip(names, jdata)), dict(zip(names, tdata))
    jf, tf = tmp_path / "jax.params", tmp_path / "port.params"
    mx.nd.save(str(jf), jdata)
    tnd.save(str(tf), tdata)
    assert tf.read_bytes() == jf.read_bytes()
    got = tnd.load(str(jf), device="cpu")
    back = mx.nd.load(str(tf))
    if form == "dict":
        assert list(got) == names and list(back) == names
        got, back = list(got.values()), list(back.values())
    for a, g, b in zip(arrays, got, back):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == a.shape
        onp.testing.assert_array_equal(_host(g), a)
        onp.testing.assert_array_equal(_host(b), a)


def test_nd_save_takes_one_tensor_and_numpy(tmp_path):
    """One tensor saves as a list of one; a numpy array as itself; a
    bf16 tensor on another dtype's view keeps its bits."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    tnd.save(str(tmp_path / "a"), t)
    mx.nd.save(str(tmp_path / "b"), NDArray(jnp.arange(6.0).reshape(2, 3)))
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    (got,) = tnd.load(str(tmp_path / "a"), device="cpu")
    assert torch.equal(got, t)
    tnd.save(str(tmp_path / "c"), {"x": t.numpy()})
    assert torch.equal(tnd.load(str(tmp_path / "c"), device="cpu")["x"], t)


def test_bad_magic_raises(tmp_path):
    from incubator_mxnet_tpu_torch import MXNetError

    (tmp_path / "bad").write_bytes(b"\0" * 32)
    with pytest.raises(MXNetError, match="magic"):
        tnd.load(str(tmp_path / "bad"), device="cpu")


# ------------------------------------------------------------ the nets
def _resnet_pair(seed):
    mx.random.seed(seed)
    jnet = jvision.resnet18_v1(classes=10)
    jnet.initialize()
    jnet(NDArray(jnp.zeros((1, 3, 32, 32))))
    tnet = vision.resnet18_v1(classes=10, device="cpu")
    return jnet, tnet


def _transformer_pair(seed):
    cfg = dict(units=32, hidden_size=64, num_layers=2, num_heads=4,
               max_length=64)
    mx.random.seed(seed)
    jnet = jtr.Transformer(100, 100, dropout=0.0, **cfg)
    jnet.initialize()
    tnet = ttr.Transformer(100, 100, dropout=0.0, device="cpu", **cfg)
    return jnet, tnet


def _resnet_inputs():
    x = onp.random.RandomState(3).randn(2, 3, 32, 32).astype(onp.float32)
    return (x,)


def _transformer_inputs():
    rs = onp.random.RandomState(4)
    return (rs.randint(1, 100, (2, 6)).astype(onp.int32),
            rs.randint(1, 100, (2, 5)).astype(onp.int32))


NETS = {"resnet18_v1": (_resnet_pair, _resnet_inputs),
        "transformer": (_transformer_pair, _transformer_inputs)}


def _logits(jnet, tnet, inputs):
    want = jnet(*[NDArray(jnp.asarray(a)) for a in inputs]).asnumpy()
    got = tnet(*[torch.from_numpy(a) for a in inputs]).numpy()
    return got, want


@pytest.mark.parametrize("name", sorted(NETS))
def test_save_parameters_across_packages(tmp_path, name):
    """A JAX net and a port net with its weights write the same keys
    (the tied embedding under both names, the running stats) and the
    same bytes; a fresh net of each package (another seed) loads the
    other's file and gives the same logits."""
    pair, inputs = NETS[name]
    jnet, tnet = pair(0)
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                           jnet._collect_params_with_prefix().items()})
    jf, tf = tmp_path / "jax.params", tmp_path / "port.params"
    jnet.save_parameters(str(jf))
    tnet.save_parameters(str(tf))
    assert list(tnd.load(str(tf), device="cpu")) \
        == list(jnet._collect_params_with_prefix())
    assert tf.read_bytes() == jf.read_bytes()
    if name == "transformer":
        keys = list(tnd.load(str(tf), device="cpu"))
        assert "src_embed.weight" in keys and "tgt_embed.weight" in keys
        tnet.save_parameters(str(tmp_path / "dedup"), deduplicate=True)
        jnet.save_parameters(str(tmp_path / "jdedup"), deduplicate=True)
        assert (tmp_path / "dedup").read_bytes() \
            == (tmp_path / "jdedup").read_bytes()
        assert "tgt_embed.weight" not in tnd.load(str(tmp_path / "dedup"),
                                                  device="cpu")
    j2, t2 = pair(1)
    t2.load_parameters(str(jf))
    j2.load_parameters(str(tf))
    for a, b in ((jnet, t2), (j2, tnet)):
        got, want = _logits(a, b, inputs())
        onp.testing.assert_allclose(got, want, rtol=0,
                                    atol=1e-5 * onp.abs(want).max())
    for n, p in t2.named_parameters():
        assert torch.equal(p, dict(tnet.named_parameters())[n])


def _small(seed=0):
    mxr.seed(seed, device="cpu")
    return nn.HybridSequential().add(
        nn.Dense(4, 3, device="cpu"),
        nn.BatchNorm(in_channels=4, device="cpu")).initialize()


def _jsmall():
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(4, in_units=3))
    jnet.add(mx.gluon.nn.BatchNorm(in_channels=4))
    jnet.initialize()
    return jnet


def _outcome(fn):
    try:
        fn()
        return "ok"
    except OSError:
        return "IOError"


@pytest.mark.parametrize("case", ["missing", "missing_allowed", "extra",
                                  "extra_ignored", "prefixed"])
def test_load_parameters_cases_as_in_jax(tmp_path, case):
    """A file without a parameter raises unless ``allow_missing``; with
    an extra key unless ``ignore_extra``; ``arg:``/``aux:`` prefixes are
    dropped; each package does the same with the same file, and the
    parameters it reads take the file's values."""
    arrays = {k: onp.random.RandomState(i).randn(*s).astype(onp.float32)
              for i, (k, s) in enumerate([
                  ("0.weight", (4, 3)), ("0.bias", (4,)),
                  ("1.gamma", (4,)), ("1.beta", (4,)),
                  ("1.running_mean", (4,)), ("1.running_var", (4,))])}
    kw = {}
    if case.startswith("missing"):
        del arrays["1.beta"]
        kw = {"allow_missing": case == "missing_allowed"}
    elif case.startswith("extra"):
        arrays["2.weight"] = onp.zeros(2, onp.float32)
        kw = {"ignore_extra": case == "extra_ignored"}
    else:
        arrays = {("aux:" if "running" in k else "arg:") + k: v
                  for k, v in arrays.items()}
    f = str(tmp_path / "f.params")
    tnd.save(f, {k: torch.from_numpy(v) for k, v in arrays.items()})
    tnet, jnet = _small(), _jsmall()
    got = _outcome(lambda: tnet.load_parameters(f, **kw))
    want = _outcome(lambda: jnet.load_parameters(f, **kw))
    assert got == want
    assert got == ("IOError" if case in ("missing", "extra") else "ok")
    if got == "ok":
        params = tnet._collect_params_with_prefix()
        for k, v in arrays.items():
            k = k.split(":")[-1]
            if k in params:
                onp.testing.assert_array_equal(params[k].detach().numpy(), v)


def test_parameter_dict_save_load_prefixes(tmp_path):
    """``ParameterDict.save(strip_prefix=)`` and ``load(restore_prefix=,
    allow_missing=, ignore_extra=)``, as the JAX ParameterDict's."""
    net = _small()
    params = net.collect_params()
    f = str(tmp_path / "p.params")
    params.save(f, strip_prefix="1.")
    keys = list(tnd.load(f, device="cpu"))
    assert keys == ["0.weight", "0.bias", "gamma", "beta", "running_mean",
                    "running_var"]
    with pytest.raises(IOError):
        _small(5).collect_params().load(f)          # "1.gamma" missing
    other = _small(5)
    sub = other.collect_params("1\\.")
    with pytest.raises(IOError, match="not in model"):
        sub.load(f, restore_prefix="1.")            # 1.0.weight extra
    sub.load(f, restore_prefix="1.", ignore_extra=True)
    for n in ("1.gamma", "1.beta", "1.running_mean", "1.running_var"):
        assert torch.equal(other.collect_params()[n], params[n])
    assert not torch.equal(other[0].weight, net[0].weight)
    other.collect_params().load(f, allow_missing=True, ignore_extra=True)
    assert torch.equal(other[0].weight, net[0].weight)
    jp = _jsmall().collect_params()
    with pytest.raises(IOError):
        jp.load(f)


def test_aliases_and_bf16_parameters(tmp_path):
    """``save_params``/``load_params`` are the same functions; a bf16
    net writes code-12 arrays the JAX package reads as bf16, and a
    file's f32 values load into bf16 parameters rounded to nearest
    even."""
    net = _small().cast("bfloat16")
    f = str(tmp_path / "b.params")
    net.save_params(f)
    jl = mx.nd.load(f)
    assert jl["0.weight"]._data.dtype == jnp.bfloat16
    f32 = str(tmp_path / "f.params")
    _small(3).save_parameters(f32)
    net.load_params(f32)
    src = tnd.load(f32, device="cpu")
    assert torch.equal(net[0].weight, src["0.weight"].to(torch.bfloat16))
