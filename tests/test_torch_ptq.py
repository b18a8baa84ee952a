"""Post-training quantization of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/contrib/quantization.py` `calibrate`,
`QuantizedConv`, `QuantizedDense`, `quantize_net`, and
`ops/int8_conv.py`) against the JAX package's on the CPU, from numpy
seeds; the mirror of `tests/test_custom_op_quant.py`.

Tolerances.  The thresholds of `calibrate` are equal.  The int8
activations and the int32 accumulators of `int8_conv` are equal to the
JAX package's.  Its output is equal without a bias; with one, XLA's CPU
backend fuses ``acc * scale + bias`` into one FMA (checked below),
where the port, its kernel and its plain version round the product
first, so an element may differ by the rounding of the product plus one
rounding of the sum: ``spacing(|acc * scale|) + spacing(|out|)`` in
f32.  Through a whole net the float layers between the int8 ones (the
two packages' convolutions and BatchNorms sum in other orders) move
each layer's minmax threshold by up to 1e-5 relative, which can move
an int8 activation by one step: ResNet-18's logits are held within
1e-2 of the largest |logit|.

The kernel itself, ``csrc/int8_conv.cu``, is compiled here for the host
(a stand-in for the CUDA runtime: one `std::thread` per CUDA thread, a
mutex-and-condition barrier for ``__syncthreads``, the blocks one after another) and
held bit for bit to the plain version `int8_conv_reference`.
"""
import ctypes
import importlib
import os
import re
import shutil
import subprocess
import tempfile

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import MXNetError, autograd
from incubator_mxnet_tpu_torch import random as mxr
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

jq = importlib.import_module("incubator_mxnet_tpu.contrib.quantization")
tq = importlib.import_module("incubator_mxnet_tpu_torch.contrib.quantization")
tk = importlib.import_module("incubator_mxnet_tpu_torch.ops.int8_conv")


def _j(a):
    return NDArray(jnp.asarray(a))


def _arrays(jnet):
    return {k: onp.asarray(p.data().asnumpy(), onp.float32)
            for k, p in jnet._collect_params_with_prefix().items()}


def _ulp_bound(acc, scale, out):
    """spacing(|acc·scale|) + spacing(|out|), f32, elementwise."""
    prod = onp.abs(acc.astype(onp.float32) * scale)
    return onp.spacing(prod) + onp.spacing(onp.abs(out).astype(onp.float32))


# ------------------------------------------------------------ calibrate
@pytest.mark.parametrize("mode", ["minmax", "entropy"])
def test_calibrate_thresholds_equal_jax(mode):
    """Three batches of numpy activations, a heavy tail in one: the
    same threshold as the JAX ``calibrate``, bit for bit."""
    rs = onp.random.RandomState(5)
    acts = [rs.randn(400).astype(onp.float32) for _ in range(2)]
    acts.append((rs.standard_t(2, 600) * 3).astype(onp.float32))
    want = jq.calibrate(acts, mode)
    assert tq.calibrate(acts, mode) == want
    assert tq.calibrate([torch.from_numpy(a) for a in acts], mode) == want
    with pytest.raises(ValueError):
        tq.calibrate(acts, "kl")


def test_threshold_from_stats_equals_jax():
    """`_threshold_from_stats` on the same records: minmax, entropy over
    subsamples, and the all-zero layer's 1e-8."""
    rs = onp.random.RandomState(6)
    samples = [onp.abs(rs.randn(3000)).astype(onp.float32) for _ in range(3)]
    rec = {"amax": float(max(s.max() for s in samples)),
           "samples": samples, "hits": 3}
    for mode in ("minmax", "entropy"):
        assert tq._threshold_from_stats(rec, mode) \
            == jq._threshold_from_stats(rec, mode)
    zero = {"amax": 0.0, "samples": [], "hits": 1}
    assert tq._threshold_from_stats(zero, "entropy") == 1e-8


# ------------------------------------------------------------ int8_conv
# (x shape, conv kwargs, bias, activation): 1-D, 2-D with stride and
# pad, grouped and dilated, 3-D with mixed strides, pads and dilations
CONV_CASES = [
    ((2, 4, 20), dict(channels=6, kernel_size=5, strides=2, padding=2),
     True, None),
    ((2, 8, 16, 16), dict(channels=16, kernel_size=3, strides=2, padding=1),
     True, "relu"),
    ((2, 8, 16, 16), dict(channels=16, kernel_size=3, strides=2, padding=1),
     False, None),
    ((2, 8, 10, 10), dict(channels=8, kernel_size=3, padding=2, dilation=2,
                          groups=4), True, None),
    ((1, 4, 6, 7, 8), dict(channels=5, kernel_size=3, strides=(1, 2, 1),
                           padding=(1, 1, 0), dilation=(1, 1, 2)),
     True, "relu"),
]
_JCONV = {3: jnn.Conv1D, 4: jnn.Conv2D, 5: jnn.Conv3D}
_TCONV = {3: nn.Conv1D, 4: nn.Conv2D, 5: nn.Conv3D}


def _conv_pair(shape, kw, bias, act, seed):
    mx.random.seed(seed)
    jconv = _JCONV[len(shape)](in_channels=shape[1], use_bias=bias,
                               activation=act, **kw)
    jconv.initialize(mx.init.Normal(0.5))
    jconv.bias.set_data(jnp.asarray(onp.random.RandomState(seed).randn(
        kw["channels"]), jnp.float32)) if bias else None
    tconv = _TCONV[len(shape)](in_channels=shape[1], use_bias=bias,
                               activation=act, device="cpu", **kw)
    load_jax_params(tconv, _arrays(jconv))
    return jconv, tconv


@pytest.mark.parametrize("shape,kw,bias,act", CONV_CASES)
def test_int8_conv_matches_jax(shape, kw, bias, act):
    """`QuantizedConv` of the same layer at the same threshold: the int8
    activations and int32 accumulators equal the JAX package's (its
    jitted quantize and s32 convolution), the outputs equal without a
    bias and within the FMA bound with one (module docstring)."""
    jconv, tconv = _conv_pair(shape, kw, bias, act, len(shape))
    x = (onp.random.RandomState(7).randn(*shape) * 2).astype(onp.float32)
    thr = float(onp.abs(x).max()) * 0.6      # some activations clip
    jl, tl = jq.QuantizedConv(jconv, thr), tq.QuantizedConv(tconv, thr)
    assert onp.array_equal(onp.asarray(jl.w_q), tl.w_q.numpy())
    assert onp.array_equal(onp.asarray(jl.w_scale), tl.w_scale.numpy())
    nd = len(shape) - 2

    @jax.jit
    def parts(xj):
        xq = jnp.clip(jnp.round(xj / jl.act_scale), -127, 127).astype(
            jnp.int8)
        spatial = "DHW"[-nd:]
        acc = jax.lax.conv_general_dilated(
            xq, jl.w_q, jl.stride, [(p, p) for p in jl.pad],
            rhs_dilation=jl.dilate,
            dimension_numbers=("NC" + spatial, "OI" + spatial,
                               "NC" + spatial),
            feature_group_count=jl.groups, preferred_element_type=jnp.int32)
        return xq, acc, jl.act_scale * jl.w_scale

    jxq, jacc, jscale = (onp.asarray(a) for a in parts(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    txq = tk.quantize_activation(xt, tl.act_scale)
    assert onp.array_equal(txq.numpy(), jxq)
    tacc = torch.nn.functional.__dict__[f"conv{nd}d"](
        txq.double(), tl.w_q.double(), None, tl.stride, tl.pad, tl.dilate,
        tl.groups).to(torch.int32).numpy()
    assert onp.array_equal(tacc, jacc)
    assert onp.array_equal(tl.scale.numpy(), jscale)
    want = onp.asarray(jl(_j(x)).asnumpy())
    got = tl(xt).numpy()
    assert got.shape == want.shape and got.dtype == onp.float32
    if not bias:
        assert onp.array_equal(got, want)
    else:
        bound = _ulp_bound(tacc, jscale.reshape((1, -1) + (1,) * nd), want)
        assert (onp.abs(got - want) <= bound).all()
        assert not onp.array_equal(got, want) or act is not None


def test_xla_cpu_fuses_the_epilogue_into_an_fma():
    """The reason for the bound: the JAX package's output with a bias is
    ``fma(acc, scale, bias)`` rounded once, element for element, and
    the port's differs from it somewhere at these inputs."""
    jconv, tconv = _conv_pair((2, 8, 16, 16), CONV_CASES[1][1], True, None,
                              4)
    x = (onp.random.RandomState(7).randn(2, 8, 16, 16) * 2).astype(
        onp.float32)
    thr = float(onp.abs(x).max()) * 0.6
    jl, tl = jq.QuantizedConv(jconv, thr), tq.QuantizedConv(tconv, thr)
    want = onp.asarray(jl(_j(x)).asnumpy())
    xq = tk.quantize_activation(torch.from_numpy(x), tl.act_scale).double()
    acc = torch.nn.functional.conv2d(xq, tl.w_q.double(), None, 2, 1)
    scale = tl.scale.double().reshape(1, -1, 1, 1)
    fma = (acc * scale + tl.bias.double().reshape(1, -1, 1, 1)).float()
    assert onp.array_equal(fma.numpy(), want)
    assert not onp.array_equal(tl(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("flatten,shape", [(True, (3, 2, 5)),
                                           (False, (3, 4, 10)),
                                           (True, (4, 10))])
def test_quantized_dense_matches_jax(flatten, shape):
    """`QuantizedDense` with ``flatten`` over a 3-D input (folded to
    (N, -1)), without it over a 3-D input (the leading dims kept), and
    over 2-D; a fused relu survives; within the FMA bound."""
    mx.random.seed(2)
    jd = jnn.Dense(7, in_units=10, flatten=flatten, activation="relu")
    jd.initialize(mx.init.Normal(0.5))
    jd.bias.set_data(jnp.asarray(onp.random.RandomState(3).randn(7),
                                 jnp.float32))
    td = load_jax_params(nn.Dense(7, 10, flatten=flatten, activation="relu",
                                  device="cpu"), _arrays(jd))
    x = onp.random.RandomState(4).randn(*shape).astype(onp.float32)
    thr = float(onp.abs(x).max())
    want = onp.asarray(jq.QuantizedDense(jd, thr)(_j(x)).asnumpy())
    got = tq.QuantizedDense(td, thr)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert (want >= 0).all() and (want == 0).any()
    x2 = x.reshape(-1, 10) if not flatten else x.reshape(x.shape[0], -1)
    xq = tk.quantize_activation(torch.from_numpy(x2), thr / 127.0)
    acc = (xq.double() @ tq.quantize_weight(td.weight)[0].double().t()
           ).numpy().reshape(got.shape)
    scale = tq.QuantizedDense(td, thr).scale.numpy()
    assert (onp.abs(got - want) <= _ulp_bound(acc, scale, want)).all()


# ---------------------------------------------------------- quantize_net
def _resnet18_pair():
    mx.random.seed(0)
    jnet = jvision.resnet18_v1(classes=10)
    jnet.initialize()
    jnet(_j(onp.zeros((1, 3, 32, 32), onp.float32)))
    tnet = load_jax_params(vision.resnet18_v1(classes=10, device="cpu"),
                           _arrays(jnet))
    return jnet, tnet


def _wrapped(net, kind):
    """(structural name, threshold) of every quantized layer, in order."""
    out = []
    if kind == "jax":
        def walk(block, prefix):
            for name, c in block._children.items():
                if isinstance(c, jq._QuantizedWrapper):
                    out.append((prefix + name, c._qd.act_scale))
                else:
                    walk(c, prefix + name + ".")
        walk(net, "")
    else:
        out = [(n, m._qd.act_scale) for n, m in net.named_modules()
               if isinstance(m, tq._QuantizedWrapper)]
    return out


def test_quantize_net_resnet18_matches_jax():
    """ResNet-18 v1 (10 classes, 32x32) with the JAX net's weights and
    the same two calibration batches: the same 21 wrapped layers under
    the same names (20 convolutions, the Dense), the stem's threshold
    equal (it sees the images) and every other within 1e-5 relative,
    logits within 1e-2 of the largest |logit|; the JAX wrapper's keys
    (``...src.weight``) in both nets' structural names."""
    jnet, tnet = _resnet18_pair()
    rs = onp.random.RandomState(11)
    calib = [rs.randn(2, 3, 32, 32).astype(onp.float32) for _ in range(2)]
    x = rs.randn(2, 3, 32, 32).astype(onp.float32)
    jq.quantize_net(jnet, [_j(c) for c in calib])
    tq.quantize_net(tnet, [torch.from_numpy(c) for c in calib])
    jw, tw = _wrapped(jnet, "jax"), _wrapped(tnet, "port")
    assert len(jw) == 21 and [n for n, _ in tw] == [n for n, _ in jw]
    assert tw[0] == jw[0]
    onp.testing.assert_allclose([s for _, s in tw], [s for _, s in jw],
                                rtol=1e-5, atol=0)
    want = onp.asarray(jnet(_j(x)).asnumpy())
    got = tnet(torch.from_numpy(x)).numpy()
    onp.testing.assert_allclose(got, want, rtol=0,
                                atol=1e-2 * onp.abs(want).max())
    keys = list(jnet._collect_params_with_prefix())
    assert "features.0.src.weight" in keys
    assert list(tnet._collect_params_with_prefix()) == keys


def test_quantize_net_entropy_thresholds_equal_jax():
    """``calib_mode="entropy"`` on a Dense net whose first layer sees the
    batches themselves (so both packages hold the same values): its
    threshold equals the JAX package's, subsampling included (batches of
    70,000 values, above the 65,536 cap)."""
    rs = onp.random.RandomState(12)
    calib = [(rs.standard_t(3, (7, 10000))).astype(onp.float32)
             for _ in range(2)]
    mx.random.seed(1)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(4, in_units=10000))
    jnet.initialize()
    tnet = nn.HybridSequential().add(nn.Dense(4, 10000, device="cpu"))
    load_jax_params(tnet, _arrays(jnet))
    jq.quantize_net(jnet, [_j(c) for c in calib], calib_mode="entropy")
    tq.quantize_net(tnet, [torch.from_numpy(c) for c in calib],
                    calib_mode="entropy")
    assert _wrapped(tnet, "port") == _wrapped(jnet, "jax")
    assert _wrapped(tnet, "port")[0][1] * 127 < onp.abs(calib[0]).max()


def _mlp(seed=0):
    mxr.seed(seed, device="cpu")
    net = nn.HybridSequential().add(
        nn.Dense(8, 6, activation="relu", device="cpu"),
        nn.Dense(4, 8, device="cpu"))
    return net.initialize()


def test_hybridized_net_drops_its_program_after_quantize_net():
    """A hybridized net's captured program is dropped by quantize_net:
    the next call runs the int8 layers (calibration ran eagerly, its
    hooks firing, though the net was hybridized)."""
    net = _mlp()
    net.hybridize()
    x = torch.from_numpy(onp.random.RandomState(0).randn(2, 6).astype(
        onp.float32))
    before = net(x)
    assert net._graph_cache
    tq.quantize_net(net, [x])
    assert net._hybrid and not net._graph_cache
    after = net(x)
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, before, rtol=0.1, atol=0.05)
    assert isinstance(net[0], tq._QuantizedWrapper) and net._graph_cache


def test_user_pre_hook_survives_quantize_net():
    """quantize_net removes its own hooks only: a user's pre-hook on a
    target layer keeps firing (on the wrapped float layer it stays
    registered; the calibration batches reach it too); its handle's
    ``remove()`` removes it."""
    net = _mlp()
    seen = []
    h = net[1].register_forward_pre_hook(
        lambda blk, inputs: seen.append(tuple(inputs[0].shape)))
    x = torch.zeros(3, 6)
    tq.quantize_net(net, [x, x])
    assert seen == [(3, 8), (3, 8)]
    assert len(net[0].src._forward_pre_hooks) == 0
    assert len(net[1].src._forward_pre_hooks) == 1
    net[1].src(torch.zeros(5, 8))
    assert seen[-1] == (5, 8)
    h.remove()
    net[1].src(torch.zeros(5, 8))
    assert len(seen) == 3


def test_layer_no_batch_reached_raises():
    """A target layer the calibration forwards never call raises, and
    the net keeps its float layers and its hybridization."""
    class Two(nn.HybridSequential):
        def forward(self, x):
            return self[1](x)

    mxr.seed(0, device="cpu")
    net = Two().add(nn.Dense(4, 4, device="cpu"),
                    nn.Dense(4, 6, device="cpu")).initialize()
    net.hybridize()
    with pytest.raises(ValueError, match="saw no calibration"):
        tq.quantize_net(net, [torch.zeros(2, 6)])
    assert isinstance(net[0], nn.Dense) and isinstance(net[1], nn.Dense)
    assert net._hybrid and not any(len(b._forward_pre_hooks) for b in net)


def test_hooks_fire_outside_programs_only():
    """Gluon's hook contract on the port's blocks: a hybridized block's
    own hooks fire around its program's run; its children's do not fire
    inside the program's body."""
    net = _mlp()
    calls = []
    net.register_forward_pre_hook(lambda b, a: calls.append("pre"))
    net.register_forward_hook(lambda b, a, o: calls.append(("post",
                                                             o.shape)))
    net[0].register_forward_pre_hook(lambda b, a: calls.append("child"))
    x = torch.zeros(2, 6)
    net(x)
    assert calls == ["pre", "child", ("post", (2, 4))]
    net.hybridize()
    calls.clear()
    net(x)
    net(x)
    assert calls == ["pre", ("post", (2, 4))] * 2


# ------------------------------------------------- the kernel, host build
_SHIM_RUNTIME = r"""
#pragma once
#include <climits>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ alignas(16) static
#define __align__(n)
// names of their own: another host build loaded into the process (the
// dropout kernel's) exports its own blockIdx, threadIdx and gridDim,
// which the dynamic linker would bind these references to
#define blockIdx shim_int8_blockIdx
#define threadIdx shim_int8_threadIdx
#define gridDim shim_int8_gridDim
struct Dim { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local Dim blockIdx, threadIdx;
inline Dim gridDim;
struct ShimBarrier {          // a block's threads meet at __syncthreads
  std::mutex m;
  std::condition_variable cv;
  int count = 0, size = 0;
  unsigned phase = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const unsigned p = phase;
    if (++count == size) {
      count = 0;
      ++phase;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return phase != p; });
    }
  }
};
inline ShimBarrier shim_barrier;
inline void __syncthreads() { shim_barrier.wait(); }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return 0; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __int2float_rn(int a) { return static_cast<float>(a); }
inline int __float2int_rn(float f) {
  if (std::isnan(f)) return 0;
  const float r = std::nearbyint(f);
  if (r >= 2147483647.0f) return INT_MAX;
  if (r <= -2147483648.0f) return INT_MIN;
  return static_cast<int>(r);
}
inline int __dp4a(int a, int b, int c) {
  for (int i = 0; i < 4; ++i)
    c += static_cast<int8_t>(a >> (8 * i)) * static_cast<int8_t>(b >> (8 * i));
  return c;
}
template <class K, class... A>
void shim_run(dim3 grid, int threads, K kernel, A... args) {
  gridDim = {grid.x, grid.y, grid.z};
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        shim_barrier.size = threads;
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([=] {
            blockIdx = {x, y, z};
            threadIdx = {static_cast<unsigned>(t), 0, 0};
            kernel(args...);
          });
        for (auto& th : pool) th.join();
      }
}
"""
_SHIM_BF16 = r"""
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { uint16_t x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if (std::isnan(f)) return {0x7fff};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = static_cast<uint32_t>(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
"""


@pytest.fixture(scope="module")
def host_kernel():
    """``csrc/int8_conv.cu`` built for the host as a ctypes library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build csrc/int8_conv.cu for the host")
    src = open(os.path.join(os.path.dirname(tk.__file__), os.pardir,
                            "csrc", "int8_conv.cu")).read()
    src, n = re.subn(r"(\w+<[^<>]*>)<<<([^,]+),\s*([^,]+),.*?>>>\(",
                     r"shim_run(\2, \3, \1, ", src, flags=re.S)
    assert n == 1, "one launch expected in csrc/int8_conv.cu"
    with tempfile.TemporaryDirectory() as out:
        for name, text in (("cuda_runtime.h", _SHIM_RUNTIME),
                           ("cuda_bf16.h", _SHIM_BF16),
                           ("int8_conv.cpp", src)):
            with open(os.path.join(out, name), "w") as f:
                f.write(text)
        lib = os.path.join(out, "libint8_conv.so")
        subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off",
                        "-shared", "-fPIC", "-pthread", "-I", out, "-o", lib,
                        os.path.join(out, "int8_conv.cpp")], check=True,
                       timeout=240)
        yield ctypes.CDLL(lib)


# (x shape, weight shape, stride, pad, dilation, groups, bias): K past a
# 32-deep step (147 = the stem's 3·7·7), pixels past a 128-row tile,
# channels past a 64-wide one, groups, dilation, 1-D and 3-D, the GEMM
# case (1x1 over (M, K, 1, 1))
KERNEL_CASES = [
    ((1, 3, 12, 12), (8, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1, True),
    ((2, 6, 9, 9), (70, 6, 1, 1), (1, 1), (0, 0), (1, 1), 1, False),
    ((1, 8, 10, 10), (8, 2, 3, 3), (1, 1), (2, 2), (2, 2), 4, True),
    ((2, 4, 21), (6, 4, 5), (2,), (2,), (1,), 1, True),
    ((1, 4, 5, 6, 7), (5, 4, 3, 3, 3), (1, 2, 1), (1, 1, 0), (1, 1, 2), 1,
     True),
    ((3, 40, 1, 1), (9, 40, 1, 1), (1, 1), (0, 0), (1, 1), 1, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,ws,stride,pad,dil,groups,bias", KERNEL_CASES)
def test_kernel_source_gives_the_plain_bits(monkeypatch, host_kernel, dtype,
                                            xs, ws, stride, pad, dil, groups,
                                            bias):
    """`int8_conv` on the kernel route, on the host build of
    ``csrc/int8_conv.cu``, bit for bit against `int8_conv_reference`
    (values clipped at ±127 and rounded halves included); one launch
    counted a call."""
    dt = getattr(torch, dtype)
    rs = onp.random.RandomState(sum(xs))
    x = torch.from_numpy((rs.randn(*xs) * 3).astype(onp.float32)).to(dt)
    act = 0.05
    x.view(-1)[:4] = torch.tensor([0.025, -0.075, 0.125, 9.0]).to(dt)
    w_q = torch.from_numpy(rs.randint(-127, 128, ws).astype(onp.int8))
    scale = torch.from_numpy(rs.rand(ws[0]).astype(onp.float32) * 1e-2)
    b = torch.from_numpy(rs.randn(ws[0]).astype(onp.float32)) if bias \
        else None
    want = tk.int8_conv_reference(x, w_q, scale, act, b, stride, pad, dil,
                                  groups)
    monkeypatch.setattr(tk._build, "load", lambda name: host_kernel)
    monkeypatch.setattr(tk._build, "stream", lambda device: None)
    monkeypatch.setattr(tk, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tk, "int8_conv_reference", None)
    monkeypatch.setattr(tk.int8_conv, "launches", 0)
    got = tk.int8_conv(x, w_q, scale, act, b, stride, pad, dil, groups)
    assert got.dtype == dt and got.shape == want.shape
    assert torch.equal(got.view(-1).view(torch.int16 if dtype == "bfloat16"
                                          else torch.int32),
                       want.view(-1).view(torch.int16 if dtype == "bfloat16"
                                          else torch.int32))
    assert tk.int8_conv.launches == 1


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """On the kernel route the wrapper raises on a float16 x, float
    weights, a channel count the groups do not divide, an f64 scale;
    nothing falls back to the plain version."""
    monkeypatch.setattr(tk, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tk, "int8_conv_reference", None)
    x = torch.zeros(1, 4, 5, 5)
    w = torch.zeros(6, 4, 3, 3, dtype=torch.int8)
    s = torch.ones(6)
    bad = [(x.half(), w, s, 1), (x, w.float(), s, 1), (x, w, s, 3),
           (x, w, s.double(), 1), (x, w[:, :2], s, 1)]
    for xx, ww, ss, g in bad:
        with pytest.raises(MXNetError):
            tk.int8_conv(xx, ww, ss, 0.1, None, (1, 1), (0, 0), (1, 1), g)
