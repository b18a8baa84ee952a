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

The kernels run on the card only; here each is held by another means.
The quantize pass, ``csrc/int8_quantize.cu``, is compiled for the host
(a stand-in for the CUDA runtime: one `std::thread` per CUDA thread, a
mutex-and-condition barrier for ``__syncthreads``, the blocks one after
another) and held bit for bit to `quantize_channels_last_reference`.
The tensor-core GEMM, ``csrc/int8_conv.cu`` (s8 ``wgmma``, TMA and
``cp.async`` in inline PTX, which g++ cannot compile), is held through a
test-only emulation of its arithmetic: the same row and (tap, chunk)
walk over the channels-last buffer and `pack_weight`'s layout, the same
split of K into 128-byte stages over blocks, exact int64 partial sums
(each within the kernel's s32), summed over the splits, and the
two-rounding epilogue; with the host quantize kernel, through the
wrapper, bit for bit against `int8_conv_reference`.
"""
import ctypes
import importlib
import math
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
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
inline int __float2int_rn(float f) {
  if (std::isnan(f)) return 0;
  const float r = std::nearbyint(f);
  if (r >= 2147483647.0f) return INT_MAX;
  if (r <= -2147483648.0f) return INT_MIN;
  return static_cast<int>(r);
}
struct alignas(16) uint4 { unsigned x, y, z, w; };
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
    """``csrc/int8_quantize.cu`` built for the host as a ctypes library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build csrc/int8_quantize.cu for "
                    "the host")
    src = open(os.path.join(os.path.dirname(tk.__file__), os.pardir,
                            "csrc", "int8_quantize.cu")).read()
    src, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),.*?>>>\(",
                     r"shim_run(\2, \3, \1, ", src, flags=re.S)
    assert n == 1, "one launch expected in csrc/int8_quantize.cu"
    with tempfile.TemporaryDirectory() as out:
        for name, text in (("cuda_runtime.h", _SHIM_RUNTIME),
                           ("cuda_bf16.h", _SHIM_BF16),
                           ("int8_quantize.cpp", src)):
            with open(os.path.join(out, name), "w") as f:
                f.write(text)
        lib = os.path.join(out, "libint8_quantize.so")
        subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off",
                        "-shared", "-fPIC", "-pthread", "-I", out, "-o", lib,
                        os.path.join(out, "int8_quantize.cpp")], check=True,
                       timeout=240)
        yield ctypes.CDLL(lib)


# (x shape, weight shape, stride, pad, dilation, groups, bias): K past a
# 32-deep step (147 = the stem's 3·7·7), pixels past a 128-row tile,
# channels past a 64-wide one, groups, dilation, 1-D and 3-D, the GEMM
# case (1x1 over (M, K, 1, 1)); then a strided 1x1 (the subsampled
# buffer) over 160 channels (two 128-byte stages), a 3x3 over 64 (five
# stages, 72 output channels: a 128-wide block) and a strided 3x3 over 128
# (A by one tap's TMA box a stage)
KERNEL_CASES = [
    ((1, 3, 12, 12), (8, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1, True),
    ((2, 6, 9, 9), (70, 6, 1, 1), (1, 1), (0, 0), (1, 1), 1, False),
    ((1, 8, 10, 10), (8, 2, 3, 3), (1, 1), (2, 2), (2, 2), 4, True),
    ((2, 4, 21), (6, 4, 5), (2,), (2,), (1,), 1, True),
    ((1, 4, 5, 6, 7), (5, 4, 3, 3, 3), (1, 2, 1), (1, 1, 0), (1, 1, 2), 1,
     True),
    ((3, 40, 1, 1), (9, 40, 1, 1), (1, 1), (0, 0), (1, 1), 1, True),
    ((2, 160, 7, 7), (40, 160, 1, 1), (2, 2), (0, 0), (1, 1), 1, True),
    ((2, 64, 6, 6), (72, 64, 3, 3), (1, 1), (1, 1), (1, 1), 1, False),
    ((1, 128, 7, 6), (16, 128, 3, 3), (2, 2), (1, 1), (1, 1), 1, True),
]


def _kernel_inputs(dtype, xs, ws, bias):
    """x (values clipped at ±127 and rounded halves among them), int8
    weights, f32 scale and bias from a seed of the shape."""
    dt = getattr(torch, dtype)
    rs = onp.random.RandomState(sum(xs))
    x = torch.from_numpy((rs.randn(*xs) * 3).astype(onp.float32)).to(dt)
    x.view(-1)[:4] = torch.tensor([0.025, -0.075, 0.125, 9.0]).to(dt)
    w_q = torch.from_numpy(rs.randint(-127, 128, ws).astype(onp.int8))
    scale = torch.from_numpy(rs.rand(ws[0]).astype(onp.float32) * 1e-2)
    b = torch.from_numpy(rs.randn(ws[0]).astype(onp.float32)) if bias \
        else None
    return x, w_q, scale, 0.05, b


def _kernel_route(monkeypatch, host_kernel):
    """CPU tensors through the kernel wrappers: the quantize pass on its
    host build, nothing falling back to the plain versions."""
    def load(name):
        assert name == "int8_quantize", name
        return host_kernel

    monkeypatch.setattr(tk._build, "load", load)
    monkeypatch.setattr(tk._build, "stream", lambda device: None)
    monkeypatch.setattr(tk, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tk, "int8_conv_reference", None)
    monkeypatch.setattr(tk, "quantize_channels_last_reference", None)
    for fn in (tk.int8_conv, tk.int8_dense, tk.int8_quantize):
        monkeypatch.setattr(fn, "launches", 0)


def _same_bits(got, want):
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return got.dtype == want.dtype and got.shape == want.shape \
        and torch.equal(got.reshape(-1).view(view),
                        want.reshape(-1).view(view))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,ws,stride,pad,dil,groups,bias", KERNEL_CASES)
def test_kernel_source_gives_the_plain_bits(monkeypatch, host_kernel, dtype,
                                            xs, ws, stride, pad, dil, groups,
                                            bias):
    """`int8_quantize` on the kernel route, on the host build of
    ``csrc/int8_quantize.cu``, bit for bit against
    `quantize_channels_last_reference` over the buffer the convolution
    of the case reads (a 1x1 without padding: every stride-th pixel; a
    kernel over few channels: its width taps folded into them, with the
    stride, padding and dilation of the width), values clipped at ±127,
    rounded halves and the zero lanes of Cp included; one launch counted
    a call."""
    x, w_q, scale, act, b = _kernel_inputs(dtype, xs, ws, bias)
    geo = tk._Geometry(xs, ws, stride, pad, dil, groups)
    sub, fold = geo.quant_args()
    want = tk.quantize_channels_last_reference(x, act, groups, sub, fold)
    assert tuple(want.shape) == geo.xq_shape
    _kernel_route(monkeypatch, host_kernel)
    got = tk.int8_quantize(x, act, groups, sub, fold)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert tk.int8_quantize.launches == 1


def _tiled_pixels(geo):
    """``pixel_of`` of ``csrc/int8_conv.cu`` for every (tile, row) of a
    tiled convolution: row r of the box at (x0, y0, z0, n0) is output
    pixel (n0 + nn, z0 + zz, y0 + yy, x0 + xx), r = ((nn bd + zz) bh +
    yy) bw + xx, or -1 past the output."""
    bw, bh, bd, bn = geo.box
    od, oh, ow = geo.outs
    r = torch.arange(_BM)
    xx, yy = r % bw, (r // bw) % bh
    zz, nn = (r // (bw * bh)) % bd, r // (bw * bh * bd)
    t = torch.arange(geo.m_tiles)[:, None]
    tw, th, td = -(-ow // bw), -(-oh // bh), -(-od // bd)
    x = (t % tw) * bw + xx
    y = (t // tw % th) * bh + yy
    z = (t // (tw * th) % td) * bd + zz
    n = (t // (tw * th * td)) * bn + nn
    live = (x < ow) & (y < oh) & (z < od) & (n < geo.n)
    return torch.where(live, ((n * od + z) * oh + y) * ow + x, -1)


_BM = 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,groups,offset", [((2, 16, 8, 8), 1, 0),
                                              ((1, 24, 4, 4), 3, 0),
                                              ((2, 16, 8, 8), 1, 1)])
def test_kernel_source_vector_reads(monkeypatch, host_kernel, dtype, xs,
                                    groups, offset):
    """The quantize kernel's vector reads (8 bf16 or 4 f32 pixels of one
    channel where an image's pixels and x's alignment allow), grouped,
    and the scalar reads of an x one element into its storage, on the
    host build, against `quantize_channels_last_reference`."""
    dt = getattr(torch, dtype)
    rs = onp.random.RandomState(9)
    buf = torch.from_numpy((rs.randn(offset + math.prod(xs)) * 3).astype(
        onp.float32)).to(dt)
    x = buf[offset:].view(xs)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    want = tk.quantize_channels_last_reference(x, 0.05, groups)
    _kernel_route(monkeypatch, host_kernel)
    got = tk.int8_quantize(x, 0.05, groups)
    assert torch.equal(got, want) and tk.int8_quantize.launches == 1


def _emulated_conv(xq, w_packed, scale, bias, out, ws, geo, splits):
    """``csrc/int8_conv.cu``'s arithmetic in torch, with the arguments
    of `ops.int8_conv._conv_cuda`: output row m is pixel (nb, oz, oy,
    ox); its K is the 16-byte chunks kc of 128-byte stages, chunk
    kc tap kc // (Cp/16) (kd-major) and channels 16 (kc % (Cp/16)) on; a
    tap in the padding or a chunk past K reads zeros (a tiled tile's TMA
    box reads, for row (.., ox), input column ox * sw - pw + kx * dw:
    the same pixels, and the boxes cover every output pixel once); split
    s sums the stages [s nkb / S, (s+1) nkb / S) exactly (int64, each
    partial within s32) into ws[s], and the epilogue sums ws over s,
    then rounds f32(acc) * scale and + bias, writing NC[D]HW."""
    G, O, Cp = geo.groups, geo.o, geo.cp
    ng, cpc, cps = O // G, Cp // 16, tk._BK // 16
    ID, IH, IW = geo.qs
    OD, OH, OW = geo.outs
    _, KH, KW = geo.ks
    KC, nkb, M = geo.taps * cpc, geo.nkb, geo.m
    if geo.mode == "tiled":
        cover = _tiled_pixels(geo).reshape(-1)
        assert torch.equal(cover[cover >= 0].sort().values, torch.arange(M))
        assert Cp % tk._BK == 0
    osp = OD * OH * OW
    m = torch.arange(M)
    nb, sp = m // osp, m % osp
    ox, oy, oz = sp % OW, (sp // OW) % OH, sp // (OW * OH)
    kc = torch.arange(nkb * cps)
    tap, cc = kc // cpc, kc % cpc
    kz, ky, kx = tap // (KH * KW), (tap % (KH * KW)) // KW, tap % KW
    z = (oz * geo.st[0] - geo.pd[0])[:, None] + (kz * geo.dl[0])[None]
    y = (oy * geo.st[1] - geo.pd[1])[:, None] + (ky * geo.dl[1])[None]
    x = (ox * geo.st[2] - geo.pd[2])[:, None] + (kx * geo.dl[2])[None]
    ok = (kc < KC)[None] & (z >= 0) & (z < ID) & (y >= 0) & (y < IH) \
        & (x >= 0) & (x < IW)
    pix = torch.where(ok, nb[:, None] * (ID * IH * IW) + (z * IH + y) * IW
                      + x, 0)
    rows = xq.reshape(-1, G, cpc, 16).long()
    acc = torch.zeros(splits, O, M, dtype=torch.int64)
    bk = tk._BK
    for g in range(G):
        a = torch.where(ok[..., None], rows[pix, g, cc.clamp(max=cpc - 1)],
                        0).reshape(M, nkb * bk)
        wb = torch.zeros(ng, nkb * bk, dtype=torch.int64)
        wb[:, :KC * 16] = w_packed[g].reshape(ng, KC * 16).long()
        for s in range(splits):
            k0, k1 = s * nkb // splits * bk, (s + 1) * nkb // splits * bk
            assert k1 > k0
            acc[s, g * ng:(g + 1) * ng] = (a[:, k0:k1] @ wb[:, k0:k1].T).T
    assert acc.abs().max() < 2 ** 31
    if splits > 1:
        ws.copy_(acc.to(torch.int32))
        acc = ws.long()
    v = acc.sum(0).to(torch.int32).float() * scale[:, None]
    if bias is not None:
        v = v + bias[:, None]
    out.view(geo.n, O, osp).copy_(
        v.reshape(O, geo.n, osp).transpose(0, 1).to(out.dtype))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,ws,stride,pad,dil,groups,bias", KERNEL_CASES)
def test_gemm_emulation_gives_the_plain_bits(monkeypatch, host_kernel, dtype,
                                             xs, ws, stride, pad, dil, groups,
                                             bias, split):
    """`int8_conv` on the kernel route: the host build of the quantize
    kernel, then `_emulated_conv` in place of the GEMM's launch, over
    `pack_weight`'s layout, bit for bit against `int8_conv_reference`,
    in one split of K and in up to three (a case whose K is one
    128-byte stage has one); one launch of each kernel counted."""
    x, w_q, scale, act, b = _kernel_inputs(dtype, xs, ws, bias)
    want = tk.int8_conv_reference(x, w_q, scale, act, b, stride, pad, dil,
                                  groups)
    geo = tk._Geometry(xs, ws, stride, pad, dil, groups)
    splits = min(3, geo.nkb) if split else 1
    _kernel_route(monkeypatch, host_kernel)
    monkeypatch.setattr(tk._Geometry, "splits", lambda self, sms: splits)
    seen = []

    def conv(*args):
        seen.append(args[-1])
        assert (args[5] is None) == (splits == 1)
        _emulated_conv(*args)

    monkeypatch.setattr(tk, "_conv_cuda", conv)
    got = tk.int8_conv(x, w_q, scale, act, b, stride, pad, dil, groups)
    assert _same_bits(got, want)
    assert seen == [splits]
    assert tk.int8_quantize.launches == tk.int8_conv.launches == 1


def test_dense_runs_through_the_same_kernels(monkeypatch, host_kernel):
    """`int8_dense` on the kernel route (K = 40, 3 rows, 9 outputs, a
    bias) over weights packed by `QuantizedDense`'s rule, with a split:
    the plain bits, one quantize and one dense launch, no conv launch."""
    rs = onp.random.RandomState(3)
    x = torch.from_numpy((rs.randn(3, 40) * 3).astype(onp.float32))
    w_q = torch.from_numpy(rs.randint(-127, 128, (9, 40)).astype(onp.int8))
    scale = torch.from_numpy(rs.rand(9).astype(onp.float32) * 1e-2)
    b = torch.from_numpy(rs.randn(9).astype(onp.float32))
    want = tk.int8_conv_reference(x[:, :, None, None], w_q[:, :, None, None],
                                  scale, 0.05, b, (1, 1), (0, 0), (1, 1),
                                  1).reshape(3, 9)
    packed = tk.pack_weight(w_q[:, :, None, None])
    assert tuple(packed.shape) == (1, 9, 1, 48)
    _kernel_route(monkeypatch, host_kernel)
    monkeypatch.setattr(tk, "_conv_cuda", _emulated_conv)
    got = tk.int8_dense(x, w_q, scale, 0.05, b, w_packed=packed)
    assert _same_bits(got, want)
    assert (tk.int8_quantize.launches, tk.int8_dense.launches,
            tk.int8_conv.launches) == (1, 1, 0)


def test_buffer_modes_of_the_cases():
    """Which buffer each kernel case's convolution reads: the kernels
    over 2-4 channels a group (the stem's shape, grouped, 1-D, 3-D) fold
    their width taps into the channels, the strided 1x1 subsamples, the
    other 1x1s and the 3x3 over 64 channels read the input as it is; the
    folded reference holds, at an output column, its input columns'
    channels in (kx, c) order.  And how the GEMM loads each case's A:
    the buffer's rows by TMA (the 1x1s, and the 1-D case, whose fold
    leaves a 1-wide kernel), one tap's TMA box (the 3x3 over 128), 16-byte
    gathers (the rest: Cp below 128)."""
    modes = []
    for xs, ws, stride, pad, dil, groups, _ in KERNEL_CASES:
        sub, fold = tk._Geometry(xs, ws, stride, pad, dil,
                                 groups).quant_args()
        modes.append("fold" if fold else "sub" if sub else "plain")
    assert modes == ["fold", "plain", "fold", "fold", "fold", "plain",
                     "sub", "plain", "plain"]
    gemm = [tk._Geometry(*c[:6]).mode for c in KERNEL_CASES]
    assert gemm == ["gather", "dense", "gather", "dense", "gather", "dense",
                    "dense", "gather", "tiled"]
    x = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(1, 2, 3, 5)
    q = tk.quantize_channels_last_reference(x, 1.0, 1, None, (3, 2, 1, 1))
    assert tuple(q.shape) == (1, 3, 3, 1, 16)
    # row 0, output column 1: input columns 1, 2, 3 of channels 0 and 1
    assert q[0, 0, 1, 0, :6].tolist() == [1, 16, 2, 17, 3, 18]
    # output column 0: input column -1 is padding
    assert q[0, 0, 0, 0, :6].tolist() == [0, 0, 0, 15, 1, 16]


@pytest.mark.parametrize("xs,ws,stride,pad", [
    ((3, 128, 28, 28), (128, 128, 3, 3), (1, 1), (1, 1)),
    ((2, 256, 14, 14), (256, 256, 3, 3), (1, 1), (1, 1)),
    ((1, 512, 7, 7), (512, 512, 3, 3), (1, 1), (1, 1)),
    ((2, 256, 57, 9), (64, 256, 3, 3), (2, 2), (1, 1)),
    ((2, 128, 9, 10, 11), (8, 128, 3, 3, 3), (1, 2, 2), (1, 1, 1)),
])
def test_tiled_boxes_cover_resnet_outputs(xs, ws, stride, pad):
    """ResNet-50's 3x3 layers over 128-512 channels (and a strided, a
    ragged and a 3-D case) load A by one tap's TMA box; the boxes of 128
    pixels, powers of two in (w, h, d, n), cover every output pixel
    once, and each stage is one tap's 128 channel bytes."""
    geo = tk._Geometry(xs, ws, stride, pad, (1,) * len(stride), 1)
    assert geo.mode == "tiled" and geo.cp % tk._BK == 0
    assert math.prod(geo.box) == _BM
    cover = _tiled_pixels(geo).reshape(-1)
    assert torch.equal(cover[cover >= 0].sort().values,
                       torch.arange(geo.m))
    assert geo.nkb == geo.taps * geo.cp // tk._BK


def test_splits_fill_the_card_only_where_tiles_are_few():
    """The split of K at ResNet-50 v1's shapes on 132 SMs: none at
    B=256 (the tiles fill the card), several for the deep layers at B=1
    and the Dense, each split at least two 128-byte stages."""
    deep = tk._Geometry((1, 512, 7, 7), (512, 512, 3, 3), (1, 1), (1, 1),
                        (1, 1), 1)
    wide = tk._Geometry((256, 64, 56, 56), (64, 64, 3, 3), (1, 1), (1, 1),
                        (1, 1), 1)
    dense = tk._Geometry((1, 2048, 1, 1), (1000, 2048, 1, 1), (1, 1),
                         (0, 0), (1, 1), 1)
    assert wide.splits(132) == 1
    for geo in (deep, dense):
        s = geo.splits(132)
        assert 1 < s and 2 * s <= geo.nkb
    assert (deep.bn, dense.bn, wide.bn) == (256, 256, 64)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """On the kernel route the wrapper raises on a float16 x, float
    weights, a channel count the groups do not divide, an f64 scale, and
    packed weights of another shape or type than `pack_weight`'s;
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
    good = tk.pack_weight(w)
    assert tuple(good.shape) == (1, 6, 3, 16)         # width folded in
    unfolded = torch.zeros(1, 6, 9, 16, dtype=torch.int8)
    for packed in (good[:, :, :, :4].contiguous(), good[:, :5].contiguous(),
                   good.reshape(1, 6, 1, 48), unfolded, good.float()):
        with pytest.raises(MXNetError, match="packed weights"):
            tk.int8_conv(x, w, s, 0.1, None, (1, 1), (0, 0), (1, 1), 1,
                         w_packed=packed)
