"""Dropout of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/ops/dropout_kernel.py`, `nd.Dropout`,
`nd.DropoutAdd`) held against its contract and the JAX package.

The port's keep-mask is Philox4x32-10 keyed by the seed with the
counter at element // 4; its plain version is checked here against the
published Random123 known-answer vectors, and for the mask's
statistics and invariants (keep fraction within 4 sigma, same seed same
mask, independence of dtype and shape, prefix property for odd sizes).
The JAX package draws other bits (threefry here, the TPU's PRNG on
the chip), so its apply and gradient are compared with the port's on
the mask that JAX draws, injected into the port (f32, atol 1e-6).

The CUDA route (`_DropoutApply` over the fused forward and backward
entry points) is held here to the CPU composition bit for bit: through
the entry points' plain versions, and through ``csrc/dropout.cu``
itself compiled for the host (a stand-in for the CUDA runtime that runs
the launch's threads one after another) wherever a C++ compiler is
found.  The kernels on the card are held to the plain versions bit for
bit by chip_smoke.py.
"""
import ctypes
import importlib
import math
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import MXNetError, autograd, nd

jdk = importlib.import_module("incubator_mxnet_tpu.ops.dropout_kernel")
tdk = importlib.import_module("incubator_mxnet_tpu_torch.ops.dropout_kernel")

# Random123 kat_vectors, philox4x32 with 10 rounds: counter, key, output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_plain_philox_matches_known_answers(ctr, key, want):
    words = tdk.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w) for w in words) == want


def test_mask_words_are_philox_of_element_index():
    seed = (0x299f31d0 << 32) | 0xa4093822
    ctr = torch.arange(3, dtype=torch.int64)
    zero = torch.zeros_like(ctr)
    words = torch.stack(tdk.philox4x32_10((ctr, zero, zero, zero),
                                          (0xa4093822, 0x299f31d0)), 1)
    m = tdk.mask_reference(12, seed, 0.5)
    assert torch.equal(m, (words.reshape(-1) >= 1 << 31).to(torch.uint8))


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_keep_fraction_within_four_sigma(rate):
    n = 1 << 18
    keep = tdk.mask_reference(n, 1234, rate).double().mean().item()
    assert abs(keep - (1 - rate)) <= 4 * math.sqrt(rate * (1 - rate) / n)


def test_same_seed_same_mask_other_seed_differs():
    x = torch.zeros((64, 48))
    a = tdk.dropout_mask(x, 7, 0.3)
    assert a.shape == x.shape and a.dtype == torch.uint8
    assert torch.equal(tdk.dropout_mask(x, 7, 0.3), a)
    assert not torch.equal(tdk.dropout_mask(x, 8, 0.3), a)


def test_mask_depends_on_numel_not_dtype_or_shape():
    a = tdk.dropout_mask(torch.zeros((8, 24)), 5, 0.2)
    b = tdk.dropout_mask(torch.zeros((4, 6, 8), dtype=torch.bfloat16), 5, 0.2)
    assert torch.equal(a.reshape(-1), b.reshape(-1))


@pytest.mark.parametrize("n", [1, 3, 5, 4099])
def test_odd_numel_is_a_prefix_of_the_longer_mask(n):
    full = tdk.mask_reference(n + 17, 11, 0.4)
    assert torch.equal(tdk.mask_reference(n, 11, 0.4), full[:n])


def test_degenerate_rates_draw_no_mask(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a mask was drawn")

    monkeypatch.setattr(tdk, "mask_reference", refuse)
    x = torch.randn(5, 7)
    assert tdk.fused_dropout(x, 1, 0.0) is x
    assert torch.equal(tdk.fused_dropout(x, 1, 1.0), torch.zeros_like(x))
    empty = torch.zeros((0, 3))
    assert tdk.fused_dropout(empty, 1, 0.5) is empty
    assert torch.equal(tdk.fused_dropout_add(x, x, 1, 1.0), x)


def test_forward_and_backward_share_one_mask():
    x = torch.randn(32, 40, requires_grad=True)
    y = tdk.fused_dropout(x, 3, 0.25)
    w = torch.randn(32, 40)
    (y * w).sum().backward()
    kept = tdk.dropout_mask(x, 3, 0.25).bool()
    scale = 1.0 / 0.75
    assert torch.equal(y == 0, ~kept | (x == 0))
    torch.testing.assert_close(x.grad, torch.where(kept, w * scale, 0.0),
                               atol=1e-6, rtol=0)


def _inputs(shape, seed):
    rs = onp.random.RandomState(seed)
    return (rs.randn(*shape).astype(onp.float32),
            rs.randn(*shape).astype(onp.float32),
            rs.randn(*shape).astype(onp.float32))


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("with_residual", [False, True])
def test_apply_and_grad_match_jax_on_its_mask(monkeypatch, rate,
                                              with_residual):
    x, res, w = _inputs((6, 200), int(rate * 10) + with_residual)
    seed = jnp.asarray([17], jnp.int32)
    jmask = onp.asarray(jdk.dropout_mask(jnp.asarray(x), seed, rate))

    def jf(xx, rr):
        y = jdk.fused_dropout_add(xx, rr, seed, rate) if with_residual \
            else jdk.fused_dropout(xx, seed, rate)
        return jnp.sum(y * jnp.asarray(w)), y

    (_, jy), (jgx, jgr) = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x), jnp.asarray(res))
    monkeypatch.setattr(tdk, "dropout_mask",
                        lambda t, s, r: torch.from_numpy(jmask))
    tx = torch.from_numpy(x).requires_grad_()
    tr = torch.from_numpy(res).requires_grad_()
    ty = tdk.fused_dropout_add(tx, tr, 0, rate) if with_residual \
        else tdk.fused_dropout(tx, 0, rate)
    (ty * torch.from_numpy(w)).sum().backward()
    onp.testing.assert_allclose(ty.detach().numpy(), onp.asarray(jy),
                                atol=1e-6)
    onp.testing.assert_allclose(tx.grad.numpy(), onp.asarray(jgx), atol=1e-6)
    if with_residual:
        onp.testing.assert_allclose(tr.grad.numpy(), onp.asarray(jgr),
                                    atol=1e-6)


def test_nd_dropout_follows_autograd_train_mode():
    x = torch.ones(64, 64)
    assert nd.Dropout(x, p=0.5) is x                 # not recording
    with autograd.record():
        y = nd.Dropout(x, p=0.5)
        with autograd.predict_mode():
            assert nd.Dropout(x, p=0.5) is x
    assert 0 < int((y == 0).sum()) < x.numel()
    with autograd.train_mode():
        assert not torch.equal(nd.Dropout(x, p=0.5), x)
    torch.testing.assert_close(nd.DropoutAdd(x, x, p=0.5), 2 * x)


def test_layer_ignores_module_training_flag():
    layer = mxt.gluon.nn.Dropout(0.5)
    layer.eval()
    x = torch.ones(32, 32)
    with autograd.record():
        assert not torch.equal(layer(x), x)
    layer.train()
    assert torch.equal(layer(x), x)


def test_seed_replays_the_same_masks():
    x = torch.ones(16, 16)

    def draw():
        mxt.random.seed(5, device="cpu")
        with autograd.train_mode():
            return [nd.Dropout(x, p=0.3), nd.DropoutAdd(x, x, p=0.3)]

    a, b = draw(), draw()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], a[1] - x)           # fresh seed per call


def test_dropout_axes_is_not_ported():
    with pytest.raises(MXNetError):
        nd.Dropout(torch.ones(2, 3), p=0.5, axes=(0,))



# ---- the fused route: one forward and one backward pass a site ----
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bits(t):
    """The tensor's bit patterns (tells -0.0 from +0.0)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _site_inputs(shape, dtype, seed):
    rs = onp.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randn(*shape).astype(onp.float32))
                 .to(dtype) for _ in range(3))


def _composition(x, res, dy, seed, rate):
    """y, dx, dres of the CPU route: the mask, the torch apply and add,
    autograd's backward."""
    xr = x.detach().clone().requires_grad_()
    rr = None if res is None else res.detach().clone().requires_grad_()
    y = tdk.fused_dropout(xr, seed, rate) if rr is None \
        else tdk.fused_dropout_add(xr, rr, seed, rate)
    y.backward(dy)
    return y.detach(), xr.grad, None if rr is None else rr.grad


def _function(x, res, dy, seed, rate):
    """y, dx, dres through `_DropoutApply`."""
    xr = x.detach().clone().requires_grad_()
    rr = None if res is None else res.detach().clone().requires_grad_()
    y = tdk._DropoutApply.apply(xr, rr, seed, rate)
    y.backward(dy)
    return y.detach(), xr.grad, None if rr is None else rr.grad


def _assert_same_bits(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_function_plain_path_matches_composition(dtype, with_residual, rate):
    x, res, dy = _site_inputs((24, 100), DTYPES[dtype], 3)
    res = res if with_residual else None
    _assert_same_bits(_function(x, res, dy, 41, rate),
                      _composition(x, res, dy, 41, rate))


def _special_inputs(dtype, seed, rate, n=4096):
    """x with NaN, +Inf and -Inf on dropped elements, a residual of
    -0.0 on dropped and on some kept elements, dy with NaN on dropped
    elements; returns them with the mask."""
    x, res, dy = _site_inputs((n,), dtype, 7)
    keep = tdk.mask_reference(n, seed, rate).bool()
    drop = (~keep).nonzero().flatten()
    x[drop[0::3]] = float("nan")
    x[drop[1::3]] = float("inf")
    x[drop[2::3]] = -float("inf")
    res[drop] = -0.0
    res[keep.nonzero().flatten()[:9]] = -0.0
    dy[drop[::2]] = float("nan")
    return x, res, dy, keep


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dropped_nonfinite_and_signed_zero_values(dtype):
    seed, rate = 5, 0.5
    x, res, dy, keep = _special_inputs(DTYPES[dtype], seed, rate)
    drop = ~keep
    for route in (_function, _composition):
        y, dx, dres = route(x, res, dy, seed, rate)
        # a dropped element is res + 0: -0.0 + 0.0 is +0.0, never NaN
        assert torch.equal(_bits(y[drop]), _bits(torch.zeros_like(y[drop])))
        assert torch.equal(dx[drop], torch.zeros_like(dx[drop]))
        assert not torch.signbit(dx[drop]).any()
        assert torch.equal(_bits(dres), _bits(dy))
        y, dx, _ = route(x, None, dy, seed, rate)
        assert torch.equal(_bits(y[drop]), _bits(torch.zeros_like(y[drop])))
    _assert_same_bits(_function(x, res, dy, seed, rate),
                      _composition(x, res, dy, seed, rate))


def _refuse(*args, **kw):
    raise AssertionError("a kernel was launched or a mask drawn")


def test_degenerate_rates_launch_nothing_on_the_kernel_route(monkeypatch):
    monkeypatch.setattr(tdk, "_on_cuda", lambda t: True)
    for name in ("_mask_cuda", "_fwd_cuda", "_bwd_cuda", "mask_reference"):
        monkeypatch.setattr(tdk, name, _refuse)
    x = torch.randn(5, 7)
    assert tdk.fused_dropout(x, 1, 0.0) is x
    assert torch.equal(tdk.fused_dropout(x, 1, 1.0), torch.zeros_like(x))
    assert torch.equal(tdk.fused_dropout_add(x, x, 1, 0.0), 2 * x)
    assert torch.equal(tdk.fused_dropout_add(x, x, 1, 1.0), x)
    empty = torch.zeros((0, 3))
    assert tdk.fused_dropout(empty, 1, 0.5) is empty


def test_kernel_route_launches_forward_and_backward_once_a_site(monkeypatch):
    """On the kernel route a `DropoutAdd` site is one forward launch and
    one backward launch, never the mask-only kernel nor the CPU
    route's mask and torch apply."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(x, res, seed, rate):
        calls["fwd"] += 1
        return tdk.dropout_fwd_reference(x, res, seed, rate)

    def bwd(dy, mask, rate):
        calls["bwd"] += 1
        return tdk.dropout_bwd_reference(dy, mask, rate)

    x, res, dy = _site_inputs((8, 64), torch.float32, 9)
    want = _composition(x, res, dy, 13, 0.3)
    monkeypatch.setattr(tdk, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tdk, "_fwd_cuda", fwd)
    monkeypatch.setattr(tdk, "_bwd_cuda", bwd)
    monkeypatch.setattr(tdk, "_mask_cuda", _refuse)
    monkeypatch.setattr(tdk, "dropout_mask", _refuse)
    got = _composition(x, res, dy, 13, 0.3)
    assert calls == {"fwd": 1, "bwd": 1}
    _assert_same_bits(got, want)
    xr = x.clone().requires_grad_()
    with autograd.record():
        y = nd.DropoutAdd(xr, res, p=0.3)
    y.backward(dy)
    assert calls == {"fwd": 2, "bwd": 2}


@pytest.mark.parametrize("case", ["float16", "shape", "dtype", "device"])
def test_kernel_wrappers_refuse_what_the_kernel_does_not_take(monkeypatch,
                                                              case):
    monkeypatch.setattr(tdk._build, "load", _refuse)
    x = torch.zeros((4, 8))
    res = {"float16": x, "shape": torch.zeros((4, 7)),
           "dtype": x.to(torch.bfloat16), "device": x.to("meta")}[case]
    if case == "float16":
        x = x.half()
        res = x
    with pytest.raises(MXNetError):
        tdk._fwd_cuda(x, res, 1, 0.5)
    if case in ("float16", "shape"):
        with pytest.raises(MXNetError):
            tdk._bwd_cuda(x, torch.ones(res.shape, dtype=torch.uint8)
                          if case == "shape" else res.to(torch.uint8), 0.5)


# csrc/dropout.cu compiled for the host: the CUDA runtime's types and
# intrinsics stood in for, every thread of a launch run in turn (the
# kernel has no barriers and no shared memory)
_SHIM_RUNTIME = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
struct Dim { unsigned x, y, z; };
inline thread_local Dim blockIdx, threadIdx, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 3; return 0;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, F, int,
                                                          int) {
  *v = 2; return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
template <class K, class... A>
void shim_run(unsigned blocks, int threads, K kernel, A... args) {
  gridDim = {blocks, 1, 1};
  for (unsigned b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx = {b, 0, 0};
      threadIdx = {static_cast<unsigned>(t), 0, 0};
      kernel(args...);
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
def host_kernel(tmp_path_factory):
    """``csrc/dropout.cu`` built for the host as a ctypes library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build csrc/dropout.cu for the host")
    src = open(os.path.join(os.path.dirname(tdk.__file__), os.pardir,
                            "csrc", "dropout.cu")).read()
    src, n = re.subn(r"(\w+<[^<>]*>)<<<([^,]+),\s*([^,]+),.*?>>>\(",
                     r"shim_run(\2, \3, \1, ", src, flags=re.S)
    assert n == 1, "one launch expected in csrc/dropout.cu"
    out = tmp_path_factory.mktemp("dropout_host")
    (out / "cuda_runtime.h").write_text(_SHIM_RUNTIME)
    (out / "cuda_bf16.h").write_text(_SHIM_BF16)
    (out / "dropout.cpp").write_text(src)
    lib = out / "libdropout.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(out), "-o", str(lib),
                    str(out / "dropout.cpp")], check=True, timeout=240)
    return ctypes.CDLL(str(lib))


@pytest.fixture
def kernel_route(monkeypatch, host_kernel):
    """Route CPU tensors through the kernel wrappers onto the host
    build of the kernel."""
    monkeypatch.setattr(tdk._build, "load", lambda name: host_kernel)
    monkeypatch.setattr(tdk._build, "stream", lambda device: None)
    monkeypatch.setattr(tdk, "_on_cuda", lambda t: True)


# (numel, rate, leading elements cut off the buffer): a grid-stride walk
# of several steps, ragged tails, and views that start off the 16-byte
# grid (the scalar path)
HOST_CASES = [(70000, 0.1, 0), (70000, 0.5, 0), (3003, 0.3, 0), (17, 0.3, 0),
              (7, 0.3, 0), (1, 0.3, 0), (5000, 0.5, 1), (5000, 0.5, 3)]


@pytest.mark.parametrize("numel,rate,offset", HOST_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_source_gives_the_plain_bits(kernel_route, dtype, numel, rate,
                                            offset):
    dt = DTYPES[dtype]
    rs = onp.random.RandomState(numel + offset)
    bufs = [torch.from_numpy(rs.randn(numel + offset).astype(onp.float32))
            .to(dt) for _ in range(3)]
    x, res, dy = (b[offset:] for b in bufs)
    seed = 1234567891234
    n0 = (tdk.dropout_mask.launches, tdk.dropout_fwd.launches,
          tdk.dropout_bwd.launches)
    assert torch.equal(tdk.dropout_mask(x, seed, rate),
                       tdk.mask_reference(numel, seed, rate))
    for r in (None, res):
        y, mask = tdk.dropout_fwd(x, r, seed, rate)
        ref_y, ref_mask = tdk.dropout_fwd_reference(x, r, seed, rate)
        assert torch.equal(mask, ref_mask)
        assert torch.equal(_bits(y), _bits(ref_y))
        assert torch.equal(_bits(tdk.dropout_bwd(dy, mask, rate)),
                           _bits(tdk.dropout_bwd_reference(dy, mask, rate)))
    assert (tdk.dropout_mask.launches, tdk.dropout_fwd.launches,
            tdk.dropout_bwd.launches) == (n0[0] + 1, n0[1] + 2, n0[2] + 2)


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_source_through_the_function(monkeypatch, host_kernel, dtype,
                                            with_residual):
    """`fused_dropout(_add)` on the kernel route, on the host build of
    the kernel, against the CPU composition: the same y, dx and dres
    bits, also for a transposed (non-contiguous) x and for NaN, Inf and
    -0.0 on dropped elements."""
    dt = DTYPES[dtype]
    x, res, dy = _site_inputs((48, 40), dt, 21)
    sx, sres, sdy, _ = _special_inputs(dt, 5, 0.5)
    cases = [(x, res, dy, 3, 0.1), (x.t(), res.t(), dy.t(), 4, 0.5),
             (sx, sres, sdy, 5, 0.5)]
    want = [_composition(a, r if with_residual else None, g, s, p)
            for a, r, g, s, p in cases]
    monkeypatch.setattr(tdk._build, "load", lambda name: host_kernel)
    monkeypatch.setattr(tdk._build, "stream", lambda device: None)
    monkeypatch.setattr(tdk, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tdk, "mask_reference", _refuse)
    for (a, r, g, s, p), w in zip(cases, want):
        _assert_same_bits(
            _composition(a, r if with_residual else None, g, s, p), w)


@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_source_bf16_x_with_f32_residual(monkeypatch, host_kernel,
                                               offset):
    """The bf16 `Transformer`'s residual stream: a bf16 sublayer output
    added to an f32 residual (the JAX package's type promotion).  On the
    host build of the kernel, through `fused_dropout_add`'s Function, y
    (f32), dx (bf16) and dres (f32) have the bits of the CPU
    composition, which rounds x * scale to bf16 before the f32 add; also
    on views one element into their buffers (the scalar path)."""
    n = 48 * 40
    rs = onp.random.RandomState(31)
    bufs = [torch.from_numpy(rs.randn(n + offset).astype(onp.float32))
            for _ in range(3)]
    x = bufs[0].to(torch.bfloat16)[offset:].view(48, 40)
    res, dy = (b[offset:].view(48, 40) for b in bufs[1:])
    want = _composition(x, res, dy, 3, 0.1)
    assert (want[0].dtype, want[1].dtype, want[2].dtype) == (
        torch.float32, torch.bfloat16, torch.float32)
    monkeypatch.setattr(tdk._build, "load", lambda name: host_kernel)
    monkeypatch.setattr(tdk._build, "stream", lambda device: None)
    monkeypatch.setattr(tdk, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tdk, "mask_reference", _refuse)
    monkeypatch.setattr(tdk.dropout_fwd, "launches", 0)
    monkeypatch.setattr(tdk.dropout_bwd, "launches", 0)
    _assert_same_bits(_composition(x, res, dy, 3, 0.1), want)
    assert (tdk.dropout_fwd.launches, tdk.dropout_bwd.launches) == (1, 1)
