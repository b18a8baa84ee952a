"""Paged attention of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/ops/paged_attention.py`) held against the
JAX package's.

The same numpy inputs (made from a seed) go through the port's plain
version and through the JAX dense recipe and the JAX Pallas kernel in
interpret mode: f32 within 2e-5, bf16 within 2e-2 (the tolerances of
tests/test_paged_attention.py).  The port's version keeps the two facts
the engine's eviction contract rests on: masked slots contribute
exactly 0.0 and lanes never mix — both checked bitwise.  The int8
pages (`quantize_kv` of the same pools in both packages, f32 scales per
(block, head, slot)) go through the port's plain version and the JAX
dense recipe and interpret-mode Pallas kernel with scales, within 2e-5
(the tolerance of tests/test_paged_attention.py's int8 case); masked
int8 slots with NaN scales contribute exactly 0.0.  The CUDA kernels
themselves are held to the plain version on the card by chip_smoke.py.
"""
import importlib

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu_torch import MXNetError

from incubator_mxnet_tpu.contrib.quantization import quantize_kv as jax_qkv
from incubator_mxnet_tpu_torch.contrib.quantization import quantize_kv

# the packages' ops/__init__ re-export functions of the modules' names
jpa = importlib.import_module("incubator_mxnet_tpu.ops.paged_attention")
tpa = importlib.import_module("incubator_mxnet_tpu_torch.ops.paged_attention")

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _case(seed, B=3, H=2, D=16, bs=8, nbps=4):
    """Random pool, permuted tables, ragged positions: lane 0 one token,
    lane 1 mid-block, lane 2 pool-full (numpy f32 / int32)."""
    rs = onp.random.RandomState(seed)
    nblocks = B * nbps + 3      # spare blocks hold garbage the walk skips
    pool_k = rs.randn(nblocks, H, bs, D).astype(onp.float32)
    pool_v = rs.randn(nblocks, H, bs, D).astype(onp.float32)
    q = rs.randn(B, H, D).astype(onp.float32)
    tables = rs.permutation(B * nbps).astype(onp.int32).reshape(B, nbps)
    pos = onp.array([0, bs + 3, bs * nbps - 1] * B, onp.int32)[:B]
    return q, pool_k, pool_v, tables, pos


def _torch(arrs, dtype):
    q, pk, pv, tables, pos = arrs
    dt = getattr(torch, dtype)
    return (torch.from_numpy(q).to(dt), torch.from_numpy(pk).to(dt),
            torch.from_numpy(pv).to(dt), torch.from_numpy(tables),
            torch.from_numpy(pos))


def _jax(arrs, dtype):
    q, pk, pv, tables, pos = arrs
    dt = getattr(jnp, dtype)
    return (jnp.asarray(q).astype(dt), jnp.asarray(pk).astype(dt),
            jnp.asarray(pv).astype(dt), jnp.asarray(tables),
            jnp.asarray(pos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_impl", ["dense", "pallas"])
@pytest.mark.parametrize("shape", [dict(), dict(B=4, H=4, D=32, bs=4,
                                                nbps=5)])
def test_plain_version_matches_jax(dtype, jax_impl, shape):
    arrs = _case(0, **shape)
    got = tpa.paged_attention(*_torch(arrs, dtype))
    kw = {"interpret": True} if jax_impl == "pallas" else {}
    ref = jpa.paged_attention(*_jax(arrs, dtype), impl=jax_impl, **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == ref.shape
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(ref, onp.float32),
                                atol=TOL[dtype])


def test_masked_slots_contribute_exactly_zero():
    q, pk, pv, tables, pos = _torch(_case(1), "float32")
    out = tpa.paged_attention(q, pk, pv, tables, pos)
    bs = pk.shape[2]
    slot = torch.arange(tables.shape[1] * bs)
    masked = slot[None, :] > pos[:, None].long()
    blk = tables.long()[:, slot // bs][masked]
    off = (slot % bs)[None, :].expand_as(masked)[masked]
    pk2, pv2 = pk.clone(), pv.clone()
    pk2[blk, :, off] = 1e4          # finite garbage past every lane's pos
    pv2[blk, :, off] = -3e4
    assert torch.equal(tpa.paged_attention(q, pk2, pv2, tables, pos), out)


def test_lanes_never_mix():
    q, pk, pv, tables, pos = _torch(_case(2, B=4), "float32")
    out = tpa.paged_attention(q, pk, pv, tables, pos)
    for b in range(q.shape[0]):
        solo = tpa.paged_attention(q[b:b + 1], pk, pv, tables[b:b + 1],
                                   pos[b:b + 1])
        assert torch.equal(solo[0], out[b])


def _int8(arrs, dtype):
    """The port's int8 pools of a case: `quantize_kv` of its f32 pools,
    with q in ``dtype`` (q, pk8, pv8, sk, sv, tables, pos)."""
    q, pk, pv, tables, pos = _torch(arrs, "float32")
    pk8, sk = quantize_kv(pk)
    pv8, sv = quantize_kv(pv)
    return q.to(getattr(torch, dtype)), pk8, pv8, sk, sv, tables, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_impl", ["dense", "pallas"])
@pytest.mark.parametrize("shape", [dict(), dict(B=4, H=4, D=32, bs=4,
                                                nbps=5)])
def test_int8_plain_version_matches_jax(dtype, jax_impl, shape):
    arrs = _case(5, **shape)
    q, pk8, pv8, sk, sv, tables, pos = _int8(arrs, dtype)
    jq, jpk, jpv, jtables, jpos = _jax(arrs, "float32")
    jk8, jsk = jax_qkv(jpk)
    jv8, jsv = jax_qkv(jpv)
    # both packages store the same int8 pages and scales
    assert onp.array_equal(pk8.numpy(), onp.asarray(jk8))
    assert onp.array_equal(sv.numpy(), onp.asarray(jsv))
    got = tpa.paged_attention(q, pk8, pv8, tables, pos, scale_k=sk,
                              scale_v=sv)
    kw = {"interpret": True} if jax_impl == "pallas" else {}
    ref = jpa.paged_attention(jq.astype(getattr(jnp, dtype)), jk8, jv8,
                              jtables, jpos, scale_k=jsk, scale_v=jsv,
                              impl=jax_impl, **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == ref.shape
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(ref, onp.float32),
                                atol=2e-5 if dtype == "float32"
                                else TOL[dtype])
    # the q8 wrapper is the same function
    assert torch.equal(tpa.paged_attention_q8(q, pk8, pv8, sk, sv, tables,
                                              pos), got)


def test_int8_masked_slots_contribute_exactly_zero():
    """Masked slots with random int8 values, NaN scales on K and 1e30 on
    V, give the same bits as zeros there.  (A NaN V scale would reach
    the plain version's PV product as p = 0 times NaN, as it would the
    JAX dense recipe's; the kernel never loads a masked slot's scale,
    which chip_smoke.py checks with NaN on both.)"""
    q, pk8, pv8, sk, sv, tables, pos = _int8(_case(6), "float32")
    bs = pk8.shape[2]
    slot = torch.arange(tables.shape[1] * bs)
    masked = slot[None, :] > pos[:, None].long()
    blk = tables.long()[:, slot // bs][masked]
    off = (slot % bs)[None, :].expand_as(masked)[masked]

    def filled(page_val, sk_val, sv_val):
        k8, v8, k_s, v_s = pk8.clone(), pv8.clone(), sk.clone(), sv.clone()
        k8[blk, :, off] = page_val
        v8[blk, :, off] = page_val
        k_s[blk, :, off] = sk_val
        v_s[blk, :, off] = sv_val
        return tpa.paged_attention(q, k8, v8, tables, pos, scale_k=k_s,
                                   scale_v=v_s)

    zero = filled(0, 0.0, 0.0)
    noise = torch.from_numpy(onp.random.RandomState(7).randint(
        -127, 128, (int(masked.sum()), pk8.shape[1], pk8.shape[3]))
        .astype(onp.int8))
    junk = filled(noise, float("nan"), 1e30)
    assert torch.isfinite(zero).all()
    assert torch.equal(junk, zero)


def test_int8_lanes_never_mix():
    q, pk8, pv8, sk, sv, tables, pos = _int8(_case(8, B=4), "float32")
    out = tpa.paged_attention(q, pk8, pv8, tables, pos, scale_k=sk,
                              scale_v=sv)
    for b in range(q.shape[0]):
        solo = tpa.paged_attention(q[b:b + 1], pk8, pv8, tables[b:b + 1],
                                   pos[b:b + 1], scale_k=sk, scale_v=sv)
        assert torch.equal(solo[0], out[b])


def test_impl_validation():
    q, pk, pv, tables, pos = _torch(_case(3, B=1, nbps=1), "float32")
    with pytest.raises(ValueError):
        tpa.paged_attention(q, pk, pv, tables, pos, impl="banana")
    # CPU tensors take the plain version; naming the kernel there raises
    with pytest.raises(MXNetError):
        tpa.paged_attention(q, pk, pv, tables, pos, impl="kernel")
    assert torch.equal(
        tpa.paged_attention(q, pk, pv, tables, pos, impl="dense"),
        tpa.paged_attention_dense(q, pk, pv, tables, pos))
    # int8 pools run (plain version here) and need both scales
    pk8, sk = quantize_kv(pk)
    pv8, sv = quantize_kv(pv)
    assert torch.equal(
        tpa.paged_attention(q, pk8, pv8, tables, pos, scale_k=sk,
                            scale_v=sv, impl="dense"),
        tpa.paged_attention_dense(q, pk8, pv8, tables, pos, sk, sv))
    with pytest.raises(MXNetError):
        tpa.paged_attention(q, pk8, pv8, tables, pos, scale_k=sk)
    with pytest.raises(MXNetError):
        tpa.paged_attention(q, pk8, pv8, tables, pos, scale_k=sk,
                            scale_v=sv, impl="kernel")
    # nothing launched on CPU
    assert tpa.paged_attention.launches == 0
    assert tpa.paged_attention_q8.launches == 0


@pytest.mark.parametrize("bad", ["head_dim", "block_size", "dtype",
                                 "index_dtype", "shape", "contiguity"])
def test_kernel_argument_checks(bad):
    """The checks the wrapper makes before it hands pointers to the
    kernel (they run on any device; the launch itself needs the card)."""
    q, pk, pv, tables, pos = _torch(_case(4), "float32")
    tpa._check(q, pk, pv, tables, pos)          # the good case passes
    if bad == "head_dim":
        q, pk, pv = q[..., :12], pk[..., :12], pv[..., :12]
    elif bad == "block_size":
        pk, pv = pk[:, :, :6].contiguous(), pv[:, :, :6].contiguous()
    elif bad == "dtype":
        pk = pk.double()
    elif bad == "index_dtype":
        tables = tables.long()
    elif bad == "shape":
        pos = pos[:2]
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(MXNetError):
        tpa._check(q.contiguous() if bad == "head_dim" else q,
                   pk.contiguous(), pv.contiguous(), tables, pos)


@pytest.mark.parametrize("bad", ["page_dtype", "scale_dtype", "scale_shape",
                                 "scale_contiguity", "scale_device"])
def test_int8_kernel_argument_checks(bad):
    """The int8 layouts the wrapper checks before the launch: pages int8
    (num_blocks, H, bs, D), scales f32 contiguous (num_blocks, H, bs)."""
    q, pk, pv, tables, pos = _torch(_case(9), "float32")
    pk8, sk = quantize_kv(pk)
    pv8, sv = quantize_kv(pv)
    tpa._check(q, pk8, pv8, tables, pos, sk, sv)  # the good case passes
    if bad == "page_dtype":
        pk8 = pk8.to(torch.uint8)
    elif bad == "scale_dtype":
        sv = sv.double()
    elif bad == "scale_shape":
        sk = sk[:, :, :-1].contiguous()
    elif bad == "scale_contiguity":
        sk = sk.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        sv = sv.to("meta")
    with pytest.raises(MXNetError):
        tpa._check(q, pk8, pv8, tables, pos, sk, sv)
    # float pages are refused where scales are given, and int8 without
    with pytest.raises(MXNetError):
        tpa._check(q, pk, pv, tables, pos, *quantize_kv(pk)[1:],
                   *quantize_kv(pv)[1:])
    with pytest.raises(MXNetError):
        tpa._check(q, *quantize_kv(pk)[:1], *quantize_kv(pv)[:1], tables,
                   pos)
