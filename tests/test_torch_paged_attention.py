"""Paged attention of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/ops/paged_attention.py`) held against the
JAX package's.

The same numpy inputs (made from a seed) go through the port's plain
version and through the JAX dense recipe and the JAX Pallas kernel in
interpret mode: f32 within 2e-5, bf16 within 2e-2 (the tolerances of
tests/test_paged_attention.py).  The port's version keeps the two facts
the engine's eviction contract rests on: masked slots contribute
exactly 0.0 and lanes never mix — both checked bitwise.  The CUDA
kernel itself is held to the plain version on the card by
chip_smoke.py.
"""
import importlib

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu_torch import MXNetError

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
    with pytest.raises(NotImplementedError):
        tpa.paged_attention(q, pk, pv, tables, pos, scale_k=pk, scale_v=pv)
    assert tpa.paged_attention.launches == 0   # nothing launched on CPU


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
