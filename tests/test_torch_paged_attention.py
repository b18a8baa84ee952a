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
import math

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


# ---- the CUDA kernel's numerics, modelled on the CPU ----------------------
# A torch model of csrc/paged_attention.cu's arithmetic (the kernel runs
# only on the card, where chip_smoke.py holds it to the plain version):
# a block of W = 8 warps per (lane, head); warp w walks pages w, w + 8, ...
# of the lane's pages 0 .. pos // bs, each in units of 4 passes of
# 32 / (D / vec) slot rows (vec = 16 bytes of page elements), with its own
# online softmax (m from finfo(f32).min, l, acc); masked slots (past pos)
# are never read; the warps' partials merge in a fixed order, out = sum
# exp(m_w - M) acc_w / sum exp(m_w - M) l_w, 0 where that sum is 0
# (pos < 0).
WARPS = 8
FMIN = torch.finfo(torch.float32).min


def _unit_rows(page_dtype, D):
    vec = 16 // torch.empty((), dtype=page_dtype).element_size()
    return 4 * (32 // (D // vec))


def _paged_model(q, pool_k, pool_v, tables, pos, scale_k=None,
                 scale_v=None):
    """(out, pages): the kernel's output and, per (lane, warp), the
    pages that warp walked."""
    B, H, D = q.shape
    bs, nbps = pool_k.shape[2], tables.shape[1]
    unit = _unit_rows(pool_k.dtype, D)
    out = torch.zeros((B, H, D), dtype=torch.float32)
    walked = {}
    for b in range(B):
        t = int(pos[b])
        npages = 0 if t < 0 else min(t // bs, nbps - 1) + 1
        for h in range(H):
            qv = q[b, h].float()
            parts = []
            for w in range(WARPS):
                m = torch.tensor(FMIN)
                l = torch.tensor(0.0)
                acc = torch.zeros(D)
                pages = list(range(w, npages, WARPS))
                walked[(b, w)] = pages
                for j in pages:
                    blk = int(tables[b, j])
                    live = min(bs, t - j * bs + 1)
                    for u in range(0, live, unit):
                        rows = slice(u, min(u + unit, live))
                        k = pool_k[blk, h, rows].float()
                        v = pool_v[blk, h, rows].float()
                        if scale_k is not None:     # dequantize first
                            k = k * scale_k[blk, h, rows][:, None]
                            v = v * scale_v[blk, h, rows][:, None]
                        s = (k @ qv) / math.sqrt(D)
                        m_new = torch.maximum(m, s.max())
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new)
                        l = l * alpha + p.sum()
                        acc = acc * alpha + p @ v
                        m = m_new
                parts.append((m, l, acc))
            mm = max(pm for pm, _, _ in parts)
            ll, o = torch.tensor(0.0), torch.zeros(D)
            for pm, pl, pa in parts:             # warp 0, 1, ... in order
                a = torch.exp(pm - mm)
                ll = ll + a * pl
                o = o + a * pa
            out[b, h] = o / ll if ll > 0 else 0.0
    return out.to(q.dtype), walked


def _edge_case(seed, bs, positions, nbps, D=16, H=2):
    """A pool and block tables for lanes at ``positions`` (numpy f32 /
    int32); spare blocks hold garbage no walk reads."""
    rs = onp.random.RandomState(seed)
    B = len(positions)
    nblocks = B * nbps + 2
    pool_k = rs.randn(nblocks, H, bs, D).astype(onp.float32)
    pool_v = rs.randn(nblocks, H, bs, D).astype(onp.float32)
    q = rs.randn(B, H, D).astype(onp.float32)
    tables = rs.permutation(B * nbps).astype(onp.int32).reshape(B, nbps)
    return q, pool_k, pool_v, tables, onp.asarray(positions, onp.int32)


# (bs, lane positions, nbps): a lane at pos 2047 with bs 16 (128 pages,
# 16 a warp); lanes at pos 0, bs - 1 and bs; a lane with fewer pages than
# warps (3 pages); bs 1 (every slot a page) and 64 (one page spans the
# warps' units)
PAGED_EDGE_CASES = [(16, [2047], 128),
                    (16, [0, 15, 16], 4),
                    (16, [47], 8),
                    (1, [0, 5, 11], 12),
                    (64, [0, 63, 64, 200], 4)]


def _edge_id(case):
    bs, positions, nbps = case
    return f"bs{bs}-pos{'_'.join(map(str, positions))}"


@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", PAGED_EDGE_CASES, ids=_edge_id)
def test_kernel_model_matches_jax_kernel_and_dense(case, pages):
    """The W-way page partition and its fixed-order merge against the
    JAX `_paged_core` / `_paged_core_q8` in interpret mode and the port's
    `paged_attention_dense`: f32 within 2e-5 (bf16 pages are exact in
    f32; the sums run in another order), and each warp walks exactly
    pages w, w + 8, ... up to pos // bs."""
    bs, positions, nbps = case
    q, pk, pv, tables, pos = _edge_case(bs * 13 + len(positions), bs,
                                        positions, nbps)
    tq, tpk, tpv, ttab, tpos = (torch.from_numpy(a)
                                for a in (q, pk, pv, tables, pos))
    jq, jtab, jpos = jnp.asarray(q), jnp.asarray(tables), jnp.asarray(pos)
    if pages == "int8":
        tpk, sk = quantize_kv(tpk)
        tpv, sv = quantize_kv(tpv)
        jk8, jsk = jax_qkv(jnp.asarray(pk))
        jv8, jsv = jax_qkv(jnp.asarray(pv))
        got, walked = _paged_model(tq, tpk, tpv, ttab, tpos, sk, sv)
        ref = tpa.paged_attention_dense(tq, tpk, tpv, ttab, tpos, sk, sv)
        jref = jpa._paged_core_q8(jq, jk8, jv8, jsk, jsv, jtab, jpos, True)
    else:
        dt = getattr(torch, pages)
        tpk, tpv = tpk.to(dt).float(), tpv.to(dt).float()
        got, walked = _paged_model(tq, tpk, tpv, ttab, tpos)
        ref = tpa.paged_attention_dense(tq, tpk, tpv, ttab, tpos)
        jref = jpa._paged_core(jq, jnp.asarray(tpk.numpy()),
                               jnp.asarray(tpv.numpy()), jtab, jpos, True)
    onp.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-5)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(jref), rtol=0,
                                atol=2e-5)
    for b, t in enumerate(positions):
        npages = min(t // bs, nbps - 1) + 1
        for w in range(WARPS):
            assert walked[(b, w)] == list(range(w, npages, WARPS))


def test_kernel_model_negative_pos_gives_zero():
    """pos < 0: no warp has a page, every one merges as a no-op (m =
    finfo.min, l = 0), and the lane's output is exactly 0."""
    q, pk, pv, tables, pos = (torch.from_numpy(a) for a in _edge_case(
        3, 16, [-1, 20], 4))
    got, walked = _paged_model(q, pk, pv, tables, pos)
    assert torch.all(got[0] == 0)
    assert all(walked[(0, w)] == [] for w in range(WARPS))
    torch.testing.assert_close(
        got[1], tpa.paged_attention_dense(q, pk, pv, tables, pos)[1],
        rtol=0, atol=2e-5)


@pytest.mark.parametrize("change", ["pos", "pages"])
def test_kernel_model_lane_bits_ignore_other_lanes(change):
    """A lane's output bits do not move when another lane's pos or pages
    do: which warp takes which page, and every sum's order, depend only
    on the lane's own pos.  The same holds for the port's plain
    version."""
    q, pk, pv, tables, pos = (torch.from_numpy(a) for a in _edge_case(
        4, 16, [100, 37, 200], 16))
    base, _ = _paged_model(q, pk, pv, tables, pos)
    dense = tpa.paged_attention_dense(q, pk, pv, tables, pos)
    pk2, pv2, pos2 = pk.clone(), pv.clone(), pos.clone()
    if change == "pos":
        pos2[1] = 255
    else:
        blocks = tables[1].long()
        pk2[blocks] = torch.randn_like(pk2[blocks]) * 100
        pv2[blocks] = -pv2[blocks]
    moved, _ = _paged_model(q, pk2, pv2, tables, pos2)
    moved_dense = tpa.paged_attention_dense(q, pk2, pv2, tables, pos2)
    for b in (0, 2):
        assert torch.equal(moved[b], base[b])
        assert torch.equal(moved_dense[b], dense[b])
    assert not torch.equal(moved[1], base[1])
