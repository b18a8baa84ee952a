"""Flash attention of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/ops/flash_attention.py`), forward and
backward, held against the JAX package's.

Forward: the same numpy inputs (made from a seed) go through the
port's plain version and through the JAX `flash_attention` (the Pallas
kernel in interpret mode at these sizes) and `attention_reference`:
causal (bottom-right aligned) and not, Tq != Tk, f32 within 2e-5; the
logsumexp within 2e-5 as well.  Rows that see no key give output 0 and
logsumexp -inf.

Backward: the port's `flash_bwd_plain` (from the saved lse and Δ) and
the gradients of its autograd Function are held against the JAX
`_flash_bwd_core` in interpret mode (fed by `_flash_core` in interpret
mode) and against the JAX `_flash_bwd_reference`, at the JAX test's
own f32 tolerance (rtol 2e-4, atol 2e-4); the ``(out, lse)`` variant's
gradients against `jax.vjp` of the JAX `flash_attention_with_lse` with
both cotangents.  The CUDA kernels themselves are held to the plain
versions on the card by chip_smoke.py.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu_torch import MXNetError

# the packages' ops/__init__ re-export functions of the modules' names
jfa = importlib.import_module("incubator_mxnet_tpu.ops.flash_attention")
tfa = importlib.import_module("incubator_mxnet_tpu_torch.ops.flash_attention")

TOL = 2e-5


def _qkv(seed, B, H, tq, tk, D):
    rs = onp.random.RandomState(seed)
    return (rs.randn(B, H, tq, D).astype(onp.float32),
            rs.randn(B, H, tk, D).astype(onp.float32),
            rs.randn(B, H, tk, D).astype(onp.float32))


@pytest.mark.parametrize("tq,tk", [(16, 16), (7, 13), (13, 7), (70, 70)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_jax(tq, tk, causal):
    q, k, v = _qkv(tq * 100 + tk, 2, 2, tq, tk, 16)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq_, tk_, tv_ = map(torch.from_numpy, (q, k, v))
    got, lse = tfa.flash_attention_with_lse(tq_, tk_, tv_, causal)
    ref_kernel, ref_lse = jfa.flash_attention_with_lse(jq, jk, jv, causal)
    ref_plain = jfa.attention_reference(jq, jk, jv, causal)
    assert got.dtype == torch.float32 and lse.shape == (2, 2, tq)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref_kernel),
                                atol=TOL)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref_plain),
                                atol=TOL)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(ref_lse), atol=TOL)
    assert torch.equal(tfa.flash_attention(tq_, tk_, tv_, causal), got)
    assert torch.equal(tfa.attention_reference(tq_, tk_, tv_, causal), got)


def test_explicit_scale_matches_jax():
    q, k, v = _qkv(5, 1, 2, 9, 9, 8)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=True, scale=0.3)
    ref = jfa.attention_reference(*map(jnp.asarray, (q, k, v)),
                                  causal=True, scale=0.3)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(ref), atol=TOL)


def test_fully_masked_rows_give_zero_and_neg_inf_lse():
    # causal with Tq > Tk: the first Tq - Tk query rows see no key
    q, k, v = _qkv(6, 1, 2, 12, 5, 8)
    out, lse = tfa.flash_attention_with_lse(
        *map(torch.from_numpy, (q, k, v)), causal=True)
    dead = 12 - 5
    assert torch.all(out[:, :, :dead] == 0)
    assert torch.all(torch.isneginf(lse[:, :, :dead]))
    assert torch.all(torch.isfinite(lse[:, :, dead:]))
    _, jlse = jfa.flash_attention_with_lse(*map(jnp.asarray, (q, k, v)),
                                           causal=True)
    assert onp.isneginf(onp.asarray(jlse)[:, :, :dead]).all()
    scale = 1.0 / math.sqrt(8)
    s = onp.einsum("bhqd,bhkd->bhqk", q, k)[:, :, dead:] * scale
    mask = onp.tril(onp.ones((5, 5), bool))
    s = onp.where(mask, s, -onp.inf)
    m = s.max(-1, keepdims=True)
    want = (m + onp.log(onp.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    onp.testing.assert_allclose(lse[:, :, dead:].numpy(), want, atol=1e-5)


def test_bf16_plain_version_matches_jax():
    q, k, v = _qkv(7, 1, 2, 24, 24, 16)
    got = tfa.flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=True)
    ref = jfa.attention_reference(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=True)
    assert got.dtype == torch.bfloat16
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(ref, onp.float32), atol=2e-2)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "shape",
                                 "contiguity"])
def test_kernel_argument_checks(bad):
    """The checks the wrapper makes before it hands pointers to the
    kernel (they run on any device; the launch itself needs the card)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 1, 2, 8, 8, 16))
    tfa._check(q, k, v)                          # the good case passes
    if bad == "head_dim":
        q, k, v = (t[..., :12].contiguous() for t in (q, k, v))
    elif bad == "dtype":
        v = v.double()
    elif bad == "shape":
        k = k[:, :1].contiguous()
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(MXNetError):
        tfa._check(q, k, v)


# ---- the backward ------------------------------------------------------
BWD_TOL = dict(rtol=2e-4, atol=2e-4)    # the JAX package's own test's
# (tq, tk): square, longer queries, longer keys, ragged; (12, 5) causal
# leaves the first 7 query rows without a key (as does (16, 8) causal)
BWD_SHAPES = [(8, 8), (16, 8), (8, 16), (7, 13), (12, 5)]
# one compile per shape instead of one per op
_jax_bwd_reference = jax.jit(jfa._flash_bwd_reference, static_argnums=(4, 5))


def _bwd_inputs(seed, tq, tk, B=1, H=2, D=8):
    q, k, v = _qkv(seed, B, H, tq, tk, D)
    do = onp.random.RandomState(seed + 1).randn(B, H, tq, D) \
        .astype(onp.float32)
    return q, k, v, do


def _close(got, want, **tol):
    for g, w in zip(got, want):
        onp.testing.assert_allclose(onp.asarray(g), onp.asarray(w),
                                    **(tol or BWD_TOL))


def _torch_grads(q, k, v, do, causal, scale=None):
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq_, tk_, tv_, causal, scale)
    return torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(do))


@pytest.mark.parametrize("tq,tk", BWD_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_matches_jax_kernels_and_reference(tq, tk, causal):
    """flash_bwd_plain, the port's `_flash_bwd_reference` and the
    Function's gradients against the JAX Pallas backward (interpret
    mode) and the JAX exact backward."""
    q, k, v, do = _bwd_inputs(tq * 31 + tk + causal, tq, tk)
    scale = 8 ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, jlse = jfa._flash_core(jq, jk, jv, causal, scale, 4, 4, True)
    jdelta = jnp.sum(jdo * jout.astype(jnp.float32), axis=-1)
    jkern = jfa._flash_bwd_core(jq, jk, jv, jdo, jlse, jdelta, causal, scale,
                                4, 4, True)
    jref = _jax_bwd_reference(jq, jk, jv, jdo, causal, scale)

    tq_, tk_, tv_, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = tfa.flash_attention_with_lse(tq_, tk_, tv_, causal, scale)
    delta = (tdo * out).sum(-1)
    plain = tfa.flash_bwd_plain(tq_, tk_, tv_, tdo, lse, delta, causal,
                                scale)
    ref = tfa._flash_bwd_reference(tq_, tk_, tv_, tdo, causal, scale)
    grads = _torch_grads(q, k, v, do, causal)
    for got in (plain, ref, grads):
        assert all(g.dtype == torch.float32 for g in got)
        assert all(torch.isfinite(g).all() for g in got)
        _close(got, jkern)
        _close(got, jref)
    # the per-kernel wrappers take the same plain version on the CPU
    assert torch.equal(tfa.flash_bwd_dq(tq_, tk_, tv_, tdo, lse, delta,
                                        causal, scale), plain[0])
    dk, dv = tfa.flash_bwd_dkdv(tq_, tk_, tv_, tdo, lse, delta, causal,
                                scale)
    assert torch.equal(dk, plain[1]) and torch.equal(dv, plain[2])


@pytest.mark.parametrize("causal", [False, True])
def test_explicit_scale_reaches_the_backward(causal):
    q, k, v, do = _bwd_inputs(21, 9, 11)
    jref = _jax_bwd_reference(*map(jnp.asarray, (q, k, v, do)),
                                    causal, 0.3)
    _close(_torch_grads(q, k, v, do, causal, scale=0.3), jref)
    # the default scale gives other gradients
    default = _torch_grads(q, k, v, do, causal)
    assert not onp.allclose(default[0].numpy(), onp.asarray(jref[0]),
                            **BWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_variant_grads_match_jax_vjp(causal):
    """Cotangents on both outputs: (do, dlse) through `jax.vjp` of the
    JAX `flash_attention_with_lse` and `torch.autograd.grad` of the
    port's; also the JAX exact backward given Δ − dlse."""
    q, k, v, do = _bwd_inputs(33, 12, 10)
    dlse = onp.random.RandomState(34).randn(1, 2, 12).astype(onp.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    (jout, jlse), vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention_with_lse(a, b, c, causal), jq, jk,
        jv)
    # rows that see no key have lse -inf: their lse cotangent is moot
    dlse = onp.where(onp.isfinite(onp.asarray(jlse)), dlse, 0.0) \
        .astype(onp.float32)
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = tfa.flash_attention_with_lse(tq_, tk_, tv_, causal)
    onp.testing.assert_allclose(lse.detach().numpy(), onp.asarray(jlse),
                                atol=TOL)
    grads = torch.autograd.grad((out, lse), (tq_, tk_, tv_),
                                (torch.from_numpy(do),
                                 torch.from_numpy(dlse)))
    _close(grads, jgrads)
    delta = jnp.sum(jnp.asarray(do) * jout, axis=-1) - jnp.asarray(dlse)
    _close(grads, _jax_bwd_reference(jq, jk, jv, jnp.asarray(do),
                                           causal, 8 ** -0.5, delta=delta))
    # dlse folded with the wrong sign gives other gradients
    wrong = tfa._flash_bwd_reference(
        *(t.detach() for t in (tq_, tk_, tv_)), torch.from_numpy(do), causal,
        8 ** -0.5, delta=torch.from_numpy(onp.asarray(delta + 2 * dlse)))
    assert not onp.allclose(wrong[0].numpy(), grads[0].numpy(), **BWD_TOL)


def test_lse_cotangent_alone():
    """Only lse is used: the output's cotangent counts as zero."""
    q, k, v, _ = _bwd_inputs(35, 6, 9)
    dlse = onp.random.RandomState(36).randn(1, 2, 6).astype(onp.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_with_lse(a, b, c),
                     jq, jk, jv)
    jgrads = vjp((jnp.zeros((1, 2, 6, 8)), jnp.asarray(dlse)))
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    _, lse = tfa.flash_attention_with_lse(tq_, tk_, tv_)
    grads = torch.autograd.grad(lse, (tq_, tk_, tv_), torch.from_numpy(dlse))
    _close(grads, jgrads)


def test_bf16_bwd_matches_jax_reference():
    """bf16 inputs: gradients in bf16 within 2e-2 (about five bf16
    roundings of O(1) values: inputs, dO and the outputs round on both
    sides) of the JAX exact backward on the same bf16 inputs."""
    q, k, v, do = _bwd_inputs(37, 16, 16, D=16)
    jref = _jax_bwd_reference(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do)), True,
        0.25)
    tq_, tk_, tv_ = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                     for a in (q, k, v))
    out = tfa.flash_attention(tq_, tk_, tv_, causal=True)
    grads = torch.autograd.grad(out, (tq_, tk_, tv_),
                                torch.from_numpy(do).to(torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    _close([g.float() for g in grads],
           [onp.asarray(r, onp.float32) for r in jref], rtol=0, atol=2e-2)


def test_rows_without_keys_get_zero_grads():
    q, k, v, do = _bwd_inputs(38, 12, 5)
    dq, dk, dv = _torch_grads(q, k, v, do, causal=True)
    assert torch.all(dq[:, :, :7] == 0)
    # a key the visible rows see gets a gradient
    assert torch.all(dk.abs().sum(-1) > 0) and torch.all(dv.abs().sum(-1) > 0)


def test_function_only_when_grad_is_needed():
    """Inference saves nothing and builds no graph; on the CPU nothing
    is launched either way."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(39, 8, 8))
    out = tfa.flash_attention(q, k, v)
    assert out.grad_fn is None
    qr = q.clone().requires_grad_()
    with torch.no_grad():
        assert tfa.flash_attention(qr, k, v).grad_fn is None
    out_r = tfa.flash_attention(qr, k, v)
    assert out_r.grad_fn is not None
    assert torch.equal(out_r.detach(), out)
    torch.autograd.grad(out_r, qr, do)
    assert tfa.flash_attention.launches == 0
    assert tfa.flash_bwd_dkdv.launches == tfa.flash_bwd_dq.launches == 0


def test_noncontiguous_cotangent():
    """The cotangent autograd hands the backward may be a strided view
    (here of a (B, T, H, D) layout): the result equals the contiguous
    one's."""
    q, k, v, do = _bwd_inputs(40, 8, 8)
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq_, tk_, tv_).transpose(1, 2)    # (B,T,H,D)
    g = torch.from_numpy(do).transpose(1, 2).contiguous()
    grads = torch.autograd.grad(out, (tq_, tk_, tv_), g)
    _close(grads, _torch_grads(q, k, v, do, False), rtol=0, atol=1e-7)


def test_bwd_launch_hands_the_kernels_16_byte_aligned_tiles(monkeypatch):
    """The bf16 backward kernels load their tiles with TMA, which needs
    16-byte aligned data: the wrapper hands them an aligned copy of a
    misaligned input (a view at an odd offset) and the input itself
    otherwise."""
    from incubator_mxnet_tpu_torch import _build

    seen = {}

    class Lib:
        def __getattr__(self, name):
            def launch(dtype, q, k, v, do, lse, delta, *rest):
                seen.update(q=q, k=k, v=v, do=do)
                return 0
            return launch

    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    # the stand-in launches count: restore the process-wide counter after
    monkeypatch.setattr(tfa.flash_bwd_dq, "launches",
                        tfa.flash_bwd_dq.launches)
    g = torch.Generator().manual_seed(0)
    B, H, T, D = 1, 2, 8, 16
    flat = torch.randn(B * H * T * D + 1, generator=g).to(torch.bfloat16)
    q = flat[1:].view(B, H, T, D)              # 2-byte offset: misaligned
    k, v, do = (torch.randn((B, H, T, D), generator=g).to(torch.bfloat16)
                for _ in range(3))
    lse = torch.zeros((B, H, T))
    delta = torch.zeros((B, H, T))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    tfa._dq_cuda(q, k, v, do, lse, delta, False, 0.25)
    assert seen["q"] % 16 == 0 and seen["q"] != q.data_ptr()
    assert seen["k"] == k.data_ptr() and seen["do"] == do.data_ptr()


def test_bwd_source_keeps_the_no_atomics_contract():
    """Each block of the backward kernels owns its output tile: the CUDA
    source issues no atomic or reduction to memory (CUDA atomics, PTX
    ``red``/``atom``, bulk reduce copies)."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(tfa.__file__), os.pardir,
                            "csrc", "flash_attention_bwd.cu")).read()
    code = re.sub(r"//[^\n]*", "", src)          # comments may name them
    for pattern in (r"\batomic\w*\s*\(", r"\bred\.", r"\batom\.",
                    r"cp\.reduce"):
        assert not re.search(pattern, code), pattern


# ---- the bf16 forward kernel's numerics, modelled on the CPU ------------
# A torch model of the arithmetic of csrc/flash_attention.cu's bf16 kernel
# (the kernel itself runs only on the card, where chip_smoke.py holds it
# to the plain version): 64-row query slices (one consumer warpgroup
# each) walk 64-key tiles, stopping before the first tile wholly past the
# slice's last row's causal diagonal; the mask runs only on tiles that
# cross the diagonal or the ragged Tk edge; the online softmax is in base
# 2 with the scale folded into one multiply-add (p = exp2(s * c - m2),
# c = scale * log2(e)); a row without a visible key keeps m2 = -inf and
# its exponent base 0; P goes to P V as the kernel sends it (``p_mode``
# "pair": the bf16 pair hi = bf16(p), lo = bf16(p - hi)), or rounded to
# bf16 once ("bf16", the TPU's default-precision pass), or in f32; out =
# O / l (0 where l = 0) and lse = m2 * ln(2) + log(l) (-inf there).
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)


def _p_for_pv(p, p_mode):
    if p_mode == "f32":
        return p
    hi = p.to(torch.bfloat16).float()
    if p_mode == "bf16":
        return hi
    return hi + (p - hi).to(torch.bfloat16).float()


def _fwd_tile_model(q, k, v, causal, scale, p_mode, rows=64, keys=64):
    """(out, lse, tiles): the kernel's outputs and, per 64-row slice,
    the key tiles it walked."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    qf, kf, vf = (t.float().reshape(B * H, -1, D) for t in (q, k, v))
    c = scale * LOG2E
    shift = Tk - Tq
    out = torch.zeros((B * H, Tq, D))
    lse = torch.full((B * H, Tq), float("-inf"))
    ninf = torch.tensor(float("-inf"))
    tiles = {}
    for r0 in range(0, Tq, rows):
        r1 = min(r0 + rows, Tq)
        nk = -(-Tk // keys)
        if causal:
            lim = r1 - 1 + shift
            nk = 0 if lim < 0 else min(nk, lim // keys + 1)
        tiles[r0] = list(range(nk))
        m2 = torch.full((B * H, r1 - r0), float("-inf"))
        l = torch.zeros((B * H, r1 - r0))
        o = torch.zeros((B * H, r1 - r0, D))
        row = torch.arange(r0, r1)[:, None]
        for t in range(nk):
            c0, c1 = t * keys, min((t + 1) * keys, Tk)
            s = qf[:, r0:r1] @ kf[:, c0:c1].transpose(1, 2)
            key = torch.arange(c0, c1)[None, :]
            interior = c0 + keys <= Tk and \
                (not causal or c0 + keys - 1 <= r0 + shift)
            live = torch.ones_like(s, dtype=torch.bool) if interior else \
                (key <= row + shift).expand_as(s) if causal else \
                torch.ones_like(s, dtype=torch.bool)
            s = torch.where(live, s, ninf)
            m_new = torch.maximum(m2, s.amax(-1) * c)
            m_use = torch.where(m_new == ninf, torch.zeros_like(m_new), m_new)
            alpha = torch.exp2(m2 - m_use)
            p = torch.where(live, torch.exp2(s * c - m_use[..., None]),
                            torch.zeros_like(s))
            l = alpha * l + p.sum(-1)
            o = o * alpha[..., None] + _p_for_pv(p, p_mode) @ vf[:, c0:c1]
            m2 = m_new
        inv = torch.where(l > 0, 1.0 / l.clamp(min=1e-30), torch.zeros_like(l))
        out[:, r0:r1] = o * inv[..., None]
        lse[:, r0:r1] = torch.where(l > 0, m2 * LN2 + torch.log(
            l.clamp(min=1e-30)), ninf)
    return (out.reshape(B, H, Tq, D).to(q.dtype), lse.reshape(B, H, Tq),
            tiles)


# chip_smoke.py's FLASH_CASES, cut to CPU size (batch and heads; the
# lengths and head dims kept, so every ragged edge, empty walk and panel
# width the card sees is modelled): (qshape, tk, causal)
FWD_MODEL_CASES = [((1, 2, 128, 64), 128, True),
                   ((1, 1, 200, 64), 200, True),
                   ((1, 2, 37, 64), 300, True),
                   ((1, 2, 256, 64), 256, False),
                   ((1, 2, 300, 32), 37, True),     # 263 rows see no key
                   ((1, 2, 70, 128), 70, True),
                   ((1, 2, 33, 8), 90, False)]


def _case_id(case):
    (B, H, tq, D), tk, causal = case
    return f"q{tq}-k{tk}-d{D}-{'causal' if causal else 'full'}"


# P V's tolerance per P mode, in units of max|v| (f32: absolute 1e-5):
# one bf16 rounding of each weight is 2^-9 relative, over a convex
# combination of V's rows; the pair carries P to ~2^-17
P_MODE_ATOL = {"f32": None, "pair": 2.0 ** -16, "bf16": 2.0 ** -8}


@pytest.mark.parametrize("p_mode", list(P_MODE_ATOL))
@pytest.mark.parametrize("case", FWD_MODEL_CASES, ids=_case_id)
def test_fwd_tile_model_matches_jax_kernel_and_reference(case, p_mode):
    """The model against the JAX `_flash_core` (interpret mode, 64 x 64
    blocks) and the port's `_reference_attention_lse`: with P in f32
    within 1e-5; with P as the kernel's bf16 pair within 2^-16 of
    max|v|; with P rounded to bf16 once within 2^-8 of max|v|; lse within
    1e-5 in every mode (it never sees P's rounding).  Rows that see no
    key give exactly 0 and -inf."""
    qshape, tk, causal = case
    B, H, tq, D = qshape
    q, k, v = _qkv(tq * 7 + tk + D, B, H, tq, tk, D)
    scale = 1.0 / math.sqrt(D)
    tq_, tk_, tv_ = map(torch.from_numpy, (q, k, v))
    out, lse, _ = _fwd_tile_model(tq_, tk_, tv_, causal, scale, p_mode)
    jout, jlse = jfa._flash_core(*map(jnp.asarray, (q, k, v)), causal,
                                 scale, 64, 64, True)
    ref, ref_lse = tfa._reference_attention_lse(tq_, tk_, tv_, causal, scale)
    atol = 1e-5 if p_mode == "f32" else \
        P_MODE_ATOL[p_mode] * float(onp.abs(v).max())
    for want, want_lse in ((onp.asarray(jout), onp.asarray(jlse)),
                           (ref.numpy(), ref_lse.numpy())):
        onp.testing.assert_allclose(out.numpy(), want, rtol=0, atol=atol)
        onp.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)
    dead = torch.isneginf(ref_lse)
    assert torch.equal(torch.isneginf(lse), dead)
    assert torch.all(out[dead] == 0)
    if case == FWD_MODEL_CASES[4]:
        assert int(dead.sum()) == B * H * 263


@pytest.mark.parametrize("case", FWD_MODEL_CASES, ids=_case_id)
def test_fwd_tile_model_walks_exactly_the_live_tiles(case):
    """The walk of each 64-row slice visits every key tile that holds a
    visible key of one of its rows and none wholly past its diagonal."""
    qshape, tk, causal = case
    tq = qshape[2]
    z = torch.zeros((1, 1, tq, 8)), torch.zeros((1, 1, tk, 8))
    _, _, tiles = _fwd_tile_model(z[0], z[1], z[1], causal, 1.0, "f32")
    shift = tk - tq
    for r0, walked in tiles.items():
        r1 = min(r0 + 64, tq)
        live = [t for t in range(-(-tk // 64))
                if not causal or t * 64 <= r1 - 1 + shift]
        assert walked == live, (r0, walked, live)


@pytest.mark.parametrize("causal", [False, True])
def test_fwd_tile_model_bf16_inputs_match_plain_version(causal):
    """bf16 inputs (as the kernel reads them, widened exactly), with a
    common offset on V as a projection's bias gives BERT's values: the
    model with the kernel's P pair, output rounded to bf16, against the
    port's plain version on the same bf16 inputs within one bf16 ulp of
    the output (the two f32 results differ by ~2^-16 of max|v|, so their
    roundings differ by at most an ulp); with P rounded once the f32
    results are further apart (2^-9 of a weight)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(41, 1, 2, 96, 160, 64))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v + 3.0))
    ref, ref_lse = tfa._reference_attention_lse(q, k, v, causal, 0.125)
    ref32 = tfa._reference_attention_lse(q.float(), k.float(), v.float(),
                                         causal, 0.125)[0]
    ulp = torch.pow(2.0, torch.floor(torch.log2(ref32.abs())) - 7)
    errs = {}
    for p_mode in ("pair", "bf16"):
        out, lse, _ = _fwd_tile_model(q, k, v, causal, 0.125, p_mode)
        assert out.dtype == torch.bfloat16
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5)
        out32 = _fwd_tile_model(q.float(), k.float(), v.float(), causal,
                                0.125, p_mode)[0]
        errs[p_mode] = float((out32 - ref32).abs().max())
        if p_mode == "pair":
            assert torch.all((out.float() - ref.float()).abs() <= ulp)
    assert errs["pair"] <= 2.0 ** -16 * float(v.float().abs().max())
    assert errs["bf16"] > 8 * errs["pair"]


def test_fwd_launch_hands_the_kernel_aligned_tiles_and_nonnegative_scale(
        monkeypatch):
    """The bf16 forward kernel loads its tiles with TMA (16-byte aligned
    data) and folds the scale into exp2 (it takes scale >= 0): the
    wrapper hands it an aligned copy of a misaligned input, and for a
    negative scale -q with -scale, the same attention."""
    from incubator_mxnet_tpu_torch import _build

    seen = {}

    class Lib:
        def __getattr__(self, name):
            def launch(dtype, q, k, v, out, lse, BH, Tq, Tk, D, causal,
                       scale, stream):
                seen.update(q=q, k=k, v=v, scale=scale)
                return 0
            return launch

    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    # the stand-in launches count: restore the process-wide counter after
    monkeypatch.setattr(tfa.flash_attention, "launches",
                        tfa.flash_attention.launches)
    g = torch.Generator().manual_seed(0)
    B, H, T, D = 1, 2, 8, 16
    flat = torch.randn(B * H * T * D + 1, generator=g).to(torch.bfloat16)
    k = flat[1:].view(B, H, T, D)              # 2-byte offset: misaligned
    q, v = (torch.randn((B, H, T, D), generator=g).to(torch.bfloat16)
            for _ in range(2))
    assert k.is_contiguous() and k.data_ptr() % 16 != 0
    tfa._flash_core(q, k, v, False, 0.25)
    assert seen["k"] % 16 == 0 and seen["k"] != k.data_ptr()
    assert seen["q"] == q.data_ptr() and seen["v"] == v.data_ptr()
    assert seen["scale"] == 0.25
    tfa._flash_core(q, k, v, False, -0.25)
    assert seen["scale"] == 0.25 and seen["q"] != q.data_ptr()
    # the plain version: softmax((-q) k^T * 0.25) = softmax(q k^T * -0.25)
    neg = tfa._reference_attention_lse(-q, k, v, False, 0.25)
    pos = tfa._reference_attention_lse(q, k, v, False, -0.25)
    assert torch.equal(neg[0], pos[0])


@pytest.mark.parametrize("source", ["flash_attention.cu", "hopper_tc.cuh",
                                    "paged_attention.cu"])
def test_sources_keep_the_no_atomics_contract(source):
    """Each block of the forward and paged kernels owns its output: the
    CUDA sources (and the shared header) issue no atomic or reduction to
    memory."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(tfa.__file__), os.pardir,
                            "csrc", source)).read()
    code = re.sub(r"//[^\n]*", "", src)
    for pattern in (r"\batomic\w*\s*\(", r"\bred\.", r"\batom\.",
                    r"cp\.reduce"):
        assert not re.search(pattern, code), pattern


def test_fwd_source_runs_both_products_on_wgmma():
    """The bf16 forward issues `wgmma.mma_async` (through the shared
    header) for S = Q K^T and O += P V."""
    import os

    csrc = os.path.join(os.path.dirname(tfa.__file__), os.pardir, "csrc")
    fwd = open(os.path.join(csrc, "flash_attention.cu")).read()
    hdr = open(os.path.join(csrc, "hopper_tc.cuh")).read()
    assert "wgmma.mma_async" in hdr
    assert "product_ss<" in fwd and "product_rs(" in fwd
