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
