"""Flash attention forward of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/ops/flash_attention.py`) held against the
JAX package's.

The same numpy inputs (made from a seed) go through the port's plain
version and through the JAX `flash_attention` (the Pallas kernel in
interpret mode at these sizes) and `attention_reference`: causal
(bottom-right aligned) and not, Tq != Tk, f32 within 2e-5; the
logsumexp within 2e-5 as well.  Rows that see no key give output 0 and
logsumexp -inf.  The CUDA kernel itself is held to the plain version on
the card by chip_smoke.py.
"""
import importlib
import math

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


def test_forward_only_refuses_grad():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 1, 4, 4, 8))
    with pytest.raises(MXNetError):
        tfa.flash_attention(q.requires_grad_(), k, v)
    assert tfa.flash_attention.launches == 0   # nothing launched on CPU


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
