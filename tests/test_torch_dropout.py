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
the mask that JAX draws, injected into the port (f32, atol 1e-6).  The
CUDA kernel is held to the plain version bit for bit by chip_smoke.py.
"""
import importlib
import math

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
