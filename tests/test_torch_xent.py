"""Streamed softmax cross-entropy of the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch/ops/xent_kernel.py`) and the loss block
that gates it (`gluon.loss.SoftmaxCrossEntropyLoss`), held against the
JAX package's.

The same numpy logits go through the port's plain forward and backward
and through the JAX Pallas kernels in interpret mode (`run_interpret`,
`run_interpret_bwd`), over ragged and odd vocabularies, eps 0 and 0.1,
f32 and bf16 inputs: lse and loss within 1e-5 of the logits' scale
(f32 arithmetic in a different order), d(logits) within 1e-6 in f32 and
4e-3 (one bf16 step below 1) in bf16.  The CUDA kernels are held to the
plain versions on the card by chip_smoke.py.
"""
import importlib

import jax.numpy as jnp
import numpy as onp
import pytest
import torch
import torch.nn.functional as F

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

jxk = importlib.import_module("incubator_mxnet_tpu.ops.xent_kernel")
txk = importlib.import_module("incubator_mxnet_tpu_torch.ops.xent_kernel")

CASES = [(8, 600, "float32", 0.0), (8, 1000, "float32", 0.1),
         (16, 1001, "float32", 0.0), (128, 520, "float32", 0.1),
         (4, 1999, "bfloat16", 0.0), (6, 1000, "bfloat16", 0.1)]
DX_TOL = {"float32": 1e-6, "bfloat16": 4e-3}


def _data(N, V, dtype, seed, scale=1.0):
    rs = onp.random.RandomState(seed)
    x = (rs.randn(N, V) * scale).astype(onp.float32)
    x = torch.from_numpy(x).to(getattr(torch, dtype))
    labels = rs.randint(0, V, N).astype(onp.int32)
    g = rs.rand(N).astype(onp.float32)
    return x, labels, g


def _jax(x):
    return jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("N,V,dtype,eps", CASES)
def test_forward_matches_jax_kernel(N, V, dtype, eps):
    x, labels, _ = _data(N, V, dtype, N + V)
    jloss, jlse = jxk.run_interpret(_jax(x), jnp.asarray(labels), eps)
    lse, xsum = txk.xent_forward(x, want_sum=eps != 0.0)
    assert lse.dtype == torch.float32 and lse.shape == (N,)
    assert (xsum is None) == (eps == 0.0)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(jlse), atol=1e-5)
    tl = torch.from_numpy(labels)
    loss = txk.fused_smoothed_xent(x, tl, eps)
    onp.testing.assert_allclose(loss.numpy(), onp.asarray(jloss), atol=1e-5)


@pytest.mark.parametrize("N,V,dtype,eps", CASES)
def test_backward_matches_jax_kernel(N, V, dtype, eps):
    x, labels, g = _data(N, V, dtype, 7 * N + V)
    _, jlse = jxk.run_interpret(_jax(x), jnp.asarray(labels), eps)
    jdx = jxk.run_interpret_bwd(_jax(x), jnp.asarray(labels), jlse,
                                jnp.asarray(g), eps)
    dx = txk.xent_backward(x, torch.from_numpy(labels),
                           torch.from_numpy(onp.asarray(jlse)),
                           torch.from_numpy(g), eps)
    assert dx.dtype == x.dtype and dx.shape == x.shape
    onp.testing.assert_allclose(dx.float().numpy(),
                                onp.asarray(jdx.astype(jnp.float32)),
                                atol=DX_TOL[dtype])


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_extreme_logits_stay_finite(eps):
    x, labels, g = _data(6, 700, "float32", 3, scale=1e4)
    x[0, :] = -1e4
    _, jlse = jxk.run_interpret(_jax(x), jnp.asarray(labels), eps)
    lse, _ = txk.xent_forward(x, want_sum=eps != 0.0)
    assert torch.isfinite(lse).all()
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(jlse), rtol=1e-6)
    dx = txk.xent_backward(x, torch.from_numpy(labels), lse,
                           torch.from_numpy(g), eps)
    assert torch.isfinite(dx).all()


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_autograd_matches_torch_cross_entropy(eps):
    x, labels, _ = _data(12, 900, "float32", 5)
    y = torch.from_numpy(labels).long()
    a = x.clone().requires_grad_()
    b = x.clone().requires_grad_()
    la = txk.fused_smoothed_xent(a, y, eps)
    lb = F.cross_entropy(b, y, reduction="none", label_smoothing=eps)
    torch.testing.assert_close(la, lb, atol=1e-5, rtol=0)
    w = torch.rand(12)
    (la * w).sum().backward()
    (lb * w).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=0)


@pytest.mark.parametrize("V,kw,fused", [
    (1000, {}, True), (512, {}, True), (511, {}, False),
    (1000, {"sparse_label": False}, False),
    (1000, {"from_logits": True}, False), (1000, {"axis": 1}, False)])
def test_loss_gate(V, kw, fused):
    p = torch.zeros(2, 3, V)
    assert SoftmaxCrossEntropyLoss(**kw)._use_fused(p) is fused
    assert txk.should_fuse(V) is (V >= 512)


@pytest.mark.parametrize("V", [100, 1000])
def test_loss_block_matches_jax(V):
    rs = onp.random.RandomState(V)
    pred = rs.randn(3, 5, V).astype(onp.float32)
    label = rs.randint(0, V, (3, 5)).astype(onp.int32)
    ref = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
        NDArray(jnp.asarray(pred)), NDArray(jnp.asarray(label))).asnumpy()
    got = SoftmaxCrossEntropyLoss()(torch.from_numpy(pred),
                                    torch.from_numpy(label))
    assert got.shape == (3,) and got.dtype == torch.float32
    onp.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_loss_keeps_pred_dtype():
    pred = torch.randn(2, 4, 600).to(torch.bfloat16)
    loss = SoftmaxCrossEntropyLoss()(pred, torch.randint(0, 600, (2, 4)))
    assert loss.dtype == torch.bfloat16


@pytest.mark.parametrize("V", [50, 700])
def test_nd_softmax_cross_entropy_matches_jax(V):
    rs = onp.random.RandomState(V)
    x = rs.randn(9, V).astype(onp.float32)
    y = rs.randint(0, V, 9)
    y[2] = V + 3                      # out of range: contributes 0
    ref = mx.nd.softmax_cross_entropy(NDArray(jnp.asarray(x)),
                                      NDArray(jnp.asarray(y))).asnumpy()
    got = nd.softmax_cross_entropy(torch.from_numpy(x), torch.from_numpy(y))
    onp.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
