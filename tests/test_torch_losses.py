"""The Gluon losses of the PyTorch/CUDA port (`gluon.loss`) against the
JAX package's, on the same numpy inputs from a seed, f32 on the CPU:
L2, L1, SigmoidBinaryCrossEntropy (from logits and ``from_sigmoid``),
KLDiv (from log-probabilities and from logits), Huber, Hinge,
SquaredHinge, Logistic (signed and binary labels), Triplet, PoissonNLL
(from logits with Stirling's term, and from rates), CosineEmbedding and
CTC (blank last, NTC and TNC, with ``pred_lengths`` and
``label_lengths`` or -1 padding), each with a weight or a
``sample_weight`` somewhere.

Each loss and the gradient of every differentiable input against
``jax.vjp`` of the JAX loss (`test_torch_conv_layers._vjp_pair`):
values within 1e-5·|ref| + 1e-5·max|ref|, gradients within
1e-4·|ref| + 1e-5·max|ref|.  CTC, whose JAX version is optax's
log-space recursion and the port's torch's, is held to the same
bounds.  The losses return one value a sample (PoissonNLL one in all),
compared flat.
"""
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu.gluon import loss as jloss
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.gluon import loss as tloss
from test_torch_conv_layers import _randn, _vjp_pair

torch.set_num_threads(1)  # six xdist workers share the cores

N, K = 4, 6


def _recorded(block, *args, **kwargs):
    """A block's call under ``record()`` (outside it a call keeps no
    graph)."""
    with autograd.record():
        return block(*args, **kwargs)


def _inputs(rs, kind):
    """(differentiable inputs, fixed inputs) for a loss of ``kind``."""
    pred = _randn(rs, N, K, scale=2.0)
    if kind == "real":
        return [pred], [_randn(rs, N, K)]
    if kind == "prob":
        return [1 / (1 + onp.exp(-pred))], [(rs.rand(N, K) > 0.5).astype(
            onp.float32)]
    if kind == "binary":
        return [pred], [(rs.rand(N, K) > 0.5).astype(onp.float32)]
    if kind == "signed":
        return [pred], [onp.sign(rs.randn(N, K)).astype(onp.float32)]
    if kind == "dist":
        lab = rs.rand(N, K).astype(onp.float32) + 0.05
        lab[0, 0] = 0.0
        return [pred], [lab / lab.sum(1, keepdims=True)]
    if kind == "logdist":
        logp = pred - onp.log(onp.exp(pred).sum(1, keepdims=True))
        lab = rs.rand(N, K).astype(onp.float32)
        return [logp.astype(onp.float32)], [lab / lab.sum(1, keepdims=True)]
    if kind == "counts":
        return [0.5 * pred], [rs.poisson(2.0, (N, K)).astype(onp.float32)]
    if kind == "rates":
        return [onp.abs(pred) + 0.1], [rs.poisson(2.0, (N, K)).astype(
            onp.float32)]
    if kind == "triplet":
        return [pred, _randn(rs, N, K), _randn(rs, N, K)], []
    if kind == "cosine":
        lab = onp.array([1, -1, 1, -1], onp.float32)
        return [pred, _randn(rs, N, K)], [lab]
    raise ValueError(kind)


CASES = [
    ("L2Loss", {}, "real", None),
    ("L2Loss", {"weight": 0.5}, "real", "sample"),
    ("L1Loss", {}, "real", None),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary", None),
    ("SigmoidBinaryCrossEntropyLoss", {"weight": 2.0}, "binary", "sample"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "prob", None),
    ("KLDivLoss", {}, "logdist", None),
    ("KLDivLoss", {"from_logits": False, "axis": -1}, "dist", "sample"),
    ("HuberLoss", {"rho": 0.5}, "real", None),
    ("HingeLoss", {"margin": 0.7}, "signed", None),
    ("SquaredHingeLoss", {}, "signed", "sample"),
    ("LogisticLoss", {}, "signed", None),
    ("LogisticLoss", {"label_format": "binary"}, "binary", None),
    ("TripletLoss", {"margin": 0.5}, "triplet", None),
    ("PoissonNLLLoss", {"compute_full": True}, "counts", None),
    ("PoissonNLLLoss", {"from_logits": False}, "rates", None),
    ("CosineEmbeddingLoss", {"margin": 0.2}, "cosine", None),
    ("CosineEmbeddingLoss", {"weight": 3.0}, "cosine", "sample_n"),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, "dist", "sample_n"),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_loss_matches_jax(case):
    name, kw, kind, sw = CASES[case]
    rs = onp.random.RandomState(case)
    diff, fixed = _inputs(rs, kind)
    if sw == "sample":
        fixed = fixed + [rs.rand(N, K).astype(onp.float32)]
    elif sw == "sample_n":
        fixed = fixed + [rs.rand(N).astype(onp.float32)]
    jl = getattr(jloss, name)(hybridize=False, **kw)
    tl = getattr(tloss, name)(**kw)
    jfix = [NDArray(onp.asarray(a)) for a in fixed]
    tfix = [torch.from_numpy(a) for a in fixed]
    # flat: PoissonNLL's loss is one scalar
    _vjp_pair(lambda *a: jl(*[NDArray(x) for x in a],
                            *jfix)._data.reshape(-1),
              lambda *a: _recorded(tl, *a, *tfix).reshape(-1), diff,
              700 + case)


def test_aliases():
    assert tloss.SigmoidBCELoss is tloss.SigmoidBinaryCrossEntropyLoss
    assert tloss.SoftmaxCELoss is tloss.SoftmaxCrossEntropyLoss


CTC_CASES = [
    # layout, label layout, with pred_lengths, with label_lengths, weights
    ("NTC", "NT", True, True, False),
    ("TNC", "TN", False, False, True),
]


@pytest.mark.parametrize("case", range(len(CTC_CASES)))
def test_ctc_loss_matches_jax(case):
    """CTCLoss (the reference's blank, the last class, moved to class 0
    in both packages): each sequence's loss and the gradient of the
    scores, with pred_lengths and label_lengths, or labels padded by -1,
    in NTC and TNC, with a sample weight."""
    layout, llayout, with_plen, with_llen, with_sw = CTC_CASES[case]
    rs = onp.random.RandomState(case)
    B, T, C, S = 3, 9, 5, 4
    pred = _randn(rs, B, T, C, scale=1.5)
    labels = rs.randint(0, C - 1, (B, S)).astype(onp.float32)
    llen = onp.array([4, 2, 3], onp.float32)
    plen = onp.array([9, 7, 8], onp.float32)
    if not with_llen:
        for b, n in enumerate(llen.astype(int)):
            labels[b, n:] = -1
    if layout == "TNC":
        pred = onp.ascontiguousarray(pred.transpose(1, 0, 2))
    if llayout == "TN":
        labels = onp.ascontiguousarray(labels.T)
    fixed = [labels]
    kw = {}
    if with_plen:
        kw["pred_lengths"] = plen
    if with_llen:
        kw["label_lengths"] = llen
    if with_sw:
        kw["sample_weight"] = rs.rand(B).astype(onp.float32)
    jl = jloss.CTCLoss(layout=layout, label_layout=llayout, hybridize=False)
    tl = tloss.CTCLoss(layout=layout, label_layout=llayout)
    jkw = {k: NDArray(onp.asarray(v)) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    _vjp_pair(lambda p: jl(NDArray(p), NDArray(onp.asarray(fixed[0])),
                           **jkw)._data,
              lambda p: _recorded(tl, p, torch.from_numpy(fixed[0]), **tkw),
              [pred],
              750 + case)
