"""Gluon losses of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/loss.py`): the `Loss` base,
SoftmaxCrossEntropy (the streamed cross-entropy over wide
vocabularies), L2, L1, SigmoidBinaryCrossEntropy, KLDiv, CTC, Huber,
Hinge, SquaredHinge, Logistic, Triplet, PoissonNLL and
CosineEmbedding, each the JAX package's formula in torch ops.  Unlike
the JAX package's, a loss is not hybridized until ``hybridize()`` is
called on it (or on a block holding it)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.xent_kernel import fused_sparse_xent, should_fuse
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if pred.shape != label.shape else label


def _bce_logits(p, label):
    """``relu(p) - p·label + softplus(-|p|)``: sigmoid cross-entropy from
    logits without overflow."""
    return F.relu(p) - p * label + F.softplus(-p.abs())


class Loss(HybridBlock):
    """Base loss: a weight and the batch axis the per-sample loss keeps."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_all_but_batch(self, x):
        axes = tuple(i for i in range(x.dim()) if i != self._batch_axis)
        return x.mean(dim=axes) if axes else x


class L2Loss(Loss):
    """``weight/2 · (label - pred)²``, meaned over all but the batch
    axis."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(_reshape_like(pred, label) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_all_but_batch(loss)


class L1Loss(Loss):
    """``weight · |label - pred|``, meaned over all but the batch axis."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(_reshape_like(pred, label) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``pred`` (logits, or probabilities with
    ``from_sigmoid``, clamped by 1e-12 inside the logs) against
    ``label`` in [0, 1].  ``pos_weight`` is accepted and not applied,
    as in the JAX package."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            loss = _bce_logits(pred, label)
        else:
            eps = 1e-12
            loss = -(label * torch.log(pred + eps)
                     + (1 - label) * torch.log(1 - pred + eps))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy per sample (mean over every axis but the
    batch axis), in pred's dtype.  Sparse integer labels over the last
    axis of a wide vocabulary (`xent_kernel.should_fuse`) take the
    streamed cross-entropy, which never builds the (N, V) f32 log-prob
    tensor; otherwise an f32 ``log_softmax`` does the same math."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def _use_fused(self, p) -> bool:
        return (self._sparse_label and not self._from_logits
                and self._axis in (-1, p.dim() - 1)
                and should_fuse(p.shape[-1]))

    def forward(self, pred, label, sample_weight=None):
        if self._use_fused(pred):
            loss = fused_sparse_xent(pred, label).to(pred.dtype)
        elif self._sparse_label and not self._from_logits:
            logp = F.log_softmax(pred.float(), dim=self._axis)
            li = label.long().unsqueeze(self._axis)
            loss = -logp.gather(self._axis, li).squeeze(self._axis)
            loss = loss.to(pred.dtype)
        else:
            logp = pred if self._from_logits \
                else F.log_softmax(pred, dim=self._axis)
            if self._sparse_label:
                li = label.long().unsqueeze(self._axis)
                loss = -logp.gather(self._axis, li).squeeze(self._axis)
            else:
                loss = -(logp * _reshape_like(logp, label)).sum(self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label · (log label - log pred)`` (``log label`` clamped at
    1e-12; ``pred`` log-probabilities, or logits put through a
    log-softmax over ``axis`` without ``from_logits``)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        logp = pred if self._from_logits \
            else F.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - logp)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class CTCLoss(Loss):
    """Connectionist temporal classification, each sequence's negative
    log-likelihood.  ``pred`` holds unnormalized scores, NTC (or TNC),
    whose last class is the blank, as in the reference; labels NT (or
    TN), padded after ``label_lengths`` or, without them, by negative
    values; ``pred_lengths`` the valid steps of each sequence.  The JAX
    package calls ``optax.ctc_loss`` with the blank moved to class 0;
    the port calls torch's CTC loss the same way."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        super().__init__(weight, 0)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        p, lab = pred, label
        if self._layout == "TNC":
            p = p.transpose(0, 1)
        if self._label_layout == "TN":
            lab = lab.transpose(0, 1)
        B, T, _ = p.shape
        logits = torch.cat([p[..., -1:], p[..., :-1]], -1)
        logp = F.log_softmax(logits.float(), -1).transpose(0, 1)
        lab = lab.long()
        if label_lengths is None:
            valid = lab >= 0
            llen = valid.sum(1)
        else:
            llen = label_lengths.long().reshape(B)
            valid = torch.arange(lab.shape[1], device=lab.device) \
                < llen[:, None]
        plen = torch.full((B,), T, dtype=torch.long, device=p.device) \
            if pred_lengths is None else pred_lengths.long().reshape(B)
        targets = torch.where(valid, lab + 1, 0)
        loss = F.ctc_loss(logp, targets, plen, llen, blank=0,
                          reduction="none").to(p.dtype)
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """``|d| - rho/2`` where |d| > rho, else ``d²/(2 rho)``; d = label -
    pred."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        d = torch.abs(_reshape_like(pred, label) - pred)
        loss = torch.where(d > self._rho, d - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(d))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class HingeLoss(Loss):
    """``relu(margin - pred·label)``, labels ±1."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = F.relu(self._margin - pred * _reshape_like(pred, label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class SquaredHingeLoss(Loss):
    """``relu(margin - pred·label)²``, labels ±1."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(F.relu(self._margin
                                   - pred * _reshape_like(pred, label)))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_all_but_batch(loss)


class LogisticLoss(Loss):
    """Sigmoid cross-entropy from logits, labels ±1 (``signed``) or
    0/1."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = _apply_weighting(_bce_logits(pred, label), self._weight,
                                sample_weight)
        return self._mean_all_but_batch(loss)


class TripletLoss(Loss):
    """``relu(sum(|pred - positive|² - |pred - negative|²) + margin)``,
    the sum over every axis but the first."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        loss = (torch.square(pred - positive)
                - torch.square(pred - negative)).sum(
                    tuple(range(1, pred.dim())))
        loss = F.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """``exp(pred) - label·pred`` (``from_logits``), else ``pred -
    label·log(pred + epsilon)``, with Stirling's term where label > 1
    (``compute_full``); the mean over every element, as in the JAX
    package."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, label, sample_weight=None, epsilon=1e-08):
        label = _reshape_like(pred, label)
        if self._from_logits:
            loss = torch.exp(pred) - label * pred
        else:
            loss = pred - label * torch.log(pred + epsilon)
        if self._compute_full:
            m = torch.clamp_min(label, 1.0)
            stirling = label * torch.log(m) - label \
                + 0.5 * torch.log(2 * math.pi * m)
            loss = loss + torch.where(label > 1, stirling, 0.0)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` where label is 1, else ``relu(cos -
    margin)``; each input flattened per sample."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        x1 = input1.reshape(input1.shape[0], -1)
        x2 = input2.reshape(input2.shape[0], -1)
        cos = (x1 * x2).sum(1) / (torch.linalg.vector_norm(x1, dim=1)
                                  * torch.linalg.vector_norm(x2, dim=1)
                                  + 1e-12)
        loss = torch.where(label.reshape(-1) == 1, 1 - cos,
                           F.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)
