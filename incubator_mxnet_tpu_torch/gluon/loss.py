"""Gluon losses of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/loss.py`): the `Loss` base and
`SoftmaxCrossEntropyLoss`, the loss of the BERT training path.  The
other losses are a later slice's."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.xent_kernel import fused_sparse_xent, should_fuse
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if pred.shape != label.shape else label


class Loss(HybridBlock):
    """Base loss: a weight and the batch axis the per-sample loss keeps."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_all_but_batch(self, x):
        axes = tuple(i for i in range(x.dim()) if i != self._batch_axis)
        return x.mean(dim=axes) if axes else x


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
