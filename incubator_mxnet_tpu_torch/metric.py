"""Evaluation metrics of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/metric.py`; ref `python/mxnet/metric.py`): the
EvalMetric zoo with the reference's `update(labels, preds)` / `get()`
protocol, plus composite and custom metrics.

In MXNet `metric.update` is a sync point.  Here, as in the JAX
package, the hot-loop metrics (Accuracy, Loss) accumulate ON THE DEVICE
when given tensors: `update` launches a few small ops and never reads a
value back (no ``.item()``, ``.cpu()``, ``.tolist()``), so a graphed
training loop never stalls on it; the single host read happens in
`get()` (the Speedometer's interval).  The other metrics compute on the
host over numpy copies.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC", "MAE", "MSE",
           "RMSE", "CrossEntropy", "NegativeLogLikelihood", "Perplexity",
           "PearsonCorrelation", "Loss", "CompositeEvalMetric", "CustomMetric",
           "create", "np"]

class _Registry(dict):
    """Metric classes by lower-case name."""

    def register(self, obj=None, name=None):
        def _do(o):
            self[(name or o.__name__).lower()] = o
            return o

        return _do if obj is None else _do(obj)

    def create(self, key, *args, **kwargs):
        cls = self.get(key.lower())
        if cls is None:
            raise MXNetError(f"metric '{key}' is not registered. Known: "
                             f"{sorted(self)}")
        return cls(*args, **kwargs)


_REG = _Registry()

# device partials fold into the float64 device total every this many
# updates (a float32 partial sums them exactly below 2**24)
_FOLD_EVERY = 128


def _as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return onp.asarray(x)


def _to_list(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        # set before reset(): subclasses may override reset() without
        # calling super (e.g. CompositeEvalMetric)
        self._dev_partial = None
        self._dev_total = None
        self._dev_updates = 0
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0
        self._dev_partial = None   # float32 device scalar, ≤128 updates
        self._dev_total = None     # float64 device scalar, older updates
        self._dev_updates = 0

    def reset_local(self):
        self._flush_dev()  # pending device partial belongs to global too
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def _update(self, metric, num):
        self.num_inst += num
        self.global_num_inst += num
        if isinstance(metric, (int, float)):
            self.sum_metric += metric
            self.global_sum_metric += metric
            return
        # device scalar: accumulate a bounded float32 PARTIAL on the
        # device (upcast — bf16 sums round away increments within tens
        # of updates), fold it into a float64 device total every
        # _FOLD_EVERY updates (on the device: no host read) and into the
        # host float64 totals at flush, so long-run sums keep float64
        # exactness.
        m = metric.detach().to(torch.float32)
        self._dev_partial = m if self._dev_partial is None \
            else self._dev_partial + m
        self._dev_updates += 1
        if self._dev_updates >= _FOLD_EVERY:
            self._fold_dev()

    def _fold_dev(self):
        if self._dev_partial is not None:
            p = self._dev_partial.to(torch.float64)
            self._dev_total = p if self._dev_total is None \
                else self._dev_total + p
            self._dev_partial = None
        self._dev_updates = 0

    def _flush_dev(self):
        self._fold_dev()
        if self._dev_total is not None:
            v = float(self._dev_total)  # the single host read
            self.sum_metric += v
            self.global_sum_metric += v
            self._dev_total = None

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        self._flush_dev()
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        self._flush_dev()
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        return list(zip(_to_list(name), _to_list(value)))

    def get_config(self):
        return {"metric": type(self).__name__, **self._kwargs}

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@_REG.register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, axis=axis, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            if isinstance(pred, torch.Tensor) and \
                    isinstance(label, torch.Tensor):
                # on-device accumulation: metric.update is NOT a sync
                # point (unlike the reference) — the count stays a
                # device scalar until get()
                p, l = pred.detach(), label.detach()
                if p.dim() > l.dim():
                    p = p.argmax(dim=self.axis)
                p = p.to(torch.int32).reshape(-1)
                l = l.to(torch.int32).reshape(-1)
                n = min(p.shape[0], l.shape[0])
                self._update((p[:n] == l[:n]).sum(), n)
                continue
            label = _as_np(label)
            pred = _as_np(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype("int32").reshape(-1)
            label = label.astype("int32").reshape(-1)
            n = min(len(label), len(pred))
            self._update(float((pred[:n] == label[:n]).sum()), n)


@_REG.register(name="top_k_accuracy")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", top_k=top_k, **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).astype("int32").reshape(-1)
            pred = _as_np(pred)
            topk = onp.argsort(-pred, axis=-1)[..., :self.top_k].reshape(len(label), -1)
            hits = (topk == label[:, None]).any(axis=1)
            self._update(float(hits.sum()), len(label))


@_REG.register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, average=average, **kwargs)
        self.average = average
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).reshape(-1).astype("int32")
            pred = _as_np(pred)
            pred_label = (pred[:, 1] > 0.5).astype("int32") if pred.ndim > 1 else (pred > 0.5).astype("int32")
            pred_label = pred_label.reshape(-1)
            self._tp += float(((pred_label == 1) & (label == 1)).sum())
            self._fp += float(((pred_label == 1) & (label == 0)).sum())
            self._fn += float(((pred_label == 0) & (label == 1)).sum())
            prec = self._tp / (self._tp + self._fp) if self._tp + self._fp > 0 else 0.0
            rec = self._tp / (self._tp + self._fn) if self._tp + self._fn > 0 else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
            self.sum_metric = f1
            self.num_inst = 1
            self.global_sum_metric = f1
            self.global_num_inst = 1


@_REG.register
class MCC(EvalMetric):
    """Matthews correlation coefficient (binary)."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self._c = onp.zeros((2, 2))

    def reset(self):
        super().reset()
        self._c = onp.zeros((2, 2))

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).reshape(-1).astype("int32")
            pred = _as_np(pred)
            pred_label = pred.argmax(-1).reshape(-1) if pred.ndim > 1 else (pred > 0.5).astype("int32").reshape(-1)
            for l, p in ((0, 0), (0, 1), (1, 0), (1, 1)):
                self._c[l, p] += float(((label == l) & (pred_label == p)).sum())
            tn, fp, fn, tp = self._c[0, 0], self._c[0, 1], self._c[1, 0], self._c[1, 1]
            den = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
            mcc = ((tp * tn) - (fp * fn)) / den if den > 0 else 0.0
            self.sum_metric = mcc
            self.num_inst = 1
            self.global_sum_metric = mcc
            self.global_num_inst = 1


@_REG.register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label, pred = _as_np(label), _as_np(pred)
            if label.shape != pred.shape:
                label = label.reshape(pred.shape)
            self._update(float(onp.abs(label - pred).mean()) * label.shape[0], label.shape[0])


@_REG.register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label, pred = _as_np(label), _as_np(pred)
            if label.shape != pred.shape:
                label = label.reshape(pred.shape)
            self._update(float(((label - pred) ** 2).mean()) * label.shape[0], label.shape[0])


@_REG.register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@_REG.register(name="ce")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, eps=eps, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).ravel().astype("int64")
            pred = _as_np(pred)
            prob = pred[onp.arange(label.shape[0]), label]
            self._update(float((-onp.log(prob + self.eps)).sum()), label.shape[0])


@_REG.register(name="nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        EvalMetric.__init__(self, name, eps=eps, **kwargs)
        self.eps = eps


@_REG.register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name, ignore_label=ignore_label, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label = _as_np(label).reshape(-1).astype("int64")
            pred = _as_np(pred).reshape(label.shape[0], -1)
            prob = pred[onp.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                prob = prob[~ignore]
            loss += float(-onp.log(onp.maximum(1e-10, prob)).sum())
            num += prob.shape[0]
        self._update(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@_REG.register(name="pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            label, pred = _as_np(label).ravel(), _as_np(pred).ravel()
            r = onp.corrcoef(label, pred)[0, 1]
            self._update(float(r), 1)


@_REG.register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _to_list(preds):
            if isinstance(pred, torch.Tensor):
                r = pred.detach()
                self._update(r.sum(), r.numel())  # device scalar, no sync
            else:
                loss = float(_as_np(pred).sum())
                self._update(loss, _as_np(pred).size)


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) if isinstance(m, str) else m for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str) else metric)

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def reset_local(self):
        # Speedometer auto_reset must clear the CHILDREN's local sums
        for m in getattr(self, "metrics", []):
            m.reset_local()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names += _to_list(n)
            values += _to_list(v)
        return (names, values)


class CustomMetric(EvalMetric):
    def __init__(self, feval: Callable, name="custom", allow_extra_outputs=False, **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        for label, pred in zip(_to_list(labels), _to_list(preds)):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                m, n = reval
                self._update(m, n)
            else:
                self._update(reval, 1)


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """Create a CustomMetric from a numpy feval (parity: mx.metric.np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", name)
    return CustomMetric(feval, name=feval.__name__, allow_extra_outputs=allow_extra_outputs)


def create(metric, *args, **kwargs) -> EvalMetric:
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        comp = CompositeEvalMetric()
        for m in metric:
            comp.add(create(m, *args, **kwargs))
        return comp
    # reference short aliases (mx.metric.create('acc') etc.)
    aliases = {"acc": "accuracy", "cross-entropy": "ce", "top_k_acc": "top_k_accuracy"}
    return _REG.create(aliases.get(metric, metric), *args, **kwargs)
