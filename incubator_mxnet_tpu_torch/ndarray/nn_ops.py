"""Neural-network ops of the PyTorch/CUDA port on plain tensors
(counterpart of `incubator_mxnet_tpu/ndarray/nn_ops.py` and the
embedding of `ndarray/ops.py`): the ops of the BERT training path.

The port's arrays are `torch.Tensor`s (there is no NDArray class);
each function takes and returns tensors and is differentiable through
`torch.autograd`.  Dense products, normalisation and activations are
torch ops, as the JAX package leaves them to XLA; dropout and the
vocabulary-wide cross-entropy go through the port's kernels
(`ops.dropout_kernel`, `ops.xent_kernel`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..ops.dropout_kernel import fused_dropout, fused_dropout_add

__all__ = ["FullyConnected", "Activation", "gelu", "log_softmax",
           "softmax_cross_entropy", "LayerNorm", "Embedding", "Dropout",
           "DropoutAdd"]


def FullyConnected(data, weight, bias=None, flatten: bool = True):
    """``y = x · Wᵀ + b``; weight (units, in).  ``flatten`` folds every
    axis after the first into the input width.  The input follows the
    weight's dtype, as in the JAX package."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    if x.dtype != weight.dtype:
        x = x.to(weight.dtype)
    return F.linear(x, weight, None if bias is None else bias.to(x.dtype))


def gelu(data, approximate: bool = True):
    """GELU; the tanh approximation by default, as ``jax.nn.gelu``."""
    return F.gelu(data, approximate="tanh" if approximate else "none")


_ACTS = {"relu": F.relu, "tanh": torch.tanh, "gelu": gelu}


def Activation(data, act_type: str = "relu"):
    fn = _ACTS.get(act_type)
    if fn is None:
        raise MXNetError(f"Activation {act_type!r} is not ported "
                         f"(ported: {sorted(_ACTS)})")
    return fn(data)


def log_softmax(data, axis: int = -1):
    return F.log_softmax(data, dim=axis)


def softmax_cross_entropy(data, label):
    """Sum over all rows of ``-log_softmax(data)[label]``, in data's
    dtype.  Wide vocabularies (`xent_kernel.should_fuse`) go through the
    streamed cross-entropy, with out-of-range labels contributing 0 as
    in the one-hot formulation."""
    from ..ops.xent_kernel import fused_sparse_xent, should_fuse

    V = data.shape[-1]
    y = label.long()
    if should_fuse(V):
        valid = (y >= 0) & (y < V)
        nll = fused_sparse_xent(data, torch.where(valid, y, 0))
        return torch.where(valid, nll, 0.0).sum().to(data.dtype)
    logp = F.log_softmax(data, dim=-1)
    oh = F.one_hot(torch.where((y >= 0) & (y < V), y, V), V + 1)[..., :V]
    return -(oh.to(logp.dtype) * logp).sum()


def LayerNorm(data, gamma, beta, axis: int = -1, eps: float = 1e-5):
    """Mean and variance over ``axis`` in f32; the normalised value is
    rounded to data's dtype before the affine, as in the JAX package."""
    x = data.movedim(axis, -1) if axis not in (-1, data.ndim - 1) else data
    y = F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)
    out = (y * gamma + beta).to(x.dtype)
    return out.movedim(-1, axis) if x is not data else out


def Embedding(data, weight):
    """Rows of ``weight`` at the indices ``data``, clipped into range as
    the JAX package's gather is."""
    return F.embedding(data.long().clamp(0, weight.shape[0] - 1), weight)


def Dropout(data, p: float = 0.5, axes=()):
    """Dropout with the port's keep-mask kernel, active in `autograd`'s
    train mode (on inside ``record()``, off outside), not by
    `torch.nn.Module.training`.  Each active call draws a fresh seed
    from `random.next_seed`: a Python int passed by value, or inside a
    captured program's body a slot of its seed table, which the `_dev`
    kernels read on the card, so each replay draws a fresh mask.  The
    ``axes`` (shared-mask) form is not ported."""
    if axes:
        raise MXNetError("Dropout with axes (a mask shared along axes) is "
                         "not ported")
    if not (autograd.is_training() and p > 0.0):
        return data
    return fused_dropout(data, _random.next_seed(), float(p))


def DropoutAdd(data, residual, p: float = 0.5):
    """``residual + Dropout(data)``, same mask and train-mode rule as
    `Dropout`; the plain sum when dropout is inactive."""
    if not (autograd.is_training() and p > 0.0):
        return data + residual
    return fused_dropout_add(data, residual, _random.next_seed(), float(p))
