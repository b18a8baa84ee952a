"""Neural-network ops of the PyTorch/CUDA port on plain tensors
(counterpart of `incubator_mxnet_tpu/ndarray/nn_ops.py` and the
embedding and flatten of `ndarray/ops.py`): the ops of the BERT,
ResNet, word-level LSTM and DCGAN training paths, with the transposed
convolution, upsampling, the activations and softmaxes, group,
instance and L2 normalisation and the fused RNN.

The port's arrays are `torch.Tensor`s (there is no NDArray class);
each function takes and returns tensors and is differentiable through
`torch.autograd`.  Dense products, convolutions, pooling, normalisation
and activations are torch ops (cuDNN and cuBLAS on the card), as the
JAX package leaves them to XLA; dropout and the vocabulary-wide
cross-entropy go through the port's kernels (`ops.dropout_kernel`,
`ops.xent_kernel`).  Layouts are the JAX package's: NCW / NCHW / NCDHW
activations, (out, in/groups, *kernel) convolution weights, (in,
out/groups, *kernel) transposed-convolution weights (torch's own).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..ops.dropout_kernel import (fused_dropout, fused_dropout_add,
                                  fused_dropout_shared)

__all__ = ["FullyConnected", "Convolution", "Deconvolution", "Pooling",
           "UpSampling", "Activation", "LeakyReLU", "gelu", "softmax",
           "log_softmax", "softmin", "masked_softmax", "masked_log_softmax",
           "SoftmaxOutput", "softmax_cross_entropy", "smooth_l1",
           "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm",
           "L2Normalization", "Embedding", "Dropout", "DropoutAdd",
           "flatten", "RNN"]


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def FullyConnected(data, weight, bias=None, flatten: bool = True):
    """``y = x · Wᵀ + b``; weight (units, in).  ``flatten`` folds every
    axis after the first into the input width.  The input follows the
    weight's dtype, as in the JAX package."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    if x.dtype != weight.dtype:
        x = x.to(weight.dtype)
    return F.linear(x, weight, None if bias is None else bias.to(x.dtype))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def Convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter: int = 0,
                num_group: int = 1, no_bias: bool = False,
                layout: str = "NCHW", **kwargs):
    """1-, 2- or 3-D convolution, NC(D)(H)W, with ``num_group`` groups;
    weight (out, in/groups, *kernel).  The input follows the weight's
    dtype and the bias is added in the output's, as in the JAX package,
    whose TPU-only space-to-depth stem (the same math) the port leaves
    out."""
    nd = len(kernel) if kernel is not None else weight.dim() - 2
    if nd not in _CONV or not layout.startswith("NC"):
        raise MXNetError(f"Convolution: {nd}-D {layout} is not ported "
                         f"(1-3-D, channels first)")
    x = data.to(weight.dtype) if data.dtype != weight.dtype else data
    b = None if no_bias or bias is None else bias.to(x.dtype)
    return _CONV[nd](x, weight, b, _tuple(stride or 1, nd),
                     _tuple(pad or 0, nd), _tuple(dilate or 1, nd),
                     num_group)


_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def Deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter: int = 0,
                  num_group: int = 1, no_bias: bool = True,
                  layout: str = "NCHW", **kwargs):
    """1-, 2- or 3-D transposed convolution, NC(D)(H)W; weight (in,
    out/groups, *kernel), torch's layout.  Each output axis is
    ``stride·(i - 1) + dilate·(k - 1) + 1 - 2·pad + adj`` long (``adj``
    is torch's ``output_padding``).  As in the JAX package the bias is
    left out unless ``no_bias=False``, and the input follows the
    weight's dtype; the JAX package computes the same function as a
    dilated convolution with the flipped kernel."""
    nd = len(kernel) if kernel is not None else weight.dim() - 2
    if nd not in _DECONV or not layout.startswith("NC"):
        raise MXNetError(f"Deconvolution: {nd}-D {layout} is not ported "
                         f"(1-3-D, channels first)")
    x = data.to(weight.dtype) if data.dtype != weight.dtype else data
    b = None if no_bias or bias is None else bias.to(x.dtype)
    return _DECONV[nd](x, weight, b, _tuple(stride or 1, nd),
                       _tuple(pad or 0, nd), _tuple(adj or 0, nd),
                       num_group, _tuple(dilate or 1, nd))


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def Pooling(data, kernel=None, pool_type: str = "max", stride=None,
            pad=None, global_pool: bool = False,
            pooling_convention: str = "valid",
            count_include_pad: bool = True, **kwargs):
    """Max, avg or sum pooling over the trailing 1-3 axes, the windows
    of ``lax.reduce_window`` in the JAX package: ``pad`` on both sides,
    ``pooling_convention="full"`` (ceil) extends the upper padding so a
    partial window counts, max pads with -inf, avg divides by the
    window's size (``count_include_pad``) or by its elements inside the
    input.  ``global_pool`` reduces every trailing axis (keepdims)."""
    x = data
    nd = x.dim() - 2
    if pool_type not in ("max", "avg", "sum") or nd not in _MAX_POOL:
        raise MXNetError(f"Pooling {pool_type!r} over {nd} axes is not "
                         f"ported (max, avg, sum over 1-3)")
    if global_pool:
        dims = tuple(range(2, x.dim()))
        if pool_type == "max":
            return x.amax(dims, keepdim=True)
        return x.mean(dims, keepdim=True) if pool_type == "avg" \
            else x.sum(dims, keepdim=True)
    k = _tuple(kernel, nd)
    s = _tuple(stride or k, nd)
    p = _tuple(pad or 0, nd)
    extra = [0] * nd
    if pooling_convention == "full":
        for i in range(nd):
            rem = (x.shape[2 + i] + 2 * p[i] - k[i]) % s[i]
            extra[i] = 0 if rem == 0 else s[i] - rem
    if not any(extra) and all(2 * pp <= kk for pp, kk in zip(p, k)) \
            and pool_type != "sum":
        # torch's own windows are the same here
        if pool_type == "max":
            return _MAX_POOL[nd](x, k, s, p)
        if nd == 1:
            return F.avg_pool1d(x, k, s, p, False, count_include_pad)
        return _AVG_POOL[nd](x, k, s, p, False, count_include_pad)
    # explicit padding (the upper side extended), then unpadded windows
    widths = [w for i in reversed(range(nd)) for w in (p[i], p[i] + extra[i])]
    if pool_type == "max":
        return _MAX_POOL[nd](F.pad(x, widths, value=-math.inf), k, s)
    x2 = x.unsqueeze(2) if nd == 1 else x          # avg pooling is 2-/3-D
    k2, s2 = ((1,) + k, (1,) + s) if nd == 1 else (k, s)
    pool = _AVG_POOL[x2.dim() - 2]
    ssum = pool(F.pad(x2, widths), k2, s2, divisor_override=1)
    if pool_type == "avg":
        if count_include_pad:
            ssum = ssum / math.prod(k)
        else:
            ones = torch.ones((1, 1) + tuple(x2.shape[2:]), dtype=x.dtype,
                              device=x.device)
            ssum = ssum / pool(F.pad(ones, widths), k2, s2,
                               divisor_override=1)
    return ssum.squeeze(2) if nd == 1 else ssum


def UpSampling(data, scale: int = 2, sample_type: str = "nearest",
               **kwargs):
    """NCHW upsampled ``scale`` times along H and W: each pixel repeated
    (``nearest``), or bilinear with half-pixel centres, which at an
    integer scale up is ``jax.image.resize``'s bilinear."""
    if sample_type == "nearest":
        return data.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
    return F.interpolate(data, scale_factor=scale, mode="bilinear",
                         align_corners=False)


def gelu(data, approximate: bool = True):
    """GELU; the tanh approximation by default, as ``jax.nn.gelu``."""
    return F.gelu(data, approximate="tanh" if approximate else "none")


_ACTS = {"relu": F.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "softrelu": F.softplus, "softsign": F.softsign, "gelu": gelu,
         "silu": F.silu, "swish": F.silu}


def Activation(data, act_type: str = "relu"):
    fn = _ACTS.get(act_type)
    if fn is None:
        raise MXNetError(f"Activation {act_type!r} is not ported "
                         f"(ported: {sorted(_ACTS)})")
    return fn(data)


def LeakyReLU(data, gamma=None, act_type: str = "leaky",
              slope: float = 0.25, lower_bound: float = 0.125,
              upper_bound: float = 0.334):
    """``leaky`` (and ``rrelu``, at its fixed ``slope`` as in the JAX
    package): ``x`` where x >= 0, else ``slope·x``; ``elu``:
    ``slope·(eˣ - 1)`` there; ``selu``; ``gelu`` (the tanh
    approximation); ``prelu``: ``gamma·x`` there, ``gamma`` per channel
    (axis 1)."""
    x = data
    if act_type in ("leaky", "rrelu"):
        return torch.where(x >= 0, x, slope * x)
    if act_type == "elu":
        return torch.where(x >= 0, x, slope * (torch.exp(x) - 1))
    if act_type == "selu":
        return F.selu(x)
    if act_type == "gelu":
        return gelu(x)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (x.dim() - 2)) \
            if x.dim() > 2 else gamma
        return torch.where(x >= 0, x, g * x)
    raise MXNetError(f"LeakyReLU: unknown act_type {act_type!r}")


def _length_mask(data, length, axis):
    """1 where the step along ``axis`` is below the row's length (rows
    along axis 0), else 0."""
    steps = torch.arange(data.shape[axis], device=data.device)
    shape = [1] * data.dim()
    shape[axis] = -1
    lshape = [1] * data.dim()
    lshape[0] = -1
    length = torch.as_tensor(length, device=data.device)
    return (steps.reshape(shape) < length.reshape(lshape)).float()


def softmax(data, axis: int = -1, temperature=None, length=None):
    """Softmax over ``axis`` of ``data / temperature``; with ``length``,
    over each row's first ``length`` steps (`masked_softmax`)."""
    if length is not None:
        return masked_softmax(data, _length_mask(data, length, axis),
                              axis=axis)
    x = data / temperature if temperature else data
    return F.softmax(x, dim=axis)


def log_softmax(data, axis: int = -1, temperature=None):
    x = data / temperature if temperature else data
    return F.log_softmax(x, dim=axis)


def softmin(data, axis: int = -1):
    return F.softmax(-data, dim=axis)


def masked_softmax(data, mask, axis: int = -1, temperature: float = 1.0):
    """Softmax over the entries where ``mask`` is nonzero (the others
    enter as the dtype's lowest value and come out 0)."""
    m = mask.to(torch.bool)
    neg = torch.finfo(data.dtype).min
    y = F.softmax(torch.where(m, data / temperature, neg), dim=axis)
    return torch.where(m, y, 0.0)


def masked_log_softmax(data, mask, axis: int = -1):
    """Log-softmax with the masked-out entries entering as the dtype's
    lowest value (they come out hugely negative, not -inf)."""
    neg = torch.finfo(data.dtype).min
    return F.log_softmax(torch.where(mask.to(torch.bool), data, neg),
                         dim=axis)


def SoftmaxOutput(data, label=None, grad_scale: float = 1.0,
                  ignore_label: float = -1.0, use_ignore: bool = False,
                  multi_output: bool = False, **kwargs):
    """The legacy softmax output: its forward is the softmax (over axis
    1 with ``multi_output``, else the last); ``label`` is not read, as
    in the JAX package, whose backward is the softmax's own."""
    return softmax(data, axis=1 if multi_output else -1)


def smooth_l1(data, scalar: float = 1.0):
    """``s²x²/2`` where |x| < 1/s², else ``|x| - 1/(2s²)``."""
    s2 = scalar * scalar
    ax = data.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * data * data, ax - 0.5 / s2)


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


def _bn_stats_f32(x, axis: int = 1):
    """Per-channel (mean, biased variance) in f32, as the JAX package's
    two-stage reduction: f32 sums over the spatial axes, then over the
    batch; the square taken in x's dtype; ``E[x²] - mean²`` clamped at
    0."""
    cnt = x.numel() // x.shape[axis]
    f32 = torch.float32
    if x.dim() >= 3 and axis == 1:
        xr = x.reshape(x.shape[0], x.shape[1], -1)
        s = xr.sum(2, dtype=f32).sum(0)
        q = (xr * xr).sum(2, dtype=f32).sum(0)
    elif axis in (x.dim() - 1, -1):
        xr = x.reshape(-1, x.shape[-1])
        s = xr.sum(0, dtype=f32)
        q = (xr * xr).sum(0, dtype=f32)
    else:
        axes = tuple(i for i in range(x.dim()) if i != axis)
        s = x.sum(axes, dtype=f32)
        q = (x * x).sum(axes, dtype=f32)
    mean = s / cnt
    return mean, torch.clamp_min(q / cnt - mean * mean, 0.0)


def _in(dtype, v: float) -> float:
    """The Python float ``v`` rounded to ``dtype``, as JAX takes a
    weakly-typed scalar in the array's dtype."""
    return float(torch.tensor(v, dtype=dtype))


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps: float = 1e-5,
              momentum: float = 0.9, axis: int = 1,
              use_global_stats: bool = False, fix_gamma: bool = False,
              training: bool = False):
    """MXNet's BatchNorm, functional: returns ``(out, new_moving_mean,
    new_moving_var)``.  In training (and without ``use_global_stats``)
    it normalizes by the batch's statistics (`_bn_stats_f32`: the biased
    variance) and mixes them into the running ones as ``momentum·old +
    (1 - momentum)·batch``, in the running stats' dtype, outside
    autograd; otherwise it reads the running stats and returns them.
    The normalization is one multiply-add, ``x·inv + shift`` with ``inv =
    rsqrt(var + eps)·gamma`` and ``shift = beta - mean·inv`` taken in f32
    at (C,) and cast once to x's dtype.  torch's own running update (a
    momentum of the other sense, the unbiased variance) is not used."""
    x = data
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    if training and not use_global_stats:
        mean32, var32 = _bn_stats_f32(x, axis)
        with torch.no_grad():
            m, dt = momentum, moving_mean.dtype
            new_mm = moving_mean * _in(dt, m) \
                + mean32.to(dt) * _in(dt, 1 - m)
            new_mv = moving_var * _in(dt, m) + var32.to(dt) * _in(dt, 1 - m)
    else:
        mean32, var32 = moving_mean.float(), moving_var.float()
        new_mm, new_mv = moving_mean, moving_var
    shape = [1] * x.dim()
    shape[axis] = -1
    inv = torch.rsqrt(var32 + eps) * gamma.float()
    shift = beta.float() - mean32 * inv
    out = torch.addcmul(shift.to(x.dtype).reshape(shape), x,
                        inv.to(x.dtype).reshape(shape))
    return out, new_mm, new_mv


def LayerNorm(data, gamma, beta, axis: int = -1, eps: float = 1e-5):
    """Mean and variance over ``axis`` in f32; the normalised value is
    rounded to data's dtype before the affine, as in the JAX package."""
    x = data.movedim(axis, -1) if axis not in (-1, data.ndim - 1) else data
    y = F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)
    out = (y * gamma + beta).to(x.dtype)
    return out.movedim(-1, axis) if x is not data else out


def GroupNorm(data, gamma, beta, num_groups: int = 1, eps: float = 1e-5):
    """Statistics over each of ``num_groups`` channel groups and the
    spatial axes, in data's dtype; then the per-channel affine."""
    x = data
    n, c = x.shape[:2]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(axes, keepdim=True)
    var = xg.var(axes, unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * gamma.reshape(shape) + beta.reshape(shape)


def InstanceNorm(data, gamma, beta, eps: float = 1e-5):
    """Statistics over each sample's and channel's spatial axes; then the
    per-channel affine."""
    x = data
    axes = tuple(range(2, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, unbiased=False, keepdim=True)
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    return (x - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


def L2Normalization(data, eps: float = 1e-10, mode: str = "instance"):
    """``x / sqrt(sum(x²) + eps)``, the sum over each sample
    (``instance``), over the channels (``channel``) or over the spatial
    axes (``spatial``)."""
    x = data
    if mode == "channel":
        denom = torch.sqrt((x * x).sum(1, keepdim=True) + eps)
    elif mode == "spatial":
        denom = torch.sqrt((x * x).sum(tuple(range(2, x.dim())),
                                       keepdim=True) + eps)
    else:
        denom = torch.sqrt(x.reshape(x.shape[0], -1).square().sum(1) + eps)
        denom = denom.reshape((-1,) + (1,) * (x.dim() - 1))
    return x / denom


def Embedding(data, weight):
    """Rows of ``weight`` at the indices ``data``, clipped into range as
    the JAX package's gather is."""
    return F.embedding(data.long().clamp(0, weight.shape[0] - 1), weight)


def flatten(data):
    """(N, ...) -> (N, prod(...))."""
    return data.reshape(data.shape[0], -1)


def Dropout(data, p: float = 0.5, axes=()):
    """Dropout with the port's keep-mask kernel, active in `autograd`'s
    train mode (on inside ``record()``, off outside), not by
    `torch.nn.Module.training`.  Each active call draws a fresh seed
    from `random.next_seed`: a Python int passed by value, or inside a
    captured program's body a slot of its seed table, which the `_dev`
    kernels read on the card, so each replay draws a fresh mask.  With
    ``axes`` one mask is shared along those axes: the mask-only kernel
    draws it at the shape with those axes 1 and the apply broadcasts it
    (`fused_dropout_shared`); the JAX package draws that mask with
    ``jax.random``, so its bits differ, as every dropout's do."""
    if not (autograd.is_training() and p > 0.0):
        return data
    if axes:
        return fused_dropout_shared(data, _random.next_seed(), float(p),
                                    axes)
    return fused_dropout(data, _random.next_seed(), float(p))


def DropoutAdd(data, residual, p: float = 0.5):
    """``residual + Dropout(data)``, same mask and train-mode rule as
    `Dropout`; the plain sum when dropout is inactive."""
    if not (autograd.is_training() and p > 0.0):
        return data + residual
    return fused_dropout_add(data, residual, _random.next_seed(), float(p))


def RNN(data, parameters, state, state_cell=None, mode: str = "lstm",
        state_size: int = 0, num_layers: int = 1,
        bidirectional: bool = False, p: float = 0.0,
        state_outputs: bool = True, training: bool = False, **kwargs):
    """The fused multi-layer RNN over the packed parameter blob
    (`rnn_impl.fused_rnn`): (out, h, c) for ``lstm``, else (out, h)."""
    from .rnn_impl import fused_rnn

    return fused_rnn(data, parameters, state, state_cell, mode=mode,
                     state_size=state_size, num_layers=num_layers,
                     bidirectional=bidirectional, dropout=p,
                     training=training)
