"""int8 convolution and dense product of post-training quantization
(PyTorch/CUDA port of `int8_conv` and `int8_dense`,
`incubator_mxnet_tpu/contrib/quantization.py:96-136`).

``int8_conv(x, w_q, scale, act_scale, bias, stride, pad, dilate,
groups)`` over an NC[D]HW activation ``x`` (f32 or bf16) with 1-3
spatial dims and int8 weights (O, C/groups, *kernel):

1. ``xq = clip(round(f32(x) / act_scale), -127, 127)``, half to even;
2. ``acc`` = the convolution of xq and w_q in int32 (groups, stride,
   symmetric zero padding, dilation);
3. ``f32(acc) * scale[o] + bias[o]``, cast to x's dtype.

``scale`` is ``act_scale * w_scale`` per output channel, an f32
product the caller stages once (the JAX package forms it in its jitted
body, the same f32 rounding).  Two versions:

* `int8_conv_reference` — the plain PyTorch version: the same quantize
  (a true division by a one-element tensor, never torch's multiply by
  the reciprocal of a Python scalar on CUDA), an f64 convolution of the
  integer values (exact: |acc| < 2^53; cuDNN off, so no transform
  algorithm rounds), int32, then the epilogue as two torch ops.  The
  CPU path and the oracle the kernel is held to.
* ``csrc/int8_conv.cu`` — the hand-written implicit-GEMM kernel
  (``mx_int8_conv``), bit-identical to the plain version.

`int8_dense(x, w_q, scale, act_scale, bias)` is the GEMM case: (M, K)
rows against (N, K) int8 weights as a 1x1 convolution over (M, K, 1,
1).  Each wrapper launches the kernel for CUDA tensors (or raises) and
takes the plain version for CPU tensors; ``int8_conv.launches`` and
``int8_dense.launches`` count the kernel's launches for each.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build, _graphs
from ..base import MXNetError

__all__ = ["int8_conv", "int8_dense", "int8_conv_reference",
           "quantize_activation"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_P = ctypes.c_void_p
_bound: dict = {}                         # "fn" -> (library, function)


def quantize_activation(x, act_scale: float) -> torch.Tensor:
    """``clip(round(f32(x) / act_scale), -127, 127)`` as int8."""
    s = torch.tensor([act_scale], dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def int8_conv_reference(x, w_q, scale, act_scale: float, bias, stride, pad,
                        dilate, groups: int) -> torch.Tensor:
    """The plain version of `int8_conv` (see the module docstring)."""
    nd = x.dim() - 2
    xq = quantize_activation(x, act_scale)
    with torch.backends.cudnn.flags(enabled=False):
        acc = _CONV[nd](xq.double(), w_q.double(), None, tuple(stride),
                        tuple(pad), tuple(dilate), groups)
    shape = (1, -1) + (1,) * nd
    out = acc.to(torch.int32).float() * scale.reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out.to(x.dtype)


def _out_size(n, k, s, p, d):
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def _check(x, w_q, scale, bias, groups):
    if x.dtype not in _DTYPES:
        raise MXNetError(f"int8_conv: x dtype {x.dtype} (float32 or "
                         f"bfloat16)")
    nd = x.dim() - 2
    if nd not in _CONV or w_q.dim() != x.dim() or w_q.dtype != torch.int8:
        raise MXNetError(f"int8_conv: x {tuple(x.shape)} and int8 weights "
                         f"{tuple(w_q.shape)} {w_q.dtype} (1-3 spatial dims)")
    O = w_q.shape[0]
    if x.shape[1] != w_q.shape[1] * groups or O % groups:
        raise MXNetError(f"int8_conv: {x.shape[1]} input channels, weights "
                         f"{tuple(w_q.shape)}, {groups} groups")
    for t, what in ((scale, "scale"), (bias, "bias")):
        if t is not None and (t.dtype != torch.float32 or t.numel() != O
                              or t.device != x.device):
            raise MXNetError(f"int8_conv: {what} must be f32 ({O},) on "
                             f"{x.device}")
    if w_q.device != x.device:
        raise MXNetError("int8_conv: weights on another device")


def _launch(x, w_q, scale, act_scale, bias, stride, pad, dilate, groups,
            fn):
    """Launch ``mx_int8_conv``, counted as a launch of ``fn``
    (`int8_conv` or `int8_dense`): the output, NC[D]HW in x's dtype."""
    _check(x, w_q, scale, bias, groups)
    nd = x.dim() - 2
    lead = (1,) * (3 - nd)
    ins = lead + tuple(x.shape[2:])
    ks = lead + tuple(w_q.shape[2:])
    st, dl = lead + tuple(stride), lead + tuple(dilate)
    pd = (0,) * (3 - nd) + tuple(pad)
    outs = tuple(_out_size(*a) for a in zip(ins, ks, st, pd, dl))
    if min(outs) <= 0:
        raise MXNetError(f"int8_conv: empty output {outs[3 - nd:]}")
    N, C, O = x.shape[0], x.shape[1], w_q.shape[0]
    out = torch.empty((N, O) + outs[3 - nd:], dtype=x.dtype, device=x.device)
    dims = (ctypes.c_longlong * 22)(N, C, O, groups, *ins, *outs, *ks, *st,
                                    *pd, *dl)
    x = x.contiguous()
    w_q = w_q.contiguous()
    hit = _bound.get("fn")
    lib = _build.load("int8_conv")
    if hit is None or hit[0] is not lib:
        entry = lib.mx_int8_conv
        entry.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_float,
                          ctypes.c_int, _P]
        entry.restype = ctypes.c_int
        hit = _bound["fn"] = (lib, entry)
    err = hit[1](x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 dims, float(act_scale), _DTYPES[x.dtype],
                 _build.stream(x.device))
    if err != 0:
        raise MXNetError(f"int8 convolution kernel launch failed "
                         f"(CUDA error {err})")
    _graphs.note_launch(fn)
    return out


def _on_cuda(x) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise MXNetError(f"int8_conv: unsupported device {x.device}")


def int8_conv(x, w_q, scale, act_scale: float, bias, stride, pad, dilate,
              groups: int = 1) -> torch.Tensor:
    """The int8 convolution (see the module docstring): the kernel for a
    CUDA ``x``, the plain version for a CPU one."""
    args = (x, w_q, scale, act_scale, bias, stride, pad, dilate, groups)
    if _on_cuda(x):
        return _launch(*args, int8_conv)
    return int8_conv_reference(*args)


def int8_dense(x, w_q, scale, act_scale: float, bias=None) -> torch.Tensor:
    """``f32(int8(x) @ w_qᵀ) * scale + bias`` in x's dtype for (M, K)
    ``x`` and (N, K) int8 weights: the convolution over (M, K, 1, 1)."""
    args = (x[:, :, None, None], w_q[:, :, None, None], scale, act_scale,
            bias, (1, 1), (0, 0), (1, 1), 1)
    out = _launch(*args, int8_dense) if _on_cuda(x) \
        else int8_conv_reference(*args)
    return out.reshape(x.shape[0], w_q.shape[0])


# kernel launches since import (the main-path proof in chip_smoke.py),
# the convolutions' and the dense products' apart
int8_conv.launches = 0
int8_dense.launches = 0
