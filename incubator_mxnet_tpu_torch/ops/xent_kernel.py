"""Streamed sparse softmax cross-entropy over wide vocabularies
(PyTorch/CUDA port of `incubator_mxnet_tpu/ops/xent_kernel.py`).

``-log_softmax(logits)[label]`` over (N, V) logits without an (N, V)
f32 log-probability tensor: the forward reads the logits once and keeps
only the f32 row logsumexp (and, for the label-smoothed loss, the raw
row sum); the backward regenerates softmax from the saved lse and
writes d(logits) in the logits' dtype.  Two versions of each half:

* `stats_reference` / `dlogits_reference` — the plain PyTorch version:
  f32 ``logsumexp`` and sum; ``(exp(x - lse) - target) * g`` with a
  one-hot target.  The CPU path, and the oracle the kernels are held
  to.
* ``csrc/xent.cu`` — the hand-written CUDA kernels that replace the
  Pallas TPU kernels `_fwd_kernel` (launched by `_pallas_fwd`) and
  `_bwd_kernel` (launched by `_pallas_bwd`).

`xent_forward` and `xent_backward` take the plain version only for CPU
tensors; for CUDA tensors they launch their kernel or raise.  The loss
value ``lse - x[label]`` (smoothed: ``lse - (1-eps)·x[label] -
eps·mean(x)``) is torch ops around the forward, as in the JAX package,
and `fused_sparse_xent` / `fused_smoothed_xent` wrap forward and
backward in one `torch.autograd.Function`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build, _graphs
from ..base import MXNetError

__all__ = ["fused_sparse_xent", "fused_smoothed_xent", "should_fuse",
           "FUSED_MIN_CLASSES", "xent_forward", "xent_backward",
           "stats_reference", "dlogits_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# below this class count the streamed path's per-call overhead outweighs
# the (N, V) f32 log-prob tensor it avoids (the JAX package's constant)
FUSED_MIN_CLASSES = 512


def should_fuse(num_classes: int) -> bool:
    """The gate both public xent entry points share (the gluon loss and
    ``nd.softmax_cross_entropy``).  The JAX package also requires a TPU
    backend; in the port every device takes the streamed function — the
    kernels on CUDA, their plain version on the CPU."""
    return num_classes >= FUSED_MIN_CLASSES


def stats_reference(x2: torch.Tensor, want_sum: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(lse, row sum or None), f32 (N,), with torch ops."""
    xf = x2.float()
    return torch.logsumexp(xf, dim=-1), (xf.sum(-1) if want_sum else None)


def dlogits_reference(x2, labels, lse, g, eps: float = 0.0):
    """d(logits) = (softmax - ((1-eps)·onehot + eps/V)) · g, in x's dtype."""
    V = x2.shape[-1]
    p = torch.exp(x2.float() - lse[:, None])
    oh = F.one_hot(labels.long(), V).float()
    tgt = oh if eps == 0.0 else (1.0 - eps) * oh + eps / V
    return ((p - tgt) * g.float()[:, None]).to(x2.dtype)


def _check(x2):
    if x2.dim() != 2 or not x2.is_contiguous():
        raise MXNetError("xent: logits must be a contiguous (N, V) tensor")
    if x2.dtype not in _DTYPES:
        raise MXNetError(f"xent: logits dtype {x2.dtype} is not one of "
                         f"{list(_DTYPES)}")


def _fwd_cuda(x2, want_sum):
    """Launch the forward kernel: (lse, row sum or None), f32 (N,)."""
    _check(x2)
    N, V = x2.shape
    lse = torch.empty(N, dtype=torch.float32, device=x2.device)
    xsum = torch.empty_like(lse) if want_sum else None
    if N == 0:
        return lse, xsum
    import ctypes

    fn = _build.load("xent").mx_xent_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_DTYPES[x2.dtype], x2.data_ptr(), lse.data_ptr(),
             xsum.data_ptr() if want_sum else None, N, V,
             _build.stream(x2.device))
    if err != 0:
        raise MXNetError(f"xent forward kernel launch failed "
                         f"(CUDA error {err})")
    _graphs.note_launch(xent_forward)
    return lse, xsum


def _bwd_cuda(x2, labels, lse, g, eps):
    """Launch the backward kernel: d(logits) like x2."""
    _check(x2)
    N, V = x2.shape
    dx = torch.empty_like(x2)
    if N == 0:
        return dx
    labels = labels.to(torch.int32).contiguous()
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    import ctypes

    fn = _build.load("xent").mx_xent_bwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_DTYPES[x2.dtype], x2.data_ptr(), labels.data_ptr(),
             lse.data_ptr(), g.data_ptr(), dx.data_ptr(), N, V, float(eps),
             _build.stream(x2.device))
    if err != 0:
        raise MXNetError(f"xent backward kernel launch failed "
                         f"(CUDA error {err})")
    _graphs.note_launch(xent_backward)
    return dx


def _device_of(x2):
    if x2.device.type not in ("cuda", "cpu"):
        raise MXNetError(f"xent: unsupported device {x2.device}")
    return x2.device.type


def xent_forward(x2: torch.Tensor, want_sum: bool = False):
    """(lse, row sum or None) of (N, V) logits, f32 (N,).  CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    if _device_of(x2) == "cuda":
        return _fwd_cuda(x2, want_sum)
    return stats_reference(x2, want_sum)


def xent_backward(x2, labels, lse, g, eps: float = 0.0) -> torch.Tensor:
    """d(logits) for per-row loss gradients ``g``.  CUDA tensors launch
    the kernel, CPU tensors take the plain version."""
    if _device_of(x2) == "cuda":
        return _bwd_cuda(x2, labels, lse, g, eps)
    return dlogits_reference(x2, labels, lse, g, eps)


# kernel launches since import (the main-path proof in chip_smoke.py)
xent_forward.launches = 0
xent_backward.launches = 0


def _smooth_value(x2, labels, eps, lse, xsum):
    """lse - (1-eps)·x[label] - eps·mean(x): the exact smoothed CE,
    reassociated so only row statistics survive the (N, V) stream."""
    pick = x2.gather(1, labels.long()[:, None])[:, 0].float()
    if eps == 0.0:
        return lse - pick
    return lse - (1.0 - eps) * pick - (eps / x2.shape[-1]) * xsum


class _Xent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, labels, eps):
        lse, xsum = xent_forward(x2, want_sum=eps != 0.0)
        ctx.save_for_backward(x2, labels, lse)
        ctx.eps = eps
        return _smooth_value(x2, labels, eps, lse, xsum)

    @staticmethod
    def backward(ctx, g):
        x2, labels, lse = ctx.saved_tensors
        return xent_backward(x2, labels, lse, g, ctx.eps), None, None


def _xent(logits, labels, eps):
    V = logits.shape[-1]
    lead = logits.shape[:-1]
    x2 = logits.reshape(-1, V).contiguous()
    return _Xent.apply(x2, labels.reshape(-1), float(eps)).reshape(lead)


def fused_sparse_xent(logits, labels):
    """Per-element ``lse - logits[label]``, f32 (...), differentiable in
    logits.  logits: (..., V); labels: integer (...)."""
    return _xent(logits, labels, 0.0)


def fused_smoothed_xent(logits, labels, smoothing: float):
    """Label-smoothed CE ``lse - (1-eps)·logits[label] - eps·mean(logits)``
    per element; the row sum rides the forward's streaming pass and the
    backward folds the eps/V uniform target in.  smoothing=0 is
    `fused_sparse_xent`."""
    return _xent(logits, labels, smoothing)
