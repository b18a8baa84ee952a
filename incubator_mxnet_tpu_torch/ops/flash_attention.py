"""Flash attention forward (PyTorch/CUDA port of
`incubator_mxnet_tpu/ops/flash_attention.py`).

softmax(Q Kᵀ · scale) V over (B, H, T, D), with causal masking
bottom-right aligned (query i sees key j iff j − (Tk − Tq) ≤ i) and
rows that see no key giving output 0 and logsumexp −inf.  Two
versions of one function:

* `attention_reference` / `_reference_attention_lse` — the plain
  PyTorch version: f32 scores, −inf mask, `_safe_softmax`, f32 PV.
  The CPU path, and the oracle the kernel is held to.
* ``csrc/flash_attention.cu`` — the hand-written CUDA kernel that
  replaces the Pallas TPU kernels `_fa_kernel_resident` and
  `_fa_kernel_streamed` (launched by `_flash_core`): one thread block
  per (batch·head, 64-row query tile) streams K/V tiles through shared
  memory with an f32 online softmax, skipping tiles past the causal
  diagonal.  It runs at every size on CUDA (no crossover to the plain
  version yet).  The source says what bounds it on the H100.

`flash_attention` / `flash_attention_with_lse` take the plain version
only for CPU tensors; for CUDA tensors they launch the kernel or
raise.  The forward is all this slice ports: inputs that require grad
are refused until the backward kernels exist.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_with_lse",
           "attention_reference", "attention_bthd", "kernel_active"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 128

# the JAX package's forward crossover off the CPU: below this many
# scores per (batch, head) its models take the XLA attention
# (`attention_bthd`), at or above it the flash kernel
_FLASH_MIN_SCORES = 512 * 512


def kernel_active(tq: int, tk: int, device) -> bool:
    """Would a model's attention take the flash kernel at these sizes on
    ``device``?  On CUDA, at or above the JAX package's crossover
    (``tq * tk >= 512 * 512``); on the CPU never (models there take
    `attention_bthd`)."""
    return torch.device(device).type == "cuda" \
        and tq * tk >= _FLASH_MIN_SCORES


def attention_bthd(q, k, v, scale: Optional[float] = None):
    """Transpose-free attention on (B, T, H, D) tensors: f32 scores,
    softmax, f32 PV, output in q's dtype — the XLA computation of the
    JAX package's `attention_bthd` (non-causal, unmasked) in torch ops,
    differentiable through `torch.autograd`."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _causal_mask(tq, tk, device):
    """(Tq, Tk) bool, bottom-right aligned: ``tril(k=Tk - Tq)``."""
    return torch.ones((tq, tk), dtype=torch.bool,
                      device=device).tril(diagonal=tk - tq)


def _safe_softmax(s):
    """Softmax along -1 that returns 0 (not NaN) on fully-masked rows —
    the flash-kernel convention for queries with no visible keys."""
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(torch.isfinite(s), torch.exp(s - m_safe),
                    torch.zeros_like(s))
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


def _scores(q, k, causal, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(s.shape[-2], s.shape[-1], s.device)
        s = s.masked_fill(~mask, float("-inf"))
    return s


def attention_reference(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Plain softmax(QKᵀ)V oracle. q, k, v: (B, H, T, D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p = _safe_softmax(_scores(q, k, causal, scale))
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _reference_attention_lse(q, k, v, causal, scale):
    """(out, lse) from ONE score computation."""
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    l = e.sum(dim=-1)
    lse = torch.where(l > 0, m_safe + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, float("-inf")))
    p = e / torch.clamp(l, min=1e-30)[..., None]
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return out, lse


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention: q, k, v must be (B, H, T, D)")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != H \
            or k.shape[3] != D:
        raise MXNetError(f"flash_attention: shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if D > _MAX_D or D % 8:
        raise MXNetError(f"flash_attention: head dim {D} must be a "
                         f"multiple of 8 <= {_MAX_D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f"flash_attention: q, k, v must share one dtype "
                         f"of {list(_DTYPES)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise MXNetError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise MXNetError(f"flash_attention: {name} must be contiguous")


def _flash_core(q, k, v, causal, scale):
    """Launch the CUDA kernel: (out (B, H, Tq, D) in q.dtype,
    lse (B, H, Tq) f32)."""
    _check(q, k, v)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if B * H * Tq == 0:
        return out, lse
    import ctypes

    lib = _build.load("flash_attention")
    fn = lib.mx_flash_attention_fwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), lse.data_ptr(), B * H, Tq, Tk, D, int(causal),
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError(f"flash_attention kernel launch failed "
                         f"(CUDA error {err})")
    flash_attention.launches += 1
    return out, lse


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None):
    """(out, logsumexp) attention; q, k, v (B, H, T, D) tensors.  lse is
    f32 (B, H, Tq), −inf on rows that see no key."""
    if any(t.requires_grad for t in (q, k, v)):
        raise MXNetError("flash_attention is forward-only in this port: "
                         "its backward kernels are not written yet")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _flash_core(q, k, v, causal, scale)
    if q.device.type != "cpu":
        raise MXNetError(f"flash_attention: unsupported device {q.device}")
    return _reference_attention_lse(q, k, v, causal, scale)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """Fused attention; q, k, v (B, H, T, D) tensors, output in q.dtype.
    CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    return flash_attention_with_lse(q, k, v, causal, scale)[0]


# kernel launches since import (the main-path proof in chip_smoke.py)
flash_attention.launches = 0
