"""Flash attention, forward and backward (PyTorch/CUDA port of
`incubator_mxnet_tpu/ops/flash_attention.py`).

softmax(Q Kᵀ · scale) V over (B, H, T, D), with causal masking
bottom-right aligned (query i sees key j iff j − (Tk − Tq) ≤ i) and
rows that see no key giving output 0 and logsumexp −inf.  The backward
recomputes the probabilities from the saved lse, with
Δ = rowsum(dO ∘ O) (Δ − dlse in the ``(out, lse)`` variant).  Two
versions of each half:

* plain PyTorch — forward `attention_reference` /
  `_reference_attention_lse` (f32 scores, −inf mask, `_safe_softmax`,
  f32 PV); backward `flash_bwd_plain` (the math of the JAX package's
  `_bwd_block_terms` over the whole score matrix, from the lse).  The
  CPU path, and the oracles the kernels are held to.
  `_flash_bwd_reference` (softmax recomputed, Δ overridable) is the
  port of the JAX package's exact backward, a second oracle.  These
  build the whole (Tq, Tk) score matrix, 64 GB in f32 at B=1, H=16,
  T=32768; `attention_chunked` / `flash_bwd_chunked` are the same math
  a block of query rows at a time against the keys it sees, the oracles
  at long T (no caller on a model's path).
* CUDA — ``csrc/flash_attention.cu`` replaces the Pallas TPU kernels
  `_fa_kernel_resident` and `_fa_kernel_streamed` (launched by
  `_flash_core`); ``csrc/flash_attention_bwd.cu`` replaces
  `_fa_dkdv_kernel` and `_fa_dq_kernel` (launched by
  `_flash_bwd_core`).  Each kernel's block owns its output tile and
  walks the other operand's tiles, skipping tiles past the causal
  diagonal: in bf16 with `wgmma` products on tiles that TMA streams
  into shared memory (the helpers shared through
  ``csrc/hopper_tc.cuh``), in f32 with f32 products on the CUDA cores.
  The sources say what bounds them on the H100.

`flash_attention` / `flash_attention_with_lse` run the kernels on CUDA
tensors (or raise) and the plain versions on CPU tensors.  When an
input requires grad they go through a `torch.autograd.Function` whose
backward is the two backward kernels (`flash_bwd_dkdv`, `flash_bwd_dq`)
on CUDA and `flash_bwd_plain` on the CPU; otherwise only the forward
runs and nothing is saved.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _build, _graphs
from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_with_lse",
           "attention_reference", "attention_bthd", "kernel_active",
           "flash_bwd_plain", "flash_bwd_dkdv", "flash_bwd_dq",
           "attention_chunked", "flash_bwd_chunked"]

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


def _check(q, k, v, do=None):
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
    if do is not None and (do.shape != q.shape or do.dtype != q.dtype):
        raise MXNetError(f"flash_attention: dO {tuple(do.shape)} "
                         f"{do.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    named = (("q", q), ("k", k), ("v", v)) + ((("dO", do),) if do is not None
                                              else ())
    for name, t in named:
        if t.device != q.device:
            raise MXNetError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise MXNetError(f"flash_attention: {name} must be contiguous")


def _flash_core(q, k, v, causal, scale):
    """Launch the forward kernel: (out (B, H, Tq, D) in q.dtype,
    lse (B, H, Tq) f32).  The bf16 kernel folds the scale into its
    exp2 and takes it >= 0: a negative one is carried by -q."""
    _check(q, k, v)
    if q.dtype == torch.bfloat16 and scale < 0:
        q, scale = -q, -scale
    q, k, v = (_aligned(t) for t in (q, k, v))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if B * H * Tq == 0:
        return out, lse
    import ctypes

    fn = _build.load("flash_attention").mx_flash_attention_fwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), lse.data_ptr(), B * H, Tq, Tk, D, int(causal),
             float(scale), _build.stream(q.device))
    if err != 0:
        raise MXNetError(f"flash_attention kernel launch failed "
                         f"(CUDA error {err})")
    _graphs.note_launch(flash_attention)
    return out, lse


def _device_of(q):
    if q.device.type not in ("cuda", "cpu"):
        raise MXNetError(f"flash_attention: unsupported device {q.device}")
    return q.device.type


def _flash_fwd(q, k, v, causal, scale):
    """(out, lse): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if _device_of(q) == "cuda":
        return _flash_core(q, k, v, causal, scale)
    return _reference_attention_lse(q, k, v, causal, scale)


# ---------------------------------------------------------------- backward
def flash_bwd_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dq, dk, dv) from the saved lse and Δ, in torch ops: the math of
    the JAX package's `_bwd_block_terms` over the whole score matrix.
    An entry is valid when (causal) its key is visible to its query and
    its row's lse is finite; there ``p = exp(s − lse)``, elsewhere 0.
    ``ds = p·(dp − Δ)·scale``, ``dv = pᵀ·dO``, ``dk = dsᵀ·q``,
    ``dq = ds·k``; f32 sums, outputs in the inputs' dtype."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    finite = torch.isfinite(lse)
    valid = finite[..., None].expand_as(s)
    if causal:
        valid = valid & _causal_mask(s.shape[-2], s.shape[-1], s.device)
    lse0 = torch.where(finite, lse, torch.zeros_like(lse))
    p = torch.where(valid, torch.exp(s - lse0[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.float()[..., None]) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_reference(q, k, v, do, causal, scale, delta=None):
    """The JAX package's exact backward: the softmax recomputed from the
    scores (no lse), Δ = rowsum(dP ∘ P) unless ``delta`` overrides it
    (the lse-cotangent variant passes Δ − dlse)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = _safe_softmax(_scores(q, k, causal, scale))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    if delta is None:
        delta = (dp * p).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _row_blocks(Tq, Tk, causal, rows, device):
    """The query blocks of the chunked versions: (i0, i1, keys the block
    sees, its (i1 - i0, keys) validity mask or None)."""
    for i0 in range(0, Tq, rows):
        i1 = min(Tq, i0 + rows)
        if not causal:
            yield i0, i1, Tk, None
            continue
        kend = max(0, min(Tk, i1 + Tk - Tq))
        qpos = torch.arange(i0, i1, device=device)[:, None] + (Tk - Tq)
        yield i0, i1, kend, torch.arange(kend, device=device)[None] <= qpos


def attention_chunked(q, k, v, causal: bool = False,
                      scale: Optional[float] = None, rows: int = 1024):
    """(out, lse) as `_reference_attention_lse` computes them, ``rows``
    query rows at a time against the keys they see (causal: up to the
    block's last diagonal), so no (Tq, Tk) tensor exists: f32 scores,
    −inf mask, f32 PV; out in q's dtype, lse f32 (−inf on rows that see
    no key, whose out is 0)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    B, H, Tq, _ = q.shape
    out = torch.zeros_like(q)
    lse = torch.full((B, H, Tq), float("-inf"), dtype=torch.float32,
                     device=q.device)
    kf, vf = k.float(), v.float()
    for i0, i1, kend, mask in _row_blocks(Tq, k.shape[2], causal, rows,
                                          q.device):
        if kend == 0:
            continue
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i0:i1].float(),
                         kf[:, :, :kend]) * scale
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        e = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]),
                        torch.zeros_like(s))
        del s
        l = e.sum(dim=-1)
        lse[:, :, i0:i1] = torch.where(
            l > 0, m_safe + torch.log(torch.clamp(l, min=1e-30)),
            torch.full_like(l, float("-inf")))
        p = e.div_(torch.clamp(l, min=1e-30)[..., None])
        out[:, :, i0:i1] = torch.einsum("bhqk,bhkd->bhqd", p,
                                        vf[:, :, :kend]).to(q.dtype)
    return out, lse


def flash_bwd_chunked(q, k, v, do, lse, delta, causal: bool, scale: float,
                      rows: int = 1024):
    """(dq, dk, dv) as `flash_bwd_plain` computes them from the saved lse
    and Δ, ``rows`` query rows at a time: each block's dq whole, its
    dK/dV terms added into f32 sums over the keys it sees."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i0, i1, kend, mask in _row_blocks(q.shape[2], k.shape[2], causal,
                                          rows, q.device):
        if kend == 0:
            continue
        qb, dob = qf[:, :, i0:i1], dof[:, :, i0:i1]
        kb, vb = kf[:, :, :kend], vf[:, :, :kend]
        lb = lse[:, :, i0:i1]
        s = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
        finite = torch.isfinite(lb)
        valid = finite[..., None].expand_as(s)
        if mask is not None:
            valid = valid & mask
        lse0 = torch.where(finite, lb, torch.zeros_like(lb))
        p = torch.where(valid, torch.exp(s - lse0[..., None]),
                        torch.zeros_like(s))
        del s, valid
        dp = torch.einsum("bhqd,bhkd->bhqk", dob, vb)
        ds = p * (dp - delta[:, :, i0:i1].float()[..., None]) * scale
        del dp
        dv[:, :, :kend] += torch.einsum("bhqk,bhqd->bhkd", p, dob)
        dk[:, :, :kend] += torch.einsum("bhqk,bhqd->bhkd", ds, qb)
        dq[:, :, i0:i1] = torch.einsum("bhqk,bhkd->bhqd", ds, kb)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_rows(q, lse, delta):
    want = tuple(q.shape[:3])
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != want or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise MXNetError(f"flash_attention backward: {name} must be a "
                             f"contiguous f32 {want} tensor on {q.device}")


def _aligned(t):
    """``t``, or a copy of it if its data is not 16-byte aligned (the
    bf16 kernels, forward and backward, load their tiles with TMA, which
    needs that)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bwd_launch(entry, q, k, v, do, lse, delta, outs, causal, scale):
    """Launch ``entry`` of csrc/flash_attention_bwd.cu into ``outs``."""
    _check(q, k, v, do)
    _check_rows(q, lse, delta)
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    import ctypes

    fn = getattr(_build.load("flash_attention_bwd"), entry)
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * (6 + len(outs)) \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, H, Tq, D = q.shape
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             *(t.data_ptr() for t in outs), B * H, Tq, k.shape[2], D,
             int(causal), float(scale), _build.stream(q.device))
    if err != 0:
        raise MXNetError(f"flash attention backward kernel launch failed "
                         f"({entry}, CUDA error {err})")


def _dkdv_cuda(q, k, v, do, lse, delta, causal, scale):
    """Launch the dK/dV kernel: (dk, dv), each like k."""
    if k.numel() == 0:
        return torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("mx_flash_attention_dkdv", q, k, v, do, lse, delta,
                (dk, dv), causal, scale)
    _graphs.note_launch(flash_bwd_dkdv)
    return dk, dv


def _dq_cuda(q, k, v, do, lse, delta, causal, scale):
    """Launch the dQ kernel: dq like q."""
    if q.numel() == 0:
        return torch.zeros_like(q)
    dq = torch.empty_like(q)
    _bwd_launch("mx_flash_attention_dq", q, k, v, do, lse, delta, (dq,),
                causal, scale)
    _graphs.note_launch(flash_bwd_dq)
    return dq


def flash_bwd_dkdv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dk, dv), each like k.  CUDA tensors launch the dK/dV kernel, CPU
    tensors take the plain version."""
    if _device_of(q) == "cuda":
        return _dkdv_cuda(q, k, v, do, lse, delta, causal, scale)
    return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)[1:]


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dq like q.  CUDA tensors launch the dQ kernel, CPU tensors take
    the plain version."""
    if _device_of(q) == "cuda":
        return _dq_cuda(q, k, v, do, lse, delta, causal, scale)
    return flash_bwd_plain(q, k, v, do, lse, delta, causal, scale)[0]


def _flash_bwd_core(q, k, v, do, lse, delta, causal, scale):
    """The two backward kernels on CUDA tensors: (dq, dk, dv)."""
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, causal, scale)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal, scale), dk, dv


class _FlashAttention(torch.autograd.Function):
    """(out, lse) with the flash backward; a cotangent left out (None)
    counts as zero."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        do = torch.zeros_like(out) if dout is None else dout.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        if dlse is not None:
            # d(lse)/ds = P: the lse cotangent folds into the row term
            delta = delta - dlse.float()
        bwd = _flash_bwd_core if _device_of(q) == "cuda" else flash_bwd_plain
        dq, dk, dv = bwd(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None):
    """(out, logsumexp) attention; q, k, v (B, H, T, D) tensors.  lse is
    f32 (B, H, Tq), −inf on rows that see no key.  Differentiable in q,
    k and v through both outputs."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _flash_fwd(q, k, v, causal, scale)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """Fused attention; q, k, v (B, H, T, D) tensors, output in q.dtype.
    CUDA tensors launch the kernels, CPU tensors take the plain
    versions."""
    return flash_attention_with_lse(q, k, v, causal, scale)[0]


# kernel launches since import (the main-path proof in chip_smoke.py)
flash_attention.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_dq.launches = 0
