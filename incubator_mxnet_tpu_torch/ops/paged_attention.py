"""Single-query paged attention over the serving KV pool (PyTorch/CUDA
port of `incubator_mxnet_tpu/ops/paged_attention.py`).

The serving programs decode one token per lane against that lane's
block table; the prefill-chunk program runs the same attention with
each window row as a lane.  Two versions of one function:

* `paged_attention_dense` — the plain PyTorch version, the JAX dense
  recipe verbatim: gather every page into a (B, H, W, D) view (int8
  pages dequantized after the gather, ``f32(page) * scale``), f32
  scores / sqrt(D), ``finfo(f32).min`` position mask, full-width f32
  softmax, f32 PV.  The CPU path, and the oracle the kernels are held
  to.
* ``csrc/paged_attention.cu`` — the hand-written CUDA kernel that
  replaces the Pallas TPU kernel `_paged_kernel`, in two entry points:
  ``mx_paged_attention`` for float pages (the TPU's `_paged_core`) and
  ``mx_paged_attention_q8`` for int8 pages with an f32 scale per
  (block, head, slot) (the TPU's `_paged_core_q8`), dequantized as
  each page is loaded.  One thread block per (lane, head) splits the
  lane's pages (through its block-table row) over eight warps, each
  with its own f32 online softmax, merges the warps' partials in a
  fixed order, and skips pages past ``pos // block_size``.  It is bound
  by the bytes of the live pages; the source says what its design does
  about that.  The pools must be 16-byte aligned (the kernel loads
  16-byte vectors of a slot row).

`paged_attention` takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.  With ``scale_k`` and
``scale_v`` it goes through `paged_attention_q8`, the int8 kernel's
wrapper, which counts its own launches.  Both keep the two facts
the serving engine's eviction contract rests on (docs/serving.md, "Why
eviction is exact"): masked slots contribute exactly 0.0 and lanes
never mix.  They agree to f32 roundoff, not bitwise, and an engine only
ever runs one of them.

Layouts are the JAX package's: q (B, H, D); pools (num_blocks, H, bs,
D) in q's dtype, or int8 with f32 scales (num_blocks, H, bs); tables
(B, blocks_per_seq) int32; pos (B,) int32, attending slots ``<= pos``;
output (B, H, D) in q's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _build, _graphs
from ..base import MXNetError
from ..telemetry import perf as _perf

__all__ = ["paged_attention", "paged_attention_dense",
           "paged_attention_q8", "kernel_shape_problem"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_BLOCK = 64
_IMPLS = (None, "kernel", "dense")


def kernel_shape_problem(head_dim: int, block_size: int) -> Optional[str]:
    """Why the CUDA kernels refuse pages of this head dim and block
    size, or None when they take them (head dims in `_HEAD_DIMS`, block
    sizes a power of two <= `_MAX_BLOCK`).  The plain version takes
    any."""
    if head_dim not in _HEAD_DIMS:
        return f"head dim {head_dim} not in {_HEAD_DIMS}"
    if block_size < 1 or block_size > _MAX_BLOCK \
            or block_size & (block_size - 1):
        return (f"block size {block_size} must be a power of two <= "
                f"{_MAX_BLOCK}")
    return None


def _dequant(pages, scales):
    """(..., bs, D) int8 pages x (..., bs) f32 scales -> f32."""
    return pages.float() * scales[..., None]


def paged_attention_dense(q, pool_k, pool_v, tables, pos, scale_k=None,
                          scale_v=None):
    """The dense-gather recipe, verbatim: gather the lane's pages into a
    (B, H, W, D) view, f32 scores / sqrt(D), iota position mask at
    ``finfo(f32).min``, full-width f32 softmax, f32 PV.  int8 pools
    (``scale_k``/``scale_v`` given) are dequantized after the gather,
    with the same score math."""
    B, nbps = tables.shape
    H, bs, D = pool_k.shape[1], pool_k.shape[2], pool_k.shape[3]
    W = nbps * bs
    idx = tables.long()
    gk, gv = pool_k[idx], pool_v[idx]
    if scale_k is not None:
        gk = _dequant(gk, scale_k[idx])
        gv = _dequant(gv, scale_v[idx])
    gk = gk.permute(0, 2, 1, 3, 4).reshape(B, H, W, D)
    gv = gv.permute(0, 2, 1, 3, 4).reshape(B, H, W, D)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), gk.float()) / math.sqrt(D)
    kpos = torch.arange(W, device=q.device)
    s = torch.where(kpos[None, None, :] <= pos.long()[:, None, None], s,
                    torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, gv.float()).to(q.dtype)


def _check(q, pool_k, pool_v, tables, pos, scale_k=None, scale_v=None):
    quant = scale_k is not None
    if q.dim() != 3 or pool_k.dim() != 4 or tables.dim() != 2 \
            or pos.dim() != 1:
        raise MXNetError("paged_attention: q (B, H, D), pools "
                         "(num_blocks, H, bs, D), tables (B, nbps), pos (B,)")
    B, H, D = q.shape
    bs = pool_k.shape[2]
    if pool_k.shape != pool_v.shape or pool_k.shape[1] != H \
            or pool_k.shape[3] != D or tables.shape[0] != B \
            or pos.shape[0] != B:
        raise MXNetError(
            f"paged_attention: shapes disagree: q {tuple(q.shape)}, pools "
            f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}, tables "
            f"{tuple(tables.shape)}, pos {tuple(pos.shape)}")
    problem = kernel_shape_problem(D, bs)
    if problem is not None:
        raise MXNetError(f"paged_attention: {problem}")
    page_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPES or pool_k.dtype != page_dtype \
            or pool_v.dtype != page_dtype:
        pools = "int8" if quant else "of q's dtype"
        raise MXNetError(f"paged_attention: q must be one of "
                         f"{list(_DTYPES)} and the pools {pools}")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise MXNetError("paged_attention: tables and pos must be int32")
    named = [("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
             ("tables", tables), ("pos", pos)]
    if quant:
        for name, t in (("scale_k", scale_k), ("scale_v", scale_v)):
            if t.dtype != torch.float32 or t.shape != pool_k.shape[:3]:
                raise MXNetError(
                    f"paged_attention: {name} must be float32 "
                    f"{tuple(pool_k.shape[:3])}, got {t.dtype} "
                    f"{tuple(t.shape)}")
        named += [("scale_k", scale_k), ("scale_v", scale_v)]
    for name, t in named:
        if t.device != q.device:
            raise MXNetError(f"paged_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise MXNetError(f"paged_attention: {name} must be contiguous")


def _ctypes_fn(name, n_ptrs):
    import ctypes

    fn = getattr(_build.load("paged_attention"), name)
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, pool_k, pool_v, tables, pos):
    """The float-page kernel (`mx_paged_attention`)."""
    fn = _ctypes_fn("mx_paged_attention", 6)
    B, H, D = q.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = fn(_DTYPES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
             pool_v.data_ptr(), tables.data_ptr(), pos.data_ptr(),
             out.data_ptr(), B, H, D, pool_k.shape[2], tables.shape[1],
             _build.stream(q.device))
    if err != 0:
        raise MXNetError(f"paged_attention kernel launch failed "
                         f"(CUDA error {err})")
    _graphs.note_launch(paged_attention)
    _cost(q, pool_k, tables, 0)
    return out


def _cost(q, pool_k, tables, scale_bytes) -> None:
    """telemetry's count of a paged launch, from shapes: the positions
    live on the card, so every block-table slot counts (4 flops x D a
    slot and head; read its K and V pages and scales, q, the tables and
    positions; write out)."""
    B, H, D = q.shape
    bs = pool_k.shape[2]
    slots = tables.numel() * bs
    _perf.add_kernel_cost(
        4 * slots * H * D,
        2 * slots * H * (D * pool_k.element_size() + scale_bytes)
        + 2 * q.numel() * q.element_size() + tables.numel() * 4 + B * 4)


def _launch_q8(q, pool_k, pool_v, scale_k, scale_v, tables, pos):
    """The int8-page kernel (`mx_paged_attention_q8`)."""
    fn = _ctypes_fn("mx_paged_attention_q8", 8)
    B, H, D = q.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = fn(_DTYPES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
             pool_v.data_ptr(), scale_k.data_ptr(), scale_v.data_ptr(),
             tables.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H, D,
             pool_k.shape[2], tables.shape[1], _build.stream(q.device))
    if err != 0:
        raise MXNetError(f"paged_attention_q8 kernel launch failed "
                         f"(CUDA error {err})")
    _graphs.note_launch(paged_attention_q8)
    _cost(q, pool_k, tables, 4)
    return out


def _on_cuda(q, impl) -> bool:
    """Whether ``q``'s device takes the kernel (cuda) or the plain
    version (cpu); ``impl`` may only name the one it implies."""
    if impl not in _IMPLS:
        raise ValueError(f"paged_attention impl {impl!r} (kernel|dense)")
    on_cuda = q.device.type == "cuda"
    if impl is not None and impl != ("kernel" if on_cuda else "dense"):
        raise MXNetError(f"paged_attention impl {impl!r} does not run on "
                         f"{q.device.type} tensors")
    if not on_cuda and q.device.type != "cpu":
        raise MXNetError(f"paged_attention: unsupported device {q.device}")
    return on_cuda


def paged_attention_q8(q, pool_k, pool_v, scale_k, scale_v, tables, pos, *,
                       impl: Optional[str] = None):
    """`paged_attention` over an int8 pool: pages (num_blocks, H, bs, D)
    int8 with f32 scales (num_blocks, H, bs), dequantized inside the
    kernel.  CUDA tensors launch ``mx_paged_attention_q8``; CPU tensors
    take `paged_attention_dense` with the scales."""
    if not _on_cuda(q, impl):
        return paged_attention_dense(q, pool_k, pool_v, tables, pos,
                                     scale_k, scale_v)
    _check(q, pool_k, pool_v, tables, pos, scale_k, scale_v)
    return _launch_q8(q, pool_k, pool_v, scale_k, scale_v, tables, pos)


def paged_attention(q, pool_k, pool_v, tables, pos, *,
                    scale_k=None, scale_v=None, impl: Optional[str] = None):
    """Single-query attention of ``q`` (B, H, D) against the paged KV
    pool (num_blocks, H, block_size, D) through per-lane block tables
    (B, blocks_per_seq) at positions ``pos`` (B,), attending slots
    ``<= pos``.

    CUDA tensors launch the kernel, CPU tensors take the plain version.
    ``impl`` may name the one the tensors' device implies ("kernel" for
    CUDA, "dense" for CPU); naming the other raises.  Pass
    ``scale_k``/``scale_v`` (num_blocks, H, block_size) f32 when the
    pool is int8: that goes through `paged_attention_q8`.
    """
    if scale_k is not None or scale_v is not None:
        if scale_k is None or scale_v is None:
            raise MXNetError("paged_attention: pass both scale_k and "
                             "scale_v for an int8 pool")
        return paged_attention_q8(q, pool_k, pool_v, scale_k, scale_v,
                                  tables, pos, impl=impl)
    if not _on_cuda(q, impl):
        return paged_attention_dense(q, pool_k, pool_v, tables, pos)
    _check(q, pool_k, pool_v, tables, pos)
    return _launch(q, pool_k, pool_v, tables, pos)


# kernel launches since import (the main-path proof in chip_smoke.py)
paged_attention.launches = 0
paged_attention_q8.launches = 0
