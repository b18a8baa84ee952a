"""Fused dropout (PyTorch/CUDA port of
`incubator_mxnet_tpu/ops/dropout_kernel.py`).

The kernel writes only the uint8 keep-mask; the apply
``where(mask, x * scale, 0)`` and the residual add stay torch ops, and
autograd's backward of that apply reuses the saved mask, so forward and
backward drop the same elements and the kernel runs in the forward
only.  Two versions of the mask:

* `mask_reference` — the plain PyTorch version: Philox4x32-10 in int64
  tensor ops (each 32-bit product split into 16-bit halves, since torch
  has no unsigned multiply-high).  The CPU path, and the oracle the
  kernel is held to bit for bit.
* ``csrc/dropout.cu`` — the hand-written CUDA kernel that replaces the
  Pallas TPU kernel `_dropout_kernel` (launched by `_kernel2d`): one
  thread per 4 mask bytes, one Philox call each.

Mask contract: element ``i`` of the flattened array is kept iff word
``i % 4`` of ``philox4x32_10(counter=(i // 4, 0, 0), key=seed)`` is
``>= min(int(rate * 2**32), 2**32 - 1)`` — a pure function of
(seed, numel, rate), independent of dtype and launch geometry.  The JAX
package's bits differ (the TPU's PRNG, threefry elsewhere), so the
port holds the contract, not JAX's bits.

`dropout_mask` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["fused_dropout", "fused_dropout_add", "dropout_mask",
           "mask_reference", "philox4x32_10", "threshold"]

_U32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57        # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85        # Weyl key increments


def threshold(rate: float) -> int:
    """Keep iff the 32-bit word is >= this (P(drop) = rate to 2**-32)."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for int64 tensors holding
    uint32 values and a uint32 constant, without overflowing int64."""
    p_lo = (a & 0xFFFF) * m                      # < 2**48
    p_hi = (a >> 16) * m                         # < 2**48
    hi = ((p_lo >> 16) + p_hi) >> 16
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _U32
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 of four int64 tensors (or ints) holding uint32
    counter words and a (k0, k1) key of ints; returns four int64
    tensors of uint32 words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _U32
            k1 = (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def mask_reference(numel: int, seed: int, rate: float,
                   device=None) -> torch.Tensor:
    """The keep-mask, uint8 (numel,), computed with tensor ops."""
    t = torch.arange((numel + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(t)
    seed = int(seed) & ((1 << 64) - 1)
    words = philox4x32_10((t & _U32, t >> 32, zero, zero),
                          (seed & _U32, seed >> 32))
    bits = torch.stack(words, dim=1).reshape(-1)[:numel]
    return (bits >= threshold(rate)).to(torch.uint8)


def _mask_cuda(numel: int, seed: int, rate: float, device) -> torch.Tensor:
    """Launch ``csrc/dropout.cu``: the keep-mask, uint8 (numel,)."""
    mask = torch.empty(numel, dtype=torch.uint8, device=device)
    if numel == 0:
        return mask
    import ctypes

    fn = _build.load("dropout").mx_dropout_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                   ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(mask.data_ptr(), numel, int(seed) & ((1 << 64) - 1),
             threshold(rate), _build.stream(device))
    if err != 0:
        raise MXNetError(f"dropout mask kernel launch failed "
                         f"(CUDA error {err})")
    dropout_mask.launches += 1
    return mask


def dropout_mask(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """The uint8 keep-mask for ``x`` (same shape; a function of seed,
    numel and rate only).  CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    if x.device.type == "cuda":
        m = _mask_cuda(x.numel(), seed, rate, x.device)
    elif x.device.type == "cpu":
        m = mask_reference(x.numel(), seed, rate)
    else:
        raise MXNetError(f"dropout_mask: unsupported device {x.device}")
    return m.view(x.shape)


# kernel launches since import (the main-path proof in chip_smoke.py)
dropout_mask.launches = 0


@functools.lru_cache(maxsize=64)
def _scale(rate: float, dtype: torch.dtype) -> float:
    """1/(1-rate) rounded to ``dtype`` first, as the JAX apply
    multiplies by ``asarray(1/(1-rate), x.dtype)``."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def _apply_mask(x, mask, rate):
    return torch.where(mask.view(torch.bool), x * _scale(rate, x.dtype), 0.0)


def fused_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Dropout of ``x`` with the mask of (``seed``, numel, ``rate``).
    rate >= 1 gives zeros; rate <= 0 or an empty ``x`` gives ``x``; no
    mask is drawn in either case."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    if rate <= 0.0 or x.numel() == 0:
        return x
    return _apply_mask(x, dropout_mask(x, seed, rate), rate)


def fused_dropout_add(x, res, seed: int, rate: float) -> torch.Tensor:
    """``res + dropout(x)`` — the transformer post-sublayer pattern,
    literally ``res + fused_dropout(...)`` as in the JAX package."""
    return res + fused_dropout(x, seed, rate)
