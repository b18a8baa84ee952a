"""Fused dropout (PyTorch/CUDA port of
`incubator_mxnet_tpu/ops/dropout_kernel.py`).

The JAX package's kernel writes only the uint8 keep-mask and leaves the
apply ``where(mask, x * scale, 0) [+ res]`` to XLA, which fuses it into
the surrounding fusions.  Eager PyTorch fuses nothing, so on the card
the port writes that fusion out: ``csrc/dropout.cu`` draws the mask,
writes it and applies it (with the residual add) in one pass, and its
backward applies the saved mask to the gradient in one pass.  Three
entry points, each with its plain PyTorch version:

* `dropout_mask` — the keep-mask alone (``mx_dropout_mask``); plain
  version `mask_reference`: Philox4x32-10 in int64 tensor ops (each
  32-bit product split into 16-bit halves, since torch has no unsigned
  multiply-high).
* `dropout_fwd` — (``[res +] where(keep, x * scale, 0)``, mask)
  (``mx_dropout_fwd``); plain version `dropout_fwd_reference`.  A bf16
  ``x`` may come with an f32 ``res`` (the bf16 `Transformer`'s residual
  stream, f32 as in the JAX package): the product is rounded to bf16,
  the add and y are f32, and the backward gives dx in bf16.
* `dropout_bwd` — ``where(mask, dy, 0) * scale`` (``mx_dropout_bwd``);
  plain version `dropout_bwd_reference`.

The mask and the forward also take their seed from device memory:
`dropout_mask_dev` (``mx_dropout_mask_dev``) and `dropout_fwd_dev`
(``mx_dropout_fwd_dev``) take an int64 tensor of one element on the
card, a slot of the seed table a captured program stages before each
replay (`random.next_seed` inside a program body), so each replay draws
a fresh mask; the plain versions take the same tensor.  Eager dropout
outside a program passes its seed by value and copies nothing.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
its plain version for CPU tensors.  `fused_dropout` and
`fused_dropout_add` on CUDA tensors run `_DropoutApply`, an autograd
Function over the forward and backward kernels; on CPU tensors they
are the composition of `dropout_mask` and the torch apply, with
autograd's own backward.  The two give the same bits.

Mask contract: element ``i`` of the flattened array is kept iff word
``i % 4`` of ``philox4x32_10(counter=(i // 4, 0, 0), key=seed)`` is
``>= min(int(rate * 2**32), 2**32 - 1)`` — a pure function of
(seed, numel, rate), independent of dtype and launch geometry.  The JAX
package's bits differ (the TPU's PRNG, threefry elsewhere), so the
port holds the contract, not JAX's bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, _graphs
from ..base import MXNetError
from ..telemetry import perf as _perf

__all__ = ["fused_dropout", "fused_dropout_add", "dropout_mask",
           "dropout_fwd", "dropout_bwd", "dropout_mask_dev",
           "dropout_fwd_dev", "dropout_fwd_reference",
           "dropout_bwd_reference", "mask_reference", "philox4x32_10",
           "threshold"]

_U32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57        # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85        # Weyl key increments
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernels' dtype codes
_MIXED = 2              # a bf16 x with an f32 residual and y (forward only)
_P = ctypes.c_void_p
_ARGTYPES = {
    "mx_dropout_mask": [_P, ctypes.c_longlong, ctypes.c_ulonglong,
                        ctypes.c_uint, _P],
    "mx_dropout_fwd": [_P, _P, _P, _P, ctypes.c_longlong,
                       ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float,
                       ctypes.c_int, _P],
    "mx_dropout_bwd": [_P, _P, _P, ctypes.c_longlong, ctypes.c_float,
                       ctypes.c_int, _P],
    "mx_dropout_mask_dev": [_P, ctypes.c_longlong, _P, ctypes.c_uint, _P],
    "mx_dropout_fwd_dev": [_P, _P, _P, _P, ctypes.c_longlong, _P,
                           ctypes.c_uint, ctypes.c_float, ctypes.c_int, _P],
}
_bound: dict = {}                         # entry name -> (library, function)


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


def mask_reference(numel: int, seed, rate: float,
                   device=None) -> torch.Tensor:
    """The keep-mask, uint8 (numel,), computed with tensor ops.  ``seed``
    is an int or an int64 tensor of one element holding a seed in
    [0, 2**63) (a seed-table slot; read on its device, never on the
    host, so a capture records the read)."""
    t = torch.arange((numel + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(t)
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(()).to(t.device)
    else:
        seed = int(seed) & ((1 << 64) - 1)
    words = philox4x32_10((t & _U32, t >> 32, zero, zero),
                          (seed & _U32, seed >> 32))
    bits = torch.stack(words, dim=1).reshape(-1)[:numel]
    return (bits >= threshold(rate)).to(torch.uint8)


@functools.lru_cache(maxsize=64)
def _scale(rate: float, dtype: torch.dtype) -> float:
    """1/(1-rate) rounded to ``dtype`` first, as the JAX apply
    multiplies by ``asarray(1/(1-rate), x.dtype)``."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))


def _apply_mask(x, mask, rate):
    return torch.where(mask.view(torch.bool), x * _scale(rate, x.dtype), 0.0)


def dropout_fwd_reference(x, res, seed, rate: float):
    """Plain version of the fused forward: (``[res +] where(keep,
    x * scale, 0)``, the uint8 keep-mask shaped like ``x``); ``seed`` an
    int or a seed-table slot, as `mask_reference` takes it."""
    mask = mask_reference(x.numel(), seed, rate, device=x.device)
    mask = mask.view(x.shape)
    y = _apply_mask(x, mask, rate)
    return (y if res is None else res + y), mask


def dropout_bwd_reference(dy, mask, rate: float):
    """Plain version of the fused backward: ``where(mask, dy, 0) *
    scale``, as autograd differentiates `_apply_mask`."""
    return torch.where(mask.view(torch.bool), dy, 0.0) \
        * _scale(rate, dy.dtype)


def _entry(name: str):
    """``csrc/dropout.cu``'s C function ``name``, its argument and
    result types set once per loaded library."""
    lib = _build.load("dropout")
    hit = _bound.get(name)
    if hit is not None and hit[0] is lib:
        return hit[1]
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    _bound[name] = (lib, fn)
    return fn


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise MXNetError(f"dropout {what} kernel launch failed "
                         f"(CUDA error {err})")


def _seed64(seed: int) -> int:
    return int(seed) & ((1 << 64) - 1)


def _seed_slot(seed: torch.Tensor, device) -> torch.Tensor:
    """A seed in device memory, checked: one int64 on ``device``."""
    if seed.dtype != torch.int64 or seed.numel() != 1 \
            or seed.device != torch.device(device):
        raise MXNetError(f"dropout: a device seed is one int64 on {device}, "
                         f"got {tuple(seed.shape)} {seed.dtype} on "
                         f"{seed.device}")
    return seed


def _mask_cuda(numel: int, seed, rate: float, device) -> torch.Tensor:
    """Launch ``mx_dropout_mask`` (an int seed) or ``mx_dropout_mask_dev``
    (a seed in device memory): the keep-mask, uint8 (numel,)."""
    mask = torch.empty(numel, dtype=torch.uint8, device=device)
    if numel == 0:
        return mask
    if isinstance(seed, torch.Tensor):
        err = _entry("mx_dropout_mask_dev")(
            mask.data_ptr(), numel, _seed_slot(seed, device).data_ptr(),
            threshold(rate), _build.stream(device))
        fn = dropout_mask_dev
    else:
        err = _entry("mx_dropout_mask")(mask.data_ptr(), numel,
                                        _seed64(seed), threshold(rate),
                                        _build.stream(device))
        fn = dropout_mask
    _raise_on(err, "mask")
    _graphs.note_launch(fn)
    # telemetry's count: no floating-point work; write the mask
    _perf.add_kernel_cost(0, numel)
    return mask


def _operand(t: torch.Tensor, like: torch.Tensor, what: str,
             dtype=None) -> torch.Tensor:
    """``t`` checked against ``like`` (device, shape, and dtype, or
    ``dtype`` where given) and made contiguous (a copy where it is
    not)."""
    dtype = like.dtype if dtype is None else dtype
    if t.device != like.device or t.dtype != dtype \
            or t.shape != like.shape:
        raise MXNetError(f"dropout: {what} {tuple(t.shape)} {t.dtype} on "
                         f"{t.device} does not match {tuple(like.shape)} "
                         f"{dtype} on {like.device}")
    return t.contiguous()


def _dtype_code(t: torch.Tensor) -> int:
    code = _DTYPES.get(t.dtype)
    if code is None:
        raise MXNetError(f"dropout kernel: dtype {t.dtype} (float32 or "
                         f"bfloat16)")
    return code


def _fwd_cuda(x, res, seed, rate: float):
    """Launch ``mx_dropout_fwd`` (an int seed) or ``mx_dropout_fwd_dev``
    (a seed in device memory): (y, uint8 mask), both shaped like x; y in
    the residual's dtype (f32 for a bf16 x with an f32 residual)."""
    code = _dtype_code(x)
    x = x.contiguous()
    if res is not None:
        if (x.dtype, res.dtype) == (torch.bfloat16, torch.float32):
            code = _MIXED
        res = _operand(res, x, "residual",
                       torch.float32 if code == _MIXED else x.dtype)
    y = torch.empty_like(x if res is None else res)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return y, mask
    dev = isinstance(seed, torch.Tensor)
    err = _entry("mx_dropout_fwd_dev" if dev else "mx_dropout_fwd")(
        x.data_ptr(), None if res is None else res.data_ptr(), y.data_ptr(),
        mask.data_ptr(), x.numel(),
        _seed_slot(seed, x.device).data_ptr() if dev else _seed64(seed),
        threshold(rate), _scale(rate, x.dtype), code,
        _build.stream(x.device))
    _raise_on(err, "forward")
    _graphs.note_launch(dropout_fwd_dev if dev else dropout_fwd)
    # read x (and the residual), write y and the mask
    _perf.add_kernel_cost(x.numel(), x.numel() * (
        x.element_size() + y.element_size() + 1)
        + (0 if res is None else res.numel() * res.element_size()))
    return y, mask


def _bwd_cuda(dy, mask, rate: float):
    """Launch ``mx_dropout_bwd``: dx shaped like dy."""
    code = _dtype_code(dy)
    dy = dy.contiguous()
    if mask.dtype != torch.uint8 or mask.shape != dy.shape \
            or mask.device != dy.device:
        raise MXNetError(f"dropout backward: mask {tuple(mask.shape)} "
                         f"{mask.dtype} for dy {tuple(dy.shape)}")
    mask = mask.contiguous()
    dx = torch.empty_like(dy)
    if dy.numel() == 0:
        return dx
    err = _entry("mx_dropout_bwd")(
        dy.data_ptr(), mask.data_ptr(), dx.data_ptr(), dy.numel(),
        _scale(rate, dy.dtype), code, _build.stream(dy.device))
    _raise_on(err, "backward")
    _graphs.note_launch(dropout_bwd)
    # read dy and the mask, write dx
    _perf.add_kernel_cost(dy.numel(), dy.numel() * (2 * dy.element_size()
                                                    + 1))
    return dx


def _on_cuda(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernels (cuda) or the plain versions
    (cpu); other devices are refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise MXNetError(f"dropout: unsupported device {t.device}")


def dropout_mask(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """The uint8 keep-mask for ``x`` (same shape; a function of seed,
    numel and rate only)."""
    if _on_cuda(x):
        m = _mask_cuda(x.numel(), int(seed), rate, x.device)
    else:
        m = mask_reference(x.numel(), seed, rate)
    return m.view(x.shape)


def dropout_mask_dev(x: torch.Tensor, seed: torch.Tensor,
                     rate: float) -> torch.Tensor:
    """`dropout_mask` with the seed read from device memory: ``seed`` an
    int64 tensor of one element on x's device; the same bits as
    ``dropout_mask(x, int(seed), rate)``."""
    if _on_cuda(x):
        m = _mask_cuda(x.numel(), _seed_slot(seed, x.device), rate, x.device)
    else:
        m = mask_reference(x.numel(), _seed_slot(seed, x.device), rate)
    return m.view(x.shape)


def dropout_fwd(x, res, seed: int, rate: float):
    """(``[res +] where(keep, x * scale, 0)``, uint8 keep-mask) in one
    pass; ``res`` may be None."""
    if _on_cuda(x):
        return _fwd_cuda(x, res, int(seed), rate)
    return dropout_fwd_reference(x, res, seed, rate)


def dropout_fwd_dev(x, res, seed: torch.Tensor, rate: float):
    """`dropout_fwd` with the seed read from device memory (``seed`` as
    `dropout_mask_dev` takes it); the same bits as ``dropout_fwd(x, res,
    int(seed), rate)``."""
    seed = _seed_slot(seed, x.device)
    if _on_cuda(x):
        return _fwd_cuda(x, res, seed, rate)
    return dropout_fwd_reference(x, res, seed, rate)


def dropout_bwd(dy, mask, rate: float):
    """``where(mask, dy, 0) * scale`` in one pass."""
    if _on_cuda(dy):
        return _bwd_cuda(dy, mask, rate)
    return dropout_bwd_reference(dy, mask, rate)


# kernel launches since import (the main-path proof in chip_smoke.py)
dropout_mask.launches = 0
dropout_fwd.launches = 0
dropout_bwd.launches = 0
dropout_mask_dev.launches = 0
dropout_fwd_dev.launches = 0


def _fwd_of(seed):
    """The forward wrapper for ``seed``: by value, or in device memory."""
    return dropout_fwd_dev if isinstance(seed, torch.Tensor) else dropout_fwd


def _mask_of(seed):
    return dropout_mask_dev if isinstance(seed, torch.Tensor) \
        else dropout_mask


class _DropoutApply(torch.autograd.Function):
    """``[res +] dropout(x)`` through the fused kernels: the forward
    saves the mask it drew, the backward applies it to dy; the
    residual's gradient is dy itself."""

    @staticmethod
    def forward(ctx, x, res, seed, rate):
        y, mask = _fwd_of(seed)(x, res, seed, rate)
        ctx.save_for_backward(mask)
        ctx.rate = rate
        ctx.x_dtype = x.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        (mask,) = ctx.saved_tensors
        # an f32 y over a bf16 x: dy reaches x's product rounded to bf16,
        # as autograd casts the gradient of a promoted operand
        dx = dropout_bwd(dy.to(ctx.x_dtype), mask, ctx.rate) \
            if ctx.needs_input_grad[0] else None
        return dx, dy if ctx.needs_input_grad[1] else None, None, None


def fused_dropout(x: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """Dropout of ``x`` with the mask of (``seed``, numel, ``rate``);
    ``seed`` an int or a seed-table slot on x's device (inside a
    captured program).  rate >= 1 gives zeros; rate <= 0 or an empty
    ``x`` gives ``x``; no mask is drawn in either case."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    if rate <= 0.0 or x.numel() == 0:
        return x
    if _on_cuda(x):
        return _DropoutApply.apply(x, None, seed, rate)
    return _apply_mask(x, _mask_of(seed)(x, seed, rate), rate)


def fused_dropout_add(x, res, seed, rate: float) -> torch.Tensor:
    """``res + dropout(x)`` — the transformer post-sublayer pattern, as
    ``res + fused_dropout(...)`` in the JAX package; on CUDA one kernel
    draws the mask, applies it and adds ``res``."""
    if rate >= 1.0 or rate <= 0.0 or x.numel() == 0:
        return res + fused_dropout(x, seed, rate)
    if _on_cuda(x):
        return _DropoutApply.apply(x, res, seed, rate)
    return res + _apply_mask(x, _mask_of(seed)(x, seed, rate), rate)
