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
  CPU path and the oracle the kernels are held to.
* two hand-written kernels, bit-identical to the plain version:
  ``csrc/int8_quantize.cu`` (``mx_int8_quantize_cl``) writes step 1
  once as a channels-last int8 buffer (N, [D,] H, W, G, Cp), Cp = C/G
  rounded up to 16 with zero lanes (`quantize_channels_last_reference`
  is its plain version; for a 1x1 convolution without padding only the
  pixels it reads, every stride-th); ``csrc/int8_conv.cu``
  (``mx_int8_conv``) is the implicit GEMM on the int8 tensor cores over
  that buffer and the weights packed as (G, O/G, taps, Cp)
  (`pack_weight`), K split over blocks when the output has too few
  tiles to fill the card, with steps 2-3.

`int8_dense(x, w_q, scale, act_scale, bias)` is the GEMM case: (M, K)
rows against (N, K) int8 weights as a 1x1 convolution over (M, K, 1,
1).  Both take the packed weights as ``w_packed`` (packed on the fly
without).  Each wrapper launches the kernels for CUDA tensors (or
raises) and takes the plain version for CPU tensors; ``int8_conv`` and
``int8_dense.launches`` count the product kernel's launches for each,
``int8_quantize.launches`` the quantize pass's (one a call of either,
and one a call of `int8_quantize`).
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .. import _build, _graphs
from ..base import MXNetError
from ..telemetry import perf as _perf

__all__ = ["int8_conv", "int8_dense", "int8_quantize", "int8_conv_reference",
           "quantize_activation", "quantize_channels_last_reference",
           "pack_weight"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_P = ctypes.c_void_p
_I = ctypes.c_int
_bound: dict = {}                    # entry name -> (library, function)
_sms: dict = {}                      # CUDA device index -> SM count
# the kernel's output pixels a tile and K bytes a stage
_BM = 128
_BK = 128
# SMs the split of K aims to fill where the tensor is not on a card (the
# host stand-in of the tests): the H100 SXM's
_HOST_SMS = 132


def quantize_activation(x, act_scale: float) -> torch.Tensor:
    """``clip(round(f32(x) / act_scale), -127, 127)`` as int8."""
    s = torch.tensor([act_scale], dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def _padded(n: int) -> int:
    """A group's bytes a pixel in the channels-last buffer: n rounded up
    to 16."""
    return -(-n // 16) * 16


def _folds(cg: int, kw: int) -> bool:
    """Whether a kernel of width ``kw`` over ``cg`` channels a group
    folds its width taps into the channels: (kw, cg) bytes padded once
    to 16 take fewer than kw taps of cg padded each (the stem's 3
    channels x 7: 32 bytes against 112)."""
    return kw > 1 and _padded(kw * cg) < kw * _padded(cg)


def quantize_channels_last_reference(x, act_scale: float, groups: int = 1,
                                     subsample=None,
                                     fold=None) -> torch.Tensor:
    """The plain version of `int8_quantize`: `quantize_activation` of
    ``x`` (N, C, *spatial), every ``subsample[i]``-th pixel along each
    spatial dim when given, as (N, *spatial, groups, Cp) int8, Cp the
    group's bytes rounded up to 16, the padding lanes 0.  ``fold`` =
    (kw, sw, pw, dw) gathers the width taps of a kernel into the
    channels: position ox of the last spatial dim holds, in (kx, c)
    order, the input at ox * sw - pw + kx * dw for kx < kw (0 outside
    the input), so Cp rounds kw * C/groups."""
    xq = quantize_activation(x, act_scale)
    if subsample is not None:
        xq = xq[(slice(None), slice(None))
                + tuple(slice(None, None, s) for s in subsample)]
    N, C = xq.shape[:2]
    cg = C // groups
    kw = 1
    if fold is not None:
        kw, sw, pw, dw = fold
        W = xq.shape[-1]
        ow = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        idx = (torch.arange(ow, device=x.device)[:, None] * sw - pw
               + torch.arange(kw, device=x.device)[None] * dw)
        live = (idx >= 0) & (idx < W)
        xq = xq[..., idx.clamp(0, W - 1)] * live     # (N, C, ..., ow, kw)
        xq = xq.movedim(-1, 2)                        # (N, C, kw, ..., ow)
    else:
        xq = xq.unsqueeze(2)
    spatial = tuple(xq.shape[3:])
    # (N, G, cg, kw, *spatial) -> (N, *spatial, G, kw, cg)
    xq = xq.reshape((N, groups, cg, kw) + spatial)
    xq = xq.permute((0,) + tuple(range(4, 4 + len(spatial))) + (1, 3, 2))
    out = torch.zeros((N,) + spatial + (groups, _padded(kw * cg)),
                      dtype=torch.int8, device=x.device)
    out[..., :kw * cg] = xq.reshape(out.shape[:-1] + (kw * cg,))
    return out


def pack_weight(w_q, groups: int = 1) -> torch.Tensor:
    """OI[D]HW int8 weights as the kernel reads them: (groups, O/groups,
    taps, Cp), K in (tap, channel) order, taps kd-major, the channels of
    a tap zero-padded to Cp = C/groups rounded up to 16; a kernel whose
    width folds into its channels (`_folds`) as (kd, kh) taps of (kw,
    channel) bytes, Cp = kw * C/groups rounded up."""
    O, cg = w_q.shape[:2]
    ks = tuple(w_q.shape[2:])
    kw = ks[-1] if ks and _folds(cg, ks[-1]) else 1
    taps = math.prod(ks) // kw
    w = w_q.reshape(groups, O // groups, cg, taps, kw).permute(0, 1, 3, 4, 2)
    out = torch.zeros((groups, O // groups, taps, _padded(kw * cg)),
                      dtype=torch.int8, device=w_q.device)
    out[..., :kw * cg] = w.reshape(groups, O // groups, taps, kw * cg)
    return out


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


class _Geometry:
    """The two kernels' view of one convolution: x (N, C, *ins) and
    weights (O, C/G, *ks) with 1-3 spatial dims, padded to three with
    leading 1s.  A 1x1 kernel without padding convolves the subsampled
    buffer (every stride-th pixel, stride 1 after); a kernel whose
    width folds into its channels (`_folds`) convolves a buffer that
    holds, at each output column, its kw input columns' channels (a
    kd x kh x 1 kernel, width stride 1 after); any other reads the whole
    input.  ``bn`` is the block's output channels, the least of 64, 128,
    256 that covers O/G (256 above)."""

    def __init__(self, xshape, wshape, stride, pad, dilate, groups):
        nd = len(xshape) - 2
        lead = (1,) * (3 - nd)
        self.nd = nd
        self.n, c, self.o = xshape[0], xshape[1], wshape[0]
        self.groups = groups
        cg = c // groups
        self.ins = lead + tuple(xshape[2:])
        ks = lead + tuple(wshape[2:])
        st, dl = lead + tuple(stride), lead + tuple(dilate)
        pd = (0,) * (3 - nd) + tuple(pad)
        self.outs = tuple(_out_size(*a) for a in
                          zip(self.ins, ks, st, pd, dl))
        if min(self.outs) <= 0:
            raise MXNetError(f"int8_conv: empty output "
                             f"{self.outs[3 - nd:]}")
        # the quantize pass's sampling: subsample strides, and the width
        # taps gathered into a pixel's channels (kw, pw, dw)
        self.fold = (1, 0, 1)
        self.cp = _padded(cg)
        if all(k == 1 for k in ks) and not any(pd):
            self.sub, self.qs = st, self.outs
            st, pd, dl = (1, 1, 1), (0, 0, 0), (1, 1, 1)
        elif _folds(cg, ks[2]):
            self.fold = (ks[2], pd[2], dl[2])
            self.cp = _padded(ks[2] * cg)
            self.sub = (1, 1, st[2])
            self.qs = self.ins[:2] + self.outs[2:]
            ks, st = ks[:2] + (1,), st[:2] + (1,)
            pd, dl = pd[:2] + (0,), dl[:2] + (1,)
        else:
            self.sub, self.qs = (1, 1, 1), self.ins
        self.ks, self.st, self.pd, self.dl = ks, st, pd, dl
        self.m = self.n * math.prod(self.outs)
        self.taps = math.prod(self.ks)
        ng = self.o // groups
        self.bn = 64 if ng <= 64 else 128 if ng <= 128 else 256
        self._plan_tiles()

    def _plan_tiles(self):
        """How the GEMM loads its A stages (`mode`): "dense", a 2-D TMA
        box of the buffer's rows, for a 1x1 kernel at stride 1 without
        padding; "tiled", a TMA box of 128 channel bytes of one tap over
        a ``box`` of (w, h, d, n) output pixels (powers of two, 128 in
        all; out-of-range coordinates read the padding's zeros), when Cp
        is a multiple of 128 and the strided box fits TMA's 256 elements
        a dim; else "gather", 16-byte copies of the tiles' 128
        consecutive output pixels."""
        self.mode, self.box = "gather", (0, 0, 0, 0)
        if self.taps == 1 and self.st == (1, 1, 1) and not any(self.pd):
            self.mode = "dense"
        elif self.cp % _BK == 0:
            box, left = [], _BM
            for extent in self.outs[::-1]:          # w, h, d
                b = min(left, 1 << max(0, extent - 1).bit_length())
                box.append(b)
                left //= b
            box.append(left)                         # n
            if all(b * s <= 256 and s <= 8
                   for b, s in zip(box, self.st[::-1])):
                self.mode, self.box = "tiled", tuple(box)
        self.nkb = -(-self.taps * self.cp // _BK)
        if self.mode == "tiled":
            bw, bh, bd, bn = self.box
            od, oh, ow = self.outs
            self.m_tiles = (-(-ow // bw) * -(-oh // bh) * -(-od // bd)
                            * -(-self.n // bn))
        else:
            self.m_tiles = -(-self.m // _BM)

    def quant_args(self):
        """(subsample, fold) of `int8_quantize` for this convolution's
        buffer."""
        sub = self.sub[3 - self.nd:] if self.sub != (1, 1, 1) else None
        if self.fold[0] == 1:
            return sub, None
        kw, pw, dw = self.fold
        return None, (kw, self.sub[2], pw, dw)

    @property
    def out_shape(self):
        return (self.n, self.o) + self.outs[3 - self.nd:]

    @property
    def xq_shape(self):
        return (self.n,) + self.qs[3 - self.nd:] + (self.groups, self.cp)

    def quant_dims(self, c):
        """mx_int8_quantize_cl's 16 dims for ``c`` input channels."""
        return (self.n, c, self.groups, self.cp, *self.ins, *self.qs,
                *self.sub, *self.fold)

    def conv_dims(self):
        """mx_int8_conv's 22 dims."""
        return (self.n, self.o, self.groups, self.cp, *self.qs, *self.outs,
                *self.ks, *self.st, *self.pd, *self.dl)

    def tile_dims(self):
        """mx_int8_conv's 5 tile ints: the mode and the tiled box."""
        return (("gather", "dense", "tiled").index(self.mode), *self.box)

    def splits(self, sms: int) -> int:
        """Blocks over K: 1 where the output tiles fill ``sms`` SMs, else
        enough to fill them, at least two K stages a split, with the
        s32 workspace (written and read once) within twice the bytes
        of the weights and the quantized activation."""
        ng = self.o // self.groups
        tiles = self.m_tiles * -(-ng // self.bn) * self.groups
        if tiles >= sms:
            return 1
        read = self.o * self.taps * self.cp \
            + self.n * math.prod(self.qs) * self.groups * self.cp
        cap = 2 * read // (4 * self.m * self.o)
        return max(1, min(-(-sms // tiles), self.nkb // 2, cap))


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


def _check_packed(w_packed, geo, device):
    want = (geo.groups, geo.o // geo.groups, geo.taps, geo.cp)
    if w_packed.dtype != torch.int8 or tuple(w_packed.shape) != want \
            or w_packed.device != device or not w_packed.is_contiguous() \
            or w_packed.data_ptr() % 16:
        raise MXNetError(f"int8_conv: packed weights must be int8 {want}, "
                         f"contiguous and 16-byte aligned on {device} "
                         f"(pack_weight), got {w_packed.dtype} "
                         f"{tuple(w_packed.shape)} on {w_packed.device}")


def _entry(lib_name, fn_name, argtypes):
    """``fn_name`` of the built ``csrc/<lib_name>.cu``, its C types set."""
    lib = _build.load(lib_name)
    hit = _bound.get(fn_name)
    if hit is None or hit[0] is not lib:
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        hit = _bound[fn_name] = (lib, fn)
    return hit[1]


def _sm_count(device) -> int:
    if device.type != "cuda":
        return _HOST_SMS
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _sms[idx]


def _quantize_cuda(x, act_scale: float, dims, xq_shape) -> torch.Tensor:
    """Launch ``mx_int8_quantize_cl`` on contiguous ``x``: the int8
    channels-last buffer, counted as a launch of `int8_quantize`."""
    xq = torch.empty(xq_shape, dtype=torch.int8, device=x.device)
    entry = _entry("int8_quantize", "mx_int8_quantize_cl",
                   [_P, _P, _P, ctypes.c_float, _I, _P])
    err = entry(x.data_ptr(), xq.data_ptr(), (ctypes.c_longlong * 16)(*dims),
                float(act_scale), _DTYPES[x.dtype], _build.stream(x.device))
    if err != 0:
        raise MXNetError(f"int8 quantize kernel launch failed "
                         f"(CUDA error {err})")
    _graphs.note_launch(int8_quantize)
    # telemetry's count: read x, write the int8 buffer
    _perf.add_kernel_cost(0, x.numel() * x.element_size() + xq.numel())
    return xq


def _conv_cuda(xq, w_packed, scale, bias, out, ws, geo, splits) -> None:
    """Launch ``mx_int8_conv`` (and, with splits > 1, its epilogue) into
    ``out``."""
    entry = _entry("int8_conv", "mx_int8_conv",
                   [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
    err = entry(xq.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                (ctypes.c_longlong * 22)(*geo.conv_dims()),
                (ctypes.c_longlong * 5)(*geo.tile_dims()), geo.bn, splits,
                _DTYPES[out.dtype], _build.stream(out.device))
    if err != 0:
        raise MXNetError(f"int8 convolution kernel launch failed "
                         f"(CUDA error {err})")


def _launch(x, w_q, scale, act_scale, bias, stride, pad, dilate, groups,
            fn, w_packed=None):
    """Launch the quantize pass and ``mx_int8_conv``, counted as a launch
    of `int8_quantize` and of ``fn`` (`int8_conv` or `int8_dense`): the
    output, NC[D]HW in x's dtype."""
    _check(x, w_q, scale, bias, groups)
    geo = _Geometry(tuple(x.shape), tuple(w_q.shape), stride, pad, dilate,
                    groups)
    if w_packed is None:
        w_packed = pack_weight(w_q, groups)
    _check_packed(w_packed, geo, x.device)
    if max(geo.n * math.prod(geo.qs), geo.m) >= 2 ** 31:
        raise MXNetError(f"int8_conv: {geo.n} x {geo.qs} input and {geo.m} "
                         f"output pixels, more than the kernel indexes")
    scale = scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    xq = _quantize_cuda(x.contiguous(), act_scale,
                        geo.quant_dims(x.shape[1]), geo.xq_shape)
    out = torch.empty(geo.out_shape, dtype=x.dtype, device=x.device)
    splits = geo.splits(_sm_count(x.device))
    ws = torch.empty((splits, geo.o, geo.m), dtype=torch.int32,
                     device=x.device) if splits > 1 else None
    _conv_cuda(xq, w_packed, scale, bias, out, ws, geo, splits)
    _graphs.note_launch(fn)
    # 2 operations a multiply-add (int8); read the buffer and the
    # weights, write out
    _perf.add_kernel_cost(
        2 * out.numel() * (w_q.numel() // w_q.shape[0]),
        xq.numel() + w_packed.numel() + out.numel() * out.element_size())
    return out


def _on_cuda(x) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise MXNetError(f"int8_conv: unsupported device {x.device}")


def int8_quantize(x, act_scale: float, groups: int = 1, subsample=None,
                  fold=None) -> torch.Tensor:
    """`quantize_channels_last_reference`'s buffer, (N, *spatial, groups,
    Cp) int8: the kernel for a CUDA ``x``, the plain version for a CPU
    one."""
    if not _on_cuda(x):
        return quantize_channels_last_reference(x, act_scale, groups,
                                                subsample, fold)
    nd = x.dim() - 2
    if x.dtype not in _DTYPES or nd not in _CONV or x.shape[1] % groups \
            or (subsample is not None and fold is not None):
        raise MXNetError(f"int8_quantize: x {tuple(x.shape)} {x.dtype} "
                         f"(float32 or bfloat16, 1-3 spatial dims, "
                         f"channels a multiple of {groups} groups; a "
                         f"subsample or a fold, not both)")
    lead = (1,) * (3 - nd)
    ins = lead + tuple(x.shape[2:])
    cg = x.shape[1] // groups
    if fold is not None:
        kw, sw, pw, dw = fold
        sub = (1, 1, sw)
        qs = ins[:2] + (_out_size(ins[2], kw, sw, pw, dw),)
        if qs[2] <= 0:
            raise MXNetError(f"int8_quantize: empty fold of {ins[2]}")
        extra, cp = (kw, pw, dw), _padded(kw * cg)
    else:
        sub = lead + tuple(subsample if subsample is not None
                           else (1,) * nd)
        qs = tuple(-(-i // s) for i, s in zip(ins, sub))
        extra, cp = (1, 0, 1), _padded(cg)
    return _quantize_cuda(
        x.contiguous(), act_scale,
        (x.shape[0], x.shape[1], groups, cp, *ins, *qs, *sub, *extra),
        (x.shape[0],) + qs[3 - nd:] + (groups, cp))


def int8_conv(x, w_q, scale, act_scale: float, bias, stride, pad, dilate,
              groups: int = 1, w_packed=None) -> torch.Tensor:
    """The int8 convolution (see the module docstring): the kernels for a
    CUDA ``x`` (over ``w_packed``, `pack_weight`'s layout of ``w_q``,
    packed here when not given), the plain version for a CPU one."""
    args = (x, w_q, scale, act_scale, bias, stride, pad, dilate, groups)
    if _on_cuda(x):
        return _launch(*args, int8_conv, w_packed=w_packed)
    return int8_conv_reference(*args)


def int8_dense(x, w_q, scale, act_scale: float, bias=None,
               w_packed=None) -> torch.Tensor:
    """``f32(int8(x) @ w_qᵀ) * scale + bias`` in x's dtype for (M, K)
    ``x`` and (N, K) int8 weights: the convolution over (M, K, 1, 1)
    (``w_packed``: `pack_weight` of ``w_q[:, :, None, None]``)."""
    args = (x[:, :, None, None], w_q[:, :, None, None], scale, act_scale,
            bias, (1, 1), (0, 0), (1, 1), 1)
    out = _launch(*args, int8_dense, w_packed=w_packed) if _on_cuda(x) \
        else int8_conv_reference(*args)
    return out.reshape(x.shape[0], w_q.shape[0])


# kernel launches since import (the main-path proof in chip_smoke.py):
# the product kernel's, the convolutions' and the dense products' apart,
# and the quantize pass's
int8_conv.launches = 0
int8_dense.launches = 0
int8_quantize.launches = 0
