"""The ``.params`` file codec of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/utils/serialization.py`, whose files it writes
byte for byte and reads).

The MXNet NDArray list format, little-endian::

    uint64 kMXAPINDArrayListMagic = 0x112
    uint64 reserved = 0
    uint64 ndarray_count
    per array:  uint64 NDARRAY_MAGIC = 0xF993FAC9
                uint32 shape_ndim, uint32[ndim] shape
                int32  dev_type = 1 (cpu), int32 dev_id = 0
                int32  type_flag (mshadow code)
                raw data bytes, C order
    uint64 name_count, then per name uint64 length + UTF-8 bytes

The mshadow codes: float32 0, float64 1, float16 2, uint8 3, int32 4,
int8 5, int64 6, bool 7; bfloat16 is the JAX package's extension, code
12, written as its uint16 bit patterns.  `save_ndarrays` takes torch
tensors (any device) or numpy arrays, one, a list or a dict (name ->
array; the names are written in the dict's order); `load_ndarrays`
gives torch tensors on ``device`` (CPU by default), a dict when the
file holds names, else a list.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["save_ndarrays", "load_ndarrays"]

_LIST_MAGIC = 0x112
_ND_MAGIC = 0xF993FAC9
_BF16_CODE = 12

_DTYPE_TO_CODE = {
    np.dtype("float32"): 0,
    np.dtype("float64"): 1,
    np.dtype("float16"): 2,
    np.dtype("uint8"): 3,
    np.dtype("int32"): 4,
    np.dtype("int8"): 5,
    np.dtype("int64"): 6,
    np.dtype("bool"): 7,
}
_CODE_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CODE.items()}


def _host(arr):
    """(numpy array, mshadow code) of a tensor or array."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16_CODE
        a = t.numpy()
    else:
        a = np.asarray(arr)
    code = _DTYPE_TO_CODE.get(a.dtype)
    if code is None:
        raise MXNetError(f"save: dtype {a.dtype} has no .params type code")
    return a, code


def _write(f, arr) -> None:
    data, code = _host(arr)
    f.write(struct.pack("<Q", _ND_MAGIC))
    f.write(struct.pack("<I", data.ndim))
    for s in data.shape:
        f.write(struct.pack("<I", s))
    f.write(struct.pack("<ii", 1, 0))
    f.write(struct.pack("<i", code))
    f.write(np.ascontiguousarray(data).tobytes())


def _read(f, device) -> torch.Tensor:
    (magic,) = struct.unpack("<Q", f.read(8))
    if magic != _ND_MAGIC:
        raise MXNetError(f"bad ndarray magic {magic:#x}")
    (ndim,) = struct.unpack("<I", f.read(4))
    shape = tuple(struct.unpack("<I", f.read(4))[0] for _ in range(ndim))
    f.read(8)                                   # dev_type, dev_id
    (code,) = struct.unpack("<i", f.read(4))
    n = int(np.prod(shape)) if shape else 1
    if code == _BF16_CODE:
        buf = np.frombuffer(f.read(n * 2), dtype=np.int16).reshape(shape)
        t = torch.from_numpy(buf.copy()).view(torch.bfloat16)
    else:
        dtype = _CODE_TO_DTYPE.get(code)
        if dtype is None:
            raise MXNetError(f"load: unknown type code {code}")
        buf = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)
        t = torch.from_numpy(buf.reshape(shape).copy())
    return t.to(device)


def save_ndarrays(fname: str, data: Union[Dict[str, object], List, object]
                  ) -> None:
    """Write one array, a list of arrays or a dict name -> array."""
    if isinstance(data, (torch.Tensor, np.ndarray)):
        data = [data]
    if isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    else:
        names, arrays = [], list(data)
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _write(f, a)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load_ndarrays(fname: str, device="cpu"):
    """The arrays of ``fname`` as tensors on ``device``: a dict when the
    file names them, else a list."""
    with open(fname, "rb") as f:
        magic, _ = struct.unpack("<QQ", f.read(16))
        if magic != _LIST_MAGIC:
            raise MXNetError(f"Invalid NDArray file format magic "
                             f"{magic:#x} in {fname}")
        (count,) = struct.unpack("<Q", f.read(8))
        arrays = [_read(f, device) for _ in range(count)]
        (ncount,) = struct.unpack("<Q", f.read(8))
        names = []
        for _ in range(ncount):
            (ln,) = struct.unpack("<Q", f.read(8))
            names.append(f.read(ln).decode("utf-8"))
    if names:
        return dict(zip(names, arrays))
    return arrays
