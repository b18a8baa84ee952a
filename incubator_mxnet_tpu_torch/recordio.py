"""RecordIO container format of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/recordio.py`; the dmlc-core container, exact data
compatibility).  Layout per record:

    uint32 kMagic = 0xced7230a
    uint32 lrec   = (cflag << 29) | length      # cflag: 0=whole,1=start,2=middle,3=end
    bytes  data[length], zero-padded to 4-byte boundary

Continuation records (cflag 1/2/3) are produced when payload contains
the magic — matching dmlc so `.rec` files interoperate byte-for-byte,
with the JAX package's too.  A C++ codec with the same layout lives in
`native/recordio.cc`; this module is the Python implementation and the
API (`MXRecordIO`, `MXIndexedRecordIO`,
`IRHeader`/`pack`/`unpack`/`pack_img`/`unpack_img`).  Images are uint8
numpy arrays (HWC); the codec is PIL's.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as onp

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
_CFLAG_WHOLE, _CFLAG_START, _CFLAG_MIDDLE, _CFLAG_END = 0, 1, 2, 3
_MAGIC_BYTES = struct.pack("<I", _MAGIC)


def _pad4(n: int) -> int:
    return (4 - n % 4) % 4


def _find_magic_splits(data: bytes):
    """Split payload at embedded magic boundaries (dmlc semantics)."""
    parts = []
    start = 0
    i = data.find(_MAGIC_BYTES)
    while i != -1:
        parts.append(data[start:i])
        start = i + 4
        i = data.find(_MAGIC_BYTES, start)
    parts.append(data[start:])
    return parts


class MXRecordIO:
    """Sequential .rec reader/writer.

    ``use_native=True`` reads and writes through the C++ codec
    (native/recordio.cc, byte-identical format), whose failed build
    raises `MXNetError`; ``use_native=False`` takes the Python path."""

    def __init__(self, uri: str, flag: str, use_native: bool = True):
        self.uri = uri
        self.flag = flag
        self.fid = None
        self._use_native = use_native
        self._nh = None      # native handle
        self._nlib = None
        self.open()

    def _native_lib(self):
        if not self._use_native:
            return None
        from .native import recordio_lib

        return recordio_lib()

    def open(self):
        if self.flag not in ("r", "w"):
            raise ValueError(f"Invalid flag {self.flag}")
        self.writable = self.flag == "w"
        lib = self._native_lib()
        if lib is None:
            self.fid = open(self.uri, "wb" if self.writable else "rb")
        else:
            create = lib.RecordIOWriterCreate if self.writable \
                else lib.RecordIOReaderCreate
            self._nh = create(self.uri.encode())
            if not self._nh:
                raise MXNetError(f"cannot open {self.uri} for "
                                 + ("writing" if self.writable
                                    else "reading"))
            self._nlib = lib
        self.is_open = True

    def close(self):
        if self.is_open:
            if self._nh:
                if self.writable:
                    self._nlib.RecordIOWriterFree(self._nh)
                else:
                    self._nlib.RecordIOReaderFree(self._nh)
                self._nh = None
            if self.fid is not None:
                self.fid.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["fid"] = None
        d["is_open"] = False
        d["_nh"] = None     # native handles are process-local
        d["_nlib"] = None   # ctypes CDLL is unpicklable
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if not self.is_open:
            self.open()

    def reset(self):
        self.close()
        self.open()

    def write(self, buf: bytes):
        assert self.writable
        if self._nh:
            if self._nlib.RecordIOWriterWrite(self._nh, buf, len(buf)) != 0:
                raise MXNetError(f"native RecordIO write failed for {self.uri}")
            return
        parts = _find_magic_splits(buf)
        n = len(parts)
        for i, part in enumerate(parts):
            if n == 1:
                cflag = _CFLAG_WHOLE
            elif i == 0:
                cflag = _CFLAG_START
            elif i == n - 1:
                cflag = _CFLAG_END
            else:
                cflag = _CFLAG_MIDDLE
            lrec = (cflag << 29) | len(part)
            self.fid.write(struct.pack("<II", _MAGIC, lrec))
            self.fid.write(part)
            self.fid.write(b"\x00" * _pad4(len(part)))

    def read(self):
        assert not self.writable
        if self._nh:
            import ctypes

            ptr = ctypes.c_char_p()
            n = self._nlib.RecordIOReaderNext(self._nh, ctypes.byref(ptr))
            if n == -1:
                return None
            if n < 0:
                raise MXNetError(f"corrupt RecordIO stream in {self.uri}")
            return ctypes.string_at(ptr, n)
        out = b""
        while True:
            hdr = self.fid.read(8)
            if len(hdr) < 8:
                return out if out else None
            magic, lrec = struct.unpack("<II", hdr)
            if magic != _MAGIC:
                raise MXNetError(f"invalid record magic {magic:#x} in {self.uri}")
            cflag = lrec >> 29
            length = lrec & ((1 << 29) - 1)
            data = self.fid.read(length)
            self.fid.read(_pad4(length))
            if cflag == _CFLAG_WHOLE:
                return data
            if cflag == _CFLAG_START:
                out = data
            elif cflag == _CFLAG_MIDDLE:
                out += _MAGIC_BYTES + data
            else:  # END
                return out + _MAGIC_BYTES + data

    def tell(self):
        if self._nh:
            return (self._nlib.RecordIOWriterTell(self._nh) if self.writable
                    else self._nlib.RecordIOReaderTell(self._nh))
        return self.fid.tell()

    def _seek(self, pos: int):
        if self._nh:
            self._nlib.RecordIOReaderSeek(self._nh, pos)
        else:
            self.fid.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """.rec + .idx random-access reader/writer (key\\ttell lines)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        assert not self.writable
        self._seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, header.flag, float(header.label), header.id, header.id2)
        return hdr + s
    label = onp.asarray(header.label, dtype=onp.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s: bytes):
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    payload = s[_IR_SIZE:]
    header = IRHeader(flag, label, id_, id2)
    if flag > 0 and label == 0.0 and flag != 1:
        # multi-label: flag holds label count
        labels = onp.frombuffer(payload[:flag * 4], dtype=onp.float32)
        header = header._replace(label=labels)
        payload = payload[flag * 4:]
    return header, payload


def pack_img(header: IRHeader, img, quality: int = 95, img_fmt: str = ".jpg") -> bytes:
    buf = _encode_img(img, quality, img_fmt)
    return pack(header, buf)


def unpack_img(s: bytes, iscolor: int = -1):
    """(header, the image as a uint8 numpy array, HWC)."""
    header, payload = unpack(s)
    return header, _decode_img(payload)


def _encode_img(img, quality, img_fmt):
    import io as _io

    arr = onp.asarray(img)
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("image encode requires PIL (not available)") from e
    im = Image.fromarray(arr.astype("uint8"))
    bio = _io.BytesIO()
    fmt = "JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG"
    im.save(bio, format=fmt, quality=quality)
    return bio.getvalue()


def _decode_img(payload: bytes):
    import io as _io

    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("image decode requires PIL (not available)") from e
    return onp.asarray(Image.open(_io.BytesIO(payload)))
