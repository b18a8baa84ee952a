"""Host C++ components of the port, loaded with `ctypes` (the
counterpart of the JAX package's ``native`` module, whose sources these
are copies of): the RecordIO codec
(`recordio.cc`) and the threaded image decode/augment/prefetch pipeline
(`image_pipeline.cc`), built on first use by `build.load` into the
port's ``_build/native/``.

The pipeline has two decoders, one build each: ``"libjpeg"`` (the
system's libjpeg, the JAX package's build and bits) and ``"nvjpeg"``
(the CUDA toolkit's nvJPEG, for hosts without libjpeg's headers).  A
build that fails raises `MXNetError`; nothing falls back to another
decoder or to the Python reader.
"""
from __future__ import annotations

import ctypes
import functools

from ..base import MXNetError
from . import build

__all__ = ["DECODERS", "recordio_lib", "image_pipeline_lib", "build"]

DECODERS = ("libjpeg", "nvjpeg")


@functools.lru_cache(maxsize=None)
def recordio_lib() -> ctypes.CDLL:
    lib = build.load("recordio", "recordio")
    lib.RecordIOWriterCreate.restype = ctypes.c_void_p
    lib.RecordIOWriterCreate.argtypes = [ctypes.c_char_p]
    lib.RecordIOWriterWrite.restype = ctypes.c_int
    lib.RecordIOWriterWrite.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint64]
    lib.RecordIOWriterTell.restype = ctypes.c_int64
    lib.RecordIOWriterTell.argtypes = [ctypes.c_void_p]
    lib.RecordIOWriterFree.argtypes = [ctypes.c_void_p]
    lib.RecordIOReaderCreate.restype = ctypes.c_void_p
    lib.RecordIOReaderCreate.argtypes = [ctypes.c_char_p]
    lib.RecordIOReaderNext.restype = ctypes.c_int64
    lib.RecordIOReaderNext.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_char_p)]
    lib.RecordIOReaderSeek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.RecordIOReaderTell.restype = ctypes.c_int64
    lib.RecordIOReaderTell.argtypes = [ctypes.c_void_p]
    lib.RecordIOReaderFree.argtypes = [ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def image_pipeline_lib(decoder: str = "libjpeg") -> ctypes.CDLL:
    """The pipeline built with ``decoder`` (one of `DECODERS`)."""
    if decoder == "libjpeg":
        lib = build.load("image_pipeline", "image_pipeline",
                         ldflags=("-ljpeg",))
    elif decoder == "nvjpeg":
        lib = build.load("image_pipeline_nvjpeg", "image_pipeline",
                         defines=("MXT_NVJPEG",), cuda=True,
                         ldflags=("-lnvjpeg", "-lcudart"))
        lib.ImRecIterSetDevice.argtypes = [ctypes.c_int]
    else:
        raise MXNetError(f"decoder must be one of {DECODERS}, got "
                         f"{decoder!r}")
    F = ctypes.POINTER(ctypes.c_float)
    lib.ImRecIterCreate.restype = ctypes.c_void_p
    lib.ImRecIterCreate.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, F, F, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.ImRecIterNext.restype = ctypes.c_int
    lib.ImRecIterNext.argtypes = [ctypes.c_void_p, F, F,
                                  ctypes.POINTER(ctypes.c_int)]
    lib.ImRecIterNumRecords.restype = ctypes.c_int64
    lib.ImRecIterNumRecords.argtypes = [ctypes.c_void_p]
    lib.ImRecIterReset.argtypes = [ctypes.c_void_p]
    lib.ImRecIterFree.argtypes = [ctypes.c_void_p]
    lib.ImRecIterDecodeFailures.restype = ctypes.c_int64
    lib.ImRecIterDecodeFailures.argtypes = [ctypes.c_void_p]
    lib.ImRecIterDecoder.restype = ctypes.c_int
    if lib.ImRecIterDecoder() != DECODERS.index(decoder):
        raise MXNetError(f"the {decoder} pipeline library reports decoder "
                         f"{DECODERS[lib.ImRecIterDecoder()]}")
    return lib
