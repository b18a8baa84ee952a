"""Builds the port's CUDA sources on first use and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface.  `load(name)`
compiles it with ``nvcc`` for ``sm_90a`` into
``incubator_mxnet_tpu_torch/_build/`` (a directory git ignores) and
opens it with `ctypes`; the file name carries a hash of the source,
of every header ``csrc/*.cuh`` (sources share device code through them)
and of the flags, so an edited source or header is rebuilt and never
served stale.
`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import time: only a wrapper that was handed a CUDA
tensor calls `load`, so the CPU path never looks for ``nvcc``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

from .base import MXNetError

__all__ = ["SOURCES", "build_all", "load", "stream"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("paged_attention", "flash_attention", "flash_attention_bwd",
           "dropout", "xent", "int8_conv")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
_logs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found: building the port's CUDA kernels "
                         "needs the CUDA toolkit (CUDA_HOME or PATH)")
    return found


def _target(name: str) -> tuple:
    """(source path, library path): the library's name hashes the
    source, every ``csrc/*.cuh`` header (name and bytes) and the
    flags."""
    src = os.path.join(_CSRC, name + ".cu")
    digest = hashlib.sha1()
    with open(src, "rb") as f:
        digest.update(f.read())
    for header in sorted(h for h in os.listdir(_CSRC) if h.endswith(".cuh")):
        with open(os.path.join(_CSRC, header), "rb") as f:
            digest.update(b"\0" + header.encode() + b"\0" + f.read())
    digest.update(" ".join(_FLAGS).encode())
    return src, os.path.join(_BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built;
    returns (library path, temporary output path, process or None)."""
    src, so = _target(name)
    if os.path.exists(so):
        return so, None, None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen([_nvcc(), *_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return so, tmp, proc


def _finish(name: str, so: str, tmp, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    _logs[name] = out
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise MXNetError(f"nvcc failed on csrc/{name}.cu:\n{out}")
    os.replace(tmp, so)


def build_all() -> dict:
    """Build every source, one nvcc process each, all started together;
    returns {name: compiler log} ("" when already built)."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        for n, (so, tmp, proc) in started.items():
            _finish(n, so, tmp, proc)
        return {n: _logs.get(n, "") for n in SOURCES}


def load(name: str):
    """The `ctypes` library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            import ctypes

            so, tmp, proc = _start(name)
            _finish(name, so, tmp, proc)
            lib = _libs[name] = ctypes.CDLL(so)
        return lib


def stream(device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``, which
    every kernel launches on."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
