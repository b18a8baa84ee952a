"""Builds the port's host C++ components with ``g++`` on first use and
loads them with `ctypes`.

``native/<source>.cc`` compiles into the port's git-ignored
``_build/native/`` as ``libmxt_<name>-<hash>.so``.  The hash covers the
source, every header ``native/*.h`` and the whole compiler command
(compiler, defines, flags), so an edited source or a changed command
builds a new library and a stale one is never loaded.  A failed build
raises `MXNetError` with the compiler's output: no caller falls back to
another code path.

``CXX`` names the compiler (default ``g++``); ``CUDA_HOME`` the CUDA
toolkit that the nvJPEG build compiles and links against (default
``/usr/local/cuda``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from ..base import MXNetError

__all__ = ["load", "library_path"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _command(source: str, defines=(), cuda=False, ldflags=()) -> list:
    """The compiler command, less its output path."""
    cmd = [os.environ.get("CXX") or "g++", *_FLAGS,
           *(f"-D{d}" for d in defines)]
    if cuda:
        home = _cuda_home()
        cmd.append(f"-I{home}/include")
    cmd.append(os.path.join(_DIR, source + ".cc"))
    if cuda:
        lib = os.path.join(_cuda_home(), "lib64")
        cmd += [f"-L{lib}", f"-Wl,-rpath,{lib}"]
    return cmd + list(ldflags)


def library_path(name: str, cmd: list) -> str:
    """Where the library ``name`` built by ``cmd`` lives."""
    digest = hashlib.sha1(" ".join(cmd).encode())
    for f in sorted(os.listdir(_DIR)):
        if f.endswith((".cc", ".h")):
            with open(os.path.join(_DIR, f), "rb") as fh:
                digest.update(b"\0" + f.encode() + b"\0" + fh.read())
    return os.path.join(_BUILD_DIR,
                        f"libmxt_{name}-{digest.hexdigest()[:12]}.so")


def load(name: str, source: str, defines=(), cuda=False,
         ldflags=()) -> ctypes.CDLL:
    """Build ``native/<source>.cc`` as the library ``name`` unless it is
    built already, and open it.  Raises `MXNetError` when the compiler
    is missing, fails or times out, or the library does not load."""
    cmd = _command(source, defines, cuda, ldflags)
    so = library_path(name, cmd)
    with _lock:
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
            try:
                res = subprocess.run([*cmd, "-o", tmp], capture_output=True,
                                     text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise MXNetError(f"building native/{source}.cc "
                                 f"({' '.join(cmd)}) failed: {e}") from e
            if res.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise MXNetError(
                    f"building native/{source}.cc failed (exit "
                    f"{res.returncode}): {' '.join(cmd)}\n{res.stderr}"
                    f"{res.stdout}")
            os.replace(tmp, so)
        try:
            return ctypes.CDLL(so)
        except OSError as e:
            raise MXNetError(f"loading {so} failed: {e}") from e
