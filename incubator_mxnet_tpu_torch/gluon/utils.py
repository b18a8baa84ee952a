"""Gluon utilities of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/utils.py`): `split_data`, `split_and_load`
over a list of devices, `clip_global_norm`, `check_sha1`, `download`
(from a local mirror only) and `shape_is_known`.  The mesh forms
(``shard_batch``, ``split_and_load(mesh=...)``) come with the port's
parallel stack and raise `MXNetError` until then."""
from __future__ import annotations

import hashlib
import math
import os
import shutil
import warnings
from typing import List

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "shape_is_known"]


def _tensor(data):
    return data if isinstance(data, torch.Tensor) \
        else torch.as_tensor(np.asarray(data))


def split_data(data, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[torch.Tensor]:
    """``num_slice`` slices of ``data`` along ``batch_axis``, the last
    taking the remainder (views, no copy); with ``even_split`` the axis
    must divide evenly."""
    data = _tensor(data)
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {tuple(data.shape)} cannot be evenly split "
            f"into {num_slice} slices along axis {batch_axis}.")
    step = size // num_slice
    return [data.narrow(batch_axis, i * step,
                        (size if i == num_slice - 1 else (i + 1) * step)
                        - i * step)
            for i in range(num_slice)]


def split_and_load(data, ctx_list=None, batch_axis: int = 0,
                   even_split: bool = True, mesh=None,
                   axis_name: str = "data") -> List[torch.Tensor]:
    """One slice of ``data`` on each device of ``ctx_list`` (`split_data`;
    the whole of it for one device).  A device is a `torch.device` or
    its name; ``cuda`` needs a card (`context.resolve_device`)."""
    if mesh is not None:
        raise MXNetError("split_and_load(mesh=...) is not ported yet (it "
                         "comes with the parallel stack)")
    if ctx_list is None:
        raise ValueError("split_and_load: pass either ctx_list or mesh=")
    devices = [resolve_device(c) for c in ctx_list]
    data = _tensor(data)
    if len(devices) == 1:
        return [data.to(devices[0])]
    slices = split_data(data, len(devices), batch_axis, even_split)
    return [s.to(d) for s, d in zip(slices, devices)]


def clip_global_norm(arrays, max_norm: float, check_isfinite: bool = True):
    """Scale ``arrays`` in place so their joint L2 norm (taken in f32) is
    at most ``max_norm``: each times ``min(max_norm / (norm + 1e-8),
    1)``, 1 where the norm is NaN.  The norm and the scale stay on the
    arrays' device.  Returns the norm: with ``check_isfinite`` (the
    default) as a float, which waits for the card, warning when it is
    not finite; else as a one-element tensor on the device, with no
    host sync.  ``None`` entries (a gradient no backward reached) count
    as zeros."""
    arrays = [a for a in arrays if a is not None]
    if not arrays:
        raise ValueError("arrays must not be empty")
    norms = torch._foreach_norm([a.float() if a.dtype != torch.float32
                                 else a for a in arrays])
    total = torch.linalg.vector_norm(torch.stack(norms))
    scale = max_norm / (total + 1e-8)
    scale = torch.where(scale < 1.0, scale, 1.0)
    torch._foreach_mul_(arrays, scale)
    if not check_isfinite:
        return total
    total_f = float(total)
    if not math.isfinite(total_f):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.")
    return total_f


def check_sha1(filename: str, sha1_hash: str) -> bool:
    """Whether the file's SHA-1 is ``sha1_hash`` (hex)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The file named by ``url``'s last part, at ``path`` (a file, or a
    directory to put it in; default the current directory).  Nothing is
    fetched over the network: a file already there is kept unless
    ``overwrite``; else it is copied from the local mirror
    ``$MXNET_GLUON_REPO``; else `IOError`, as in the JAX package (which
    reads neither ``sha1_hash`` nor the other arguments)."""
    fname = url.split("/")[-1]
    if path is None:
        path = fname
    elif os.path.isdir(path):
        path = os.path.join(path, fname)
    if os.path.exists(path) and not overwrite:
        return path
    mirror = os.environ.get("MXNET_GLUON_REPO")
    if mirror:
        cand = os.path.join(mirror, fname)
        if os.path.exists(cand):
            shutil.copy(cand, path)
            return path
    raise IOError(f"Cannot download {url}: files come only from the local "
                  f"mirror $MXNET_GLUON_REPO. Place the file there and "
                  f"retry.")


def shape_is_known(shape) -> bool:
    """Whether every axis of ``shape`` is known (positive)."""
    if shape is None:
        return False
    return all(s > 0 for s in shape)
