"""DataIter implementations of the PyTorch/CUDA port (see the package
docstring)."""
from __future__ import annotations

import threading
import time as _time
import queue as _queue
import warnings
from collections import namedtuple

import numpy as onp
import torch

from .. import telemetry
from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import HybridBlock
from . import prefetcher as _pf

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ResizeIter", "PrefetchingIter", "ImageRecordIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key  # BucketingModule routing (ref parity)
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        raise NotImplementedError

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._next_batch.data

    def getlabel(self):
        return self._next_batch.label

    def getindex(self):
        return self._next_batch.index

    def getpad(self):
        return self._next_batch.pad


class NDArrayIter(DataIter):
    """In-memory iterator (ref: python/mxnet/io/io.py NDArrayIter);
    batches are tensors on ``device`` (default ``cuda``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data", label_name="softmax_label",
                 device=None):
        super().__init__(batch_size)
        self._device = resolve_device(device)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._order = onp.arange(self.num_data)
        if shuffle:
            onp.random.shuffle(self._order)

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], str(v.dtype))
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], str(v.dtype))
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            onp.random.shuffle(self._order)

    def next(self) -> DataBatch:
        self.cursor += self.batch_size
        if self.cursor >= self.num_data:
            raise StopIteration
        end = self.cursor + self.batch_size
        pad = 0
        idx = self._order[self.cursor:end]
        if end > self.num_data:
            if self.last_batch_handle == "discard":
                raise StopIteration
            if self.last_batch_handle == "pad":
                pad = end - self.num_data
                idx = onp.concatenate([idx, self._order[:pad]])
            # roll_over: keep short batch
        data = [torch.from_numpy(v[idx]).to(self._device) for _, v in self.data]
        label = [torch.from_numpy(v[idx]).to(self._device)
                 for _, v in self.label]
        return DataBatch(data=data, label=label, pad=pad, index=idx,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise ValueError("data cannot be None")
        return []
    if isinstance(data, (torch.Tensor, onp.ndarray)):
        data = [(default_name, data)]
    elif isinstance(data, (list, tuple)):
        data = [(f"{default_name}_{i}" if i else default_name, d)
                for i, d in enumerate(data)]
    elif isinstance(data, dict):
        data = list(data.items())
    out = []
    for k, v in data:
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else onp.asarray(v)
        out.append((k, arr))
    return out


class CSVIter(DataIter):
    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, device=None, **kwargs):
        super().__init__(batch_size)
        data = onp.loadtxt(data_csv, delimiter=",", dtype="float32")
        data = data.reshape((-1,) + tuple(data_shape))
        label = onp.loadtxt(label_csv, delimiter=",", dtype="float32") \
            if label_csv else onp.zeros((data.shape[0],) + tuple(label_shape), "float32")
        self._inner = NDArrayIter(data, label, batch_size, last_batch_handle="discard",
                                  device=device)

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


class MNISTIter(DataIter):
    """Reads the classic idx-format MNIST files (ref: src/io/iter_mnist.cc)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 silent=False, seed=0, device=None, **kwargs):
        super().__init__(batch_size)
        import gzip
        import struct as _struct

        def _read_idx(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                magic = _struct.unpack(">I", f.read(4))[0]
                ndim = magic & 0xFF
                dims = [_struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
                return onp.frombuffer(f.read(), dtype=onp.uint8).reshape(dims)

        imgs = _read_idx(image).astype("float32") / 255.0
        labels = _read_idx(label).astype("float32")
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, 28, 28)
        self._inner = NDArrayIter(imgs, labels, batch_size, shuffle=shuffle,
                                  last_batch_handle="discard", device=device)

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


class ResizeIter(DataIter):
    """Caps an iterator at `size` batches (ref io.ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur >= self.size:
            raise StopIteration
        self.cur += 1
        try:
            return self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            return self.data_iter.next()

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label


class PrefetchingIter(DataIter):
    """Background-thread prefetcher (ref: src/io/iter_prefetcher.h) —
    overlaps host batch prep (and, with ``prefetch_to_device=True``,
    the start of the host→card copy) with compute.

    Shutdown is race-free by construction: every epoch owns a FRESH
    queue + stop flag, and the worker's blocking puts observe the stop
    flag (`prefetcher._abortable_put`), so `reset()` can always reap
    the old thread — and even a straggler can only ever touch its own
    (abandoned) queue, never the next epoch's.

    ``prefetch_to_device=True`` stages each batch on the worker thread
    (`prefetcher._Stager`: pinned buffers, a copy stream) onto
    ``device`` (default ``cuda``); `next` hands it to the consumer's
    stream.  An iterator that copies its own batches to the card
    (`ImageRecordIter`) is read through its ``_next_staged``, so that
    its copies, too, are handed over in `next`, on the consumer's
    thread, never on the worker's.  ``mesh`` is not ported
    (`MXNetError`).
    """

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2, prefetch_to_device=False, mesh=None,
                 axis_name="data", device=None):
        _pf._no_mesh(mesh)
        it = iters[0] if isinstance(iters, list) else iters
        super().__init__(it.batch_size)
        self.iter = it
        self._depth = max(1, int(prefetch_depth))
        self._stager = _pf._Stager(resolve_device(device), self._depth) \
            if prefetch_to_device else None
        self._queue: _queue.Queue = None
        self._stop: threading.Event = None
        self._thread = None
        self._start()

    def _start(self):
        # per-epoch queue + stop flag: the shutdown/pollution guarantee
        q = self._queue = _queue.Queue(maxsize=self._depth)
        stop = self._stop = threading.Event()
        it, stager = self.iter, self._stager
        staged = getattr(it, "_next_staged", None)

        def worker():
            while not stop.is_set():
                try:
                    # an iterator that stages its own batches hands them
                    # over pending: only the consumer's `next` readies
                    # them, on the consumer's stream
                    batch = staged() if staged is not None else it.next()
                    if stager is not None:
                        batch = _pf._stage(batch, stager)
                except StopIteration:
                    _pf._abortable_put(q, None, stop)
                    return
                except BaseException as e:  # re-raised on the consumer
                    _pf._abortable_put(q, _pf._Failure(e), stop)
                    return
                if not _pf._abortable_put(q, batch, stop):
                    return

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="mxtpu-prefetching-iter")
        self._thread.start()

    def _shutdown(self):
        if self._stop is not None:
            self._stop.set()
        if self._queue is not None:
            _pf._drain(self._queue)
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def reset(self):
        self._shutdown()
        self.iter.reset()
        self._start()

    def close(self):
        """Stop the worker without restarting it (end of use)."""
        self._shutdown()

    def next(self):
        want_tel = telemetry.enabled()
        t0 = _time.perf_counter() if want_tel else 0.0
        while True:
            try:
                batch = self._queue.get(timeout=1.0)
                break
            except _queue.Empty:
                if self._thread is None or not self._thread.is_alive():
                    batch = None  # worker died without a sentinel
                    break
        if want_tel:
            _pf._observe_wait(t0, self._queue.qsize())
        if batch is None:
            raise StopIteration
        if isinstance(batch, _pf._Failure):
            batch.reraise()
        return _pf._ready(batch)

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label


class ImageRecordIter(DataIter):
    """RecordIO image iterator (ref: src/io/iter_image_recordio_2.cc).

    Decode/augment runs in host worker threads of the native pipeline
    (`native/image_pipeline.cc`) or, with ``use_native=False``, in the
    Python reader; emitted batches are tensors on ``device`` (default
    ``cuda``), copied through the iterator's `prefetcher._Stager`.

    ``decoder`` names the native pipeline's JPEG decoder: ``"libjpeg"``
    (the JAX package's) or ``"nvjpeg"`` (the CUDA toolkit's, decoding
    on the card; its pixels differ from libjpeg's by its rounding).  A
    pipeline that does not build raises `MXNetError`; nothing switches
    decoder or reader behind the caller's back.  ``self.decoder`` says
    which ran (``"PIL"`` for the Python reader).  ``mesh`` is not
    ported (`MXNetError`).
    """

    def __init__(self, path_imgrec, data_shape, batch_size, path_imgidx=None,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0,
                 preprocess_threads=4, label_width=1, round_batch=True,
                 resize=0, seed=0, use_native=True, scale=1.0,
                 device_normalize=False, mesh=None, decoder="libjpeg",
                 device=None, **kwargs):
        """device_normalize=True: the iterator emits RAW uint8 pixels —
        4x fewer bytes over the host→card link — and mean/std/scale
        move into the model via `normalize()` / `wrap_net`.  The
        reference normalizes on the host (fp32 batches)."""
        super().__init__(batch_size)
        from .. import recordio as rio

        _pf._no_mesh(mesh)
        self._stager = _pf._Stager(resolve_device(device))
        self.data_shape = tuple(data_shape)
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.mean = onp.array([mean_r, mean_g, mean_b], "float32").reshape(3, 1, 1)
        self.std = onp.array([std_r, std_g, std_b], "float32").reshape(3, 1, 1)
        self.shuffle = shuffle
        self._scale = scale
        self._affine = _Affine(scale, self.mean.reshape(1, -1, 1, 1),
                               self.std.reshape(1, -1, 1, 1))
        self._resize = resize
        self._round_batch = round_batch
        self._device_normalize = device_normalize
        if device_normalize:
            # host pipeline must leave pixels raw: normalization happens
            # on the card inside the model (see normalize())
            mean_r = mean_g = mean_b = 0.0
            std_r = std_g = std_b = 1.0
            scale = 1.0
        self._native = None
        if use_native and (path_imgidx or label_width != 1):
            # The native pipeline builds its own sequential index and
            # reads one label; a user-supplied .idx (keyed access order)
            # or a wider label takes the Python reader, which honours it.
            warnings.warn(
                "ImageRecordIter: " + ("path_imgidx" if path_imgidx else
                                       f"label_width={label_width}")
                + " is not supported by the native pipeline; using the "
                "Python reader.", stacklevel=2)
            use_native = False
        if use_native:
            self._native = _NativeImagePipeline.create(
                path_imgrec, batch_size, self.data_shape, preprocess_threads,
                shuffle, seed, rand_crop, rand_mirror,
                (mean_r, mean_g, mean_b), (std_r, std_g, std_b), scale, resize,
                round_batch, decoder, self._stager.device)
            self.decoder = decoder
            self.keys = None
            return
        self.decoder = "PIL"
        if path_imgidx:
            self.rec = rio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            self.keys = list(self.rec.keys)
        else:
            self.rec = rio.MXRecordIO(path_imgrec, "r")
            self.keys = None
        self._order = None
        self.reset()

    def reset(self):
        self._padded_last = False
        if self._native is not None:
            self._native.reset()
        elif self.keys is not None:
            self._order = onp.arange(len(self.keys))
            if self.shuffle:
                onp.random.shuffle(self._order)
            self._cursor = 0
        else:
            self.rec.reset()

    def _read_one(self):
        from .. import recordio as rio

        if self.keys is not None:
            if self._cursor >= len(self.keys):
                raise StopIteration
            raw = self.rec.read_idx(self.keys[self._order[self._cursor]])
            self._cursor += 1
        else:
            raw = self.rec.read()
            if raw is None:
                raise StopIteration
        header, img = rio.unpack_img(raw)
        arr = img.astype("float32")
        if arr.ndim == 2:
            arr = onp.stack([arr] * 3, axis=-1)
        if self._resize > 0 and min(arr.shape[0], arr.shape[1]) != self._resize:
            from PIL import Image

            ih, iw = arr.shape[:2]
            if ih < iw:
                nh, nw = self._resize, int(iw * self._resize / ih)
            else:
                nh, nw = int(ih * self._resize / iw), self._resize
            arr = onp.asarray(Image.fromarray(arr.astype("uint8"))
                              .resize((nw, nh), Image.BILINEAR), dtype="float32")
        arr = arr.transpose(2, 0, 1)  # HWC→CHW
        c, h, w = self.data_shape
        arr = _center_or_rand_crop(arr, h, w, self.rand_crop)
        if self.rand_mirror and onp.random.rand() < 0.5:
            arr = arr[:, :, ::-1]
        if not self._device_normalize:
            arr = (arr * self._scale - self.mean) / self.std
        return arr, onp.float32(header.label if onp.isscalar(header.label) else header.label[0])

    @property
    def decode_failures(self) -> int:
        """Samples whose JPEG did not decode (the native pipeline's
        count; the Python reader raises instead)."""
        return self._native.decode_failures if self._native is not None \
            else 0

    def normalize(self, x):
        """Normalization of `device_normalize=True` batches on their
        device: the cast to float32 and the affine, as torch ops.  Call
        it inside a hybridized block's forward so that it runs in the
        captured program: ``x = train_iter.normalize(x); out = net(x)``"""
        return self._affine(x)

    def wrap_net(self, net, dtype="float32"):
        """Consumer side of `device_normalize=True`: returns a
        `HybridBlock` doing uint8 → float32 normalize → cast(dtype) →
        net.  Hybridized, its uint8 input is staged into the recorded
        forward's static buffer and the cast and affine run inside the
        captured program.  Save/load parameters via the INNER net (the
        wrapper adds no params of its own).  The wrapper copies
        mean/std/scale — it does NOT keep the iterator alive, so the
        model stays usable after the iterator is gone."""
        return _NormalizedNet(net, _Affine(self._scale,
                                           self._affine.mean.copy(),
                                           self._affine.std.copy()), dtype)

    def _emit(self, data_np, label_np, pad) -> DataBatch:
        """Emit path: the host arrays onto the iterator's device through
        its `prefetcher._Stager` (pinned staging, a copy stream; counts
        `h2d_bytes_total`).  On CUDA the batch's leaves are still
        pending (`prefetcher._Pending`): `next` hands them to the
        caller's stream.  Wrap the iterator in
        `PrefetchingIter(prefetch_to_device=True)` to move this copy,
        and the decode, off the consuming thread."""
        data, label = _pf._stage((data_np, label_np), self._stager)
        return DataBatch(data=[data], label=[label], pad=pad)

    def next(self) -> DataBatch:
        return _pf._ready(self._next_staged())

    def _next_staged(self) -> DataBatch:
        """The next batch with its copies in flight, not yet handed to
        any stream (`PrefetchingIter`'s worker reads this)."""
        if self._native is not None:
            d, l, pad = self._native.next()
            if self._device_normalize:
                d = d.astype("uint8")  # 4x fewer bytes to the card
            return self._emit(d, l, pad)
        if getattr(self, "_padded_last", False):
            self._padded_last = False
            raise StopIteration  # the padded batch ended the epoch
        datas, labels = [], []
        for _ in range(self.batch_size):
            try:
                d, l = self._read_one()
            except StopIteration:
                if not datas or not self._round_batch:
                    raise  # drop partial tail (round_batch=False)
                break
            datas.append(d)
            labels.append(l)
        pad = self.batch_size - len(datas)
        if pad:
            # round_batch=True: wrap to the epoch start, report `pad` so
            # exact-epoch consumers can discard the wrapped samples
            # (ref ImageRecordIter round-robin overflow handling).
            self.reset()
            self._padded_last = True
            while len(datas) < self.batch_size:
                try:
                    d, l = self._read_one()
                except StopIteration:
                    self.reset()  # dataset smaller than pad: keep wrapping
                    self._padded_last = True
                    continue
                datas.append(d)
                labels.append(l)
        stacked = onp.stack(datas)
        if self._device_normalize:
            stacked = stacked.astype("uint8")  # raw pixels, small transfer
        return self._emit(stacked, onp.stack(labels), pad)


class _Affine:
    """``x`` as float32, times ``scale``, less ``mean``, over ``std``
    (numpy (1, C, 1, 1) arrays; a term that changes nothing is left
    out).  The mean and std tensors are made once a device, at the first
    call (a captured program's warm-up), never inside a capture."""

    def __init__(self, scale, mean, std):
        self.scale, self.mean, self.std = float(scale), mean, std
        self._on: dict = {}

    def consts(self, device):
        c = self._on.get(device)
        if c is None:
            c = self._on[device] = (torch.from_numpy(self.mean).to(device),
                                    torch.from_numpy(self.std).to(device))
        return c

    def __call__(self, x):
        x = x.to(torch.float32)
        if self.scale != 1.0:
            x = x * self.scale
        mean, std = self.consts(x.device)
        if (self.mean != 0).any():
            x = x - mean
        if (self.std != 1).any():
            x = x / std
        return x


class _NormalizedNet(HybridBlock):
    """uint8 batch → float32 normalize → cast → ``net``.  The affine's
    tensors are made on the inner net's device when the wrapper is
    built, and are no buffers, so ``cast`` leaves them in float32."""

    def __init__(self, net, affine, dtype):
        super().__init__()
        self.net = net
        self._affine = affine
        self._out_dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else dtype
        p = next(iter(net.parameters()), None)
        affine.consts(p.device if p is not None else torch.device("cpu"))

    def forward(self, x):
        return self.net(self._affine(x).to(self._out_dtype))


class _NativeImagePipeline:
    """ctypes wrapper over native/image_pipeline.cc (threaded decode +
    augment + double-buffered prefetch — ref iter_image_recordio_2)."""

    def __init__(self, lib, handle, batch, shape):
        self._lib = lib
        self._h = handle
        self._batch = batch
        self._shape = shape  # (C,H,W)

    @classmethod
    def create(cls, path, batch, data_shape, threads, shuffle, seed,
               rand_crop, rand_mirror, mean, std, scale, resize,
               round_batch=True, decoder="libjpeg", device=None):
        """The pipeline over ``path``; raises `MXNetError` when its
        library does not build or the file does not open or index."""
        import ctypes

        from ..native import image_pipeline_lib

        lib = image_pipeline_lib(decoder)
        if decoder == "nvjpeg":
            idx = device.index if device is not None and \
                device.type == "cuda" and device.index is not None \
                else torch.cuda.current_device()
            lib.ImRecIterSetDevice(idx)
        c, h, w = data_shape
        mean_arr = (ctypes.c_float * 3)(*mean)
        std_arr = (ctypes.c_float * 3)(*std)
        handle = lib.ImRecIterCreate(
            path.encode(), batch, h, w, c, threads, int(shuffle), seed,
            int(rand_crop), int(rand_mirror), mean_arr, std_arr, scale, 0,
            resize, int(round_batch))
        if not handle:
            raise MXNetError(f"native image pipeline ({decoder}): cannot "
                             f"open or index {path}")
        return cls(lib, handle, batch, (c, h, w))

    def next(self):
        """Returns (data, label, pad); raises StopIteration / IOError."""
        import ctypes

        c, h, w = self._shape
        data = onp.empty((self._batch, c, h, w), "float32")
        label = onp.empty((self._batch,), "float32")
        pad = ctypes.c_int(0)
        ok = self._lib.ImRecIterNext(
            self._h,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(pad))
        if ok == 0:
            raise StopIteration
        if ok < 0:
            raise IOError(
                "native image pipeline: record read (or, with nvJPEG, "
                "decode) failure(s) in this batch; "
                f"{self.decode_failures} decode failure(s) so far")
        return data, label, pad.value

    @property
    def decode_failures(self) -> int:
        """Samples whose JPEG did not decode since the pipeline was
        made (zero-filled, as the JAX package's; with nvJPEG their batch
        raises `IOError` too)."""
        return int(self._lib.ImRecIterDecodeFailures(self._h))

    def reset(self):
        self._lib.ImRecIterReset(self._h)

    def __del__(self):
        try:
            self._lib.ImRecIterFree(self._h)
        except Exception:
            pass


def _center_or_rand_crop(arr, h, w, rand):
    c, H, W = arr.shape
    if H < h or W < w:
        # pad small images
        out = onp.zeros((c, max(H, h), max(W, w)), arr.dtype)
        out[:, :H, :W] = arr
        arr, H, W = out, max(H, h), max(W, w)
    if rand:
        y = onp.random.randint(0, H - h + 1)
        x = onp.random.randint(0, W - w + 1)
    else:
        y, x = (H - h) // 2, (W - w) // 2
    return arr[:, y:y + h, x:x + w]
