"""DataLoader of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/data/dataloader.py`; ref
`python/mxnet/gluon/data/dataloader.py`): batchify + optional thread
workers + optional prefetch to the card.

Parallel fetch uses a thread pool, as in the JAX package (decode and
augment are numpy/PIL work that releases the GIL); `num_workers` keeps
its meaning as fetch parallelism.  Batches are host batches (numpy
arrays, or CPU tensors where the samples are tensors); with
``pin_memory`` their array leaves are pinned CPU tensors, and with
``prefetch_to_device`` they flow through `io.prefetcher.DevicePrefetcher`
and arrive as tensors on ``device`` (default ``cuda``), their copy
overlapping the consumer's compute.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as onp
import torch

from ...base import MXNetError
from ...context import resolve_device
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch: tensors with `torch.stack`, anything
    else as a numpy array (float64 as float32)."""
    if isinstance(data[0], torch.Tensor):
        return torch.stack(data)
    if isinstance(data[0], (tuple, list)):
        return tuple(default_batchify_fn(list(items)) for items in zip(*data))
    arr = onp.asarray(data)
    if arr.dtype == onp.float64:
        arr = arr.astype(onp.float32)
    return arr


default_mp_batchify_fn = default_batchify_fn


def _pinned(batch):
    """``batch`` with every array leaf a pinned CPU tensor."""
    if isinstance(batch, (tuple, list)):
        out = [_pinned(b) for b in batch]
        return type(batch)(out) if isinstance(batch, tuple) else out
    if isinstance(batch, dict):
        return {k: _pinned(v) for k, v in batch.items()}
    if isinstance(batch, onp.ndarray):
        batch = torch.from_numpy(onp.ascontiguousarray(batch))
    if isinstance(batch, torch.Tensor) and batch.device.type == "cpu":
        return batch.pin_memory()
    return batch


class DataLoader:
    """Loads batches from a dataset.

    ``prefetch_to_device`` (True, or an int queue depth): batches flow
    through `io.prefetcher.DevicePrefetcher`, so host fetch/batchify,
    the host→card copy and the training step overlap; batches arrive as
    tensors on ``device`` (default ``cuda``).  ``pin_memory=True``
    returns pinned CPU tensors (it needs CUDA: `MXNetError` without a
    GPU).  ``mesh`` is not ported (`MXNetError`)."""

    def __init__(self, dataset: Dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn: Optional[Callable] = None, num_workers=0,
                 pin_memory=False, prefetch=None, thread_pool=False,
                 prefetch_to_device=False, mesh=None, data_axis="data",
                 device=None):
        from ...io.prefetcher import _no_mesh

        _no_mesh(mesh)
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler is")
            batch_sampler = BatchSampler(sampler, batch_size, last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or last_batch:
            raise ValueError("batch_size, shuffle, sampler and last_batch must "
                             "not be specified if batch_sampler is")
        if pin_memory and not torch.cuda.is_available():
            raise MXNetError("pin_memory=True needs a CUDA device")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._pin_memory = bool(pin_memory)
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None else 2 * self._num_workers)
        # device-feed prefetch: False/0 = off, True = depth 2, int = depth
        self._device_depth = 2 if prefetch_to_device is True \
            else max(0, int(prefetch_to_device or 0))
        self._device = resolve_device(device) if self._device_depth \
            else None

    def _batchify(self, idxs):
        batch = self._batchify_fn([self._dataset[i] for i in idxs])
        return _pinned(batch) if self._pin_memory else batch

    def _host_batches(self):
        """Host-side batch stream (fetch + batchify only)."""
        if self._num_workers == 0:
            for batch_idx in self._batch_sampler:
                yield self._batchify(batch_idx)
            return

        # Streaming fan-out: the sampler is consumed lazily (a streaming
        # batch_sampler never gets materialized), at most prefetch+1
        # batches are in flight, and an early break cancels the queued
        # fetches instead of blocking in pool shutdown.
        pool = ThreadPoolExecutor(max_workers=self._num_workers)
        futures: deque = deque()
        sampler_it = iter(self._batch_sampler)

        def submit_next() -> bool:
            try:
                idxs = next(sampler_it)
            except StopIteration:
                return False
            futures.append(pool.submit(self._batchify, idxs))
            return True

        try:
            draining = False
            for _ in range(self._prefetch + 1):
                if not submit_next():
                    draining = True
                    break
            while futures:
                batch = futures.popleft().result()
                if not draining:
                    draining = not submit_next()
                yield batch
        finally:
            for f in futures:
                f.cancel()
            pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self):
        if not self._device_depth:
            yield from self._host_batches()
            return
        from ...io.prefetcher import DevicePrefetcher

        # one-shot source: each __iter__ builds a fresh host generator,
        # so the prefetcher epoch consumes exactly this iteration
        yield from DevicePrefetcher(self._host_batches(),
                                    depth=self._device_depth,
                                    device=self._device)

    def __len__(self):
        return len(self._batch_sampler)
