"""Gluon datasets of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/data/dataset.py`; ref
`python/mxnet/gluon/data/dataset.py`)."""
from __future__ import annotations

from typing import Callable

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn: Callable, lazy: bool = True) -> "Dataset":
        return _LazyTransformDataset(self, fn) if lazy else \
            SimpleDataset([fn(self[i]) for i in range(len(self))])

    def transform_first(self, fn: Callable, lazy: bool = True) -> "Dataset":
        def first(*items):
            if len(items) == 1:
                return fn(items[0])
            return (fn(items[0]),) + items[1:]

        return self.transform(_UnpackWrapper(first), lazy)

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def shard(self, num_shards, index):
        items = [self[i] for i in range(len(self)) if i % num_shards == index]
        return SimpleDataset(items)


class _UnpackWrapper:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, item):
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _LazyTransformDataset(Dataset):
    def __init__(self, dataset, fn):
        self._dataset = dataset
        self._fn = fn

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, idx):
        item = self._dataset[idx]
        if isinstance(self._fn, _UnpackWrapper) or not isinstance(item, tuple):
            return self._fn(item)
        return self._fn(*item)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            assert len(a) == self._length, "all arrays must have the same length"
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over an indexed RecordIO file (ref gluon RecordFileDataset)."""

    def __init__(self, filename: str):
        from ... import recordio as rio

        idx_file = filename.rsplit(".", 1)[0] + ".idx"
        self._record = rio.MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
