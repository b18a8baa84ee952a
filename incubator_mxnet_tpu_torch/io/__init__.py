"""`mx.io` of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/io/`): the `DataIter` protocol (`next() →
DataBatch`, `provide_data/provide_label`, `reset`), `NDArrayIter` with
shuffle + last-batch handling, CSVIter, MNISTIter, and `ImageRecordIter`
backed by the RecordIO codec + the native decode workers.

`prefetcher` is the host→card input pipeline: `DevicePrefetcher`
overlaps host fetch, the pinned-memory copy to the card and compute;
`PrefetchingIter` gives the same overlap behind the DataIter protocol.
Batches land on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter, CSVIter,
                 MNISTIter, ResizeIter, PrefetchingIter, ImageRecordIter)
from .prefetcher import DevicePrefetcher, batch_sharding, to_device

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ResizeIter", "PrefetchingIter", "ImageRecordIter",
           "DevicePrefetcher", "batch_sharding", "to_device"]
