"""Gluon's data stack of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/data/`): datasets, samplers, the DataLoader
and the vision datasets and transforms, over numpy on the host."""
from .dataset import Dataset, ArrayDataset, SimpleDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader
from . import vision

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "vision"]
