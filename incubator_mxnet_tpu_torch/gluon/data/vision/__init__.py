"""Vision datasets and transforms of the PyTorch/CUDA port (counterpart
of `incubator_mxnet_tpu/gluon/data/vision/`)."""
from . import transforms
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageRecordDataset, ImageFolderDataset, SyntheticImageDataset)

__all__ = ["transforms", "MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "SyntheticImageDataset"]
