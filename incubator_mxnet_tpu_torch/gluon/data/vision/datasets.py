"""Vision datasets of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/data/vision/datasets.py`; ref
`python/mxnet/gluon/data/vision/datasets.py`).  Nothing is downloaded:
datasets read from `root` / `$MXNET_HOME/datasets` when the raw files
exist and raise with guidance otherwise.  Samples are numpy arrays
(HWC) and labels.  `SyntheticImageDataset` provides a deterministic
separable stand-in so training tests can run without downloads.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as onp

from ....base import MXNetError
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "SyntheticImageDataset"]


def _data_home():
    return os.environ.get("MXNET_HOME", os.path.join(os.path.expanduser("~"), ".mxnet"))


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        x = self._data[idx]
        y = self._label[idx]
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """Reads idx-format MNIST from root (no download in this env)."""

    _train_files = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
    _test_files = ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")

    def __init__(self, root=None, train=True, transform=None):
        root = root or os.path.join(_data_home(), "datasets", "mnist")
        super().__init__(root, train, transform)

    def _get_data(self):
        img_f, lbl_f = self._train_files if self._train else self._test_files
        img_path = os.path.join(self._root, img_f)
        lbl_path = os.path.join(self._root, lbl_f)
        if not os.path.exists(img_path) and os.path.exists(img_path[:-3]):
            img_path, lbl_path = img_path[:-3], lbl_path[:-3]
        if not os.path.exists(img_path):
            raise MXNetError(
                f"MNIST files not found under {self._root} and this environment "
                f"nothing is downloaded. Use SyntheticImageDataset for tests.")
        self._data = _read_idx(img_path).reshape(-1, 28, 28, 1).astype("float32") / 255.0
        self._label = _read_idx(lbl_path).astype("int32")


class FashionMNIST(MNIST):
    def __init__(self, root=None, train=True, transform=None):
        root = root or os.path.join(_data_home(), "datasets", "fashion-mnist")
        _DownloadedDataset.__init__(self, root, train, transform)


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        return onp.frombuffer(f.read(), dtype=onp.uint8).reshape(dims)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root=None, train=True, transform=None):
        root = root or os.path.join(_data_home(), "datasets", "cifar10")
        super().__init__(root, train, transform)

    def _get_data(self):
        import pickle

        batches = [f"data_batch_{i}" for i in range(1, 6)] if self._train else ["test_batch"]
        xs, ys = [], []
        for b in batches:
            path = os.path.join(self._root, "cifar-10-batches-py", b)
            if not os.path.exists(path):
                path = os.path.join(self._root, b)
            if not os.path.exists(path):
                raise MXNetError(f"CIFAR10 batch {b} not found under {self._root} "
                                 f"(nothing is downloaded; use SyntheticImageDataset)")
            with open(path, "rb") as f:
                blob = pickle.load(f, encoding="bytes")
            xs.append(blob[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            ys.append(onp.asarray(blob[b"labels"]))
        self._data = onp.concatenate(xs).astype("float32") / 255.0
        self._label = onp.concatenate(ys).astype("int32")


class CIFAR100(CIFAR10):
    def __init__(self, root=None, train=True, fine_label=True, transform=None):
        self._fine = fine_label
        root = root or os.path.join(_data_home(), "datasets", "cifar100")
        _DownloadedDataset.__init__(self, root, train, transform)

    def _get_data(self):
        import pickle

        name = "train" if self._train else "test"
        path = os.path.join(self._root, "cifar-100-python", name)
        if not os.path.exists(path):
            path = os.path.join(self._root, name)
        if not os.path.exists(path):
            raise MXNetError(f"CIFAR100 not found under {self._root}")
        with open(path, "rb") as f:
            blob = pickle.load(f, encoding="bytes")
        self._data = blob[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1) \
            .astype("float32") / 255.0
        key = b"fine_labels" if self._fine else b"coarse_labels"
        self._label = onp.asarray(blob[key]).astype("int32")


class SyntheticImageDataset(Dataset):
    """Deterministic separable classification data for training gates.

    Class k's images carry a class-specific spatial template + noise; a
    LeNet reaches >98% within a few epochs — mirroring the reference's
    MNIST gate without downloads.
    """

    def __init__(self, num_samples=2048, num_classes=10, shape=(1, 28, 28),
                 noise=0.15, seed=42, template_seed=1234, transform=None):
        # templates fixed by template_seed so train/val splits (different
        # `seed`) share the same class structure
        trng = onp.random.RandomState(template_seed)
        self._templates = trng.uniform(-1, 1, size=(num_classes,) + tuple(shape)) \
            .astype("float32")
        rng = onp.random.RandomState(seed)
        labels = rng.randint(0, num_classes, size=num_samples).astype("int32")
        imgs = self._templates[labels] + noise * rng.randn(num_samples, *shape) \
            .astype("float32")
        self._data = imgs.transpose(0, 2, 3, 1)  # HWC like real datasets
        self._label = labels
        self._transform = transform

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        x = self._data[idx]
        y = self._label[idx]
        if self._transform is not None:
            return self._transform(x, y)
        return x, y


class ImageRecordDataset(Dataset):
    """Dataset over .rec image records (ref ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        from ....gluon.data.dataset import RecordFileDataset

        self._inner = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._inner)

    def __getitem__(self, idx):
        from .... import recordio as rio

        record = self._inner[idx]
        header, img = rio.unpack_img(record)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """folder/label/img.jpg layout (ref ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png")):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from .... import image as img_mod

        path, label = self.items[idx]
        with open(path, "rb") as f:
            img = img_mod.imdecode(f.read(), flag=self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
