"""Gluon's data stack in the PyTorch/CUDA port
(`incubator_mxnet_tpu_torch.gluon.data`) against the JAX package's, on
the CPU: `DataLoader` batches (``num_workers`` 0 and 2, the
``last_batch`` modes, samplers, ``prefetch_to_device`` on
``device="cpu"``, early exit), the datasets (`ArrayDataset`,
`RecordFileDataset`, `SyntheticImageDataset`, `ImageRecordDataset`,
`ImageFolderDataset`; a missing MNIST raises) and the vision transforms,
each from numpy's global stream seeded alike before each package runs.
"""
import threading
import time

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import recordio as jrio
from incubator_mxnet_tpu.gluon import data as jdata
from incubator_mxnet_tpu.gluon.data.vision import transforms as jtf
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch.gluon import Trainer, nn
from incubator_mxnet_tpu_torch.gluon import data as tdata
from incubator_mxnet_tpu_torch.gluon.data.vision import transforms as ttf


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return onp.asarray(x)


def _flat(batch):
    return [_np(b) for b in batch] if isinstance(batch, (tuple, list)) \
        else [_np(batch)]


def _same(jbatches, tbatches):
    assert len(jbatches) == len(tbatches) > 0
    for jb, tb in zip(jbatches, tbatches):
        jf, tf = _flat(jb), _flat(tb)
        assert len(jf) == len(tf)
        for a, b in zip(jf, tf):
            # JAX runs without 64-bit types: Python ints batch as int32
            # there, int64 (numpy's) in the port
            assert a.dtype == b.dtype or (a.dtype, b.dtype) == (
                onp.int32, onp.int64)
            assert a.shape == b.shape
            onp.testing.assert_array_equal(b, a)


def _arrays(n=22):
    rs = onp.random.RandomState(0)
    return rs.randn(n, 3).astype("float32"), rs.randint(0, 5, n).astype(
        "int32")


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_batches_match_jax(workers, last_batch):
    X, Y = _arrays()
    out = []
    for data in (jdata, tdata):
        onp.random.seed(3)
        loader = data.DataLoader(data.ArrayDataset(X, Y), batch_size=4,
                                 shuffle=True, last_batch=last_batch,
                                 num_workers=workers)
        out.append([b for _ in range(2) for b in loader])
        assert len(loader) == len(out[-1]) // 2 or last_batch == "rollover"
    _same(*out)


def test_dataloader_samplers_and_batchify_match_jax():
    X, Y = _arrays(10)
    out = []
    for data in (jdata, tdata):
        onp.random.seed(5)
        bs = data.BatchSampler(data.RandomSampler(10), 3, "keep")
        loaders = [data.DataLoader(data.ArrayDataset(X, Y), batch_sampler=bs),
                   data.DataLoader(data.ArrayDataset(X),
                                   sampler=data.SequentialSampler(6, start=2),
                                   batch_size=4),
                   data.DataLoader(data.SimpleDataset(list(range(7))),
                                   batch_size=3)]
        out.append([b for ld in loaders for b in ld])
    _same(*out)


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_prefetch_to_device_is_byte_identical(workers):
    X, Y = _arrays()
    ds = tdata.ArrayDataset(X, Y)
    sync = list(tdata.DataLoader(ds, batch_size=4))
    pref = list(tdata.DataLoader(ds, batch_size=4, num_workers=workers,
                                 prefetch_to_device=2, device="cpu"))
    assert all(isinstance(t, torch.Tensor) for b in pref for t in b)
    _same(sync, pref)


def _join(prefix="mxtpu-prefetch", timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not [t for t in threading.enumerate()
                if t.name.startswith(prefix) and t.is_alive()]:
            return True
        time.sleep(0.02)
    return False


class _Counting(tdata.ArrayDataset):
    def __init__(self, *args):
        super().__init__(*args)
        self.fetches = 0

    def __getitem__(self, idx):
        self.fetches += 1
        return super().__getitem__(idx)


def test_dataloader_streams_its_sampler_and_cleans_up_on_break():
    pulled = []

    class Streaming:
        def __iter__(self):
            for i in range(100):
                pulled.append(i)
                yield [i % 10]

    ds = _Counting(onp.arange(10, dtype="float32"))
    it = iter(tdata.DataLoader(ds, batch_sampler=Streaming(), num_workers=2,
                               prefetch=2))
    next(it)
    next(it)
    it.close()
    assert len(pulled) <= 8 and ds.fetches <= 8
    ds = _Counting(onp.arange(400, dtype="float32"))
    loader = tdata.DataLoader(ds, batch_size=4, num_workers=2,
                              prefetch_to_device=2, device="cpu")
    for i, _ in enumerate(loader):
        if i == 1:
            break
    assert _join(), "prefetch threads leaked after break"
    assert ds.fetches <= 11 * 4
    assert len(list(loader)) == 100


def test_prefetched_trainer_loop_end_to_end():
    """DataLoader(prefetch_to_device) → record → Trainer.step gives the
    synchronous loop's weights bit for bit."""
    rng = onp.random.RandomState(3)
    X = rng.randn(16, 5).astype("float32")
    Y = rng.randn(16, 1).astype("float32")

    def train(prefetch):
        net = nn.Dense(1, 5, device="cpu")
        with torch.no_grad():
            net.weight.copy_(torch.linspace(-1, 1, 5)[None])
            net.bias.zero_()
        trainer = Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05})
        loader = tdata.DataLoader(tdata.ArrayDataset(X, Y), batch_size=4,
                                  prefetch_to_device=2 if prefetch else False,
                                  device="cpu" if prefetch else None)
        for _ in range(2):
            for data, label in loader:
                data, label = torch.as_tensor(data), torch.as_tensor(label)
                with autograd.record():
                    err = net(data) - label
                    loss = (err * err).sum()
                autograd.backward(loss)
                trainer.step(4)
        return [p.detach().clone() for p in net.parameters()]

    for a, b in zip(train(False), train(True)):
        assert torch.equal(a, b)


def test_pin_memory_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: phase 42 checks pinned batches")
    with pytest.raises(MXNetError, match="pin_memory"):
        tdata.DataLoader(tdata.ArrayDataset(onp.ones(4)), batch_size=2,
                         pin_memory=True)


# -------------------------------------------------------------- datasets
def test_dataset_transforms_and_views_match_jax():
    X, Y = _arrays(9)
    out = []
    for data in (jdata, tdata):
        ds = data.ArrayDataset(X, Y)
        t = ds.transform_first(lambda x: x * 2).transform(
            lambda x, y: (x + 1, y))
        views = [t[i] for i in range(len(t))]
        views += list(ds.take(3)) + list(ds.shard(4, 1)) + \
            list(ds.filter(lambda s: s[1] > 1))
        out.append(views)
    _same(*out)


def test_synthetic_image_dataset_matches_jax():
    kw = dict(num_samples=12, num_classes=4, shape=(3, 8, 6), seed=2)
    jds = jdata.vision.SyntheticImageDataset(**kw)
    tds = tdata.vision.SyntheticImageDataset(**kw)
    assert len(jds) == len(tds) == 12
    _same([jds[i] for i in range(12)], [tds[i] for i in range(12)])


def test_record_datasets_match_jax(tmp_path):
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    rng = onp.random.RandomState(1)
    w = jrio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(5):
        img = rng.randint(0, 255, (10, 12, 3), dtype=onp.uint8)
        w.write_idx(i, jrio.pack_img(jrio.IRHeader(0, float(i), i, 0), img))
    w.close()
    jr, tr = jdata.RecordFileDataset(rec), tdata.RecordFileDataset(rec)
    assert [jr[i] for i in range(5)] == [tr[i] for i in range(5)]
    ji = jdata.vision.ImageRecordDataset(rec)
    ti = tdata.vision.ImageRecordDataset(rec)
    _same([(ji[i][0], onp.float32(ji[i][1])) for i in range(5)],
          [(ti[i][0], onp.float32(ti[i][1])) for i in range(5)])
    assert isinstance(ti[0][0], onp.ndarray) and ti[0][0].dtype == onp.uint8
    root = tmp_path / "folders"
    for k, cls in enumerate(("cat", "dog")):
        (root / cls).mkdir(parents=True)
        for j in range(2):
            with open(root / cls / f"{j}.jpg", "wb") as f:
                f.write(jrio.unpack(jr[2 * k + j])[1])
    jf = jdata.vision.ImageFolderDataset(str(root))
    tf = tdata.vision.ImageFolderDataset(str(root))
    assert tf.synsets == jf.synsets == ["cat", "dog"]
    _same([jf[i] for i in range(4)], [tf[i] for i in range(4)])


def test_missing_mnist_raises(tmp_path):
    with pytest.raises(MXNetError, match="MNIST files not found"):
        tdata.vision.MNIST(root=str(tmp_path))
    with pytest.raises(MXNetError, match="CIFAR10"):
        tdata.vision.CIFAR10(root=str(tmp_path))


# ------------------------------------------------------------ transforms
def _img(seed, h=20, w=24, dtype=onp.uint8):
    rs = onp.random.RandomState(seed)
    return rs.randint(0, 256, (h, w, 3)).astype(dtype)


TRANSFORMS = {
    "to_tensor_uint8": (lambda m: m.ToTensor(), _img(0)),
    "to_tensor_float": (lambda m: m.ToTensor(), _img(1, dtype=onp.float32)),
    "normalize": (lambda m: m.Normalize([0.4, 0.5, 0.6], [0.2, 0.3, 0.25]),
                  onp.random.RandomState(2).rand(3, 8, 8).astype("float32")),
    "cast": (lambda m: m.Cast("float32"), _img(3)),
    "resize_down": (lambda m: m.Resize((16, 12)), _img(4)),
    "resize_up": (lambda m: m.Resize(30), _img(5, 12, 10)),
    "center_crop": (lambda m: m.CenterCrop((10, 8)), _img(6)),
    "random_resized_crop": (lambda m: m.RandomResizedCrop(12), _img(7)),
    "flip_lr": (lambda m: m.RandomFlipLeftRight(), _img(8)),
    "flip_tb": (lambda m: m.RandomFlipTopBottom(), _img(9)),
    "brightness": (lambda m: m.RandomBrightness(0.3), _img(10)),
    "contrast": (lambda m: m.RandomContrast(0.3), _img(11)),
    "compose": (lambda m: m.Compose([m.RandomFlipLeftRight(), m.ToTensor(),
                                     m.Normalize(0.5, 0.25)]), _img(12)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    make, x = TRANSFORMS[name]
    outs = []
    for mod, wrap in ((jtf, lambda a: NDArray(jnp.asarray(a))),
                      (ttf, lambda a: a)):
        onp.random.seed(21)
        t = make(mod)
        outs.append([_np(t(wrap(x))) for _ in range(4)])
    for j, t in zip(*outs):
        assert j.shape == t.shape
        onp.testing.assert_allclose(t, j.astype(t.dtype), rtol=1e-6,
                                    atol=1e-6 * max(1.0, float(abs(j).max())))
