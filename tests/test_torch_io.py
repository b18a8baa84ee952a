"""The PyTorch/CUDA port's RecordIO, native image pipeline, data
iterators and host→card prefetchers (`incubator_mxnet_tpu_torch.recordio`,
`.native`, `.io`) against the JAX package's, on the CPU.

* RecordIO: the files either package writes (sequential and indexed,
  native and Python codec, payloads holding the magic word) are
  byte-identical, and each package reads the other's;
  `pack`/`unpack` of multi-label headers and `pack_img`/`unpack_img`.
* `ImageRecordIter`: over two epochs, data, labels and `pad`
  bit-identical to the JAX package's, native (libjpeg on both sides)
  and through the Python reader (numpy's global stream seeded alike
  before each package runs), across shuffle, crops, mirror, resize,
  round_batch and device_normalize.
* `normalize` / `wrap_net` against the JAX package's to 1e-6.
* A native build that fails raises `MXNetError`; no reader is swapped in.
  A JPEG that does not decode is counted (`decode_failures`).
* The prefetchers on ``device="cpu"``: order, errors crossing threads,
  reset mid-epoch, shutdown without stray threads, and the telemetry
  metrics (the cases of tests/test_io_prefetcher.py); an iterator's own
  copies behind `PrefetchingIter` are handed to the consumer's stream on
  the consumer's thread.
"""
import threading
import time

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import recordio as jrio
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import MXNetError, native, telemetry
from incubator_mxnet_tpu_torch import io as tio
from incubator_mxnet_tpu_torch import recordio as trio
from incubator_mxnet_tpu_torch.io.prefetcher import DevicePrefetcher, to_device

MAGIC = b"\x0a\x23\xd7\xce"
PAYLOADS = [b"hello world", b"", b"x" * 1000, MAGIC, b"abc" + MAGIC + b"def",
            MAGIC + MAGIC + b"tail", bytes(range(256)) * 5]


def _write(rio, path, payloads, use_native):
    w = rio.MXRecordIO(path, "w", use_native=use_native)
    for p in payloads:
        w.write(p)
    w.close()


def _read_all(rio, path, use_native):
    r = rio.MXRecordIO(path, "r", use_native=use_native)
    out = []
    while (rec := r.read()) is not None:
        out.append(rec)
    r.close()
    return out


@pytest.mark.parametrize("t_native", [True, False])
@pytest.mark.parametrize("j_native", [True, False])
def test_rec_files_are_byte_identical_and_cross_read(tmp_path, j_native,
                                                     t_native):
    jp, tp = str(tmp_path / "j.rec"), str(tmp_path / "t.rec")
    _write(jrio, jp, PAYLOADS, j_native)
    _write(trio, tp, PAYLOADS, t_native)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    assert _read_all(trio, jp, t_native) == PAYLOADS
    assert _read_all(jrio, tp, j_native) == PAYLOADS


def test_indexed_files_are_byte_identical_and_cross_read(tmp_path):
    files = {}
    for tag, rio in (("j", jrio), ("t", trio)):
        rec, idx = str(tmp_path / f"{tag}.rec"), str(tmp_path / f"{tag}.idx")
        w = rio.MXIndexedRecordIO(idx, rec, "w")
        for i in range(12):
            w.write_idx(i, f"record-{i}".encode() + MAGIC * (i % 3))
        w.close()
        files[tag] = (idx, rec)
    for k in (0, 1):
        with open(files["j"][k], "rb") as a, open(files["t"][k], "rb") as b:
            assert a.read() == b.read()
    for rio, (idx, rec) in ((trio, files["j"]), (jrio, files["t"])):
        r = rio.MXIndexedRecordIO(idx, rec, "r")
        assert r.keys == list(range(12))
        for i in (7, 0, 11, 3):
            assert r.read_idx(i) == f"record-{i}".encode() + MAGIC * (i % 3)
        r.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0], [7.0, 0.0]])
def test_pack_unpack_headers_match(label):
    hdr = (0, label, 17, 5)
    packed = trio.pack(trio.IRHeader(*hdr), b"payload")
    assert packed == jrio.pack(jrio.IRHeader(*hdr), b"payload")
    th, tp = trio.unpack(packed)
    jh, jp = jrio.unpack(packed)
    assert tp == jp == b"payload"
    assert th.flag == jh.flag and th.id == jh.id and th.id2 == jh.id2
    onp.testing.assert_array_equal(onp.asarray(th.label),
                                   onp.asarray(jh.label))


def test_pack_img_unpack_img_match():
    img = onp.random.RandomState(0).randint(0, 255, (20, 24, 3), onp.uint8)
    hdr = (0, 2.0, 9, 0)
    packed = trio.pack_img(trio.IRHeader(*hdr), img, quality=90)
    assert packed == jrio.pack_img(jrio.IRHeader(*hdr), img, quality=90)
    th, timg = trio.unpack_img(packed)
    jh, jimg = jrio.unpack_img(packed)
    assert isinstance(timg, onp.ndarray) and timg.dtype == onp.uint8
    assert timg.shape == (20, 24, 3) and th.label == jh.label == 2.0
    onp.testing.assert_array_equal(timg, jimg.asnumpy())


# ---------------------------------------------------------- image records
def _image_rec(path, n=20, h=40, w=48, seed=0, idx=None):
    """``n`` JPEG records of random pixels (labels i % 5), written by the
    JAX package; with ``idx`` an indexed file."""
    rng = onp.random.RandomState(seed)
    w_ = jrio.MXIndexedRecordIO(idx, path, "w") if idx else \
        jrio.MXRecordIO(path, "w")
    for i in range(n):
        img = rng.randint(0, 255, (h, w, 3), dtype=onp.uint8)
        rec = jrio.pack_img(jrio.IRHeader(0, float(i % 5), i, 0), img,
                            quality=90)
        if idx:
            w_.write_idx(i, rec)
        else:
            w_.write(rec)
    w_.close()
    return path


@pytest.fixture(scope="module")
def image_rec(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgrec")
    rec = _image_rec(str(d / "img.rec"))
    idx_rec = _image_rec(str(d / "idx.rec"), idx=str(d / "idx.idx"))
    return rec, idx_rec, str(d / "idx.idx")


def _epochs(it, to_np, n=2):
    """Each batch of ``n`` epochs as (data, label, pad) numpy arrays."""
    out = []
    for _ in range(n):
        for b in it:
            out.append((to_np(b.data[0]), to_np(b.label[0]), b.pad))
        it.reset()
    return out


def _same_batches(jb, tb):
    assert len(jb) == len(tb) > 0
    for (jd, jl, jp), (td, tl, tp) in zip(jb, tb):
        assert jp == tp
        assert jd.dtype == td.dtype and jd.shape == td.shape
        onp.testing.assert_array_equal(td, jd)
        onp.testing.assert_array_equal(tl, jl)


NORM = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94, std_r=58.4,
            std_g=57.1, std_b=57.4)
ITER_CASES = {
    "center_normalized_host": dict(round_batch=True, **NORM),
    "shuffle_crop_mirror_resize_uint8": dict(
        shuffle=True, rand_crop=True, rand_mirror=True, resize=36,
        round_batch=False, device_normalize=True, **NORM),
    "shuffle_mirror_round_uint8": dict(
        shuffle=True, rand_mirror=True, round_batch=True,
        device_normalize=True, seed=5),
    "crop_resize_scaled_drop_tail": dict(
        rand_crop=True, resize=44, round_batch=False, scale=1 / 255,
        **NORM),
}


def _both(path, kw, np_seed=11, **tkw):
    """Two epochs of each package's iterator over ``path``, numpy's global
    stream seeded alike before each."""
    onp.random.seed(np_seed)
    jit = mx.io.ImageRecordIter(path, (3, 32, 32), 6, preprocess_threads=2,
                                **kw)
    jb = _epochs(jit, lambda a: a.asnumpy())
    onp.random.seed(np_seed)
    tit = tio.ImageRecordIter(path, (3, 32, 32), 6, preprocess_threads=2,
                              device="cpu", **kw, **tkw)
    tb = _epochs(tit, lambda t: t.numpy())
    return jit, tit, jb, tb


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_native_image_record_iter_matches_jax(image_rec, case):
    jit, tit, jb, tb = _both(image_rec[0], ITER_CASES[case])
    assert jit._native is not None and tit._native is not None
    assert tit.decoder == "libjpeg"
    _same_batches(jb, tb)
    if ITER_CASES[case].get("device_normalize"):
        assert tb[0][0].dtype == onp.uint8


@pytest.mark.parametrize("case", ["center_normalized_host",
                                  "shuffle_crop_mirror_resize_uint8"])
def test_python_reader_matches_jax(image_rec, case):
    kw = dict(ITER_CASES[case], use_native=False)
    jit, tit, jb, tb = _both(image_rec[0], kw)
    assert tit._native is None and tit.decoder == "PIL"
    _same_batches(jb, tb)


def test_indexed_python_reader_matches_jax(image_rec):
    """``path_imgidx`` takes the Python reader in both packages (with a
    warning when the native pipeline was asked for)."""
    kw = dict(ITER_CASES["shuffle_crop_mirror_resize_uint8"],
              path_imgidx=image_rec[2])
    with pytest.warns(UserWarning, match="path_imgidx"):
        jit, tit, jb, tb = _both(image_rec[1], kw)
    assert tit._native is None
    _same_batches(jb, tb)


def test_normalize_and_wrap_net_match_jax(image_rec):
    from incubator_mxnet_tpu.gluon import nn as jnn
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.gluon import nn as tnn

    kw = dict(device_normalize=True, scale=0.5, **NORM)
    jit = mx.io.ImageRecordIter(image_rec[0], (3, 8, 8), 4, **kw)
    tit = tio.ImageRecordIter(image_rec[0], (3, 8, 8), 4, device="cpu", **kw)
    x = onp.random.RandomState(1).randint(0, 256, (4, 3, 8, 8), onp.uint8)
    jx, tx = NDArray(jnp.asarray(x)), torch.from_numpy(x)
    onp.testing.assert_allclose(tit.normalize(tx).numpy(),
                                jit.normalize(jx).asnumpy(), rtol=1e-6,
                                atol=1e-6)
    w = onp.random.RandomState(2).randn(5, 192).astype(onp.float32) * 0.1
    jnet = jnn.Dense(5)
    jnet.initialize()
    jnet(NDArray(jnp.zeros((1, 192))))
    jnet.weight.set_data(jnp.asarray(w))
    tnet = tnn.Dense(5, 192, device="cpu")
    with torch.no_grad():
        tnet.weight.copy_(torch.from_numpy(w))
        tnet.bias.zero_()
    jw, tw = jit.wrap_net(jnet), tit.wrap_net(tnet)
    tw.hybridize()
    with autograd.record():
        out = tw(tx)
    onp.testing.assert_allclose(out.detach().numpy(), jw(jx).asnumpy(),
                                rtol=1e-6, atol=1e-6)
    autograd.backward(out.sum())
    assert tnet.weight.grad is not None and tnet.weight.grad.abs().sum() > 0
    assert not list(tw._parameters)     # no parameters of its own


def test_failed_native_build_raises(image_rec, monkeypatch):
    """A compiler that fails: `MXNetError` carrying its output, never the
    Python reader (nor a library built by another command)."""
    monkeypatch.setenv("CXX", "false")
    native.image_pipeline_lib.cache_clear()
    native.recordio_lib.cache_clear()
    try:
        with pytest.raises(MXNetError, match="building native/image_pipeline"):
            tio.ImageRecordIter(image_rec[0], (3, 32, 32), 4, device="cpu")
        with pytest.raises(MXNetError, match="building native/recordio"):
            trio.MXRecordIO(image_rec[0], "r")
    finally:
        native.image_pipeline_lib.cache_clear()
        native.recordio_lib.cache_clear()


def test_decode_failures_are_counted(tmp_path):
    """A record whose JPEG does not decode: libjpeg zero-fills the sample
    in both packages (the batches stay bit-identical) and the port counts
    it (`ImageRecordIter.decode_failures`, once an epoch)."""
    path = str(tmp_path / "bad.rec")
    rng = onp.random.RandomState(0)
    w_ = jrio.MXRecordIO(path, "w")
    for i in range(6):
        w_.write(jrio.pack_img(jrio.IRHeader(0, float(i), i, 0),
                               rng.randint(0, 255, (32, 32, 3), onp.uint8)))
    w_.write(jrio.pack(jrio.IRHeader(0, 4.0, 6, 0), b"not a jpeg" * 8))
    w_.close()
    jit, tit, jb, tb = _both(path, dict(device_normalize=True))
    _same_batches(jb, tb)
    assert tit.decode_failures == 2
    assert not tb[1][0][0].any() and tb[0][0][0].any()


class _FakeEvent:
    """Stands in for a copy's CUDA event."""


def _fake_card_stager(device="cpu"):
    """A stager whose leaves come back pending, as on CUDA, each with an
    event of its own; `events` lists them."""
    from incubator_mxnet_tpu_torch.io import prefetcher as pf

    class Stager:
        def __init__(self):
            self.device = torch.device(device)
            self.events = []

        def put(self, host):
            ev = _FakeEvent()
            self.events.append(ev)
            return pf._Pending(host.clone(), ev)

    return Stager()


@pytest.mark.parametrize("consumer", ["PrefetchingIter", "DevicePrefetcher"])
def test_prefetchers_ready_staged_batches_on_the_consumer(
        image_rec, monkeypatch, consumer):
    """`ImageRecordIter`'s own copies behind `PrefetchingIter` or
    `DevicePrefetcher` are handed over on the consumer's thread and
    stream (its current stream waits on each copy's event and records
    each tensor), never on a worker's: the leaves stay pending through
    the workers (a stand-in stager makes them pending on the CPU, and
    ``torch.cuda.current_stream`` is the calling thread's stand-in
    stream)."""
    waited, recorded = [], []

    class Stream:
        def __init__(self):
            self.thread = threading.get_ident()

        def wait_event(self, ev):
            waited.append((threading.get_ident(), self.thread, ev))

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda t, s: recorded.append(
                            (threading.get_ident(), s.thread)), raising=False)
    kw = dict(shuffle=True, rand_mirror=True, device_normalize=True, **NORM)
    plain = tio.ImageRecordIter(image_rec[0], (3, 32, 32), 6, device="cpu",
                                **kw)
    want = [(b.data[0].clone(), b.label[0].clone()) for b in plain]
    assert not waited      # CPU tensors: nothing pending
    it = tio.ImageRecordIter(image_rec[0], (3, 32, 32), 6, device="cpu",
                             **kw)
    it._stager = _fake_card_stager()
    if consumer == "PrefetchingIter":
        pit = tio.PrefetchingIter(it, prefetch_to_device=True, device="cpu")
        got = [(b.data[0], b.label[0]) for b in pit]
        pit.close()
    else:
        got = [(b.data[0], b.label[0])
               for b in DevicePrefetcher(it, device="cpu")]
    me = threading.get_ident()
    assert len(got) == len(want) and all(
        torch.equal(a, c) and torch.equal(b, d)
        for (a, b), (c, d) in zip(got, want))
    assert [ev for _, _, ev in waited] == it._stager.events
    assert {(t, s) for t, s, _ in waited} == {(me, me)}
    assert set(recorded) == {(me, me)} and len(recorded) == len(waited)
    # read directly, the iterator hands its batch over in its own `next`
    waited.clear()
    it.reset()
    it.next()
    assert len(waited) == 2 and {t for t, _, _ in waited} == {me}


def test_library_names_hash_the_command():
    from incubator_mxnet_tpu_torch.native import build

    a = build.library_path("image_pipeline",
                           build._command("image_pipeline"))
    b = build.library_path("image_pipeline_nvjpeg", build._command(
        "image_pipeline", ("MXT_NVJPEG",), cuda=True))
    assert a != b and "/incubator_mxnet_tpu_torch/_build/native/" in a
    assert a.rsplit("/", 1)[1].startswith("libmxt_image_pipeline-")


# -------------------------------------------------------------- iterators
def test_ndarray_iter_matches_jax():
    rs = onp.random.RandomState(0)
    X, Y = rs.randn(10, 3).astype("float32"), onp.arange(10, dtype="float32")
    for handle in ("pad", "discard", "roll_over"):
        onp.random.seed(4)
        jb = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
              for b in mx.io.NDArrayIter(X, Y, 4, shuffle=True,
                                         last_batch_handle=handle)]
        onp.random.seed(4)
        tb = [(b.data[0].numpy(), b.label[0].numpy(), b.pad)
              for b in tio.NDArrayIter(X, Y, 4, shuffle=True,
                                       last_batch_handle=handle,
                                       device="cpu")]
        _same_batches(jb, tb)


# ------------------------------------------------------------ prefetchers
def _join_threads(prefix="mxtpu-prefetch", timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not [t for t in threading.enumerate()
                if t.name.startswith(prefix) and t.is_alive()]:
            return []
        time.sleep(0.02)
    return [t.name for t in threading.enumerate()
            if t.name.startswith(prefix) and t.is_alive()]


def test_prefetch_overlap_pipelines_fetch_and_compute():
    fetch_s, compute_s, n = 0.005, 0.005, 30

    def slow_batches():
        for i in range(n):
            time.sleep(fetch_s)
            yield onp.full((4, 4), i, dtype=onp.float32)

    t0 = time.perf_counter()
    seen = []
    for b in DevicePrefetcher(slow_batches(), depth=2, device="cpu"):
        time.sleep(compute_s)
        seen.append(int(b[0, 0]))
    pipe_t = time.perf_counter() - t0
    assert seen == list(range(n))
    assert pipe_t <= n * max(fetch_s, compute_s) * 1.25 + 0.06


def test_prefetching_iter_matches_jax():
    X = onp.random.RandomState(1).randn(16, 5).astype("float32")
    Y = onp.arange(16, dtype="float32")
    jp = mx.io.PrefetchingIter(mx.io.NDArrayIter(X, Y, batch_size=4),
                               prefetch_to_device=True)
    jb = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in jp]
    jp.close()
    tp = tio.PrefetchingIter(tio.NDArrayIter(X, Y, batch_size=4,
                                             device="cpu"),
                             prefetch_to_device=True, device="cpu")
    tb = [(b.data[0].numpy(), b.label[0].numpy(), b.pad) for b in tp]
    tp.close()
    _same_batches(jb, tb)


def test_prefetching_iter_reset_mid_epoch_no_pollution():
    X = onp.arange(64, dtype="float32").reshape(64, 1)
    Y = onp.arange(64, dtype="float32")
    expect = [b.label[0].tolist() for b in
              tio.NDArrayIter(X, Y, batch_size=4, device="cpu")]
    pit = tio.PrefetchingIter(tio.NDArrayIter(X, Y, batch_size=4,
                                              device="cpu"),
                              prefetch_depth=2)
    for _ in range(5):
        pit.next()
        pit.next()
        t0 = time.perf_counter()
        pit.reset()
        assert time.perf_counter() - t0 < 2.0, "reset hung joining worker"
    assert [b.label[0].tolist() for b in pit] == expect
    with pytest.raises(StopIteration):
        pit.next()
    pit.reset()
    assert len(list(pit)) == 16
    pit.close()
    assert not _join_threads(prefix="mxtpu-prefetching-iter")


def test_prefetching_iter_error_reaches_the_consumer():
    class Bad(tio.DataIter):
        def __init__(self):
            super().__init__(2)
            self.n = 0

        def next(self):
            self.n += 1
            if self.n > 2:
                raise ValueError("boom in source")
            return tio.DataBatch([onp.ones((2, 2), "float32")], [])

    pit = tio.PrefetchingIter(Bad(), prefetch_to_device=True, device="cpu")
    assert pit.next().data[0].shape == (2, 2)
    pit.next()
    with pytest.raises(ValueError, match="boom in source"):
        pit.next()
    pit.close()
    assert not _join_threads(prefix="mxtpu-prefetching-iter")


def test_device_prefetcher_multi_epoch_reiterates_source():
    epochs = []

    class Source:
        def __iter__(self):
            epochs.append(len(epochs))
            return iter([onp.ones(2, onp.float32)] * 3)

    pf = DevicePrefetcher(Source(), depth=1, device="cpu")
    assert len(list(pf)) == 3 and len(list(pf)) == 3
    assert epochs == [0, 1]


def test_device_prefetcher_close_mid_epoch_and_errors():
    def gen():
        for i in range(1000):
            yield onp.full(3, i, onp.float32)

    it = iter(DevicePrefetcher(gen(), depth=2, device="cpu"))
    next(it)
    it.close()
    assert not _join_threads()

    def bad():
        yield onp.ones(2, onp.float32)
        raise ValueError("boom in fetch")

    it = iter(DevicePrefetcher(bad(), device="cpu"))
    next(it)
    with pytest.raises(ValueError, match="boom in fetch"):
        next(it)
    assert not _join_threads()


def test_to_device_keeps_structure_and_copies():
    src = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    b = tio.DataBatch([src], [torch.ones(2)], pad=1, index=[0, 1])
    out = to_device({"a": (b, "tag"), "n": 3}, device="cpu")
    got = out["a"][0]
    assert isinstance(got, tio.DataBatch) and got.pad == 1
    assert got.index == [0, 1] and out["a"][1] == "tag" and out["n"] == 3
    assert torch.equal(got.data[0], torch.from_numpy(src))
    src[0, 0] = 99.0    # the batch is a copy of the host arrays
    assert got.data[0][0, 0] == 0.0


def test_pipeline_metrics_recorded():
    """``data_wait_seconds``, ``prefetch_queue_depth`` and
    ``h2d_bytes_total`` from the prefetcher and `PrefetchingIter`, as the
    JAX package records them."""
    telemetry.reset()
    telemetry.enable()
    try:
        wait = telemetry.histogram("data_wait_seconds")
        h2d = telemetry.counter("h2d_bytes_total")
        for _ in DevicePrefetcher(iter([onp.ones((2, 4), "float32")] * 4),
                                  device="cpu"):
            pass
        assert wait.count == 5          # 4 batches and the end
        assert h2d.value == 4 * 2 * 4 * 4
        pit = tio.PrefetchingIter(tio.NDArrayIter(
            onp.ones((8, 2), "float32"), batch_size=4, device="cpu"),
            prefetch_to_device=True, device="cpu")
        list(pit)
        pit.close()
        assert wait.count == 8 and h2d.value == 128 + 2 * 32
        assert telemetry.get_registry().get("prefetch_queue_depth") \
            is not None
    finally:
        telemetry.disable()
        telemetry.reset()


def test_mesh_staging_is_not_ported():
    with pytest.raises(MXNetError, match="not ported"):
        to_device(onp.ones(2), mesh=object(), device="cpu")
    with pytest.raises(MXNetError, match="not ported"):
        tio.batch_sharding(None, 2)
    with pytest.raises(MXNetError, match="not ported"):
        DevicePrefetcher([], mesh=object(), device="cpu")
