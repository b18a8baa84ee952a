"""`metric` and `callback` of the PyTorch/CUDA port against the JAX
package's, on the CPU: every metric's value (local and global, after
``reset_local``) within 1e-6 on the same inputs, as tensors and as
numpy arrays; `Accuracy.update` and `Loss.update` on tensors read
nothing back to the host (``Tensor.item``, ``.cpu``, ``.tolist`` and
``__float__`` patched to raise), also past the device fold; the
Speedometer's and MFUMeter's lines (MFU "not measured" without a known
card).
"""
import logging

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import callback as jcb
from incubator_mxnet_tpu import metric as jmetric
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import callback as tcb
from incubator_mxnet_tpu_torch import metric as tmetric


def _inputs(seed, n=12, k=4):
    rs = onp.random.RandomState(seed)
    logits = rs.rand(n, k).astype("float32")
    probs = logits / logits.sum(1, keepdims=True)
    labels = rs.randint(0, k, n).astype("float32")
    binary = rs.randint(0, 2, n).astype("float32")
    reg = rs.randn(n, 1).astype("float32")
    return dict(probs=probs, labels=labels, binary=binary,
                bprobs=onp.stack([1 - probs[:, 0], probs[:, 0]], 1),
                reg=reg, reg_pred=(reg + 0.1 * rs.randn(n, 1)).astype(
                    "float32"))


def _custom(label, pred):
    return float(onp.abs(label - pred.argmax(-1)).sum()), len(label)


METRICS = {   # name -> (constructor args, (labels key, preds key))
    "acc": ((), ("labels", "probs")),
    "top_k_accuracy": ((), ("labels", "probs")),
    "top_k_3": (("top_k_accuracy",), ("labels", "probs")),
    "f1": ((), ("binary", "bprobs")),
    "mcc": ((), ("binary", "bprobs")),
    "mae": ((), ("reg", "reg_pred")),
    "mse": ((), ("reg", "reg_pred")),
    "rmse": ((), ("reg", "reg_pred")),
    "ce": ((), ("labels", "probs")),
    "nll_loss": ((), ("labels", "probs")),
    "perplexity": ((), ("labels", "probs")),
    "pearsonr": ((), ("reg", "reg_pred")),
    "loss": ((), ("reg", "reg_pred")),
    "composite": ((), ("labels", "probs")),
    "custom": ((), ("labels", "probs")),
}


def _make(pkg, name):
    if name == "top_k_3":
        return pkg.create("top_k_accuracy", top_k=3)
    if name == "perplexity":
        return pkg.create("perplexity", ignore_label=2)
    if name == "composite":
        return pkg.create(["acc", "ce"])
    if name == "custom":
        return pkg.np(_custom)
    return pkg.create(name)


def _wrap(pkg, a, as_tensor):
    if not as_tensor:
        return a
    return NDArray(jnp.asarray(a)) if pkg is jmetric else torch.from_numpy(a)


def _values(pkg, name, as_tensor):
    m = _make(pkg, name)
    keys = METRICS[name][1]
    got = []
    for seed in range(3):
        x = _inputs(seed)
        m.update([_wrap(pkg, x[keys[0]], as_tensor)],
                 [_wrap(pkg, x[keys[1]], as_tensor)])
        got.append(m.get())
        if seed == 1:
            m.reset_local()
    if name != "composite":     # the JAX package's composite has none
        got.append(m.get_global())
    m.reset()
    x = _inputs(9)
    m.update([_wrap(pkg, x[keys[0]], as_tensor)],
             [_wrap(pkg, x[keys[1]], as_tensor)])
    got.append(m.get_name_value())
    return got


def _flat_values(v):
    if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str):
        return [v[1]]
    if isinstance(v, (list, tuple)):
        return [y for x in v for y in _flat_values(x)]
    return [v] if isinstance(v, float) else []


@pytest.mark.parametrize("as_tensor", [True, False])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_match_jax(name, as_tensor):
    j = _values(jmetric, name, as_tensor)
    t = _values(tmetric, name, as_tensor)
    assert repr([type(x) for x in j]) == repr([type(x) for x in t])
    jv, tv = _flat_values(j), _flat_values(t)
    assert len(jv) == len(tv) > 0
    onp.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)


def test_names_and_config_match_jax():
    for name in ("acc", "top_k_accuracy", "f1", "ce", "loss"):
        assert tmetric.create(name).get_name_value()[0][0] == \
            jmetric.create(name).get_name_value()[0][0]
        assert tmetric.create(name).get_config() == \
            jmetric.create(name).get_config()


def _no_host_reads(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("metric update read a value to the host")

    for attr in ("item", "cpu", "tolist", "__float__", "numpy"):
        monkeypatch.setattr(torch.Tensor, attr, boom)


def test_accuracy_and_loss_updates_make_no_host_read(monkeypatch):
    """300 updates on tensors (past two folds of the float32 partial into
    the float64 device total) read nothing; `get()` reads once, and the
    value equals the host computation."""
    rs = onp.random.RandomState(0)
    preds = [torch.from_numpy(rs.randn(8, 5).astype("float32"))
             for _ in range(300)]
    labels = [torch.from_numpy(rs.randint(0, 5, 8)).to(torch.int32)
              for _ in range(300)]
    acc, loss = tmetric.Accuracy(), tmetric.Loss()
    with monkeypatch.context() as mp:
        _no_host_reads(mp)
        for p, y in zip(preds, labels):
            acc.update([y], [p])
            loss.update(None, [p])
        assert acc._dev_total is not None       # folded on the device
    want = float(sum((p.argmax(1).to(torch.int32) == y).sum()
                     for p, y in zip(preds, labels))) / 2400
    assert acc.get() == ("accuracy", pytest.approx(want, rel=1e-12))
    want_loss = sum(float(p.sum()) for p in preds) / (300 * 40)
    assert loss.get()[1] == pytest.approx(want_loss, rel=1e-5)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _speed_lines(cb_mod, meter, metric_mod, monkeypatch, caplog, wrap):
    clock = _Clock()
    monkeypatch.setattr(cb_mod.time, "time", clock)
    acc = metric_mod.Accuracy()
    x = _inputs(0)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for epoch in range(2):
            for nbatch in range(5):
                acc.update([wrap(x["labels"])], [wrap(x["probs"])])
                meter(cb_mod.BatchEndParam(epoch, nbatch, acc, None))
                clock.t += 0.25
        meter(cb_mod.BatchEndParam(2, 2, None, None))
    return [r.getMessage() for r in caplog.records]


def test_speedometer_and_mfu_lines_match_jax(monkeypatch, caplog):
    jl = _speed_lines(jcb, jcb.Speedometer(16, frequent=2), jmetric,
                      monkeypatch, caplog, lambda a: NDArray(jnp.asarray(a)))
    tl = _speed_lines(tcb, tcb.Speedometer(16, frequent=2), tmetric,
                      monkeypatch, caplog, torch.from_numpy)
    assert tl == jl and len(tl) == 4
    assert tl[0].startswith("Epoch[0] Batch [2]\tSpeed: 64.00 samples/sec")
    tm = _speed_lines(tcb, tcb.MFUMeter(16, 1e9, frequent=2), tmetric,
                      monkeypatch, caplog, torch.from_numpy)
    assert tm[0].startswith("Epoch[0] Batch [2]\tSpeed: 64.00 samples/sec"
                            "\tMFU: not measured\taccuracy=")
    tm = _speed_lines(tcb, tcb.MFUMeter(16, 1e9, frequent=2,
                                        peak_flops=1e12), tmetric,
                      monkeypatch, caplog, torch.from_numpy)
    assert "\tMFU: 6.40%\t" in tm[0]


def test_device_peaks_come_from_the_port_table():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: phase 42 reads its peaks")
    assert tcb.device_peak_flops() is None
    assert tcb.device_peak_hbm_bytes_per_s() is None


def test_do_checkpoint_writes_a_params_file(tmp_path):
    from incubator_mxnet_tpu_torch.utils import serialization

    cb = tcb.do_checkpoint(str(tmp_path / "m"), period=2)
    arg = {"w": torch.arange(4.0)}
    cb(0, arg=arg)
    assert not (tmp_path / "m-0001.params").exists()
    cb(1, arg=arg, aux={"s": torch.ones(2)})
    got = serialization.load_ndarrays(str(tmp_path / "m-0002.params"))
    assert torch.equal(got["arg:w"], arg["w"]) and "aux:s" in got
