"""The port's telemetry wired into its main paths, held against the JAX
package's on the CPU:

* the serving engine: a 2-layer model, weights carried by
  `convert.load_jax_params`, serves the same 4 greedy requests through
  the JAX engine and the port's, both with telemetry on: the same
  ``serving_*`` / ``decode_*`` metric names and labels, equal
  ``serving_admitted_total``, the same ``health()`` / ``requestz()`` /
  ``varz_config()`` keys and the same order of request-trace events; the
  port's ops endpoints (``/metrics /healthz /varz /requestz /profilez
  /stallz``) answer over HTTP on an ephemeral port;
* the Trainer: a 2-layer BERT step sets
  ``optimizer_state_bytes_per_device`` to the JAX Trainer's value, with
  the ``trainer/step`` span, its ``trainer/update`` child and the
  ``trainer_step`` program record;
* the disabled path: an engine run and a ``Trainer.step`` leave the
  port's registry empty.

HTTP servers bind port 0 and are closed in ``finally``; both packages'
telemetry is left off and empty, the GC hooks uninstalled.
"""
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
import incubator_mxnet_tpu.telemetry as jtel
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.gluon import Trainer as JTrainer
from incubator_mxnet_tpu.models import bert as jbert
from incubator_mxnet_tpu.models.transformer import TransformerLM as JaxLM
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu.serving import ServingEngine as JaxEngine
from incubator_mxnet_tpu_torch import autograd
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon import Trainer
from incubator_mxnet_tpu_torch.models import TransformerLM
from incubator_mxnet_tpu_torch.models import bert as tbert
from incubator_mxnet_tpu_torch.serving import ServingEngine

from test_torch_train_step import (CFG, SGD, JPretrainWithLoss,
                                   PretrainWithLoss, _batch)

V, C, DFF, L, H, MAXLEN = 61, 16, 32, 2, 2, 64
ENGINE = dict(max_batch=2, block_size=8, prefill_chunk=4,
              poll_interval=0.001)
_RS = np.random.RandomState(7)
PROMPTS = [_RS.randint(0, V, size=n).astype(np.int32) for n in (5, 9, 3, 12)]
N_NEW = 10       # past the 8-step decode trace mark


def _clean(tel):
    tel.disable()
    tel.get_registry().clear()
    tel.tracer.clear()
    tel.requestlog.clear()
    tel.perf.clear()
    tel.profiler.uninstall_gc_hooks()
    for name in list(tel.profiler.profilers()):
        tel.profiler.unregister(name)


@pytest.fixture
def clean():
    for tel in (jtel, ttel):
        _clean(tel)
    yield
    for tel in (jtel, ttel):
        _clean(tel)


@pytest.fixture(scope="module")
def nets():
    mx.random.seed(0)
    jnet = JaxLM(vocab=V, units=C, hidden_size=DFF, num_layers=L,
                 num_heads=H, max_len=MAXLEN, dropout=0.0)
    jnet.initialize()
    jnet(NDArray(jnp.ones((1, 4), jnp.int32)))
    tnet = TransformerLM(vocab=V, units=C, hidden_size=DFF, num_layers=L,
                         num_heads=H, max_len=MAXLEN, dropout=0.0,
                         device="cpu")
    load_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                           jnet._collect_params_with_prefix().items()})
    return jnet, tnet


def _serve(engine_cls, net, **kw):
    """The 4 requests, 2 lanes (so the last two queue behind the first
    two), their tokens, and the engine's payloads read before close."""
    with engine_cls(net, **ENGINE, **kw) as eng:
        reqs = [eng.submit(p, N_NEW) for p in PROMPTS]
        toks = [r.result(timeout=120) for r in reqs]
        assert eng.drain(timeout=60)
        payloads = {"health": eng.health(), "requestz": eng.requestz(),
                    "varz": eng.varz_config(), "name": eng._name}
    traces = [[e["name"] for e in r.trace.snapshot()] for r in reqs]
    return toks, traces, payloads


def _series(tel, engine_name):
    """{(name, labels)} of the serving_* and decode_* metrics, the
    engine's own name in a label replaced by a placeholder, and the
    stall causes (which ones a step saw is timing: an idle poll before
    the first request, say) by one.  A hiccup (a step over 3x the
    rolling p50: a compile, a loaded host) is timing too; the ledger
    that counts it is held to the JAX package's in
    test_torch_telemetry.py."""
    out = set()
    for m in tel.get_registry().metrics():
        if not m.name.startswith(("serving_", "decode_")) \
                or m.name == "serving_step_hiccups_total":
            continue
        labels = tuple(sorted(
            (k, "<engine>" if v == engine_name else
             "<cause>" if k == "cause" else v)
            for k, v in m.labels.items()))
        out.add((m.name, labels))
    return out


def _causes(tel):
    return {m.labels["cause"] for m in tel.get_registry().metrics()
            if m.name == "serving_step_stall_seconds"}


def _keys(d, depth=2):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()
            if k not in ("env",)}


def test_engine_metrics_match_jax(clean, nets):
    jnet, tnet = nets
    jtel.enable()
    ttel.enable()
    jtoks, jtraces, jpay = _serve(JaxEngine, jnet)
    ttoks, ttraces, tpay = _serve(ServingEngine, tnet)
    assert ttoks == jtoks
    assert ttraces == jtraces
    assert "decode" in ttraces[0] and ttraces[0][-1] == "done"
    tser, jser = _series(ttel, tpay["name"]), _series(jtel, jpay["name"])
    assert tser == jser, (sorted(tser - jser), sorted(jser - tser))
    assert {"device_step", "prefill_chunk", "lock_wait", "bookkeeping",
            "gather_params", "host_other"} <= _causes(ttel) \
        <= set(jtel.profiler.CAUSES)
    for tel in (ttel, jtel):
        assert tel.get_registry().get("serving_admitted_total").value \
            == len(PROMPTS)
    for what in ("health", "requestz", "varz"):
        assert _keys(tpay[what]) == _keys(jpay[what]), what
    assert tpay["varz"]["attn_impl"] == "dense"


def test_engine_http_endpoints(clean, nets):
    """The port's ops server, bound to an ephemeral port, serves every
    endpoint; the merged trace validates; stall causes sum to the
    step walls; the step programs have device-second records."""
    ttel.enable()
    eng = ServingEngine(nets[1], http_port=0, slo_ttft=30.0, **ENGINE)
    try:
        for r in [eng.submit(p, N_NEW) for p in PROMPTS]:
            r.result(timeout=120)
        assert eng.drain(timeout=60)
        base = f"http://127.0.0.1:{eng.http_port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=30) as resp:
                return resp.status, resp.headers["Content-Type"], \
                    resp.read().decode()

        code, ctype, text = get("/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert f"serving_admitted_total {float(len(PROMPTS))!r}" in text
        code, _, body = get("/healthz")
        assert code == 200 and json.loads(body)["status"] == "healthy"
        varz = json.loads(get("/varz")[2])
        assert varz["config"][eng._name]["max_batch"] == 2
        assert varz["perf"]["device"] == "cpu"
        assert "program_device_seconds{program=serving_step_float}" \
            in varz["metrics"]
        reqz = json.loads(get("/requestz")[2])
        assert reqz["ring"]["pushed"] == len(PROMPTS)
        stallz = json.loads(get("/stallz")[2])["engines"][eng._name]
        assert stallz["steps"] > 0 and stallz["invariant_violations"] == 0
        prof = json.loads(get("/profilez?seconds=0")[2])
        assert ttel.profiler.validate_chrome_trace(prof) == []
        names = {e["name"] for e in prof["traceEvents"]}
        assert {"serving/step", "serving/prefill_chunk", "device_step",
                "serving_step_float"} <= names
        with pytest.raises(urllib.error.HTTPError) as err:
            get("/nope")
        assert err.value.code == 404
    finally:
        eng.close()
    assert eng.http.closed and eng.http_port is not None


def test_disabled_engine_and_trainer_leave_registry_empty(clean, nets):
    with ServingEngine(nets[1], **ENGINE) as eng:
        for r in [eng.submit(p, 4) for p in PROMPTS[:2]]:
            r.result(timeout=120)
    model, tr = _bert_trainer()
    _step(model, tr, _batch(1))
    assert ttel.get_registry().metrics() == []
    assert ttel.spans() == [] and ttel.perf.programs() == {}


def _bert_trainer():
    tnet = tbert.BERTForPretraining(**CFG, dropout=0.0, device="cpu")
    tnet.initialize()
    model = PretrainWithLoss(tnet)
    model.hybridize()
    return model, Trainer(model.collect_params(), "sgd", dict(SGD),
                          keep_grads=False)


def _step(model, tr, batch):
    toks, labels = batch
    with autograd.record():
        loss = model(torch.from_numpy(toks), torch.from_numpy(labels))
    loss.backward()
    tr.step(1)


def test_trainer_state_bytes_match_jax(clean):
    mx.random.seed(0)
    jnet = jbert.BERTForPretraining(**CFG, dropout=0.0, use_flash=False)
    jnet.initialize()
    jnet(NDArray(jnp.ones((2, 8), jnp.int32)))
    jmodel = JPretrainWithLoss(jnet)
    jmodel.hybridize()
    jtr = JTrainer(jmodel.collect_params(), "sgd", dict(SGD),
                   keep_grads=False)
    model, tr = _bert_trainer()
    jtel.enable()
    ttel.enable()
    batches = [_batch(s) for s in (1, 2, 3)]
    for toks, labels in batches:
        with jag.record():
            jloss = jmodel(NDArray(jnp.asarray(toks)),
                           NDArray(jnp.asarray(labels)))
        jloss.backward()
        jtr.step(1)
        _step(model, tr, (toks, labels))
    name = "optimizer_state_bytes_per_device"
    assert ttel.get_registry().get(name).value == \
        jtel.get_registry().get(name).value == \
        tr.optimizer_state_bytes_per_device() > 0
    reg = ttel.get_registry()
    assert reg.get("trainer_steps_total").value == 3
    assert reg.get("trainer_step_seconds").count == 3
    spans = [(s.name, s.parent, s.step) for s in ttel.spans()]
    assert spans == [(n, p, k) for k in (1, 2, 3)
                     for n, p in (("trainer/update", "trainer/step"),
                                  ("trainer/step", None))]
    # steps 2 and 3: their recorded forward, backward and update
    rec = ttel.perf.programs()["trainer_step"]
    parts = sum(ttel.perf.programs()[p].flops
                for p in ("fwd_record", "bwd_record", "update"))
    assert rec.flops == parts > 0
    assert reg.get("program_device_seconds",
                   {"program": "trainer_step"}).count == 2
