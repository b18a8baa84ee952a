"""Rules of the PyTorch/CUDA port (`incubator_mxnet_tpu_torch/`).

* The port imports neither JAX nor anything of the JAX package: it
  imports with ``jax`` blocked, and an AST scan of its sources and of
  chip_smoke.py and chip_serving_ab.py finds no such import.
* Entry points run on ``cuda`` unless the caller asks for the CPU;
  without a GPU they raise `MXNetError` instead of carrying on there.
* Importing the package, and running its CPU path, builds nothing:
  neither ``nvcc`` nor a ``ctypes`` load is touched.
* Every kernel wrapper raises on a failed build or launch and counts
  nothing then; chip_smoke.py's kernel table names, for each kernel,
  the JAX package line that launches its ``pl.pallas_call``.
"""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import MXNetError, context
from incubator_mxnet_tpu_torch.models import TransformerLM

torch.set_num_threads(1)  # six xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "incubator_mxnet_tpu_torch")
SMALL = dict(vocab=11, units=16, hidden_size=32, num_layers=1, num_heads=2,
             max_len=32, dropout=0.0)


def _run(code):
    # one intra-op thread, as in this process: the workers share the cores
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "chip_serving_ab.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_package_imports_with_jax_blocked():
    res = _run("import sys\n"
               "sys.modules['jax'] = None\n"
               "sys.modules['incubator_mxnet_tpu'] = None\n"
               "import incubator_mxnet_tpu_torch as m\n"
               "import incubator_mxnet_tpu_torch.convert\n"
               "print(sorted(n for n, m in sys.modules.items()\n"
               "             if m is not None\n"
               "             and n.split('.')[0] in ('jax', 'jaxlib')))\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


@pytest.fixture(scope="module")
def blocked_imports():
    """One interpreter with ``jax`` and the JAX package blocked imports
    each module the per-slice import rules below name, in turn: (module
    -> the error its import raised or None, the jax/jaxlib/JAX-package
    modules loaded after all of them, what the long-context CPU path
    `_LONGCTX_RUN` printed or raised).  A module that imports JAX fails
    to import; one that loads jaxlib shows in the list.  Then the
    recurrent and generative CPU path `_RECURRENT_RUN` runs there too
    (a fourth item)."""
    mods = sorted(set(SLICE4_MODULES + GRAPH_MODULES + NMT_MODULES
                      + VISION_MODULES + PTQ_MODULES + STATE_MODULES
                      + LONGCTX_MODULES + TELEMETRY_MODULES + DATA_MODULES
                      + CHAIN_MODULES + RECURRENT_MODULES))
    res = _run(
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['incubator_mxnet_tpu'] = None\n"
        "errs = {}\n"
        f"for mod in {mods!r}:\n"
        "    try:\n"
        "        importlib.import_module('incubator_mxnet_tpu_torch.' + mod)\n"
        "        errs[mod] = None\n"
        "    except Exception as e:\n"
        "        errs[mod] = repr(e)\n"
        "loaded = sorted(\n"
        "    n for n, m in sys.modules.items() if m is not None\n"
        "    and n.split('.')[0] in ('jax', 'jaxlib',\n"
        "                            'incubator_mxnet_tpu'))\n"
        "def longctx():\n"
        + "".join("    " + ln + "\n" for ln in _LONGCTX_RUN.splitlines())
        + "try:\n"
        "    run = longctx()\n"
        "except BaseException as e:\n"
        "    run = repr(e)\n"
        "def recurrent():\n"
        + "".join("    " + ln + "\n" for ln in _RECURRENT_RUN.splitlines())
        + "try:\n"
        "    rec = recurrent()\n"
        "except BaseException as e:\n"
        "    rec = repr(e)\n"
        "print(json.dumps([errs, loaded, run, rec]))\n")
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def _assert_imports_with_jax_blocked(blocked_imports, mod):
    errs, loaded = blocked_imports[:2]
    assert errs[mod] is None, errs[mod]
    assert loaded == []


def test_no_jax_import_in_sources():
    bad = []
    for path in _port_sources():
        for mod in _imported_modules(path):
            top = (mod or "").split(".")[0]
            if top in ("jax", "jaxlib", "incubator_mxnet_tpu"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert bad == []


def test_no_numpy_subpackage():
    assert not os.path.exists(os.path.join(PKG, "numpy"))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert context.default_device() == torch.device("cuda")
    with pytest.raises(MXNetError):
        TransformerLM(**SMALL)
    with pytest.raises(MXNetError):
        TransformerLM(**SMALL, device="cuda")
    with pytest.raises(MXNetError):
        mxt.random.seed(0)
    net = TransformerLM(**SMALL, device="cpu")
    assert net.embed.weight.device.type == "cpu"
    assert isinstance(mxt.random.seed(0, device="cpu"), torch.Generator)
    assert mxt.cpu() == torch.device("cpu")
    assert mxt.gpu(1) == torch.device("cuda", 1)


def test_same_seed_same_weights_on_every_build():
    a = TransformerLM(**SMALL, device="cpu", seed=7)
    b = TransformerLM(**SMALL, device="cpu", seed=7)
    c = TransformerLM(**SMALL, device="cpu", seed=8)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.head.weight, c.head.weight)


def test_cpu_path_never_builds_or_loads_kernels():
    res = _run(
        "import ctypes, subprocess, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('kernel build or load attempted')\n"
        "subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "import incubator_mxnet_tpu_torch as m\n"
        "from incubator_mxnet_tpu_torch import _build\n"
        "from incubator_mxnet_tpu_torch.models import TransformerLM\n"
        "net = TransformerLM(vocab=11, units=16, hidden_size=32,\n"
        "                    num_layers=1, num_heads=2, max_len=32,\n"
        "                    device='cpu')\n"
        "out = net.generate([[1, 2, 3]], 4)\n"
        "with net.serve(max_batch=1, block_size=8) as eng:\n"
        "    toks = eng.submit([1, 2, 3], 4).result(timeout=60)\n"
        "assert toks == out[0, 3:].tolist(), (toks, out)\n"
        "assert not _build._libs\n"
        "assert m.ops.flash_attention.launches == 0\n"
        "assert m.ops.paged_attention.launches == 0\n"
        "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ---- the training slice: BERT, the Trainer and three more kernels ----
TINY_BERT = dict(vocab_size=600, units=16, hidden_size=32, num_layers=1,
                 num_heads=2)


def test_training_entry_points_default_to_cuda(monkeypatch):
    from incubator_mxnet_tpu_torch.models import BERTForPretraining
    from incubator_mxnet_tpu_torch.ops import (dropout_bwd, dropout_fwd,
                                               dropout_mask, xent_forward)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError):
        BERTForPretraining(**TINY_BERT)
    net = BERTForPretraining(**TINY_BERT, device="cpu")
    assert net.nsp.weight.device.type == "cpu"
    # the kernels' wrappers run on the tensor's device: cuda or cpu only
    meta = torch.empty((4, 600), device="meta")
    with pytest.raises(MXNetError):
        dropout_mask(meta, 1, 0.1)
    with pytest.raises(MXNetError):
        dropout_fwd(meta, None, 1, 0.1)
    with pytest.raises(MXNetError):
        dropout_bwd(meta, meta.to(torch.uint8), 0.1)
    with pytest.raises(MXNetError):
        xent_forward(meta)


def test_training_cpu_path_never_builds_or_loads_kernels():
    res = _run(
        "import ctypes, subprocess, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('kernel build or load attempted')\n"
        "subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "import incubator_mxnet_tpu_torch as m\n"
        "from incubator_mxnet_tpu_torch import _build, autograd\n"
        "from incubator_mxnet_tpu_torch.gluon import Trainer\n"
        "from incubator_mxnet_tpu_torch.gluon.loss import "
        "SoftmaxCrossEntropyLoss\n"
        "from incubator_mxnet_tpu_torch.models import BERTForPretraining\n"
        "from incubator_mxnet_tpu_torch.ops import (dropout_mask,\n"
        "    dropout_fwd, dropout_bwd, xent_forward, xent_backward)\n"
        f"net = BERTForPretraining(**{TINY_BERT!r}, device='cpu')\n"
        "net.initialize()\n"
        "tr = Trainer(net.collect_params(), 'sgd', {'momentum': 0.9})\n"
        "toks = torch.randint(0, 600, (2, 8))\n"
        "with autograd.record():\n"
        "    mlm, nsp = net(toks)\n"
        "    loss = SoftmaxCrossEntropyLoss()(mlm, toks).mean()\n"
        "loss.backward()\n"
        "tr.step(2)\n"
        "assert not _build._libs\n"
        "assert dropout_mask.launches == 0\n"
        "assert dropout_fwd.launches == dropout_bwd.launches == 0\n"
        "assert xent_forward.launches == xent_backward.launches == 0\n"
        "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _launchers():
    import importlib

    from incubator_mxnet_tpu_torch.ops import dropout_kernel as dk
    from incubator_mxnet_tpu_torch.ops import xent_kernel as xk

    fa = importlib.import_module("incubator_mxnet_tpu_torch.ops."
                                 "flash_attention")
    pa = importlib.import_module("incubator_mxnet_tpu_torch.ops."
                                 "paged_attention")
    ic = importlib.import_module("incubator_mxnet_tpu_torch.ops.int8_conv")
    x = torch.zeros((4, 600))
    q = torch.zeros((1, 2, 8, 16))
    rows = torch.zeros((1, 2, 8))
    bwd = (q, q, q, q, rows, rows, False, 0.25)
    pq = torch.zeros((1, 2, 16))
    pool = torch.zeros((3, 2, 8, 16))
    pool8 = torch.zeros((3, 2, 8, 16), dtype=torch.int8)
    scale = torch.ones((3, 2, 8))
    table = torch.ones((1, 2), dtype=torch.int32)
    pos = torch.full((1,), 9, dtype=torch.int32)
    slot = torch.full((1,), 7, dtype=torch.int64)
    return {
        "paged": (lambda: pa._launch(pq, pool, pool, table, pos),
                  pa.paged_attention),
        "paged_q8": (lambda: pa._launch_q8(pq, pool8, pool8, scale, scale,
                                           table, pos),
                     pa.paged_attention_q8),
        "flash_forward": (lambda: fa._flash_core(q, q, q, False, 0.25),
                          fa.flash_attention),
        "flash_dkdv": (lambda: fa._dkdv_cuda(*bwd), fa.flash_bwd_dkdv),
        "flash_dq": (lambda: fa._dq_cuda(*bwd), fa.flash_bwd_dq),
        "dropout": (lambda: dk._mask_cuda(2400, 7, 0.1, x.device),
                    dk.dropout_mask),
        "dropout_fwd": (lambda: dk._fwd_cuda(x, x, 7, 0.1), dk.dropout_fwd),
        "dropout_mask_dev": (lambda: dk._mask_cuda(2400, slot, 0.1,
                                                   x.device),
                             dk.dropout_mask_dev),
        "dropout_fwd_dev": (lambda: dk._fwd_cuda(x, x, slot, 0.1),
                            dk.dropout_fwd_dev),
        "dropout_bwd": (lambda: dk._bwd_cuda(
            x, torch.ones(x.shape, dtype=torch.uint8), 0.1), dk.dropout_bwd),
        "dropout_fwd_mixed": (lambda: dk._fwd_cuda(x.bfloat16(), x, 7, 0.1),
                              dk.dropout_fwd),
        "int8_conv": (lambda: ic._launch(
            torch.zeros(1, 2, 5, 5), torch.zeros(3, 2, 3, 3,
                                                 dtype=torch.int8),
            torch.ones(3), 0.1, None, (1, 1), (1, 1), (1, 1), 1,
            ic.int8_conv), ic.int8_conv),
        "int8_dense": (lambda: ic._launch(
            torch.zeros(2, 8, 1, 1), torch.zeros(3, 8, 1, 1,
                                                 dtype=torch.int8),
            torch.ones(3), 0.1, torch.zeros(3), (1, 1), (0, 0), (1, 1), 1,
            ic.int8_dense), ic.int8_dense),
        "int8_quantize": (lambda: ic._quantize_cuda(
            torch.zeros(1, 2, 5, 5), 0.1,
            (1, 2, 1, 16, 1, 5, 5, 1, 5, 5, 1, 1, 1, 1, 0, 1),
            (1, 5, 5, 1, 16)),
            ic.int8_quantize),
        "xent_forward": (lambda: xk._fwd_cuda(x, False), xk.xent_forward),
        "xent_backward": (lambda: xk._bwd_cuda(
            x, torch.zeros(4, dtype=torch.long), torch.zeros(4),
            torch.ones(4), 0.0), xk.xent_backward),
    }


KERNELS = ["dropout", "dropout_fwd", "dropout_bwd", "dropout_mask_dev",
           "dropout_fwd_dev", "xent_forward", "xent_backward",
           "flash_forward",
           "flash_dkdv", "flash_dq", "paged", "paged_q8",
           "dropout_fwd_mixed", "int8_conv", "int8_dense", "int8_quantize"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_forced_build_failure_raises(monkeypatch, kernel):
    from incubator_mxnet_tpu_torch import _build

    def broken_build(name):
        raise MXNetError(f"nvcc failed on csrc/{name}.cu")

    monkeypatch.setattr(_build, "load", broken_build)
    launch, counted = _launchers()[kernel]
    before = counted.launches
    with pytest.raises(MXNetError, match="nvcc failed"):
        launch()
    assert counted.launches == before


@pytest.mark.parametrize("kernel", KERNELS)
def test_forced_launch_failure_raises(monkeypatch, kernel):
    from incubator_mxnet_tpu_torch import _build

    class Lib:
        def __getattr__(self, name):
            def refused_launch(*args):
                return 700                  # cudaErrorIllegalAddress
            return refused_launch

    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    launch, counted = _launchers()[kernel]
    before = counted.launches
    with pytest.raises(MXNetError, match="launch failed"):
        launch()
    assert counted.launches == before


def test_flash_training_cpu_path_never_builds_or_loads_kernels():
    """The flash autograd Function, forward and backward, on CPU tensors
    takes the plain versions: nothing is built, loaded or launched."""
    res = _run(
        "import ctypes, subprocess, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('kernel build or load attempted')\n"
        "subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "import importlib\n"
        "from incubator_mxnet_tpu_torch import _build\n"
        "fa = importlib.import_module("
        "'incubator_mxnet_tpu_torch.ops.flash_attention')\n"
        "q, k, v = (torch.randn(1, 2, 8, 16, requires_grad=True)\n"
        "           for _ in range(3))\n"
        "out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)\n"
        "(out.sum() + lse.sum()).backward()\n"
        "assert all(t.grad is not None for t in (q, k, v))\n"
        "assert not _build._libs\n"
        "assert fa.flash_attention.launches == 0\n"
        "assert fa.flash_bwd_dkdv.launches == fa.flash_bwd_dq.launches == 0\n"
        "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ---- the quantized serving slice: int8 KV pages and int8 weights ----
SLICE4_MODULES = ["contrib", "contrib.quantization", "ops.paged_attention",
                  "models.generation", "serving.programs", "serving.engine"]


@pytest.mark.parametrize("mod", SLICE4_MODULES)
def test_quantized_serving_modules_import_with_jax_blocked(mod,
                                                           blocked_imports):
    _assert_imports_with_jax_blocked(blocked_imports, mod)


def _chip_smoke_kernels():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rules", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)              # defines; runs no phase
    return mod


def test_chip_smoke_names_the_int8_paged_kernel():
    cs = _chip_smoke_kernels()
    row = cs.KERNELS["paged_attention_q8"]
    assert row["replaces"] == "incubator_mxnet_tpu/ops/paged_attention.py:201"
    assert row["source"] == \
        "incubator_mxnet_tpu_torch/csrc/paged_attention.cu"
    assert row["fn"] is mxt.ops.paged_attention_q8
    assert "paged_attention_q8" in cs.SERVING_KERNELS


@pytest.mark.parametrize("name", ["paged_attention", "paged_attention_q8",
                                  "flash_attention", "flash_bwd_dkdv",
                                  "flash_bwd_dq", "dropout_mask",
                                  "dropout_fwd", "dropout_bwd",
                                  "dropout_mask_dev", "dropout_fwd_dev",
                                  "xent_forward", "xent_backward"])
def test_chip_smoke_rows_point_at_pallas_calls(name):
    """Each kernel row's ``replaces`` names a line of the JAX package
    that launches ``pl.pallas_call``, and its source exists."""
    row = _chip_smoke_kernels().KERNELS[name]
    path, line = row["replaces"].rsplit(":", 1)
    with open(os.path.join(ROOT, path)) as f:
        text = f.read().splitlines()[int(line) - 1]
    assert "pl.pallas_call(" in text, (name, text)
    assert os.path.exists(os.path.join(ROOT, row["source"]))


def test_kv8_engine_defaults_to_cuda(monkeypatch):
    from incubator_mxnet_tpu_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError):
        ServingEngine(TransformerLM(**SMALL), kv_dtype="int8")
    with ServingEngine(TransformerLM(**SMALL, device="cpu"), max_batch=1,
                       block_size=8, kv_dtype="int8") as eng:
        assert eng._programs.pool_k[0].dtype == torch.int8
        assert eng._programs.pool_k[0].device.type == "cpu"


def test_quantized_cpu_path_never_builds_or_loads_kernels():
    """The int8 weights and the int8 KV pool on CPU tensors take the
    plain versions: nothing is built, loaded or launched."""
    res = _run(
        "import ctypes, subprocess, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('kernel build or load attempted')\n"
        "subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "import incubator_mxnet_tpu_torch as m\n"
        "from incubator_mxnet_tpu_torch import _build\n"
        "from incubator_mxnet_tpu_torch.models import TransformerLM\n"
        "net = TransformerLM(vocab=11, units=16, hidden_size=32,\n"
        "                    num_layers=1, num_heads=2, max_len=32,\n"
        "                    device='cpu')\n"
        "net.quantize_for_decode()\n"
        "out = net.generate([[1, 2, 3]], 4)\n"
        "with net.serve(max_batch=1, block_size=8, kv_dtype='int8') as e:\n"
        "    toks = e.submit([1, 2, 3], 4).result(timeout=60)\n"
        "assert len(toks) == 4 and e.path == 'int8'\n"
        "assert not _build._libs\n"
        "assert m.ops.paged_attention_q8.launches == 0\n"
        "assert m.ops.paged_attention.launches == 0\n"
        "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_edited_header_gives_a_new_library_name(monkeypatch, tmp_path):
    """A library's name hashes its source and every ``csrc/*.cuh``: an
    edit to a shared header alone (the bf16 flash forward and backward
    share one) gives a new name, so the build never serves a library
    compiled against the old header.  No nvcc is needed."""
    from incubator_mxnet_tpu_torch import _build

    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    (tmp_path / "kern.cu").write_text('#include "tiles.cuh"\nint f();\n')
    (tmp_path / "tiles.cuh").write_text("constexpr int kTile = 64;\n")
    src, first = _build._target("kern")
    assert src == str(tmp_path / "kern.cu")
    assert _build._target("kern")[1] == first            # stable
    (tmp_path / "tiles.cuh").write_text("constexpr int kTile = 128;\n")
    second = _build._target("kern")[1]
    assert second != first
    (tmp_path / "more.cuh").write_text("// a second header\n")
    assert _build._target("kern")[1] not in (first, second)
    (tmp_path / "more.cuh").unlink()
    assert _build._target("kern")[1] == second
    (tmp_path / "kern.cu").write_text('#include "tiles.cuh"\nint g();\n')
    assert _build._target("kern")[1] != second


def test_the_port_sources_share_one_header():
    """The bf16 flash forward and backward include the shared Hopper
    header, and `_build` folds it into both libraries' names."""
    from incubator_mxnet_tpu_torch import _build

    csrc = os.path.join(PKG, "csrc")
    for name in ("flash_attention", "flash_attention_bwd"):
        with open(os.path.join(csrc, name + ".cu")) as f:
            assert '#include "hopper_tc.cuh"' in f.read(), name
    assert os.path.exists(os.path.join(csrc, "hopper_tc.cuh"))
    assert all(os.path.exists(_build._target(n)[0]) for n in _build.SOURCES)


# ---- the compiled-programs slice: CUDA graphs ----
GRAPH_MODULES = ["_graphs", "retrace_guard", "gluon.block",
                 "gluon.trainer", "models.generation", "serving.programs"]


@pytest.mark.parametrize("mod", GRAPH_MODULES)
def test_graph_modules_import_with_jax_blocked(mod, blocked_imports):
    _assert_imports_with_jax_blocked(blocked_imports, mod)


@pytest.mark.parametrize("name", ["_graphs.py", "retrace_guard.py"])
def test_graph_sources_import_neither_jax_nor_the_jax_package(name):
    mods = list(_imported_modules(os.path.join(PKG, name)))
    assert mods and not [m for m in mods if (m or "").split(".")[0] in
                         ("jax", "jaxlib", "incubator_mxnet_tpu")]


def _calls_torch_compile(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "compile" \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "torch":
            yield node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module == "torch" \
                and any(a.name == "compile" for a in node.names):
            yield node.lineno


def test_no_module_of_the_port_calls_torch_compile():
    """A graph replays the port's own kernels and torch ops; a library
    compiler's output is not a port of anything."""
    bad = [(os.path.relpath(p, ROOT), line) for p in _port_sources()
           for line in _calls_torch_compile(p)]
    assert bad == []


def test_cpu_graph_paths_never_touch_cuda():
    """Programs on CPU tensors run their bodies eagerly: no graph pool,
    stream or capture is made, and `generate`, `beam_search`, an engine
    and a hybridized forward all run."""
    res = _run(
        "import torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('CUDA graph machinery touched')\n"
        "torch.cuda.graph_pool_handle = refuse\n"
        "torch.cuda.Stream = refuse\n"
        "torch.cuda.CUDAGraph = refuse\n"
        "from incubator_mxnet_tpu_torch import _graphs\n"
        "from incubator_mxnet_tpu_torch.models import TransformerLM\n"
        "net = TransformerLM(vocab=11, units=16, hidden_size=32,\n"
        "                    num_layers=1, num_heads=2, max_len=32,\n"
        "                    device='cpu')\n"
        "net.generate([[1, 2, 3]], 4)\n"
        "net.generate([[1, 2, 3]], 4, pad_to_bucket=True)\n"
        "net.beam_search([[1, 2, 3]], 3, beam_size=2)\n"
        "with net.serve(max_batch=1, block_size=8) as eng:\n"
        "    eng.submit([1, 2, 3], 4).result(timeout=60)\n"
        "net.hybridize()\n"
        "net(torch.tensor([[1, 2]]))\n"
        "assert not _graphs.captures and not _graphs.replays\n"
        "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ---- the NMT slice: Transformer, its loss, Adam, schedules, translate ----
NMT_MODULES = ["lr_scheduler", "optimizer", "optimizer.optimizer",
               "models.transformer", "models.bert", "models.generation",
               "contrib.quantization", "gluon.trainer", "gluon.block",
               "gluon.parameter", "convert"]
TINY_NMT = dict(src_vocab=600, tgt_vocab=600, units=16, hidden_size=32,
                num_layers=1, num_heads=2, max_length=16)


@pytest.mark.parametrize("mod", NMT_MODULES)
def test_nmt_modules_import_with_jax_blocked(mod, blocked_imports):
    _assert_imports_with_jax_blocked(blocked_imports, mod)


def test_nmt_entry_points_default_to_cuda(monkeypatch):
    from incubator_mxnet_tpu_torch.models import Transformer, transformer_big

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError):
        Transformer(**TINY_NMT)
    with pytest.raises(MXNetError):
        transformer_big(dropout=0.0)
    net = Transformer(**TINY_NMT, device="cpu")
    assert net.out_proj.weight.device.type == "cpu"


def test_nmt_cpu_path_never_builds_or_loads_kernels():
    """A Transformer training step (hybridized, Adam, the smoothed loss
    at V=600, the streamed path's plain version) and greedy and beam
    translation on the CPU: no build, no library load, no launch count,
    no CUDA graph object."""
    res = _run(
        "import ctypes, subprocess, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('kernel build, load or graph attempted')\n"
        "subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "torch.cuda.graph_pool_handle = refuse\n"
        "torch.cuda.CUDAGraph = refuse\n"
        "from incubator_mxnet_tpu_torch import _build, _graphs, autograd\n"
        "from incubator_mxnet_tpu_torch.gluon import HybridBlock, Trainer\n"
        "from incubator_mxnet_tpu_torch.lr_scheduler import "
        "InvSqrtScheduler\n"
        "from incubator_mxnet_tpu_torch.models import (Transformer,\n"
        "    LabelSmoothedCELoss)\n"
        "from incubator_mxnet_tpu_torch.ops import xent_kernel as xk\n"
        "from incubator_mxnet_tpu_torch.ops import dropout_kernel as dk\n"
        f"net = Transformer(**{TINY_NMT!r}, dropout=0.1, device='cpu')\n"
        "net.initialize()\n"
        "class M(HybridBlock):\n"
        "    def __init__(self):\n"
        "        super().__init__(); self.net = net\n"
        "        self.loss = LabelSmoothedCELoss(0.1)\n"
        "    def forward(self, s, t, y):\n"
        "        return self.loss(self.net(s, t), y)\n"
        "m = M(); m.hybridize()\n"
        "tr = Trainer(m.collect_params(), 'adam', {'lr_scheduler':\n"
        "             InvSqrtScheduler(4), 'beta2': 0.98})\n"
        "s = torch.randint(0, 600, (2, 8))\n"
        "for _ in range(2):\n"
        "    with autograd.record():\n"
        "        loss = m(s, s, s)\n"
        "    loss.backward()\n"
        "    tr.step(2)\n"
        "net.translate(s, 4)\n"
        "net.translate(s, 4, beam_size=2)\n"
        "assert not _build._libs and not _graphs.captures\n"
        "assert xk.xent_forward.launches == xk.xent_backward.launches == 0\n"
        "assert dk.dropout_fwd_dev.launches == dk.dropout_bwd.launches == 0\n"
        "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ---- the ResNet slice: convolution, pooling, BatchNorm, the model zoo ----
# (importing the model zoo's resnet imports gluon.nn and its modules)
VISION_MODULES = ["ndarray.nn_ops", "gluon.nn.conv_layers",
                  "gluon.nn.activations", "gluon.model_zoo.vision.resnet"]
TINY_RESNET = ("vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1], "
               "[8, 16, 32, 64, 128], classes=600")


@pytest.mark.parametrize("mod", VISION_MODULES)
def test_vision_modules_import_with_jax_blocked(mod, blocked_imports):
    _assert_imports_with_jax_blocked(blocked_imports, mod)


def test_vision_entry_points_default_to_cuda(monkeypatch):
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError):
        vision.get_model("resnet50_v1", classes=1000)
    with pytest.raises(MXNetError):
        vision.resnet18_v2()
    net = vision.get_model("resnet18_v1", classes=10, device="cpu")
    assert net.output.weight.device.type == "cpu"
    assert net.features[1].running_var.device.type == "cpu"


def test_vision_cpu_path_never_builds_or_loads_kernels():
    """A small ResNet v1's hybridized training step (SGD with momentum
    and wd, the loss at 600 classes on the streamed cross-entropy's
    plain version) and its hybridized inference, on the CPU: no build,
    no library load, no launch count, no CUDA graph object."""
    res = _run(
        "import ctypes, subprocess, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('kernel build, load or graph attempted')\n"
        "subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "torch.cuda.graph_pool_handle = refuse\n"
        "torch.cuda.CUDAGraph = refuse\n"
        "from incubator_mxnet_tpu_torch import _build, _graphs, autograd\n"
        "from incubator_mxnet_tpu_torch.gluon import Trainer\n"
        "from incubator_mxnet_tpu_torch.gluon.loss import "
        "SoftmaxCrossEntropyLoss\n"
        "from incubator_mxnet_tpu_torch.gluon.model_zoo import vision\n"
        "from incubator_mxnet_tpu_torch.ops import xent_kernel as xk\n"
        f"net = {TINY_RESNET}, device='cpu')\n"
        "net.initialize()\n"
        "net.hybridize()\n"
        "tr = Trainer(net.collect_params(), 'sgd', {'learning_rate': 0.05,\n"
        "             'momentum': 0.9, 'wd': 1e-4}, keep_grads=False)\n"
        "x, y = torch.randn(2, 3, 32, 32), torch.randint(0, 600, (2,))\n"
        "for _ in range(2):\n"
        "    with autograd.record():\n"
        "        loss = SoftmaxCrossEntropyLoss()(net(x), y)\n"
        "    autograd.backward(loss)\n"
        "    tr.step(2)\n"
        "with autograd.predict_mode():\n"
        "    assert net(x).shape == (2, 600)\n"
        "assert not _build._libs and not _graphs.captures\n"
        "assert xk.xent_forward.launches == xk.xent_backward.launches == 0\n"
        "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ---- the PTQ slice: the .params codec, hooks, quantize_net, int8_conv ----
PTQ_MODULES = ["utils.serialization", "ops.int8_conv",
               "contrib.quantization", "ndarray"]


@pytest.mark.parametrize("mod", PTQ_MODULES)
def test_ptq_modules_import_with_jax_blocked(mod, blocked_imports):
    _assert_imports_with_jax_blocked(blocked_imports, mod)


def test_nd_load_defaults_to_cuda(monkeypatch, tmp_path):
    from incubator_mxnet_tpu_torch import nd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = str(tmp_path / "a.params")
    nd.save(f, {"a": torch.ones(2)})
    with pytest.raises(MXNetError):
        nd.load(f)
    assert nd.load(f, device="cpu")["a"].device.type == "cpu"


def test_ptq_cpu_path_never_builds_or_loads_kernels(tmp_path):
    """A small ResNet v1 calibrated (minmax and entropy), quantized,
    hybridized and called, then saved and loaded, on the CPU: no build,
    no library load, no int8 launch count, no CUDA graph object."""
    res = _run(
        "import ctypes, subprocess, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('kernel build, load or graph attempted')\n"
        "subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "torch.cuda.graph_pool_handle = refuse\n"
        "torch.cuda.CUDAGraph = refuse\n"
        "from incubator_mxnet_tpu_torch import _build, _graphs\n"
        "from incubator_mxnet_tpu_torch.contrib.quantization import "
        "quantize_net\n"
        "from incubator_mxnet_tpu_torch.gluon.model_zoo import vision\n"
        "import importlib\n"
        "ic = importlib.import_module('incubator_mxnet_tpu_torch.ops."
        "int8_conv')\n"
        "x = torch.randn(2, 3, 32, 32)\n"
        "for mode in ('minmax', 'entropy'):\n"
        f"    net = {TINY_RESNET}, device='cpu')\n"
        "    net.initialize()\n"
        "    quantize_net(net, [x], calib_mode=mode)\n"
        "    net.hybridize()\n"
        "    assert net(x).shape == (2, 600)\n"
        f"    net.save_parameters({str(tmp_path / 'q.params')!r})\n"
        f"    net.load_parameters({str(tmp_path / 'q.params')!r})\n"
        "assert not _build._libs and not _graphs.captures\n"
        "assert ic.int8_conv.launches == ic.int8_dense.launches == 0\n"
        "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("name,line", [("int8_conv", "def int8_conv("),
                                       ("int8_dense", "def int8_dense(")])
def test_chip_smoke_int8_rows_point_at_the_jax_functions(name, line):
    """The int8 rows of chip_smoke.py's kernel table name the JAX
    function they port (no Pallas kernel: XLA's s8 product there) and
    a source that exists."""
    row = _chip_smoke_kernels().KERNELS[name]
    path, at = row["replaces"].rsplit(":", 1)
    with open(os.path.join(ROOT, path)) as f:
        text = f.read().splitlines()[int(at) - 1]
    assert text.startswith(line), (name, text)
    assert row["source"].endswith("csrc/int8_conv.cu")
    assert os.path.exists(os.path.join(ROOT, row["source"]))


def test_chip_smoke_int8_quantize_row_points_at_the_quantize_line():
    """The quantize pass's row names the JAX `int8_conv`'s quantize
    line (XLA fuses it into the s8 convolution there), its own source,
    and stands in the int8 kernels of the table."""
    cs = _chip_smoke_kernels()
    row = cs.KERNELS["int8_quantize"]
    path, at = row["replaces"].rsplit(":", 1)
    with open(os.path.join(ROOT, path)) as f:
        lines = f.read().splitlines()
    assert lines[int(at) - 1].strip().startswith("xq = jnp.clip(")
    assert any(ln.startswith("def int8_conv(")
               for ln in lines[int(at) - 8:int(at)])
    assert row["source"].endswith("csrc/int8_quantize.cu")
    assert os.path.exists(os.path.join(ROOT, row["source"]))
    assert cs.INT8_KERNELS == ("int8_quantize", "int8_conv", "int8_dense")


# ---- the training-state slice: optimizers, checkpoints, the stream ----
STATE_MODULES = ["optimizer", "optimizer.optimizer", "utils.checkpoint",
                 "gluon.trainer", "random"]


@pytest.mark.parametrize("mod", STATE_MODULES)
def test_state_modules_import_with_jax_blocked(mod, blocked_imports):
    _assert_imports_with_jax_blocked(blocked_imports, mod)


@pytest.mark.parametrize("name", ["utils/checkpoint.py",
                                  "optimizer/optimizer.py",
                                  "optimizer/__init__.py"])
def test_state_sources_import_neither_jax_nor_the_jax_package(name):
    mods = [(m or "").split(".")[0]
            for m in _imported_modules(os.path.join(PKG, name))]
    assert not {"jax", "jaxlib", "incubator_mxnet_tpu"} & set(mods)


def test_state_cpu_path_never_builds_or_loads_kernels(tmp_path):
    """Every update rule through a hybridized net's Trainer, a
    checkpoint saved (async and not) and restored, ``save_states`` /
    ``load_states`` and an `Updater`, on the CPU: no build, no library
    load, no CUDA graph, no CUDA event or stream."""
    res = _run(
        "import ctypes, subprocess, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('kernel build, load or CUDA object')\n"
        "subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "torch.cuda.graph_pool_handle = refuse\n"
        "torch.cuda.CUDAGraph = refuse\n"
        "torch.cuda.Event = refuse\n"
        "torch.cuda.Stream = refuse\n"
        "from incubator_mxnet_tpu_torch import _build, _graphs, autograd\n"
        "from incubator_mxnet_tpu_torch import random as mxr\n"
        "from incubator_mxnet_tpu_torch.gluon import Trainer\n"
        "from incubator_mxnet_tpu_torch.gluon.nn import Dense\n"
        "from incubator_mxnet_tpu_torch.optimizer import create, "
        "get_updater\n"
        "from incubator_mxnet_tpu_torch.optimizer.optimizer import _REG\n"
        "from incubator_mxnet_tpu_torch.utils.checkpoint import "
        "CheckpointManager\n"
        "mxr.seed(0, device='cpu')\n"
        "x = torch.randn(2, 6)\n"
        "for name in sorted(_REG):\n"
        "    net = Dense(4, 6, device='cpu').initialize()\n"
        "    net.hybridize()\n"
        "    tr = Trainer(net.collect_params(), name, "
        "{'multi_precision': True})\n"
        "    for _ in range(2):\n"
        "        with autograd.record():\n"
        "            (net(x) ** 2).mean().backward()\n"
        "        tr.step(1)\n"
        "    assert tr._updates is not None, name\n"
        "    up = get_updater(create(name))\n"
        "    up(0, torch.ones(3), torch.zeros(3))\n"
        "    get_updater(create(name)).set_states(up.get_states())\n"
        f"    d = {str(tmp_path)!r} + '/' + name\n"
        "    with CheckpointManager(d) as m:\n"
        "        m.save(1, net=net, trainer=tr)\n"
        "    CheckpointManager(d, async_save=False).save(2, net=net, "
        "trainer=tr)\n"
        "    CheckpointManager(d).restore(net=net, trainer=tr)\n"
        "    tr.save_states(d + '/s')\n"
        "    tr.load_states(d + '/s')\n"
        "assert not _build._libs and not _graphs.captures\n"
        "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ---- the long-context slice: remat, the in-program encoding, lm_score --
LONGCTX_MODULES = ["models.transformer", "models.generation", "gluon.block",
                   "_graphs", "random", "ops.flash_attention"]

# run in `blocked_imports`' interpreter (jax and the JAX package blocked)
# after its imports: a long-context TransformerLM (no positional table)
# trained two steps through the remat programs, hybridized with Gluon's
# other keywords, then scored and decoded, with every kernel build or
# load, CUDA graph, event and stream refused
_LONGCTX_RUN = """\
import ctypes, subprocess, torch
def refuse(*a, **k):
    raise AssertionError('kernel build, load or CUDA object')
subprocess.Popen = refuse
ctypes.CDLL = refuse
torch.cuda.graph_pool_handle = refuse
torch.cuda.CUDAGraph = refuse
torch.cuda.Event = refuse
torch.cuda.Stream = refuse
from incubator_mxnet_tpu_torch import _build, _graphs, autograd
from incubator_mxnet_tpu_torch.gluon import HybridBlock, Trainer
from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from incubator_mxnet_tpu_torch.models import TransformerLM, lm_score
from incubator_mxnet_tpu_torch.models.transformer import _PE_TABLE_MAX
class M(HybridBlock):
    def __init__(self, net):
        super().__init__()
        self.net = net
        self.loss = SoftmaxCrossEntropyLoss()
    def forward(self, t, y):
        return self.loss(self.net(t), y).mean()
net = TransformerLM(vocab=11, units=16, hidden_size=32, num_layers=1,
                    num_heads=2, max_len=_PE_TABLE_MAX + 1, dropout=0.1,
                    device='cpu')
assert net._pe is None
m = M(net)
m.hybridize(True, static_alloc=True, static_shape=True,
            remat_backward=True)
assert net.layer0.ffn._remat_backward
tr = Trainer(m.collect_params(), 'sgd', {'momentum': 0.9},
             keep_grads=False)
t = torch.randint(0, 11, (2, 12))
for _ in range(2):
    with autograd.record():
        m(t, t).backward()
    tr.step(1)
rec = next(iter(m._graph_cache.values()))[0]
assert rec.fwd.name == 'fwd_remat' and rec.bwd.name == 'bwd_remat'
assert lm_score(net, t).shape == (2, 11)
assert net.generate(t[:, :4], 2).shape == (2, 6)
assert not _build._libs and not _graphs.captures
return 'ok'
"""


@pytest.mark.parametrize("mod", LONGCTX_MODULES)
def test_longctx_modules_import_with_jax_blocked(mod, blocked_imports):
    _assert_imports_with_jax_blocked(blocked_imports, mod)


@pytest.mark.parametrize("name", ["models/transformer.py",
                                  "models/generation.py", "gluon/block.py",
                                  "_graphs.py", "random.py",
                                  "ops/flash_attention.py"])
def test_longctx_sources_import_neither_jax_nor_the_jax_package(name):
    mods = [(m or "").split(".")[0]
            for m in _imported_modules(os.path.join(PKG, name))]
    assert not {"jax", "jaxlib", "incubator_mxnet_tpu"} & set(mods)


def test_hybridize_keeps_gluons_keywords_beside_remat():
    """``hybridize`` takes Gluon's keywords (static_alloc, static_shape,
    any other) with ``remat_backward``, on a plain `Block` and a
    `HybridBlock`, and hands the flag to every child."""
    from incubator_mxnet_tpu_torch.gluon import Block
    from incubator_mxnet_tpu_torch.gluon.nn import Dense

    class Outer(Block):
        def __init__(self):
            super().__init__()
            self.a = Dense(3, 4, device="cpu")
            self.b = Dense(2, 3, device="cpu")

    net = Outer()
    assert net.hybridize(True, static_alloc=True, static_shape=True,
                         remat_backward=True, inline_limit=2) is net
    assert net._remat_backward and net.a._remat_backward \
        and net.b._remat_backward and net.a._hybrid
    net.a.hybridize(static_alloc=True)
    assert not net.a._remat_backward and net.b._remat_backward


def test_longctx_cpu_path_never_builds_or_loads_kernels(blocked_imports):
    """The long-context path on the CPU, with jax blocked (run in the
    shared interpreter): a TransformerLM above the table's max_len
    trained through the remat programs, scored and decoded — no build,
    no library load, no CUDA graph, event or stream."""
    assert blocked_imports[2] == "ok", blocked_imports[2]


# ---- the telemetry slice: the registry, spans, perf, the ops server ---
TELEMETRY_MODULES = ["telemetry", "telemetry.registry", "telemetry.tracer",
                     "telemetry.exporters", "telemetry.requestlog",
                     "telemetry.slo", "telemetry.profiler",
                     "telemetry.http", "telemetry.flight_recorder",
                     "telemetry.perf", "lock_witness"]


@pytest.mark.parametrize("mod", TELEMETRY_MODULES)
def test_telemetry_modules_import_with_jax_blocked(mod, blocked_imports):
    _assert_imports_with_jax_blocked(blocked_imports, mod)


def _telemetry_sources():
    tdir = os.path.join(PKG, "telemetry")
    return sorted(os.path.join(tdir, f) for f in os.listdir(tdir)
                  if f.endswith(".py")) + [os.path.join(PKG,
                                                        "lock_witness.py")]


@pytest.mark.parametrize("path", _telemetry_sources(),
                         ids=os.path.basename)
def test_telemetry_sources_import_neither_jax_nor_the_jax_package(path):
    mods = [(m or "").split(".")[0] for m in _imported_modules(path)]
    assert not {"jax", "jaxlib", "incubator_mxnet_tpu"} & set(mods)


_SYNC_ATTRS = {"synchronize", "item", "cpu", "tolist"}


@pytest.mark.parametrize("path", _telemetry_sources()[:-1],
                         ids=os.path.basename)
def test_telemetry_never_forces_a_device_sync(path):
    """No file of the port's telemetry calls ``synchronize(``,
    ``.item()``, ``.cpu()`` or ``.tolist()``: instrumentation reads host
    clocks, metadata, allocator counters and ``Event.query()``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = [(node.lineno, node.func.attr) for node in ast.walk(tree)
           if isinstance(node, ast.Call)
           and isinstance(node.func, ast.Attribute)
           and node.func.attr in _SYNC_ATTRS]
    assert bad == []


def test_chip_smoke_has_the_telemetry_phase():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert callable(cs.phase_telemetry)
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "\n41. telemetry" in src
    main = src[src.index("def main() -> int:"):]
    assert "phase_telemetry" in main and "lscore, tel)" in main


# ---- the data and IO slice: RecordIO, the native pipeline, io, data ---
DATA_MODULES = ["recordio", "image", "native", "native.build", "io",
                "io.io", "io.prefetcher", "gluon.data", "gluon.data.dataset",
                "gluon.data.sampler", "gluon.data.dataloader",
                "gluon.data.vision", "gluon.data.vision.datasets",
                "gluon.data.vision.transforms", "metric", "callback"]


@pytest.mark.parametrize("mod", DATA_MODULES)
def test_data_modules_import_with_jax_blocked(mod, blocked_imports):
    _assert_imports_with_jax_blocked(blocked_imports, mod)


def test_no_port_file_names_the_jax_packages_native_build():
    """The port builds its own copies of the C++ sources into its own
    ``_build/native/``: no file of it names the JAX package's native
    directory or module."""
    bad = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cc", ".h", ".cu", ".cuh")):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    text = fh.read()
                if "incubator_mxnet_tpu/native" in text \
                        or "incubator_mxnet_tpu.native" in text:
                    bad.append(os.path.relpath(path, ROOT))
    assert bad == []


def test_data_entry_points_default_to_cuda(monkeypatch, tmp_path):
    import numpy as np

    from incubator_mxnet_tpu_torch import io
    from incubator_mxnet_tpu_torch.gluon import data

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((4, 2), np.float32)
    calls = [lambda: io.to_device(x),
             lambda: io.DevicePrefetcher([x]),
             lambda: io.NDArrayIter(x, batch_size=2),
             lambda: io.PrefetchingIter(
                 io.NDArrayIter(x, batch_size=2, device="cpu"),
                 prefetch_to_device=True),
             lambda: data.DataLoader(data.ArrayDataset(x), batch_size=2,
                                     prefetch_to_device=True),
             lambda: io.ImageRecordIter(str(tmp_path / "none.rec"),
                                        (3, 8, 8), 2)]
    for call in calls:
        with pytest.raises(MXNetError, match="no CUDA device"):
            call()
    assert io.to_device(x, device="cpu").device.type == "cpu"
    # without prefetching a DataLoader gives host batches
    batch = next(iter(data.DataLoader(data.ArrayDataset(x), batch_size=2)))
    assert isinstance(batch, np.ndarray)


def test_chip_smoke_has_the_fed_training_phase():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "\n42. fed training" in src
    main = src[src.index("def main() -> int:"):]
    assert "phase_fed_training" in main and "fed[\"launches\"]" in main


# ---- the one-program step and the chain -------------------------------
CHAIN_MODULES = ["engine", "autograd", "gluon.block", "gluon.trainer",
                 "gluon.parameter", "random"]


@pytest.mark.parametrize("mod", CHAIN_MODULES)
def test_chain_modules_import_with_jax_blocked(mod, blocked_imports):
    _assert_imports_with_jax_blocked(blocked_imports, mod)


@pytest.mark.parametrize("name", ["engine.py", "gluon/trainer.py",
                                  "autograd.py"])
def test_chain_sources_import_neither_jax_nor_the_jax_package(name):
    mods = list(_imported_modules(os.path.join(PKG, name)))
    assert mods and not [m for m in mods if (m or "").split(".")[0] in
                         ("jax", "jaxlib", "incubator_mxnet_tpu")]


def test_chip_smoke_has_the_chained_steps_phase():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "\n43. chained steps" in src
    main = src[src.index("def main() -> int:"):]
    assert "phase_chained_steps" in main and "chain[\"launches\"]" in main


# ---- the recurrent and generative slice: RNNs, cells, losses, DCGAN ----
RECURRENT_MODULES = ["initializer", "ndarray", "ndarray.nn_ops",
                     "ndarray.rnn_impl", "gluon.rnn", "gluon.rnn.rnn_layer",
                     "gluon.rnn.rnn_cell", "gluon.utils", "gluon.loss",
                     "gluon.nn.activations", "gluon.nn.basic_layers",
                     "gluon.nn.conv_layers", "models.word_lm",
                     "models.dcgan"]

# run in `blocked_imports`' interpreter after the long-context run (its
# refusals of every kernel build or load, CUDA graph, event and stream
# still in place): the word LM (tied, dropout 0.5) hybridized for two
# windows with clip_global_norm before each step, and one DCGAN
# iteration (two Trainers, D called twice in one record()); no kernel
# counted
_RECURRENT_RUN = """\
import torch
from incubator_mxnet_tpu_torch import _build, _graphs, autograd
from incubator_mxnet_tpu_torch.gluon import Trainer, utils
from incubator_mxnet_tpu_torch.gluon.loss import (
    SigmoidBinaryCrossEntropyLoss, SoftmaxCrossEntropyLoss)
from incubator_mxnet_tpu_torch.models import WordLM, dcgan_nets
from incubator_mxnet_tpu_torch.ops import dropout_kernel as dk
from incubator_mxnet_tpu_torch.ops import xent_kernel as xk
lm = WordLM(600, 8, 8, 2, 0.5, True, device='cpu')
lm.initialize()
lm.hybridize()
loss_fn = SoftmaxCrossEntropyLoss()
loss_fn.hybridize()
tr = Trainer(lm.collect_params(), 'sgd', {'learning_rate': 1.0})
states = lm.begin_state(2)
for _ in range(2):
    x = torch.randint(0, 600, (4, 2))
    states = [s.detach() for s in states]
    with autograd.record():
        logits, states = lm(x, states)
        loss = loss_fn(logits, x).mean()
    loss.backward()
    utils.clip_global_norm([p.grad for p in lm.collect_params().values()],
                           0.5, check_isfinite=False)
    tr.step(1)
G, D = dcgan_nets(2, 2, 4, device='cpu')
for n in (G, D):
    n.initialize()
    n.hybridize()
bce = SigmoidBinaryCrossEntropyLoss()
tG = Trainer(G.collect_params(), 'adam', {'beta1': 0.5})
tD = Trainer(D.collect_params(), 'adam', {'beta1': 0.5})
z = torch.randn(2, 4, 1, 1)
fake = G(z).detach()
with autograd.record():
    lD = (bce(D(torch.rand(2, 3, 32, 32)), torch.ones(2, 1))
          + bce(D(fake), torch.zeros(2, 1))).mean()
lD.backward()
tD.step(1)
with autograd.record():
    lG = bce(D(G(z)), torch.ones(2, 1)).mean()
lG.backward()
tG.step(1)
assert not _build._libs and not _graphs.captures
assert dk.dropout_fwd.launches == dk.dropout_fwd_dev.launches == 0
assert dk.dropout_bwd.launches == xk.xent_forward.launches == 0
return 'ok'
"""


@pytest.mark.parametrize("mod", RECURRENT_MODULES)
def test_recurrent_modules_import_with_jax_blocked(mod, blocked_imports):
    _assert_imports_with_jax_blocked(blocked_imports, mod)


@pytest.mark.parametrize("name", ["ndarray/rnn_impl.py", "gluon/utils.py",
                                  "gluon/rnn/rnn_layer.py",
                                  "gluon/rnn/rnn_cell.py",
                                  "models/word_lm.py", "models/dcgan.py"])
def test_recurrent_sources_import_neither_jax_nor_the_jax_package(name):
    mods = list(_imported_modules(os.path.join(PKG, name)))
    assert mods and not [m for m in mods if (m or "").split(".")[0] in
                         ("jax", "jaxlib", "incubator_mxnet_tpu")]


def test_recurrent_cpu_path_never_builds_or_loads_kernels(blocked_imports):
    """The word LM (hybridized, dropout on, clip_global_norm before the
    step) and a DCGAN iteration on the CPU, with jax blocked (run in the
    shared interpreter): no build, no library load, no CUDA graph, event
    or stream, no kernel counted."""
    assert blocked_imports[3] == "ok", blocked_imports[3]


def test_recurrent_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU the slice's entry points raise unless given the
    CPU: the word LM, DCGAN's nets, the recurrent layers and cells, the
    transposed convolutions, PReLU, GroupNorm, InstanceNorm, and
    split_and_load to ``cuda``."""
    from incubator_mxnet_tpu_torch.gluon import nn, rnn, utils
    from incubator_mxnet_tpu_torch.models import WordLM, dcgan_nets

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = [lambda **k: WordLM(50, 8, 8, 1, **k),
              lambda **k: dcgan_nets(2, 2, 4, **k)[0],
              lambda **k: rnn.LSTM(8, input_size=4, **k),
              lambda **k: rnn.GRU(8, input_size=4, **k),
              lambda **k: rnn.RNN(8, input_size=4, **k),
              lambda **k: rnn.LSTMCell(8, input_size=4, **k),
              lambda **k: rnn.GRUCell(8, input_size=4, **k),
              lambda **k: rnn.RNNCell(8, input_size=4, **k),
              lambda **k: nn.Conv1DTranspose(3, 4, in_channels=2, **k),
              lambda **k: nn.Conv2DTranspose(3, 4, in_channels=2, **k),
              lambda **k: nn.Conv3DTranspose(3, 4, in_channels=2, **k),
              lambda **k: nn.PReLU(in_channels=2, **k),
              lambda **k: nn.GroupNorm(in_channels=2, **k),
              lambda **k: nn.InstanceNorm(in_channels=2, **k)]
    for make in makers:
        with pytest.raises(MXNetError):
            make()
        with pytest.raises(MXNetError):
            make(device="cuda")
        net = make(device="cpu")
        assert all(p.device.type == "cpu" for p in net.parameters())
    with pytest.raises(MXNetError):
        utils.split_and_load(torch.zeros(4, 2), ["cuda"])


def test_chip_smoke_has_the_recurrent_phases():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "\n44. word-level LSTM" in src and "\n45. DCGAN" in src
    main = src[src.index("def main() -> int:"):]
    assert "phase_word_lm" in main and "phase_dcgan" in main
