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
import os
import subprocess
import sys

import pytest
import torch

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import MXNetError, context
from incubator_mxnet_tpu_torch.models import TransformerLM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "incubator_mxnet_tpu_torch")
SMALL = dict(vocab=11, units=16, hidden_size=32, num_layers=1, num_heads=2,
             max_len=32, dropout=0.0)


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


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
        "xent_forward": (lambda: xk._fwd_cuda(x, False), xk.xent_forward),
        "xent_backward": (lambda: xk._bwd_cuda(
            x, torch.zeros(4, dtype=torch.long), torch.zeros(4),
            torch.ones(4), 0.0), xk.xent_backward),
    }


KERNELS = ["dropout", "dropout_fwd", "dropout_bwd", "dropout_mask_dev",
           "dropout_fwd_dev", "xent_forward", "xent_backward",
           "flash_forward",
           "flash_dkdv", "flash_dq", "paged", "paged_q8",
           "dropout_fwd_mixed", "int8_conv", "int8_dense"]


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
def test_quantized_serving_modules_import_with_jax_blocked(mod):
    res = _run("import sys\n"
               "sys.modules['jax'] = None\n"
               "sys.modules['incubator_mxnet_tpu'] = None\n"
               f"import incubator_mxnet_tpu_torch.{mod}\n"
               "print(sorted(n for n, m in sys.modules.items()\n"
               "             if m is not None and n.split('.')[0] in\n"
               "             ('jax', 'jaxlib', 'incubator_mxnet_tpu')))\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


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
def test_graph_modules_import_with_jax_blocked(mod):
    res = _run("import sys\n"
               "sys.modules['jax'] = None\n"
               "sys.modules['incubator_mxnet_tpu'] = None\n"
               f"import incubator_mxnet_tpu_torch.{mod}\n"
               "print(sorted(n for n, m in sys.modules.items()\n"
               "             if m is not None and n.split('.')[0] in\n"
               "             ('jax', 'jaxlib', 'incubator_mxnet_tpu')))\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


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
def test_nmt_modules_import_with_jax_blocked(mod):
    res = _run("import sys\n"
               "sys.modules['jax'] = None\n"
               "sys.modules['incubator_mxnet_tpu'] = None\n"
               f"import incubator_mxnet_tpu_torch.{mod}\n"
               "print(sorted(n for n, m in sys.modules.items()\n"
               "             if m is not None and n.split('.')[0] in\n"
               "             ('jax', 'jaxlib', 'incubator_mxnet_tpu')))\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


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
def test_vision_modules_import_with_jax_blocked(mod):
    res = _run("import sys\n"
               "sys.modules['jax'] = None\n"
               "sys.modules['incubator_mxnet_tpu'] = None\n"
               f"import incubator_mxnet_tpu_torch.{mod}\n"
               "print(sorted(n for n, m in sys.modules.items()\n"
               "             if m is not None and n.split('.')[0] in\n"
               "             ('jax', 'jaxlib', 'incubator_mxnet_tpu')))\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


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
def test_ptq_modules_import_with_jax_blocked(mod):
    res = _run("import sys\n"
               "sys.modules['jax'] = None\n"
               "sys.modules['incubator_mxnet_tpu'] = None\n"
               f"import incubator_mxnet_tpu_torch.{mod}\n"
               "print(sorted(n for n, m in sys.modules.items()\n"
               "             if m is not None and n.split('.')[0] in\n"
               "             ('jax', 'jaxlib', 'incubator_mxnet_tpu')))\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


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
