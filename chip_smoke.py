"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. device  — print the card's name and power limit (nvidia-smi) and
   require CUDA;
2. build   — compile every CUDA source of the port with nvcc, all at
   once, into incubator_mxnet_tpu_torch/_build/;
3. kernels — hold each kernel against its plain PyTorch version on the
   card (f32 atol 2e-5, bf16 atol 2e-2), plus the paged kernel's
   masked-slot and lane bit-exactness and the flash kernel's
   logsumexp and fully-masked rows;
4. main path — a 12-layer, 1024-wide, 16-head, V=32000 TransformerLM in
   bf16 with random weights from a seed: ``net.generate`` (B=8, P=128,
   N=32), then a paged ServingEngine over 8 requests of 32-300 prompt
   tokens with one prompt submitted again as a prefix-cache hit, and a
   solo run on a fresh engine; every kernel's launch count must grow
   during this phase;
5. parity  — the same width in f32 at 2 layers: engine tokens equal
   ``net.generate`` tokens, or first differ where the top-2 logit gap is
   below 1e-3;
6. timing  — each kernel at the inputs the main path gave it (recorded
   during phase 4), held to its plain version there, and timed beside
   the plain version, the one-call PyTorch yardstick where there is one,
   and the bound (bytes over 3.35 TB/s, operations over 989 TFLOP/s for
   bf16).

The line before the last is a JSON object with every kernel's launches,
error, time, plain-version time, bound and library time; the line
before it is the nvidia-smi name and power limit; the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of the
JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from incubator_mxnet_tpu_torch import _build
from incubator_mxnet_tpu_torch.models import TransformerLM
from incubator_mxnet_tpu_torch.models import generation as gen_mod
from incubator_mxnet_tpu_torch.ops import flash_attention as _fa_fn
from incubator_mxnet_tpu_torch.ops import paged_attention as _pa_fn
from incubator_mxnet_tpu_torch.ops.flash_attention import (
    _reference_attention_lse, flash_attention_with_lse)
from incubator_mxnet_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_dense)
from incubator_mxnet_tpu_torch.serving import ServingEngine
from incubator_mxnet_tpu_torch.serving import programs as prog_mod

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PARITY_GAP = 1e-3                   # flash-vs-paged roundoff tie bound
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
DEV = torch.device("cuda")
MODEL = dict(vocab=32000, units=1024, hidden_size=4096, num_layers=12,
             num_heads=16, max_len=512)
KERNELS = {
    "paged_attention": dict(
        fn=_pa_fn, source="incubator_mxnet_tpu_torch/csrc/paged_attention.cu",
        replaces="incubator_mxnet_tpu/ops/paged_attention.py:168"),
    "flash_attention": dict(
        fn=_fa_fn, source="incubator_mxnet_tpu_torch/csrc/flash_attention.cu",
        replaces="incubator_mxnet_tpu/ops/flash_attention.py:211"),
}


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------- phase 1
def phase_device() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    log(f"card: {smi}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return smi


# ---------------------------------------------------------------- phase 2
def phase_build() -> float:
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    log(f"build: {len(logs)} sources in {dt:.1f} s")
    for name, text in logs.items():
        usage = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"  {name}: " + " | ".join(usage))
    return dt


# ---------------------------------------------------------------- timing
_FLUSH = None


def _flush_l2():
    """Overwrite more than the 50 MB L2 so each timed launch starts cold,
    as a layer's kernel does after the other layers ran."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(96 << 20, dtype=torch.uint8, device=DEV)
    _FLUSH.fill_(1)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call (CUDA events, cold L2)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        _flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------- phase 3
def paged_inputs(dtype, B=8, H=16, D=64, bs=16, nbps=32, seed=0):
    """Random pool, permuted tables, ragged positions (0, a full lane,
    the rest random), all on the card."""
    g = torch.Generator().manual_seed(seed)
    nblocks = B * nbps + 1
    pool_k = torch.randn((nblocks, H, bs, D), generator=g)
    pool_v = torch.randn((nblocks, H, bs, D), generator=g)
    q = torch.randn((B, H, D), generator=g)
    tables = (torch.randperm(B * nbps, generator=g) + 1).reshape(B, nbps)
    pos = torch.randint(0, nbps * bs, (B,), generator=g)
    pos[0] = 0
    pos[1] = nbps * bs - 1
    return (q.to(DEV, dtype), pool_k.to(DEV, dtype), pool_v.to(DEV, dtype),
            tables.to(DEV, torch.int32), pos.to(DEV, torch.int32))


def check_paged(dtype, **shape) -> float:
    q, pk, pv, tables, pos = paged_inputs(dtype, **shape)
    out = paged_attention(q, pk, pv, tables, pos)
    ref = paged_attention_dense(q, pk, pv, tables, pos)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], f"paged {dtype} {shape}: max err {err}"
    # masked-slot exactness: finite garbage in every slot past pos
    bs = pk.shape[2]
    slot = torch.arange(tables.shape[1] * bs, device=DEV)
    masked = slot[None, :] > pos[:, None].long()          # (B, W)
    blk = tables.long()[:, slot // bs][masked]
    off = (slot % bs)[None, :].expand_as(masked)[masked]
    pk2, pv2 = pk.clone(), pv.clone()
    pk2[blk, :, off] = 1e4
    pv2[blk, :, off] = -3e4
    out2 = paged_attention(q, pk2, pv2, tables, pos)
    assert torch.equal(out, out2), f"paged {dtype}: masked slots leak"
    # lane independence: each lane alone equals its co-batched row
    for b in range(q.shape[0]):
        solo = paged_attention(q[b:b + 1].contiguous(), pk, pv,
                               tables[b:b + 1].contiguous(),
                               pos[b:b + 1].contiguous())
        assert torch.equal(solo[0], out[b]), f"paged {dtype}: lane {b} mixes"
    return err


FLASH_CASES = (((8, 16, 128, 64), 128, True),
               ((2, 16, 1000, 64), 1000, True),
               ((2, 4, 37, 64), 300, True),
               ((2, 16, 256, 64), 256, False),
               ((2, 4, 300, 32), 37, True),          # 263 rows see no key
               ((1, 2, 70, 128), 70, True),
               ((1, 2, 33, 8), 90, False))


def check_flash(dtype, qshape, tk, causal) -> float:
    g = torch.Generator().manual_seed(1)
    B, H, Tq, D = qshape
    q = torch.randn(qshape, generator=g).to(DEV, dtype)
    k = torch.randn((B, H, tk, D), generator=g).to(DEV, dtype)
    v = torch.randn((B, H, tk, D), generator=g).to(DEV, dtype)
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_with_lse(q, k, v, causal, scale)
    ref, ref_lse = _reference_attention_lse(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Tq)
    err = (out.float() - ref.float()).abs().max().item()
    tag = f"flash {dtype} q{qshape} tk={tk} causal={causal}"
    assert err <= TOL[dtype], f"{tag}: max err {err}"
    dead = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), dead), f"{tag}: lse -inf rows"
    assert torch.all(lse[dead] < 0), f"{tag}: lse +inf"
    if dead.any():
        assert torch.all(out[dead] == 0), f"{tag}: masked rows not 0"
    lse_err = (lse[~dead] - ref_lse[~dead]).abs().max().item()
    assert lse_err <= 1e-4, f"{tag}: lse err {lse_err}"
    return err


def phase_kernels() -> dict:
    errs = {"paged_attention": {}, "flash_attention": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        e = [check_paged(dtype)]
        for D in (16, 32, 128):
            e.append(check_paged(dtype, B=3, H=2, D=D, bs=8, nbps=4))
        for bs in (1, 2, 64):
            e.append(check_paged(dtype, B=3, H=2, D=64, bs=bs, nbps=5))
        errs["paged_attention"][name] = max(e)
        errs["flash_attention"][name] = max(
            check_flash(dtype, *case) for case in FLASH_CASES)
    line = {"kernels": [
        {"name": k, "max_abs_err": v, "tol": {n: TOL[getattr(torch, n)]
                                              for n in v}}
        for k, v in errs.items()]}
    log(json.dumps(line))
    return errs


# ---------------------------------------------------------------- phase 4
@contextlib.contextmanager
def recording(module, name, keep):
    """Route ``module.name`` through a wrapper that hands each call's
    arguments to ``keep`` and then calls the real function — the main
    path still launches the kernel through its own wrapper; this only
    remembers the inputs it gave it, for phase 6."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        keep(args, kw)
        return real(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def _live_pages(tables, pos, bs):
    """Distinct pool blocks the lanes' walks read (pages 0..pos//bs)."""
    t, p = tables.cpu().numpy(), pos.cpu().numpy()
    return {int(t[b, j]) for b in range(t.shape[0])
            for j in range(int(p[b]) // bs + 1)}


def _build_net(dtype, num_layers, seed):
    cfg = dict(MODEL, num_layers=num_layers)
    net = TransformerLM(**cfg, dropout=0.0, device=DEV, seed=seed)
    return net.cast(dtype) if dtype != torch.float32 else net


def phase_main_path(smi: str) -> dict:
    t0 = time.perf_counter()
    net = _build_net(torch.bfloat16, MODEL["num_layers"], seed=0)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in net.parameters())
    log(f"main path: TransformerLM {MODEL} bf16, {nbytes / 1e9:.3f} GB of "
        f"weights, built in {time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(0)
    V = MODEL["vocab"]
    rec = {"flash": None, "step": [], "chunk": []}
    pools0 = []

    def keep_flash(args, kw):
        # the longest prefill of the phase (the warm-up call is shorter)
        if rec["flash"] is None \
                or args[0].shape[2] > rec["flash"][0][0].shape[2]:
            rec["flash"] = ([a.clone() for a in args[:3]], dict(kw))

    def keep_paged(args, kw):
        q, pk, pv, tables, pos = args
        if pk is not pools0[0][0]:
            return                          # layer 0's calls only
        kind = "step" if q.shape[0] == eng_batch else "chunk"
        rec[kind].append((q.clone(), tables.clone(), pos.clone()))

    eng_batch = 8
    # the counts start from 0 here and are read right after the phase
    _pa_fn.launches = 0
    _fa_fn.launches = 0
    with recording(gen_mod, "flash_attention", keep_flash), \
            recording(prog_mod, "paged_attention", keep_paged):
        # -- net.generate: B=8, P=128, N=32 (flash prefill + decode) --
        prompt = torch.from_numpy(rs.randint(0, V, (8, 128))).to(DEV)
        net.generate(prompt[:, :8], 2)                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net.generate(prompt, 32)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        assert out.shape == (8, 160) and out.dtype == torch.int32
        assert torch.equal(out[:, :128].long(), prompt)
        assert int(out.min()) >= 0 and int(out.max()) < V
        logits = net(prompt[:1, :64])
        assert logits.shape == (1, 64, V)
        assert torch.isfinite(logits.float()).all(), "non-finite logits"

        # -- the paged engine: 8 requests of 32..300 prompt tokens ----
        lens = np.linspace(32, 300, 8).astype(int)
        prompts = [rs.randint(0, V, (n,)).astype(np.int32) for n in lens]
        eng = ServingEngine(net, max_batch=eng_batch, block_size=16,
                            prefill_chunk=32)
        pools0.append((eng._programs.pool_k[0], eng._programs.pool_v[0]))
        try:
            eng.submit(prompts[0][:40], 2).result(timeout=300)  # warm-up
            t0 = time.perf_counter()
            reqs = [eng.submit(p, 32) for p in prompts]
            # the same prompt again once its blocks are registered: a
            # prefix-cache hit, co-batched with the rest
            deadline = time.monotonic() + 300
            while reqs[1].status != "running" and not reqs[1].finished:
                assert time.monotonic() < deadline, "request 1 stalled"
                time.sleep(0.001)
            dup = eng.submit(prompts[1], 32)
            toks = [r.result(timeout=600) for r in reqs]
            dup_toks = dup.result(timeout=600)
            eng_s = time.perf_counter() - t0
            st = eng.stats()
        finally:
            eng.close()
        for t in toks + [dup_toks]:
            assert len(t) == 32 and all(0 <= x < V for x in t)
        assert dup.cached_tokens > 0, "the second submission missed"
        assert dup_toks == toks[1], "prefix-cache hit differs from cold"
        # a request alone on a fresh engine (cold cache) equals its
        # co-batched run; the profiler watches this run for the card's
        # busy share
        with ServingEngine(net, max_batch=eng_batch, block_size=16,
                           prefill_chunk=32) as solo_eng:
            solo_eng.submit(prompts[0][:40], 2).result(timeout=300)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                solo = solo_eng.submit(prompts[5], 32).result(timeout=600)
                torch.cuda.synchronize()
                solo_s = time.perf_counter() - t0
        assert solo == toks[5], "solo run differs from co-batched run"
        busy = device_busy(prof, solo_s)
    torch.cuda.synchronize()
    launches = {name: k["fn"].launches for name, k in KERNELS.items()}
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"

    reqs_all = reqs + [dup]
    n_tok = sum(len(r.tokens) for r in reqs_all)
    ttft = sorted(r.ttft for r in reqs_all)
    tpot = sorted(r.tpot for r in reqs_all if r.tpot is not None)
    res = {
        "generate_tok_s": 8 * 32 / gen_s,
        "engine_tok_s": n_tok / eng_s,
        "ttft_p50_s": float(np.median(ttft)),
        "tpot_p50_s": float(np.median(tpot)),
        "engine_steps": st["steps"],
        "prefix_hits": st["prefix_cache"]["hits"],
        "launches": launches,
        "busy": busy,
        "rec": rec,
        "pools": pools0[0],                 # layer 0's, kept for phase 6
    }
    log(f"main path [{smi}]: generate B=8 P=128 N=32 {gen_s:.3f} s "
        f"({res['generate_tok_s']:.1f} tok/s); engine {n_tok} tokens over "
        f"{len(reqs_all)} requests in {eng_s:.3f} s "
        f"({res['engine_tok_s']:.1f} decoded tok/s, TTFT p50 "
        f"{res['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{res['tpot_p50_s'] * 1e3:.2f} ms, {st['steps']} steps, "
        f"{st['prefix_cache']['hits']} prefix hit(s)); launches {launches}")
    log(f"solo request ({len(prompts[5])}-token prompt, 32 tokens) under "
        f"the profiler [{smi}]: {solo_s:.3f} s wall, card busy "
        f"{busy['busy_s']:.4f} s = {busy['busy_share']:.3f} of the wall "
        f"(idle {1 - busy['busy_share']:.3f}), {busy['kernels']} kernels; "
        f"device ms by kernel: " + "; ".join(
            f"{n} {ms:.3f}" for n, ms in busy["top"]))
    return res


def device_busy(prof, wall_s: float) -> dict:
    """The card's busy time in a profiled window: the union of its
    kernel intervals, over the window's host wall time, and the kernels
    that took most of it."""
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kern, "the profiler saw no kernel on the card"
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"busy_s": busy_us * 1e-6, "busy_share": busy_us * 1e-6 / wall_s,
            "kernels": len(kern),
            "top": [(n[:60], us * 1e-3) for n, us in top]}


# ---------------------------------------------------------------- phase 5
def phase_parity() -> None:
    net = _build_net(torch.float32, 2, seed=1)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, MODEL["vocab"], (n,)).astype(np.int32)
               for n in (40, 77, 130, 200)]
    N = 16
    want = [net.generate(p[None, :], N)[0, len(p):].tolist()
            for p in prompts]
    with ServingEngine(net, max_batch=4, block_size=16,
                       prefill_chunk=32) as eng:
        reqs = [eng.submit(p, N) for p in prompts]
        got = [r.result(timeout=600) for r in reqs]
    n_equal = 0
    for p, w, g in zip(prompts, want, got):
        if w == g:
            n_equal += 1
            continue
        i = next(j for j in range(N) if w[j] != g[j])
        seq = torch.from_numpy(np.concatenate([p, w[:i]])).to(DEV)
        top2 = net(seq[None, :].long())[0, -1].topk(2).values
        gap = float(top2[0] - top2[1])
        assert gap < PARITY_GAP, (
            f"engine and generate differ at token {i} of a {len(p)}-token "
            f"prompt where the top-2 gap is {gap}")
        log(f"parity: prompt {len(p)} first differs at token {i}, top-2 "
            f"gap {gap:.2e} < {PARITY_GAP}")
    log(f"parity (f32, 2 layers): {n_equal}/{len(prompts)} prompts "
        f"token-equal over {N} tokens")


# ---------------------------------------------------------------- phase 6
def _busiest(calls, bs):
    return max(calls, key=lambda c: len(_live_pages(c[1], c[2], bs)))


def time_paged(res) -> dict:
    pk, pv = res["pools"]
    bs = pk.shape[2]
    out = {}
    for kind in ("step", "chunk"):
        q, tables, pos = _busiest(res["rec"][kind], bs)
        args = (q, pk, pv, tables, pos)
        err = (paged_attention(*args).float()
               - paged_attention_dense(*args).float()).abs().max().item()
        assert err <= TOL[q.dtype], f"paged at main-path inputs: err {err}"
        live = _live_pages(tables, pos, bs)
        H, D = pk.shape[1], pk.shape[3]
        page_bytes = H * bs * D * pk.element_size()
        nbytes = (2 * len(live) * page_bytes
                  + 2 * q.numel() * q.element_size()
                  + tables.numel() * 4 + pos.numel() * 4)
        slots = int((pos.long() + 1).sum())
        flops = 4 * slots * H * D
        bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype])
        out[kind] = {
            "shape": f"q {tuple(q.shape)} pool {tuple(pk.shape)} "
                     f"pos {pos.tolist()}",
            "max_abs_err": err,
            "ms": time_ms(lambda: paged_attention(*args)),
            "plain_ms": time_ms(lambda: paged_attention_dense(*args)),
            "bound_ms": bound * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / PEAK_FLOPS[q.dtype] else "operations"),
            "live_pages": len(live), "bytes": nbytes,
        }
    return out


def time_flash(res) -> dict:
    (q, k, v), kw = res["rec"]["flash"]
    causal = kw.get("causal", False)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    out, _ = flash_attention_with_lse(q, k, v, causal, scale)
    ref, _ = _reference_attention_lse(q, k, v, causal, scale)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[q.dtype], f"flash at main-path inputs: err {err}"
    if causal:
        rows = np.arange(Tq)
        pairs = int(np.clip(rows + (Tk - Tq) + 1, 0, Tk).sum())
    else:
        pairs = Tq * Tk
    flops = 4 * B * H * D * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + B * H * Tq * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    assert Tq == Tk or not causal     # SDPA's causal mask is top-left
    return {
        "shape": f"q {tuple(q.shape)} k {tuple(k.shape)} causal={causal}",
        "max_abs_err": err,
        "ms": time_ms(lambda: flash_attention_with_lse(q, k, v, causal,
                                                       scale)),
        "plain_ms": time_ms(lambda: _reference_attention_lse(q, k, v,
                                                             causal, scale)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale)),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "flops": flops, "bytes": nbytes,
    }


def main() -> int:
    smi = phase_device()
    phase_build()
    errs = phase_kernels()
    res = phase_main_path(smi)
    paged = time_paged(res)
    flash = time_flash(res)
    phase_parity()
    for kind, r in paged.items():
        log(f"paged_attention [{kind}] {r['shape']}: {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['live_pages']} live pages, {r['bytes']} B) [{smi}]")
    log(f"flash_attention {flash['shape']}: {flash['ms']:.4f} ms, plain "
        f"{flash['plain_ms']:.4f} ms, sdpa {flash['library_ms']:.4f} ms, "
        f"bound {flash['bound_ms']:.4f} ms ({flash['flops']} flop, "
        f"{flash['bytes']} B) [{smi}]")
    step = paged["step"]
    rows = []
    for name, t in (("paged_attention", step), ("flash_attention", flash)):
        k = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": res["launches"][name],
            "max_abs_err": max(max(errs[name].values()), t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms")})
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
