"""Autoregressive KV-cache generation for `models.TransformerLM`
(PyTorch/CUDA port of `incubator_mxnet_tpu/models/generation.py`: the
float path, the int8 weight path, `lm_score`, `lm_beam_search` and
`lm_stream`).

The JAX package compiles prefill plus the whole token loop into one XLA
program; PyTorch runs eagerly, so here the prefill is one pass over the
prompt and the token loop is a Python loop over `_decode_token`.  The
math is the JAX package's, helper for helper:

* `_prefill` runs the prompt with the training path's causal attention
  (`ops.flash_attention`, the hand-written CUDA kernel on the card);
* `_cached_self_attn` / `_decode_token` attend one token against the
  dense per-layer caches with plain torch ops — f32 scores, iota mask at
  ``finfo(f32).min``, f32 softmax and PV — as the JAX package leaves
  this math to XLA;
* sampling is counter-based: the draws at position ``t`` come from a
  stream seeded by ``(seed, t)`` alone (`random.counter_seed`), so a
  seeded run reproduces exactly.  Torch's streams are not JAX's: the
  same seed samples different tokens in the two packages.

The int8 weight path (`contrib.quantization.quantize_for_decode`):
`_gather_params` hands `_dense` an ``{"w8", "s"}`` dict for each
quantized layer, and `_dense` applies the per-channel scale to the
(..., out) result, never to the weight.  These products are XLA in the
JAX package, so here they are torch matmuls, in two forms:

* weight-only (``act_quant="none"``): JAX's ``dot_general(x, w8,
  preferred_element_type=f32)`` keeps an f32 accumulator before the
  scale.  A bf16 ``F.linear`` would round the sum to bf16 first, so the
  port keeps the f32 accumulator: on CUDA, for bf16/f16 activations,
  ``torch.mm(x, w8.to(x.dtype).T, out_dtype=torch.float32)`` (int8 to
  bf16 is exact, |w| <= 127); elsewhere f32 operands, which hold the
  same products exactly.  Measured on an H100 80GB HBM3 at 700 W
  (chip_smoke.py `check_int8_dense`, layer 0's 1024 -> 4096 FFN
  weight, bf16 activations, 8 and 32 rows): the out_dtype form within
  0.0027 and 0.0034 of the f32-operand form where the sums reach 5164
  and 6743 (f32 summation order, ~5e-7 relative), a bf16 ``F.linear``
  within 15.9 and 16.0 (~3e-3 relative, a bf16 rounding of the sum).
* dynamic (``act_quant="dynamic"``): per-row int8 activations and an
  exact INT8xINT8->INT32 product, then ``* (sx * s)``.  The product is
  ``torch._int_mm`` on the CPU, and on CUDA where its shape limits hold
  (more than 16 rows, both widths multiples of 8); elsewhere it is an
  f64 matmul, exact because every partial sum is an integer below
  2^53 (|sum| <= 127 * 127 * in_features).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..gluon.nn.basic_layers import layer_norm as _ln
from ..ops.flash_attention import flash_attention
from ..random import counter_seed

__all__ = ["lm_generate", "lm_beam_search", "lm_score", "lm_stream"]

_F32_MIN = torch.finfo(torch.float32).min


def _f32_product(x, w8):
    """x (..., in) times the int8 weight (out, in), transposed, with an
    f32 accumulator (the weight-only form; see the module docstring)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float16):
        acc = torch.mm(x2, w8.to(x.dtype).t(), out_dtype=torch.float32)
    else:
        acc = x2.float() @ w8.float().t()
    return acc.reshape(*x.shape[:-1], w8.shape[0])


def _int_product(xq, w8):
    """Exact int8 (M, in) x int8 (out, in) transposed, as f32 (M, out)."""
    M, K = xq.shape
    N = w8.shape[0]
    if xq.device.type == "cpu" or (M > 16 and K % 8 == 0 and N % 8 == 0):
        return torch._int_mm(xq, w8.t()).float()
    return (xq.double() @ w8.double().t()).float()


def _dense(x, w, b, out_dtype=None):
    """nn.Dense math on raw tensors: x @ W.T + b (weight is (out, in)).

    ``w`` is a float weight or a quantized-weight dict from
    `_gather_params` for a `quantize_for_decode`-marked net: ``{"w8":
    int8 (out, in), "s": f32 (out,)}`` (plus a ``"dyn"`` marker for
    dynamic activation quantization).  The quantized path applies the
    per-channel scale and the bias in f32 to the result, then casts."""
    if isinstance(w, dict):
        if "dyn" in w:
            xf = x.float()
            sx = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
            xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
            acc = _int_product(xq.reshape(-1, x.shape[-1]), w["w8"])
            y = acc.reshape(*x.shape[:-1], -1) * (sx * w["s"])
        else:
            y = _f32_product(x, w["w8"]) * w["s"]
        if b is not None:
            y = y + b.float()
        return y.to(x.dtype if out_dtype is None else out_dtype)
    y = F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))
    return y if out_dtype is None else y.to(out_dtype)


def _qkv_heads(qkv, H):
    """(..., 3C) -> three (..., H, D) tensors, the MHA split order."""
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    D = q.shape[-1] // H
    shp = q.shape[:-1] + (H, D)
    return q.reshape(shp), k.reshape(shp), v.reshape(shp)


def _activation(h, act):
    """The FFN activation: tanh-approximate gelu in f32, else relu."""
    if act == "gelu":
        return F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return F.relu(h)


def _quant_config(net, quantized):
    """The decode-quantization state a call uses: ``quantized=None``
    takes whatever `quantize_for_decode` attached (the float path if
    nothing), True requires it, False forces the float path."""
    qc = getattr(net, "_decode_quant", None)
    if quantized is False:
        return None
    if quantized and qc is None:
        raise ValueError(
            "quantized=True but the net has no decode-quantization state: "
            "run contrib.quantization.quantize_for_decode(net) first")
    return qc


def _decode_path(qc) -> str:
    """Which weight path a call runs: "int8" or "float"."""
    return "int8" if qc is not None else "float"


def _gather_params(net, qc=None):
    """The live parameter tensors in the JAX package's pytree layout;
    with a `DecodeQuantConfig` ``qc``, its target layers' weights come
    out as int8 + scale dicts (re-quantized here if they changed)."""
    def wb(layer):
        if qc is not None:
            packed = qc.packed(layer)
            if packed is not None:
                return packed, layer.bias
        return layer.weight, layer.bias

    layers = [{"ln1": (lyr.ln1.gamma, lyr.ln1.beta),
               "qkv": wb(lyr.attn.qkv),
               "proj": wb(lyr.attn.proj),
               "ln2": (lyr.ln2.gamma, lyr.ln2.beta),
               "ffn1": wb(lyr.ffn.ffn_dense1),
               "ffn2": wb(lyr.ffn.ffn_dense2)} for lyr in net._layers]
    return {"embed": net.embed.weight, "pe": net._pe,
            "ln": (net.ln.gamma, net.ln.beta), "head": wb(net.head),
            "layers": layers}


def _embed(params, toks, positions):
    """Token embedding · sqrt(C) plus the positional encoding at
    ``positions`` (an int or a tensor of positions, each below
    ``max_len``: callers that step past the sequence clamp first)."""
    emb = params["embed"]
    return (emb[toks.long()] * math.sqrt(emb.shape[1])
            + params["pe"][positions].to(emb.dtype))


def _ffn_fwd(x, lp, act):
    return _dense(_activation(_dense(x, *lp["ffn1"]), act), *lp["ffn2"])


def _logits_of(params, h_last):
    return _dense(_ln(h_last, *params["ln"]), *params["head"],
                  out_dtype=torch.float32)


def _prefill(params, prompt, acts, H, pad_to, return_h=False):
    """Run the prompt with the training path's causal attention; returns
    (h_last (B, C) at the final prompt position, per-layer K/V caches
    (B, H, pad_to, D)).  ``return_h`` returns the whole (B, P, C) hidden
    states and no caches instead (`lm_score`'s teacher-forced pass)."""
    B, P = prompt.shape
    emb = params["embed"]
    C = emb.shape[1]
    h = _embed(params, prompt, torch.arange(P, device=emb.device))
    kcs, vcs = [], []
    for lp, act in zip(params["layers"], acts):
        x = _ln(h, *lp["ln1"])
        q, k, v = _qkv_heads(_dense(x, *lp["qkv"]), H)   # (B, P, H, D)
        kt = k.transpose(1, 2).contiguous()               # (B, H, P, D)
        vt = v.transpose(1, 2).contiguous()
        a = flash_attention(q.transpose(1, 2).contiguous(), kt, vt,
                            causal=True).transpose(1, 2)
        h = h + _dense(a.reshape(B, P, C), *lp["proj"])
        h = h + _ffn_fwd(_ln(h, *lp["ln2"]), lp, act)
        if return_h:
            continue
        kc = kt.new_zeros((B, H, pad_to, kt.shape[-1]))
        vc = vt.new_zeros((B, H, pad_to, vt.shape[-1]))
        kc[:, :, :P] = kt
        vc[:, :, :P] = vt
        kcs.append(kc)
        vcs.append(vc)
    if return_h:
        return h, None, None
    return h[:, -1], kcs, vcs


def _cached_self_attn(lp, h, kcache, vcache, t, H):
    """The cached one-token self-attention sub-step: pre-LN, qkv, cache
    write at position t (in place: the caches are this call's state,
    where the JAX scan threads them through its carry), f32 iota-masked
    scores and softmax, PV product, output projection."""
    Bp, C = h.shape
    D = C // H
    x = _ln(h, *lp["ln1"])
    q, k, v = _qkv_heads(_dense(x, *lp["qkv"]), H)        # (B', H, D)
    kcache[:, :, t] = k
    vcache[:, :, t] = v
    s = torch.einsum("bhd,bhkd->bhk", q.float(),
                     kcache.float()) / math.sqrt(D)
    pos = torch.arange(s.shape[-1], device=s.device)
    s = torch.where(pos <= t, s, _F32_MIN)
    p = torch.softmax(s, dim=-1)
    a = torch.einsum("bhk,bhkd->bhd", p, vcache.float()).to(h.dtype)
    return h + _dense(a.reshape(Bp, C), *lp["proj"])


def _decode_token(params, acts, kcaches, vcaches, tok, t, H):
    """One transformer step for token ``tok`` (B,) at position ``t``
    against the per-layer caches; returns f32 logits (B, V)."""
    h = _embed(params, tok, t)
    for li, (lp, act) in enumerate(zip(params["layers"], acts)):
        h = _cached_self_attn(lp, h, kcaches[li], vcaches[li], t, H)
        h = h + _ffn_fwd(_ln(h, *lp["ln2"]), lp, act)
    return _logits_of(params, h)


def _top_k_logits(logits, temperature, top_k):
    """Temperature-scaled logits with everything below the k-th largest
    pushed to ``finfo(f32).min``."""
    lg = logits / temperature
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, _F32_MIN, lg)
    return lg


def _gumbel(shape, stream_seed: int, device):
    """Gumbel noise from the counter-based stream ``stream_seed``;
    argmax(logits + noise) samples softmax(logits)."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed)
    u = torch.rand(shape, generator=g, device=device)
    return -torch.log(-torch.log(u))


def _make_pick(temperature, top_k):
    """Batch token pick: greedy argmax at temperature <= 0, else
    top-k-truncated sampling from the stream of (seed, t)."""
    def pick(logits, t, seed):
        if temperature <= 0.0:
            return logits.argmax(dim=-1)
        lg = _top_k_logits(logits, temperature, top_k)
        noise = _gumbel(lg.shape, counter_seed(seed, t), lg.device)
        return (lg + noise).argmax(dim=-1)

    return pick


def _greedy_loop(first_logits, step_fn, pick, seed, t0, N, eos_id):
    """Emit N tokens at positions t0 .. t0+N-1: the first from
    ``first_logits``, the rest from ``step_fn(tok, t) -> logits``.
    eos_id >= 0 freezes a finished row at eos.  Returns (B, N)."""
    tok = pick(first_logits, t0 - 1, seed)
    done = tok == eos_id
    out = [tok]
    for t in range(t0, t0 + N - 1):
        nxt = pick(step_fn(tok, t), t, seed)
        if eos_id >= 0:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


def _as_tokens(prompt, device):
    if isinstance(prompt, torch.Tensor):
        return prompt.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(prompt, np.int64), device=device)


@torch.no_grad()
def lm_generate(net, prompt, max_new_tokens: int, *, temperature: float = 0.0,
                top_k: int = 0, eos_id: int = -1, seed: int = 0,
                quantized=None, pad_to_bucket: bool = False):
    """Generate ``max_new_tokens`` continuations of ``prompt`` with the
    `models.TransformerLM` ``net`` on the net's device.

    prompt: int (B, P) tensor or array.  temperature=0 → greedy argmax;
    temperature>0 samples (optionally top_k-truncated) from the
    counter-based streams of ``seed``.  eos_id >= 0 freezes a sequence
    at eos (further positions emit eos_id).  Returns an int32 (B, P+N)
    tensor — the prompt followed by the generated tokens.

    ``quantized``: None (default) takes the int8 weight path iff
    `contrib.quantization.quantize_for_decode(net)` was applied; True
    requires it; False forces the float path.

    ``pad_to_bucket`` is accepted for the JAX signature: the JAX
    package pads to bound its compiled-program cache, and its output is
    token-identical either way, so eager PyTorch runs the exact shape.
    """
    prompt = _as_tokens(prompt, net.embed.weight.device)
    B, P = prompt.shape
    N = int(max_new_tokens)
    if N < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {N}")
    if P + N > net._max_len:
        raise ValueError(
            f"prompt+new = {P + N} exceeds max_len {net._max_len}")
    H = net._layers[0].attn._num_heads
    acts = tuple(lyr.ffn._act for lyr in net._layers)
    params = _gather_params(net, _quant_config(net, quantized))
    pick = _make_pick(float(temperature), int(top_k))
    h_last, kcs, vcs = _prefill(params, prompt, acts, H, P + N)

    def step_fn(tok, t):
        return _decode_token(params, acts, kcs, vcs, tok, t, H)

    gen = _greedy_loop(_logits_of(params, h_last), step_fn, pick, int(seed),
                       P, N, int(eos_id))
    return torch.cat([prompt, gen], dim=1).to(torch.int32)


@torch.no_grad()
def lm_score(net, tokens, *, quantized=None):
    """Teacher-forced log-probabilities of ``tokens`` (B, T) under the
    decode stack's numerics (the int8 weight path as ``quantized``
    selects, as in `lm_generate`): f32 (B, T-1), the log-probability of
    ``tokens[:, 1:]`` given each prefix.  The perplexity oracle of the
    quantization quality contract (``exp(-mean(lm_score(...)))``)."""
    tokens = _as_tokens(tokens, net.embed.weight.device)
    B, T = tokens.shape
    if T < 2:
        raise ValueError(f"need >= 2 tokens to score, got {T}")
    if T > net._max_len:
        raise ValueError(f"sequence {T} exceeds max_len {net._max_len}")
    H = net._layers[0].attn._num_heads
    acts = tuple(lyr.ffn._act for lyr in net._layers)
    params = _gather_params(net, _quant_config(net, quantized))
    h, _, _ = _prefill(params, tokens, acts, H, T, return_h=True)
    logits = _dense(_ln(h, *params["ln"]), *params["head"],
                    out_dtype=torch.float32)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return logp.gather(2, tokens[:, 1:, None])[..., 0]


def lm_stream(net, prompt, max_new_tokens: int, *, engine=None,
              deadline=None, seed: int = 0, **engine_kw):
    """Stream generated tokens one at a time through the net's shared
    continuous-batching engine (`serving.default_engine`): yields int
    token ids as the engine emits them, so concurrent callers are
    co-batched into one decode step instead of running serial
    `lm_generate` calls.

    Abandoning the generator mid-stream (break / close / GC) cancels the
    request and returns its KV blocks to the pool.  ``deadline``
    (seconds) bounds the request end to end: past it the engine evicts
    the sequence and the generator raises `serving.RequestTimedOut`.
    ``engine_kw`` (temperature, top_k, eos_id, max_batch, ...)
    configures the shared engine on first use; ``engine=`` targets an
    explicit `ServingEngine`.
    """
    from ..serving import default_engine

    eng = engine if engine is not None else default_engine(net, **engine_kw)
    return eng.submit(prompt, max_new_tokens, deadline=deadline,
                      seed=seed).stream()


# the score of a finished beam's non-eos continuations
_NEG = -1e9


def _top_k_by_index(x, k):
    """The k largest entries of each row of ``x`` and their indices,
    ties to the lower index (``jax.lax.top_k``'s order; `torch.topk`
    promises none, and finished beams tie at ``_NEG`` by the
    thousand)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_loop(first_logits, kcs, vcs, step_fn, t0, N, B, K, eos_id, alpha):
    """K-beam token loop: the K·V candidate expansion each step, the
    per-layer caches reordered by beam parent each step, and the
    sequences rebuilt by walking the (token, parent) trace backwards.
    ``kcs``/``vcs`` are the batch-B caches (repeated K-fold here;
    ``step_fn(kcs, vcs, tok, t)`` runs at batch B·K and writes position
    ``t``).  Emits N tokens at positions t0 .. t0+N-1.  Returns (gen
    (B, K, N) best-first, normalized scores (B, K))."""
    logp0 = torch.log_softmax(first_logits, dim=-1)          # (B, V)
    V = logp0.shape[-1]
    scores, tok = _top_k_by_index(logp0, K)                  # (B, K)
    tok0 = tok
    # beams live as (B*K, ...)
    kcs = [c.repeat_interleave(K, dim=0) for c in kcs]
    vcs = [c.repeat_interleave(K, dim=0) for c in vcs]
    done = tok == eos_id if eos_id >= 0 else torch.zeros_like(tok, dtype=bool)
    lens = torch.ones_like(tok)                  # generated tokens so far
    frozen = None
    if eos_id >= 0:
        # a finished beam may only extend with eos, at no cost: its
        # score and length freeze
        frozen = torch.full((V,), _NEG, device=logp0.device)
        frozen[eos_id] = 0.0
    toks, parents = [], []
    base = torch.arange(B, device=tok.device)[:, None] * K
    for t in range(t0, t0 + N - 1):
        logits = step_fn(kcs, vcs, tok.reshape(B * K), t)
        logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        if frozen is not None:
            logp = torch.where(done[..., None], frozen, logp)
        cand = scores[..., None] + logp                      # (B, K, V)
        scores, idx = _top_k_by_index(cand.reshape(B, K * V), K)
        parent = idx // V
        tok = idx % V
        gidx = (base + parent).reshape(B * K)
        kcs = [c.index_select(0, gidx) for c in kcs]
        vcs = [c.index_select(0, gidx) for c in vcs]
        pdone = done.gather(1, parent)
        plens = lens.gather(1, parent)
        if eos_id >= 0:
            done = pdone | (tok == eos_id)
            lens = torch.where(pdone, plens, plens + 1)
        else:
            done, lens = pdone, plens + 1
        toks.append(tok)
        parents.append(parent)

    # backtrack: follow the parent pointers from the final beams to the
    # first expansion
    ptr = torch.arange(K, device=tok.device).expand(B, K)
    rest = []
    for tk, par in zip(reversed(toks), reversed(parents)):
        rest.append(tk.gather(1, ptr))
        ptr = par.gather(1, ptr)
    gen = torch.stack([tok0.gather(1, ptr)] + rest[::-1], dim=2)

    # GNMT length penalty: rank by score / ((5+len)/6)^alpha
    norm = scores / (((5.0 + lens.float()) / 6.0) ** alpha) \
        if alpha > 0.0 else scores
    order = torch.sort(-norm, dim=1, stable=True).indices
    gen = gen.gather(1, order[..., None].expand_as(gen))
    return gen, norm.gather(1, order)


@torch.no_grad()
def lm_beam_search(net, prompt, max_new_tokens: int, *, beam_size: int = 4,
                   eos_id: int = -1, alpha: float = 0.0, quantized=None):
    """K-beam search decode for `models.TransformerLM` on the net's
    device: the prompt prefilled once through the flash kernel, then
    `_beam_loop` over `_decode_token` at batch B·K.

    prompt: int (B, P).  Returns (sequences, scores): int32
    (B, beam_size, P+N) sorted best-first, and f32 (B, beam_size)
    cumulative log-probabilities (GNMT length-penalty-normalized when
    ``alpha > 0``; eos_id >= 0 freezes finished beams' scores and
    lengths).  beam_size=1 reproduces greedy `lm_generate`.
    ``quantized`` selects the weight path as in `lm_generate`.
    """
    prompt = _as_tokens(prompt, net.embed.weight.device)
    B, P = prompt.shape
    N = int(max_new_tokens)
    K = int(beam_size)
    if N < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {N}")
    if K < 1:
        raise ValueError(f"beam_size must be >= 1, got {K}")
    V = net.head.weight.shape[0]
    if K > V:
        raise ValueError(f"beam_size {K} exceeds vocab {V}")
    if P + N > net._max_len:
        raise ValueError(
            f"prompt+new = {P + N} exceeds max_len {net._max_len}")
    H = net._layers[0].attn._num_heads
    acts = tuple(lyr.ffn._act for lyr in net._layers)
    params = _gather_params(net, _quant_config(net, quantized))
    h_last, kcs, vcs = _prefill(params, prompt, acts, H, P + N)

    def step_fn(kc, vc, tok, t):
        return _decode_token(params, acts, kc, vc, tok, t, H)

    gen, norm = _beam_loop(_logits_of(params, h_last), kcs, vcs, step_fn,
                           P, N, B, K, int(eos_id), float(alpha))
    seqs = torch.cat([prompt[:, None].expand(B, K, P), gen], dim=2)
    return seqs.to(torch.int32), norm
