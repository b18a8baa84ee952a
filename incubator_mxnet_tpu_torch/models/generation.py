"""Autoregressive KV-cache generation for `models.TransformerLM`
(PyTorch/CUDA port of `incubator_mxnet_tpu/models/generation.py`: the
float path, the int8 weight path, `lm_score`, `lm_beam_search` and
`lm_stream`).

The JAX package compiles prefill plus the whole token loop into one XLA
program, cached per signature on the net.  Here the same signature keys
a `_GenerateProgram` (`_BeamProgram` for beam search) in a per-net LRU
(`_program_cache`, cap 32, ``net._gen_program_cache_cap``): a prefill
program and a one-token decode-step program over static KV caches, each
captured once into a CUDA graph and replayed after that (`_graphs`).
The position ``t`` rides in a device scalar that the step advances
itself, so one graph serves every token.  ``pad_to_bucket=True`` shapes
the program for the prompt's power-of-two bucket (`bucket_length`) and
carries the true length in, as the JAX package does.  The weights are
gathered once per `_params_fingerprint` (storage, in-place version and
casts of every tensor, and the int8 state's `cache_key`); a graph is
keyed on the gathered tensors' addresses, so a write that moves one
recaptures.  On the CPU the same bodies run eagerly on the same
buffers.  The math is the JAX package's, helper for helper:

* `_prefill` runs the prompt with the training path's causal attention
  (`ops.flash_attention`, the hand-written CUDA kernel on the card);
* `_cached_self_attn` / `_decode_token` attend one token against the
  dense per-layer caches with plain torch ops — f32 scores, iota mask at
  ``finfo(f32).min``, f32 softmax and PV — as the JAX package leaves
  this math to XLA;
* sampling is counter-based: the draws at position ``t`` come from a
  stream seeded by ``(seed, t)`` alone (`random.counter_seed`), so a
  seeded run reproduces exactly.  Torch's streams are not JAX's: the
  same seed samples different tokens in the two packages.  A
  ``torch.Generator`` seeded on the host cannot be captured, so a
  sampled pick runs between step replays; a greedy pick (and the eos
  freeze) runs inside the step's graph.

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
import os
import threading
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from .. import _graphs
from ..gluon.nn.basic_layers import layer_norm as _ln
from ..ops.flash_attention import flash_attention
from ..random import counter_seed

__all__ = ["lm_generate", "lm_beam_search", "lm_score", "lm_stream",
           "nmt_translate", "bucket_length"]

_F32_MIN = torch.finfo(torch.float32).min

# LRU caps of the per-net program cache and of the gathered weights
# (one entry per weight path); override per net with
# ``net._gen_program_cache_cap``
_PROGRAM_CACHE_CAP = int(os.environ.get("MXTPU_GEN_PROGRAM_CACHE", "32"))
_PARAMS_CACHE_CAP = 4
# LRU cap of a long-context net's positional tables, one per width;
# override per net with ``net._pe_cache_cap``
_PE_CACHE_CAP = int(os.environ.get("MXTPU_GEN_PE_CACHE", "8"))
_gather_lock = threading.Lock()


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


def _pe_table(net, width):
    """A long-context net's (``_pe is None``) positional table of
    ``width`` rows, built once per width on its device and kept in a
    per-net LRU (``net._pe_cache``, cap ``net._pe_cache_cap``), as the
    JAX package keeps it: only the rows a decode program reads are ever
    built."""
    cache = getattr(net, "_pe_cache", None)
    if cache is None:
        cache = net._pe_cache = OrderedDict()
    pe = _lru_touch(cache, width)
    if pe is None:
        from .transformer import positional_encoding

        pe = _lru_put(cache, width, positional_encoding(
            width, net._units, device=net.embed.weight.device),
            getattr(net, "_pe_cache_cap", _PE_CACHE_CAP))
    return pe


def _gather_params(net, qc=None, pe_width=None):
    """The live parameter tensors in the JAX package's pytree layout;
    with a `DecodeQuantConfig` ``qc``, its target layers' weights come
    out as int8 + scale dicts (re-quantized here if they changed).  A
    long-context net's positional table is `_pe_table` of ``pe_width``
    rows (the positions the caller reads)."""
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
    pe = net._pe if net._pe is not None else _pe_table(net, pe_width)
    return {"embed": net.embed.weight, "pe": pe,
            "ln": (net.ln.gamma, net.ln.beta), "head": wb(net.head),
            "layers": layers}


def _params_fingerprint(net, qc=None, tensors=None):
    """Key over the tensors `_gather_params` reads.  The JAX package keys
    on buffer identity, because its updates replace buffers; PyTorch
    writes in place and ``cast()`` may reuse an address, so each tensor
    contributes its storage address, in-place version, ``Block.cast``
    count and dtype, and the int8 state its `cache_key`.  A change means
    the gathered tree (and the int8 copies in it) may be stale.  A write
    through ``param.data`` bumps none of these: the float tree reads it
    in place, and the int8 copies follow at the next
    `quantize_for_decode`.  Every program call computes it, so it walks
    the layers `_gather_params` reads (a third of the cost of
    ``net.parameters()``)."""
    return (tuple((t.data_ptr(), t._version, getattr(t, "_casts", 0),
                   t.dtype) for t in (tensors or _param_tensors)(net)),
            None if qc is None else qc.cache_key())


def _param_tensors(net):
    """The tensors `_gather_params` reads: every parameter of the net
    and the positional-encoding table where it keeps one."""
    head = net.head
    ts = [net.embed.weight, net._pe, net.ln.gamma, net.ln.beta,
          head.weight, head.bias]
    for lyr in net._layers:
        attn, ffn = lyr.attn, lyr.ffn
        ts += [lyr.ln1.gamma, lyr.ln1.beta, attn.qkv.weight, attn.qkv.bias,
               attn.proj.weight, attn.proj.bias, lyr.ln2.gamma,
               lyr.ln2.beta, ffn.ffn_dense1.weight, ffn.ffn_dense1.bias,
               ffn.ffn_dense2.weight, ffn.ffn_dense2.bias]
    return [t for t in ts if t is not None]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _params_sig(params):
    """What a captured program bakes in of a gathered tree: each
    tensor's address, dtype, shape and device."""
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.device)
                 for t in _leaves(params))


def _gathered(net, qc, gather=None, tensors=None, pe_width=None):
    """(`_gather_params(net, qc, pe_width)`, its `_params_sig`), gathered
    once per `_params_fingerprint` and cached on the net per weight path
    (and per positional width for a net without a table; the JAX
    package's ``PagedPrograms.gather_params``); ``gather`` and
    ``tensors`` name another model family's gather and the tensors it
    reads (`_gather_nmt_params`, `_nmt_param_tensors`)."""
    with _gather_lock:
        cache = getattr(net, "_gen_params", None)
        if cache is None:
            cache = net._gen_params = OrderedDict()
        key = None if qc is None else qc.cache_key()
        if gather is None and net._pe is None:
            # a net without a table: one tree a positional width
            key = (key, int(pe_width))
        fp = _params_fingerprint(net, qc, tensors)
        ent = _lru_touch(cache, key)
        if ent is None or ent[0] != fp:
            params = gather(net, qc) if gather is not None \
                else _gather_params(net, qc, pe_width)
            ent = _lru_put(cache, key, (fp, params, _params_sig(params)),
                           _PARAMS_CACHE_CAP)
        return ent[1], ent[2]


def _lru_touch(cache, key):
    """LRU read: returns cache[key] (refreshing recency) or None."""
    val = cache.get(key)
    if val is not None:
        cache.move_to_end(key)
    return val


def _lru_put(cache, key, val, cap):
    """LRU insert with eviction beyond ``cap``."""
    cache[key] = val
    while len(cache) > max(1, int(cap)):
        cache.popitem(last=False)
    return val


def _program_cache(net):
    cache = getattr(net, "_gen_programs", None)
    if cache is None:
        cache = net._gen_programs = OrderedDict()
    return cache


def _cache_program(net, sig, prog):
    return _lru_put(_program_cache(net), sig, prog,
                    getattr(net, "_gen_program_cache_cap", _PROGRAM_CACHE_CAP))


def _net_pool(net):
    """The graph pool of the net's ``generate``/``beam_search`` (or
    ``translate``) programs."""
    dev = next(net.parameters()).device
    pool = getattr(net, "_graph_pool", None)
    if pool is None or pool.device != dev:
        pool = net._graph_pool = _graphs.Pool(dev)
    return pool


def bucket_length(n: int, *, floor: int = 16) -> int:
    """Prompt-length bucketing rule: the smallest power of two >=
    max(n, floor).  ``lm_generate(..., pad_to_bucket=True)`` captures
    one program per BUCKET (the true length rides in as a device
    scalar), so variable-length traffic keeps the program cache at
    O(#buckets) instead of O(#distinct lengths)."""
    if n < 0:
        raise ValueError(f"length must be >= 0, got {n}")
    b = max(1, int(floor))
    while b < n:
        b *= 2
    return b


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


def _prefill(params, prompt, acts, H, pad_to, return_h=False,
             valid_len=None, caches=None):
    """Run the prompt with the training path's causal attention; returns
    (h_last (B, C) at the final prompt position, per-layer K/V caches
    (B, H, pad_to, D)).  ``return_h`` returns the whole (B, P, C) hidden
    states and no caches instead (`lm_score`'s teacher-forced pass).

    ``valid_len`` (a (1,) int64 tensor) reads h_last at ``valid_len - 1``
    of a right-padded prompt: under the causal mask every position below
    it computes its unpadded value, and decode overwrites the pad slots
    as it goes.  ``caches`` (per-layer K and V lists) are written in
    place instead of allocated, zero past the prompt; a cache of
    ``R·B`` rows takes each row's K/V R times (beam search's K-fold
    beams)."""
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
        if caches is None:
            kc = kt.new_zeros((B, H, pad_to, kt.shape[-1]))
            vc = vt.new_zeros((B, H, pad_to, vt.shape[-1]))
        else:
            kc, vc = caches[0][len(kcs)], caches[1][len(vcs)]
            rep = kc.shape[0] // B
            if rep > 1:
                kt = kt.repeat_interleave(rep, dim=0)
                vt = vt.repeat_interleave(rep, dim=0)
            kc[:, :, P:].zero_()
            vc[:, :, P:].zero_()
        kc[:, :, :P] = kt
        vc[:, :, :P] = vt
        kcs.append(kc)
        vcs.append(vc)
    if return_h:
        return h, None, None
    if valid_len is None:
        return h[:, -1], kcs, vcs
    return h.index_select(1, valid_len - 1)[:, 0], kcs, vcs


def _cached_self_attn(lp, h, kcache, vcache, t, H):
    """The cached one-token self-attention sub-step: pre-LN, qkv, cache
    write at position ``t`` ((1,) int64 on the card; in place: the
    caches are this call's state, where the JAX scan threads them
    through its carry), f32 iota-masked scores and softmax, PV product,
    output projection."""
    Bp, C = h.shape
    D = C // H
    x = _ln(h, *lp["ln1"])
    q, k, v = _qkv_heads(_dense(x, *lp["qkv"]), H)        # (B', H, D)
    kcache.index_copy_(2, t, k[:, :, None])
    vcache.index_copy_(2, t, v[:, :, None])
    s = torch.einsum("bhd,bhkd->bhk", q.float(),
                     kcache.float()) / math.sqrt(D)
    pos = torch.arange(s.shape[-1], device=s.device)
    s = torch.where(pos <= t, s, _F32_MIN)
    p = torch.softmax(s, dim=-1)
    a = torch.einsum("bhk,bhkd->bhd", p, vcache.float()).to(h.dtype)
    return h + _dense(a.reshape(Bp, C), *lp["proj"])


def _decode_token(params, acts, kcaches, vcaches, tok, t, H):
    """One transformer step for token ``tok`` (B,) at position ``t``, a
    (1,) int64 tensor on the card (a captured step reads its position
    there: a Python int would be baked into the graph), against the
    per-layer caches; returns f32 logits (B, V)."""
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


# the score of a finished beam's non-eos continuations
_NEG = -1e9


def _top_k_by_index(x, k):
    """The k largest entries of each row of ``x`` and their indices,
    ties to the lower index (``jax.lax.top_k``'s order; `torch.topk`
    promises none, and finished beams tie at ``_NEG`` by the
    thousand)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _DecodeLoop:
    """The token loop shared by the decode programs (`_GenerateProgram`,
    `_BeamProgram`, `_TranslateProgram`): the greedy pick inside a step's
    graph, the sampled loop between replays, and the beam state, its
    first expansion, its step and its backtrack.  A subclass holds the
    static state these read (``_tok``, ``_done``, ``_out``, ``_t``,
    ``_i``, ``_eos``, ``_N``; for beams ``_B``, ``_K``, ``_V``,
    ``_alpha`` and the self-attention caches ``_kcs``/``_vcs``)."""

    def _greedy_advance(self, logits) -> None:
        """A greedy step's pick inside its graph: argmax, the eos
        freeze, the token written at the device index ``_i`` of the
        output and fed to the next step."""
        nxt = logits.argmax(dim=-1)
        if self._eos >= 0:
            nxt = torch.where(self._done, torch.full_like(nxt, self._eos),
                              nxt)
            self._done.copy_(self._done | (nxt == self._eos))
        self._out.index_copy_(1, self._i, nxt[:, None])
        self._tok.copy_(nxt)
        self._i.add_(1)

    def _sample_loop(self, psig, first, t0, seed):
        """A sampled decode: the pick at position ``t0 - 1`` from the
        first logits, then one step replay a token, each pick between
        replays from the host-seeded stream of ``(seed, t)``; returns
        (B, N) tokens."""
        tok = self._pick(first, t0 - 1, seed)
        done = tok == self._eos
        out = [tok]
        for t in range(t0, t0 + self._N - 1):
            self._tok.copy_(tok)
            (logits,) = self._step_prog.run(psig)
            nxt = self._pick(logits, t, seed)
            if self._eos >= 0:
                nxt = torch.where(done, torch.full_like(nxt, self._eos),
                                  nxt)
                done = done | (nxt == self._eos)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1)

    def _beam_state(self, dev) -> None:
        """A beam program's static state besides its caches: scores,
        tokens, finished flags and lengths (B, K), the (token, parent)
        trace of the N-1 steps, the device position and step index."""
        B, K = self._B, self._K
        long = dict(dtype=torch.long, device=dev)
        self._scores = torch.zeros((B, K), dtype=torch.float32, device=dev)
        self._tok = torch.zeros((B, K), **long)
        self._tok0 = torch.zeros((B, K), **long)
        self._done = torch.zeros((B, K), dtype=torch.bool, device=dev)
        self._lens = torch.zeros((B, K), **long)
        steps = max(self._N - 1, 1)
        self._toks = torch.zeros((steps, B, K), **long)
        self._parents = torch.zeros((steps, B, K), **long)
        self._t = torch.zeros((1,), **long)
        self._i = torch.zeros((1,), **long)
        self._base = torch.arange(B, device=dev)[:, None] * K
        self._frozen = None
        if self._eos >= 0:
            # a finished beam may only extend with eos, at no cost: its
            # score and length freeze
            self._frozen = torch.full((self._V,), _NEG, device=dev)
            self._frozen[self._eos] = 0.0

    def _beam_start(self, logits0, t0):
        """The first K expansions from the (B, V) logits at position
        ``t0 - 1``; the steps continue at ``t0``."""
        logp0 = torch.log_softmax(logits0, dim=-1)
        scores, tok = _top_k_by_index(logp0, self._K)
        self._scores.copy_(scores)
        self._tok.copy_(tok)
        self._tok0.copy_(tok)
        self._done.copy_(tok == self._eos if self._eos >= 0
                         else torch.zeros_like(self._done))
        self._lens.fill_(1)
        self._t.fill_(t0)
        self._i.zero_()
        return (scores,)

    def _beam_advance(self, logits):
        """One beam step from the (B·K, V) logits: the K·V candidate
        expansion, the caches reordered by beam parent in place, the
        (token, parent) trace written at the device step index."""
        B, K, V = self._B, self._K, self._V
        logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        if self._frozen is not None:
            logp = torch.where(self._done[..., None], self._frozen, logp)
        cand = self._scores[..., None] + logp                 # (B, K, V)
        scores, idx = _top_k_by_index(cand.reshape(B, K * V), K)
        parent = idx // V
        tok = idx % V
        gidx = (self._base + parent).reshape(B * K)
        for c in self._kcs + self._vcs:
            c.copy_(c.index_select(0, gidx))
        pdone = self._done.gather(1, parent)
        plens = self._lens.gather(1, parent)
        if self._eos >= 0:
            self._done.copy_(pdone | (tok == self._eos))
            self._lens.copy_(torch.where(pdone, plens, plens + 1))
        else:
            self._done.copy_(pdone)
            self._lens.copy_(plens + 1)
        self._scores.copy_(scores)
        self._tok.copy_(tok)
        self._toks.index_copy_(0, self._i, tok[None])
        self._parents.index_copy_(0, self._i, parent[None])
        self._t.add_(1)
        self._i.add_(1)
        return (scores,)

    def _beam_finish(self):
        """(gen (B, K, N) best-first, normalized scores (B, K)) from the
        trace: follow the parent pointers from the final beams back to
        the first expansion, then rank by the GNMT length penalty."""
        B, K, N = self._B, self._K, self._N
        ptr = torch.arange(K, device=self._tok.device).expand(B, K)
        rest = []
        for s in reversed(range(N - 1)):
            rest.append(self._toks[s].gather(1, ptr))
            ptr = self._parents[s].gather(1, ptr)
        gen = torch.stack([self._tok0.gather(1, ptr)] + rest[::-1], dim=2)
        scores, alpha = self._scores, self._alpha
        norm = scores / (((5.0 + self._lens.float()) / 6.0) ** alpha) \
            if alpha > 0.0 else scores
        order = torch.sort(-norm, dim=1, stable=True).indices
        gen = gen.gather(1, order[..., None].expand_as(gen))
        return gen, norm.gather(1, order)


class _GenerateProgram(_DecodeLoop):
    """`lm_generate`'s programs for one signature (B, Pp, N, sampling,
    eos, weight path, bucketing): ``decode_prefill`` runs the (padded)
    prompt through the flash kernel into static per-layer caches
    (B, H, Pp+N, D) and picks the first token, and ``decode_step`` runs
    one token at the device position ``t`` and advances it.  Greedy, the
    step also takes the argmax, applies the eos freeze and writes the
    token into the static output, so N-1 replays need nothing from the
    host; sampled, the pick runs between replays from the host-seeded
    streams (`_make_pick`).  Calls are serialised: the caches are the
    program's state."""

    def __init__(self, net, B, Pp, N, temperature, top_k, eos_id):
        self._B, self._Pp, self._N = B, Pp, N
        self._H = net._layers[0].attn._num_heads
        self._acts = tuple(lyr.ffn._act for lyr in net._layers)
        self._greedy = temperature <= 0.0
        self._pick = _make_pick(temperature, top_k)
        self._eos = eos_id
        self._lock = threading.Lock()
        pool = _net_pool(net)
        self._prefill_prog = _graphs.Program("decode_prefill",
                                             self._prefill_body, pool)
        self._step_prog = _graphs.Program("decode_step", self._step_body,
                                          pool)
        self._psig = None

    def _bind(self, params, psig):
        """Point the bodies at ``params``; a new weight signature (a
        recapture) gets fresh state in the weights' dtype and device."""
        self._params = params
        if psig == self._psig:
            return
        emb = params["embed"]
        B, W, H = self._B, self._Pp + self._N, self._H
        shape = (B, H, W, emb.shape[1] // H)
        L = len(params["layers"])
        self._kcs = [emb.new_zeros(shape) for _ in range(L)]
        self._vcs = [emb.new_zeros(shape) for _ in range(L)]
        long = dict(dtype=torch.long, device=emb.device)
        self._tok = torch.zeros((B,), **long)
        self._done = torch.zeros((B,), dtype=torch.bool, device=emb.device)
        self._t = torch.zeros((1,), **long)
        self._i = torch.zeros((1,), **long)
        self._out = torch.zeros((B, self._N), **long)
        self._psig = psig

    def _prefill_body(self, prompt, valid_len):
        params = self._params
        h_last, _, _ = _prefill(params, prompt, self._acts, self._H,
                                self._Pp + self._N, valid_len=valid_len,
                                caches=(self._kcs, self._vcs))
        logits = _logits_of(params, h_last)
        self._t.copy_(valid_len)
        if self._greedy:
            first = logits.argmax(dim=-1)
            self._tok.copy_(first)
            self._done.copy_(first == self._eos)
            self._out[:, 0] = first
            self._i.fill_(1)
        return (logits,)

    def _step_body(self):
        logits = _decode_token(self._params, self._acts, self._kcs,
                               self._vcs, self._tok, self._t, self._H)
        self._t.add_(1)
        if self._greedy:
            self._greedy_advance(logits)
        return (logits,)

    def __call__(self, params, psig, prompt, P, seed):
        """The (B, N) generated block for a prompt padded to Pp whose
        true length is P."""
        with self._lock:
            self._bind(params, psig)
            (first,) = self._prefill_prog.run(
                psig, prompt=prompt, valid_len=np.array([P], np.int64))
            if self._greedy:
                for _ in range(self._N - 1):
                    self._step_prog.run(psig)
                return self._out.clone()
            return self._sample_loop(psig, first, P, seed)


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

    ``pad_to_bucket=True`` right-pads the prompt to its power-of-two
    length bucket (`bucket_length`) and carries the true length in, so
    variable-length traffic captures one program per bucket instead of
    one per exact length.  The prefill's real rows and the first token
    are bit-identical to the unpadded call's (causal attention never
    reads the pad); each decode step then attends over a cache of
    bucket + N slots instead of P + N, and its P·V product sums the
    (zero-weighted) extra slots in another order.  On the CPU in f32
    the tokens were the same in the port's tests; in bf16 the small
    differences grow through the layers and a near-tie can pick
    another token: on an H100 at a
    12-layer, 1024-wide net, B=8, P=100 in the 128 bucket, N=32, the
    tokens agreed on 0.9640 of positions (`chip_smoke.py` phase 22).  The programs are
    cached on the net per (B, P, N, temperature, top_k, eos_id, weight
    path, bucketing) signature (`_GenerateProgram`), LRU-capped at 32
    (``net._gen_program_cache_cap``).
    """
    prompt = _as_tokens(prompt, net.embed.weight.device)
    B, P = prompt.shape
    N = int(max_new_tokens)
    if N < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {N}")
    if P + N > net._max_len:
        raise ValueError(
            f"prompt+new = {P + N} exceeds max_len {net._max_len}")
    qc = _quant_config(net, quantized)
    qkey = qc.cache_key() if qc is not None else None
    # the bucket never reaches past max_len - N, so the check above holds
    Pp = min(bucket_length(P), net._max_len - N) if pad_to_bucket else P
    sig = (B, Pp, N, float(temperature), int(top_k), int(eos_id), qkey,
           bool(pad_to_bucket))
    prog = _lru_touch(_program_cache(net), sig)
    if prog is None:
        prog = _cache_program(net, sig, _GenerateProgram(
            net, B, Pp, N, float(temperature), int(top_k), int(eos_id)))
    params, psig = _gathered(net, qc, pe_width=Pp + N)
    padded = prompt if Pp == P else torch.cat(
        [prompt, prompt.new_zeros((B, Pp - P))], dim=1)
    gen = prog(params, psig, padded, P, int(seed))
    return torch.cat([prompt, gen], dim=1).to(torch.int32)


@torch.no_grad()
def lm_score(net, tokens, *, quantized=None):
    """Teacher-forced log-probabilities of ``tokens`` (B, T) under the
    decode stack's numerics (the int8 weight path as ``quantized``
    selects, as in `lm_generate`): f32 (B, T-1), the log-probability of
    ``tokens[:, 1:]`` given each prefix.  The perplexity oracle of the
    quantization quality contract (``exp(-mean(lm_score(...)))``).

    One `_ScoreProgram` per (B, T, weight path) signature in the net's
    program LRU, as the JAX package caches one ``jax.jit``: captured at
    its first call on the card and replayed after that."""
    tokens = _as_tokens(tokens, net.embed.weight.device)
    B, T = tokens.shape
    if T < 2:
        raise ValueError(f"need >= 2 tokens to score, got {T}")
    if T > net._max_len:
        raise ValueError(f"sequence {T} exceeds max_len {net._max_len}")
    qc = _quant_config(net, quantized)
    sig = ("score", B, T, qc.cache_key() if qc is not None else None)
    prog = _lru_touch(_program_cache(net), sig)
    if prog is None:
        prog = _cache_program(net, sig, _ScoreProgram(net, T))
    params, psig = _gathered(net, qc, pe_width=T)
    return prog(params, psig, tokens)


class _ScoreProgram:
    """`lm_score`'s program for one signature: ``score`` runs the tokens
    through the training path's causal attention (`_prefill`'s hidden
    states, no KV caches), the final LayerNorm and the f32 head, and
    gathers each next token's log-softmax.  Calls are serialised."""

    def __init__(self, net, T):
        self._T = T
        self._H = net._layers[0].attn._num_heads
        self._acts = tuple(lyr.ffn._act for lyr in net._layers)
        self._lock = threading.Lock()
        self._prog = _graphs.Program("score", self._body, _net_pool(net))

    def _body(self, tokens):
        params = self._params
        h, _, _ = _prefill(params, tokens, self._acts, self._H, self._T,
                           return_h=True)
        logits = _dense(_ln(h, *params["ln"]), *params["head"],
                        out_dtype=torch.float32)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        return (logp.gather(2, tokens[:, 1:, None])[..., 0],)

    def __call__(self, params, psig, tokens):
        with self._lock:
            self._params = params
            (out,) = self._prog.run(psig, tokens=tokens)
            return out.clone()


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


class _BeamProgram(_DecodeLoop):
    """`lm_beam_search`'s programs for one signature (B, P, N, K, eos,
    alpha, weight path): ``beam_prefill`` runs the prompt through the
    flash kernel into static caches of B·K rows (each row K-fold) and
    takes the first K expansions; ``beam_step`` runs one position at
    batch B·K: the K·V candidate expansion, the caches reordered by beam
    parent in place (gathered, then copied back: a graph's buffers stay
    where it found them), and the (token, parent) trace written at the
    device step index.  The sequences are rebuilt on the card after the
    loop by walking the trace backwards.  Calls are serialised."""

    def __init__(self, net, B, P, N, K, eos_id, alpha):
        self._B, self._P, self._N, self._K = B, P, N, K
        self._H = net._layers[0].attn._num_heads
        self._acts = tuple(lyr.ffn._act for lyr in net._layers)
        self._V = net.head.weight.shape[0]
        self._eos, self._alpha = eos_id, alpha
        self._lock = threading.Lock()
        pool = _net_pool(net)
        self._prefill_prog = _graphs.Program("beam_prefill",
                                             self._prefill_body, pool)
        self._step_prog = _graphs.Program("beam_step", self._step_body, pool)
        self._psig = None

    def _bind(self, params, psig):
        self._params = params
        if psig == self._psig:
            return
        emb = params["embed"]
        B, K, H = self._B, self._K, self._H
        shape = (B * K, H, self._P + self._N, emb.shape[1] // H)
        L = len(params["layers"])
        self._kcs = [emb.new_zeros(shape) for _ in range(L)]
        self._vcs = [emb.new_zeros(shape) for _ in range(L)]
        self._beam_state(emb.device)
        self._psig = psig

    def _prefill_body(self, prompt):
        params = self._params
        h_last, _, _ = _prefill(params, prompt, self._acts, self._H,
                                self._P + self._N,
                                caches=(self._kcs, self._vcs))
        return self._beam_start(_logits_of(params, h_last), self._P)

    def _step_body(self):
        B, K = self._B, self._K
        logits = _decode_token(self._params, self._acts, self._kcs,
                               self._vcs, self._tok.reshape(B * K), self._t,
                               self._H)
        return self._beam_advance(logits)

    def __call__(self, params, psig, prompt):
        with self._lock:
            self._bind(params, psig)
            self._prefill_prog.run(psig, prompt=prompt)
            for _ in range(self._N - 1):
                self._step_prog.run(psig)
            return self._beam_finish()


@torch.no_grad()
def lm_beam_search(net, prompt, max_new_tokens: int, *, beam_size: int = 4,
                   eos_id: int = -1, alpha: float = 0.0, quantized=None):
    """K-beam search decode for `models.TransformerLM` on the net's
    device: the prompt prefilled once through the flash kernel, then one
    replay of the beam step a position at batch B·K (`_BeamProgram`,
    cached on the net per signature like `lm_generate`'s programs).

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
    qc = _quant_config(net, quantized)
    sig = ("beam", B, P, N, K, int(eos_id), float(alpha),
           qc.cache_key() if qc is not None else None)
    prog = _lru_touch(_program_cache(net), sig)
    if prog is None:
        prog = _cache_program(net, sig, _BeamProgram(
            net, B, P, N, K, int(eos_id), float(alpha)))
    params, psig = _gathered(net, qc, pe_width=P + N)
    gen, norm = prog(params, psig, prompt)
    seqs = torch.cat([prompt[:, None].expand(B, K, P), gen], dim=2)
    return seqs.to(torch.int32), norm


# --------------------------------------------------------------------- #
# NMT (encoder-decoder Transformer) translation
# --------------------------------------------------------------------- #
def _gather_nmt_params(net, qc=None):
    """The decoder side of a `models.Transformer` in the JAX package's
    layout (`_gather_nmt_params`, `models/generation.py:831-865`): the
    encoder runs through the public blocks outside the decode programs.
    With a `DecodeQuantConfig` ``qc`` its target layers come out as
    int8 + scale dicts (see `_dense`)."""
    def wb(layer):
        if qc is not None:
            packed = qc.packed(layer)
            if packed is not None:
                return packed, layer.bias
        return layer.weight, layer.bias

    layers = [{"ln1": (lyr.ln1.gamma, lyr.ln1.beta),
               "qkv": wb(lyr.self_attn.qkv),
               "proj": wb(lyr.self_attn.proj),
               "ln2": (lyr.ln2.gamma, lyr.ln2.beta),
               "xq": wb(lyr.cross_attn.q_proj),
               "xkv": wb(lyr.cross_attn.kv_proj),
               "xproj": wb(lyr.cross_attn.proj),
               "ln3": (lyr.ln3.gamma, lyr.ln3.beta),
               "ffn1": wb(lyr.ffn.ffn_dense1),
               "ffn2": wb(lyr.ffn.ffn_dense2)} for lyr in net.decoder._layers]
    return {"embed": net.tgt_embed.weight, "pe": net._pe,
            "ln": (net.decoder.ln.gamma, net.decoder.ln.beta),
            "head": wb(net.out_proj), "layers": layers}


def _nmt_param_tensors(net):
    """The tensors `_gather_nmt_params` reads (the fingerprint's)."""
    ts = [net.tgt_embed.weight, net._pe, net.out_proj.weight,
          net.out_proj.bias] + list(net.decoder.parameters())
    return [t for t in ts if t is not None]


def _weight_nbytes(params) -> int:
    """Bytes of the weights a decode step streams through its matmuls:
    layer matmul weights and biases, LayerNorms, the final LayerNorm and
    the head (int8 + scales where quantized); the embedding is a row
    gather and is left out, as in the JAX package's ``_weight_nbytes``."""
    def size(v):
        if isinstance(v, dict):
            return v["w8"].nbytes + v["s"].nbytes
        return 0 if v is None else v.nbytes

    total = sum(size(t) for t in params["ln"])
    total += sum(size(t) for t in params["head"])
    for lp in params["layers"]:
        total += sum(size(t) for v in lp.values() for t in v)
    return total


def _cross_kv(params, mem, H):
    """Every decoder layer's cross-attention K and V, (B, H, S, D) each,
    from the encoder memory (B, S, C)."""
    B, S, C = mem.shape
    D = C // H
    out = []
    for lp in params["layers"]:
        kx, vx = _dense(mem.to(params["embed"].dtype),
                        *lp["xkv"]).split(C, dim=-1)
        out.append((kx.reshape(B, S, H, D).transpose(1, 2),
                    vx.reshape(B, S, H, D).transpose(1, 2)))
    return out


def _nmt_decode_token(params, acts, kcaches, vcaches, xks, xvs, mem_mask,
                      tok, t, H):
    """One decoder step for target tokens ``tok`` at position ``t`` ((1,)
    int64 on the card; `models/generation.py:868-901` of the JAX
    package): pre-LN self-attention against the caches
    (`_cached_self_attn`), cross-attention over the precomputed memory
    K/V with f32 scores and softmax (the training path's numerics) and
    the memory's padding mask, FFN; f32 logits (B', V)."""
    h = _embed(params, tok, t)
    Bp, C = h.shape
    D = C // H
    for li, (lp, act) in enumerate(zip(params["layers"], acts)):
        h = _cached_self_attn(lp, h, kcaches[li], vcaches[li], t, H)
        qx = _dense(_ln(h, *lp["ln2"]), *lp["xq"]).reshape(Bp, H, D)
        s = torch.einsum("bhd,bhkd->bhk", qx.float(),
                         xks[li].float()) / math.sqrt(D)
        if mem_mask is not None:
            s = torch.where(mem_mask[:, None, :].bool(), s, _F32_MIN)
        p = torch.softmax(s, dim=-1)
        a = torch.einsum("bhk,bhkd->bhd", p, xvs[li].float()).to(h.dtype)
        h = h + _dense(a.reshape(Bp, C), *lp["xproj"])
        h = h + _ffn_fwd(_ln(h, *lp["ln3"]), lp, act)
    return _logits_of(params, h)


class _TranslateProgram(_DecodeLoop):
    """`nmt_translate`'s programs for one signature (B, S, N, K, eos,
    bos, alpha, sampling, mask, weight path), the JAX package's
    `_build_nmt_program` as two `_graphs.Program`s:

    * ``nmt_start`` — every layer's cross-attention K/V from the encoder
      memory into static buffers, the BOS step at position 0 at batch B,
      then the greedy first token (written into the static output), or
      for beams the caches, the cross K/V and the mask tiled K-fold once
      (per-beam constants) and the first K expansions;
    * ``nmt_step`` — one target position at batch B·K against the
      static self-attention caches (B·K, H, N+1, D), its position a
      device scalar it advances itself; greedy, the argmax and the eos
      freeze run inside it, for beams the K·V expansion and the cache
      reorder by parent (`_beam_advance`).  Replayed N-1 times.

    Sampled, the pick runs between step replays from the host-seeded
    streams, as in `lm_generate` (`_sample_loop`).  Calls are
    serialised: the caches are the program's state."""

    def __init__(self, net, B, S, N, K, eos_id, bos_id, alpha,
                 temperature, top_k, masked):
        self._B, self._S, self._N, self._K = B, S, N, K
        layers = net.decoder._layers
        self._H = layers[0].self_attn._num_heads
        self._acts = tuple(lyr.ffn._act for lyr in layers)
        self._V = net.out_proj.weight.shape[0]
        self._eos, self._bos, self._alpha = eos_id, bos_id, alpha
        self._greedy = temperature <= 0.0
        self._pick = _make_pick(temperature, top_k)
        self._masked = masked
        self._lock = threading.Lock()
        pool = _net_pool(net)
        self._start_prog = _graphs.Program("nmt_start", self._start_body,
                                           pool)
        self._step_prog = _graphs.Program("nmt_step", self._step_body, pool)
        self._psig = None

    def _bind(self, params, psig):
        self._params = params
        if psig == self._psig:
            return
        emb = params["embed"]
        dev = emb.device
        B, K, H = self._B, self._K, self._H
        D = emb.shape[1] // H
        L = len(params["layers"])
        cache = (B * K, H, self._N + 1, D)
        cross = (B * K, H, self._S, D)
        self._kcs = [emb.new_zeros(cache) for _ in range(L)]
        self._vcs = [emb.new_zeros(cache) for _ in range(L)]
        self._xks = [emb.new_zeros(cross) for _ in range(L)]
        self._xvs = [emb.new_zeros(cross) for _ in range(L)]
        self._mask = torch.ones((B * K, self._S), device=dev)
        if K > 1:
            self._beam_state(dev)
        else:
            long = dict(dtype=torch.long, device=dev)
            self._tok = torch.zeros((B,), **long)
            self._done = torch.zeros((B,), dtype=torch.bool, device=dev)
            self._t = torch.zeros((1,), **long)
            self._i = torch.zeros((1,), **long)
            self._out = torch.zeros((B, self._N), **long)
        self._psig = psig

    def _start_body(self, mem, mem_mask):
        params, B, K = self._params, self._B, self._K
        xkv = _cross_kv(params, mem, self._H)
        xks, xvs = [k for k, _ in xkv], [v for _, v in xkv]
        mask = mem_mask if self._masked else None
        dev = mem.device
        bos = torch.full((B,), self._bos, dtype=torch.long, device=dev)
        t0 = torch.zeros((1,), dtype=torch.long, device=dev)
        if K > 1:
            kc0 = [c.new_zeros((B,) + c.shape[1:]) for c in self._kcs]
            vc0 = [c.new_zeros((B,) + c.shape[1:]) for c in self._vcs]
            logits = _nmt_decode_token(params, self._acts, kc0, vc0, xks,
                                       xvs, mask, bos, t0, self._H)
            for src, dst in zip(kc0 + vc0 + xks + xvs, self._kcs + self._vcs
                                + self._xks + self._xvs):
                dst.copy_(src.repeat_interleave(K, dim=0))
            self._mask.copy_(mem_mask.repeat_interleave(K, dim=0))
            return self._beam_start(logits, 1)
        for src, dst in zip(xks + xvs, self._xks + self._xvs):
            dst.copy_(src)
        self._mask.copy_(mem_mask)
        for c in self._kcs + self._vcs:
            c.zero_()
        logits = _nmt_decode_token(params, self._acts, self._kcs, self._vcs,
                                   self._xks, self._xvs, mask, bos, t0,
                                   self._H)
        self._t.fill_(1)
        if self._greedy:
            first = logits.argmax(dim=-1)
            self._tok.copy_(first)
            self._done.copy_(first == self._eos)
            self._out[:, 0] = first
            self._i.fill_(1)
        return (logits,)

    def _step_body(self):
        logits = _nmt_decode_token(
            self._params, self._acts, self._kcs, self._vcs, self._xks,
            self._xvs, self._mask if self._masked else None,
            self._tok.reshape(-1), self._t, self._H)
        if self._K > 1:
            return self._beam_advance(logits)
        self._t.add_(1)
        if self._greedy:
            self._greedy_advance(logits)
        return (logits,)

    def __call__(self, params, psig, mem, mem_mask, seed):
        with self._lock:
            self._bind(params, psig)
            (first,) = self._start_prog.run(psig, mem=mem, mem_mask=mem_mask)
            if self._K == 1 and not self._greedy:
                return self._sample_loop(psig, first, 1, seed)
            for _ in range(self._N - 1):
                self._step_prog.run(psig)
            if self._K > 1:
                return self._beam_finish()
            return self._out.clone()


@torch.no_grad()
def nmt_translate(net, src, max_len: int, *, beam_size: int = 1,
                  eos_id: int = -1, bos_id: int = 0, alpha: float = 0.0,
                  temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                  src_valid_length=None, quantized=None):
    """Translate ``src`` (int (B, S)) with the `models.Transformer`
    ``net`` on the net's device (`models/generation.py:967-1055` of the
    JAX package): the encoder runs through the public blocks (the
    training numerics), the decoder through `_TranslateProgram`'s
    captured programs, cached on the net per signature like
    `lm_generate`'s (LRU of 32).  Greedy (or sampled: ``temperature``,
    ``top_k``, ``seed``, torch's streams, not JAX's) when ``beam_size``
    is 1: int32 (B, max_len) target tokens, BOS excluded.  K-beam
    otherwise: (sequences int32 (B, K, max_len), scores f32 (B, K))
    best-first, the GNMT length penalty by ``alpha``.

    ``bos_id`` seeds the decoder; ``eos_id >= 0`` freezes finished rows
    or beams; ``src_valid_length`` masks the source's padding in the
    encoder and the cross-attention; ``quantized`` selects the int8
    decoder as in `lm_generate` (the encoder stays float).  ``max_len``
    and the source length are each at most the model's ``max_length``,
    ``beam_size`` at most the vocabulary, and a beam search takes no
    sampling arguments."""
    dev = net.src_embed.weight.device
    src = _as_tokens(src, dev)
    B, S = src.shape
    N = int(max_len)
    K = int(beam_size)
    if N < 1:
        raise ValueError(f"max_len must be >= 1, got {N}")
    if K < 1:
        raise ValueError(f"beam_size must be >= 1, got {K}")
    if N > net._max_length:
        raise ValueError(f"max_len {N} exceeds the model's max_length "
                         f"{net._max_length}")
    if S > net._max_length:
        raise ValueError(f"src length {S} exceeds the model's max_length "
                         f"{net._max_length}")
    V = net.out_proj.weight.shape[0]
    if K > V:
        raise ValueError(f"beam_size {K} exceeds vocab {V}")
    if K > 1 and (temperature > 0.0 or top_k > 0):
        raise ValueError("beam search is deterministic — temperature/top_k "
                         "only apply at beam_size=1")
    from .bert import valid_mask

    qc = _quant_config(net, quantized)
    masked = src_valid_length is not None
    mem_mask = valid_mask(src_valid_length, S, dev) if masked \
        else torch.ones((B, S), device=dev)
    mem = net.encoder(net._embed(net.src_embed, src),
                      mem_mask if masked else None)
    # sampling arguments are inert for beams: kept out of their key
    samp = (float(temperature), int(top_k)) if K == 1 else (0.0, 0)
    sig = ("nmt", B, S, N, K, int(eos_id), int(bos_id), float(alpha), samp,
           masked, qc.cache_key() if qc is not None else None)
    prog = _lru_touch(_program_cache(net), sig)
    if prog is None:
        prog = _cache_program(net, sig, _TranslateProgram(
            net, B, S, N, K, int(eos_id), int(bos_id), float(alpha),
            samp[0], samp[1], masked))
    params, psig = _gathered(net, qc, _gather_nmt_params, _nmt_param_tensors)
    out = prog(params, psig, mem, mem_mask, int(seed))
    if K == 1:
        return out.to(torch.int32)
    gen, scores = out
    return gen.to(torch.int32), scores
