"""Device programs for paged continuous-batching decode (PyTorch/CUDA
port of `incubator_mxnet_tpu/serving/programs.py`: the float and the
int8 KV program families).

Two program families over a preallocated paged KV pool:

* ``step`` — ONE decode step for the whole fixed-width batch
  (``max_batch`` lanes).  Each lane carries its own block-table row,
  position, token and seed; inactive lanes write their K/V into the
  scratch block and their outputs are ignored host-side.  The batch
  width never changes, so admission and eviction change tensor values,
  never shapes.
* ``prefill_chunk`` — a FIXED-width window of ``chunk`` prompt
  positions of one sequence, computed against the paged pool.  Each
  chunk writes its K/V into the sequence's pages and attends with the
  per-position ``kpos <= pos`` mask, which makes a position's K/V (and
  the first-token logits) independent of how the prompt was chunked —
  the reason a prefix-cache hit is bit-identical to a cold prefill.

Both attend through `ops.paged_attention`: the hand-written CUDA kernel
on the card, the dense-gather recipe on the CPU.  Rows never mix (every
matmul keeps rows apart, the attention is lane-local and masked slots
contribute exactly 0.0), so co-batched lanes are independent — the
facts the eviction bit-identity contract rests on (docs/serving.md,
"Why eviction is exact").

Writes to the pool are in-place ``index_put_`` into the preallocated
per-layer tensors: this replaces the JAX programs' donation of the pool
buffers, which XLA updates in place and hands back.

Sampling keeps the `_row_pick` property of the JAX package: a lane's
draw at position ``t`` comes from the stream seeded by (its request's
seed, t) alone, never from who it was co-batched with.

``kv_dtype="int8"`` is the second family (the JAX package's
``serving_step_kv8`` / ``serving_prefill_chunk_kv8``): K/V are quantized
per head vector at page-write time (`contrib.quantization.quantize_kv`)
into int8 pools, their f32 scales into scale pools (num_blocks, H, bs)
beside them, and the attention dequantizes inside the int8-page kernel.
The weights take the int8 decode path when the net carries
`quantize_for_decode` state (``quantized=None``) or when asked.
"""
from __future__ import annotations

import numpy as np
import torch

from ..contrib.quantization import quantize_kv
from ..models import generation as G
from ..ops.paged_attention import paged_attention
from ..random import counter_seed

__all__ = ["PagedPrograms"]


def _row_pick(temperature, top_k):
    """Per-lane token pick over logits (B, V) at host positions and
    seeds: greedy argmax at temperature <= 0, else top-k-truncated
    sampling, each row from the stream of (its seed, its position)."""
    def pick(logits, positions, seeds):
        if temperature <= 0.0:
            return logits.argmax(dim=-1)
        lg = G._top_k_logits(logits, temperature, top_k)
        noise = torch.stack([
            G._gumbel(lg.shape[1:], counter_seed(int(s), int(t)), lg.device)
            for s, t in zip(seeds, positions)])
        return (lg + noise).argmax(dim=-1)

    return pick


def _write_pages(pool_k, pool_v, wblk, off, k, v):
    """Write each row's K/V (rows, H, ...) into slot ``off`` of block
    ``wblk`` of the layer's pools (pages (nb, H, bs, D) or their scales
    (nb, H, bs)), in place."""
    heads = torch.arange(k.shape[1], device=k.device)[None, :]
    idx = (wblk[:, None], heads, off[:, None])
    pool_k.index_put_(idx, k)
    pool_v.index_put_(idx, v)


def _token_forward(params, acts, H, pool_k, pool_v, scale_k, scale_v,
                   tables, toks, pos, wblk, off):
    """Every row's forward over the paged pool: embed ``toks`` at
    ``pos``, and per layer write the row's K/V at (wblk, off), then
    attend through the row's table; returns the final hidden states.
    Write-then-read: a row's own position is in the pool by the time
    its mask admits it.  With scale pools (the int8 family; empty lists
    otherwise) K/V are quantized per head vector before the write and
    their scales written beside them."""
    B = toks.shape[0]
    h = G._embed(params, toks, pos.long())
    C = h.shape[-1]
    kv8 = bool(scale_k)
    for li, (lp, act) in enumerate(zip(params["layers"], acts)):
        x = G._ln(h, *lp["ln1"])
        q, k, v = G._qkv_heads(G._dense(x, *lp["qkv"]), H)   # (B, H, D)
        sk = sv = None
        if kv8:
            k, ks = quantize_kv(k)            # (B, H, D) int8 / (B, H) f32
            v, vs = quantize_kv(v)
            sk, sv = scale_k[li], scale_v[li]
            _write_pages(sk, sv, wblk, off, ks, vs)
        _write_pages(pool_k[li], pool_v[li], wblk, off, k, v)
        a = paged_attention(q.contiguous(), pool_k[li], pool_v[li], tables,
                            pos, scale_k=sk, scale_v=sv)
        h = h + G._dense(a.reshape(B, C), *lp["proj"])
        h = h + G._ffn_fwd(G._ln(h, *lp["ln2"]), lp, act)
    return h


class PagedPrograms:
    """The engine's device surface: the per-layer KV pools
    (num_blocks, H, block_size, D), zero-filled (the scratch block must
    stay finite), in the model dtype or, with ``kv_dtype="int8"``, int8
    with f32 scale pools (num_blocks, H, block_size) filled with ones;
    and the step and prefill-chunk programs over them.  ``quantized``
    picks the weight path as in `lm_generate`.  Called from the
    scheduler thread only."""

    def __init__(self, net, *, max_batch, block_size, blocks_per_seq,
                 num_blocks, temperature, top_k, prefill_chunk=32,
                 quantized=None, kv_dtype=None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None (model dtype) or 'int8', "
                f"got {kv_dtype!r}")
        if int(prefill_chunk) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self._net = net
        self._qc = G._quant_config(net, quantized)
        self._kv_dtype = kv_dtype
        self._B = int(max_batch)
        self._H = net._layers[0].attn._num_heads
        self._acts = tuple(lyr.ffn._act for lyr in net._layers)
        self._bs = int(block_size)
        self._nbps = int(blocks_per_seq)
        self._chunk = int(prefill_chunk)
        self._pick = _row_pick(float(temperature), int(top_k))
        emb = net.embed.weight
        self.device = emb.device
        D = net._units // self._H
        shape = (int(num_blocks), self._H, self._bs, D)
        L = len(net._layers)
        dt = torch.int8 if kv_dtype == "int8" else emb.dtype

        def pools(make, shp, dtype):
            return [make(shp, dtype=dtype, device=self.device)
                    for _ in range(L)]

        self.pool_k = pools(torch.zeros, shape, dt)
        self.pool_v = pools(torch.zeros, shape, dt)
        self.scale_k = self.scale_v = []
        if kv_dtype == "int8":
            self.scale_k = pools(torch.ones, shape[:3], torch.float32)
            self.scale_v = pools(torch.ones, shape[:3], torch.float32)

    @property
    def prefill_chunk_len(self) -> int:
        """Static chunk width in tokens."""
        return self._chunk

    @property
    def path(self) -> str:
        """The weight path: "float" or "int8"."""
        return G._decode_path(self._qc)

    @property
    def kv_dtype(self):
        """None (model dtype) or "int8"."""
        return self._kv_dtype

    @property
    def kv_pool_bytes(self) -> int:
        """Device bytes of the pages and their scales, all layers."""
        return sum(t.numel() * t.element_size()
                   for t in (*self.pool_k, *self.pool_v,
                             *self.scale_k, *self.scale_v))

    def _dev(self, arr: np.ndarray):
        return torch.from_numpy(arr).to(self.device)

    @torch.no_grad()
    def step(self, tables, toks, pos, active, seeds) -> np.ndarray:
        """One decode step for every lane (host arrays in: tables
        (B, nbps) int32, toks/pos (B,) int32, active (B,) bool, seeds
        (B,) int64); returns the next token of every lane.  The JAX
        package's `_build_step` program."""
        params = G._gather_params(self._net, self._qc)
        t_tables, t_pos = self._dev(tables), self._dev(pos)
        posl = t_pos.long()
        wblk = t_tables.long().gather(1, (posl // self._bs)[:, None])[:, 0]
        wblk = torch.where(self._dev(active), wblk, 0)   # idle -> scratch
        h = _token_forward(params, self._acts, self._H, self.pool_k,
                           self.pool_v, self.scale_k, self.scale_v, t_tables,
                           self._dev(toks), t_pos, wblk, posl % self._bs)
        nxt = self._pick(G._logits_of(params, h), pos, seeds)
        return nxt.cpu().numpy()

    @torch.no_grad()
    def prefill_chunk(self, table_row, toks, start: int, valid_len: int,
                      seed: int, final: bool):
        """Positions ``start .. start+chunk-1`` of one sequence's prompt
        (table_row (nbps,) int32, toks (chunk,) int32; positions past
        ``valid_len`` write to scratch).  On the ``final`` chunk,
        returns the first generated token (picked from the row of
        position ``valid_len - 1``); else None.  The JAX package's
        `_build_prefill_chunk` program."""
        CH, bs, nbps = self._chunk, self._bs, self._nbps
        params = G._gather_params(self._net, self._qc)
        posw = start + torch.arange(CH, device=self.device)
        posc = posw.clamp(0, nbps * bs - 1)
        row = self._dev(table_row)
        wblk = torch.where(posw < valid_len,
                           row.long()[(posc // bs).clamp(0, nbps - 1)], 0)
        tables = row[None, :].expand(CH, nbps).contiguous()
        h = _token_forward(params, self._acts, self._H, self.pool_k,
                           self.pool_v, self.scale_k, self.scale_v, tables,
                           self._dev(toks), posc.to(torch.int32), wblk,
                           posc % bs)
        if not final:
            return None
        li = min(max(valid_len - 1 - start, 0), CH - 1)
        logits = G._logits_of(params, h[li:li + 1])
        return int(self._pick(logits, [valid_len - 1], [seed])[0])
