"""Device programs for paged continuous-batching decode (PyTorch/CUDA
port of `incubator_mxnet_tpu/serving/programs.py`: the float and the
int8 KV program families, and speculative decoding).

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

Each program is a `_graphs.Program`: captured into a CUDA graph at its
first call on the scheduler thread and replayed after that, over static
input buffers that the host arrays are staged into (pinned,
``non_blocking``).  A graph bakes in the pools' addresses, so the
programs belong to the `PagedPrograms` that owns the pools and capture
into its graph pool: a graph never replays over another engine's pools
(the JAX package caches its programs on the net, keyed on the static
config alone, because its pools are arguments).  The weights are
gathered once per `models.generation._params_fingerprint`; a gather
whose tensors moved (a ``cast()``, a re-quantization) recaptures.  What
draws from a host-seeded ``torch.Generator`` (a sampled pick, the
stochastic acceptance) runs between replays; greedy picks and the
greedy acceptance run inside the graphs.

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

Speculative decoding (``speculate_k > 0``) adds three programs over a
second, DRAFT pool in the draft net's dtype, addressed by the same
block tables and block ids as the target's: ``draft_step`` (k token
forwards of the draft, each proposing d_j), ``draft_prefill_chunk``
(the chunk program on the draft weights, without the pick) and
``spec_verify`` (ONE target forward of every lane's window ``[tok,
d_1 .. d_k]`` at ``pos .. pos+k`` as B·(k+1) rows, then exact
acceptance on the card; only the emitted tokens and the accepted
lengths come back to the host).  The window steps past the committed
positions, so rows at positions >= the sequence cap clamp their
positional encoding and write the scratch block (`_host_slots`).
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import _graphs
from ..contrib.quantization import quantize_kv
from ..models import generation as G
from ..ops.paged_attention import paged_attention
from ..random import counter_seed
from .kv_pool import SCRATCH_BLOCK

__all__ = ["PagedPrograms"]

# salts deriving the speculative acceptance and residual-resample
# streams from a request's seed: distinct from each other and from the
# plain (seed, position) streams the draft and bonus picks use, so every
# uniform the rejection sampler consumes is independent of the proposal
# it judges (the JAX package's values)
_ACCEPT_SALT = 0x5ACC
_RESID_SALT = 0x0E51

# program objects built, by kind (the JAX package's
# ``serving_program_builds_total``)
program_builds: Counter = Counter()


def _note_build(kind: str) -> None:
    """Count a program built (a fresh `_graphs.Program`; its capture
    happens at its first call)."""
    program_builds[kind] += 1


def _stream(seed, t, salt=None) -> int:
    """Seed of the draws at position ``t`` of a request's ``seed``: the
    plain stream, or the one derived with ``salt``."""
    s = int(seed) if salt is None else counter_seed(int(seed), salt)
    return counter_seed(s, int(t))


def _lane_noise(shape, seeds, positions, device, salt=None):
    """Gumbel noise (rows, *shape), each row from the stream of (its
    seed, its position)."""
    return torch.stack([G._gumbel(shape, _stream(s, t, salt), device)
                        for s, t in zip(seeds, positions)])


def _uniform(stream_seed: int) -> float:
    """One uniform draw in [0, 1) from the stream ``stream_seed``, on
    the host."""
    g = torch.Generator().manual_seed(stream_seed)
    return float(torch.rand((), generator=g))


def _sample(lg, seeds, positions, salt=None):
    """One draw from softmax(``lg``) (rows, V) per row: argmax of the
    logits plus the row's stream's Gumbel noise."""
    return (lg + _lane_noise(lg.shape[1:], seeds, positions, lg.device,
                             salt)).argmax(dim=-1)


def _row_pick(temperature, top_k):
    """Per-lane token pick over logits (B, V) at host positions and
    seeds: greedy argmax at temperature <= 0, else top-k-truncated
    sampling, each row from the stream of (its seed, its position)."""
    def pick(logits, positions, seeds):
        if temperature <= 0.0:
            return logits.argmax(dim=-1)
        return _sample(G._top_k_logits(logits, temperature, top_k), seeds,
                       positions)

    return pick


def _host_slots(tables, pos, ok, bs, msl):
    """Host arithmetic of the rows' page writes: positions clamped to
    ``msl - 1`` (for the positional encoding and the attention, which
    reads every slot of a lane's table either way past it), and the
    block and slot each row writes; rows not ``ok`` or at positions >=
    ``msl`` write the scratch block."""
    posc = np.clip(pos, 0, msl - 1)
    blk = np.take_along_axis(tables, (posc // bs)[:, None], axis=1)[:, 0]
    wblk = np.where(ok & (pos < msl), blk, SCRATCH_BLOCK)
    return (posc.astype(np.int32), wblk.astype(np.int64),
            (posc % bs).astype(np.int64))


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
    ``pos`` (below the sequence cap: `_host_slots` clamps), and per
    layer write every row's K/V at (wblk, off), then attend through
    each row's table; returns the final hidden states.  Write-then-read:
    a row's own position is in the pool by the time its mask admits it,
    and rows of one lane at later positions are masked out of it.  With
    scale pools (the int8 family; empty lists otherwise) K/V are
    quantized per head vector before the write and their scales written
    beside them."""
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
    picks the weight path as in `lm_generate`.

    With ``speculate_k > 0`` also the draft pools (in the draft's dtype,
    never int8) and the speculative programs.  ``draft_net=None``
    self-drafts through the int8 weight path of the target (a float
    target marked by `quantize_for_decode`); ``spec_greedy`` (forced at
    temperature <= 0) accepts the leading run of draft tokens that
    match the target's argmax.  Called from the scheduler thread
    only."""

    def __init__(self, net, *, max_batch, block_size, blocks_per_seq,
                 num_blocks, temperature, top_k, prefill_chunk=32,
                 quantized=None, kv_dtype=None, speculate_k=0,
                 draft_net=None, spec_greedy=False):
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
        self._msl = self._nbps * self._bs
        self._chunk = int(prefill_chunk)
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._pick = _row_pick(self._temperature, self._top_k)
        self._nb = int(num_blocks)
        emb = net.embed.weight
        self.device = emb.device
        dt = torch.int8 if kv_dtype == "int8" else emb.dtype
        self.pool_k, self.pool_v = self._pools(net, dt)
        self.scale_k = self.scale_v = []
        if kv_dtype == "int8":
            L, H, bs = len(net._layers), self._H, self._bs
            self.scale_k = [torch.ones((self._nb, H, bs), device=self.device)
                            for _ in range(L)]
            self.scale_v = [torch.ones((self._nb, H, bs), device=self.device)
                            for _ in range(L)]
        # distinct names per KV family, as the JAX package's: a
        # RetraceGuard budgets captures by name
        sfx = "_kv8" if kv_dtype == "int8" else ""
        self._graph_pool = _graphs.Pool(self.device)
        self.programs = {}
        self._program("step", "serving_step" + sfx,
                      self._body(False, logits=True))
        self._program("prefill_chunk", "serving_prefill_chunk" + sfx,
                      self._body(False, logits=False))
        self._params = self._dparams = None
        self._init_speculative(net, speculate_k, draft_net, spec_greedy)

    def _program(self, kind, name, body):
        _note_build(kind)
        self.programs[kind] = _graphs.Program(name, body, self._graph_pool)

    def _pools(self, net, dtype):
        """Zero-filled per-layer K and V pools for ``net``'s heads."""
        H = net._layers[0].attn._num_heads
        shape = (self._nb, H, self._bs, net._units // H)
        return tuple([torch.zeros(shape, dtype=dtype, device=self.device)
                      for _ in net._layers] for _ in range(2))

    def _init_speculative(self, net, speculate_k, draft_net, spec_greedy):
        """Resolve the draft model, make its pools and programs."""
        self._spec_k = int(speculate_k)
        self._spec_greedy = bool(spec_greedy) or self._temperature <= 0.0
        self._draft_net = None
        self._draft_label = None
        self.dpool_k = self.dpool_v = []
        if self._spec_k == 0:
            return
        if self._spec_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if draft_net is None:
            if self.path != "float":
                raise ValueError(
                    "speculate_k with draft_net=None self-drafts through "
                    "the int8 weight path, but the target is already int8: "
                    "pass a distinct draft_net")
            self._draft_qc = G._quant_config(net, True)
            self._draft_net = net
            self._draft_label = "self-int8"
        else:
            self._draft_qc = G._quant_config(draft_net, None)
            self._draft_net = draft_net
            self._draft_label = (f"net[{len(draft_net._layers)}x"
                                 f"{draft_net._units}]")
        dnet = self._draft_net
        self._dH = dnet._layers[0].attn._num_heads
        self._dacts = tuple(lyr.ffn._act for lyr in dnet._layers)
        self.dpool_k, self.dpool_v = self._pools(dnet,
                                                 dnet.embed.weight.dtype)
        sfx = "_kv8" if self._kv_dtype == "int8" else ""
        # greedy: the k draft forwards and their argmax in one graph;
        # sampled: one forward a graph, the picks between replays
        self._program("draft_step", "serving_draft_step",
                      self._draft_body if self._spec_greedy
                      else self._body(True, logits=True))
        self._program("draft_prefill_chunk", "serving_draft_prefill_chunk",
                      self._body(True, logits=False))
        self._program("spec_verify", "serving_spec_verify" + sfx,
                      self._verify_body)

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
        """Device bytes of the pages and their scales, all layers, the
        draft's pages included (resident memory spent per position)."""
        return sum(t.numel() * t.element_size()
                   for t in (*self.pool_k, *self.pool_v, *self.scale_k,
                             *self.scale_v, *self.dpool_k, *self.dpool_v))

    @property
    def speculate_k(self) -> int:
        """Draft window length (0: speculation off)."""
        return self._spec_k

    @property
    def spec_greedy(self) -> bool:
        """The acceptance rule: True is the argmax prefix match."""
        return self._spec_greedy

    @property
    def draft_label(self):
        """"self-int8", or the draft net's layers x width."""
        return self._draft_label

    @property
    def draft_net(self):
        return self._draft_net

    # -- weights and bodies -------------------------------------------- #
    def gather_params(self):
        """The target's weights for the bodies, gathered once per
        fingerprint; returns the signature a graph is captured for."""
        self._params, psig = G._gathered(self._net, self._qc,
                                         pe_width=self._msl)
        return psig

    def draft_params(self):
        """The draft's weights (the target's int8 weights when it
        self-drafts), as `gather_params`."""
        self._dparams, psig = G._gathered(self._draft_net, self._draft_qc,
                                          pe_width=self._msl)
        return psig

    def _slots(self, tables, pos, ok):
        """The static inputs of rows at host ``tables`` (rows, nbps),
        ``pos`` (rows,) and ``ok`` (rows,) bool: their tables, clamped
        positions, and the block and slot each writes (`_host_slots`),
        as host arrays for `_graphs.Program.run`."""
        posc, wblk, off = _host_slots(tables, pos, ok, self._bs, self._msl)
        return dict(tables=tables, posc=posc, wblk=wblk, off=off)

    def _forward(self, draft, tables, posc, wblk, off, toks):
        """Every row's forward over the target (or the draft) pools with
        their weights; returns the final hidden states (rows, C)."""
        if draft:
            params, H, acts = self._dparams, self._dH, self._dacts
            pools = (self.dpool_k, self.dpool_v, [], [])
        else:
            params, H, acts = self._params, self._H, self._acts
            pools = (self.pool_k, self.pool_v, self.scale_k, self.scale_v)
        return _token_forward(params, acts, H, *pools, tables, toks, posc,
                              wblk, off)

    def _body(self, draft, logits):
        """The step and chunk bodies: the rows' forward, then (``logits``)
        their f32 logits and, when the pick is greedy, its argmax."""
        greedy = (self._spec_greedy if draft
                  else self._temperature <= 0.0)

        def body(tables, toks, posc, wblk, off):
            h = self._forward(draft, tables, posc, wblk, off, toks)
            if not logits:
                return (h,)
            lg = G._logits_of(self._dparams if draft else self._params, h)
            return (lg, lg.argmax(dim=-1)) if greedy else (lg,)

        return body

    def _draft_body(self, tables, toks, posc, wblk, off):
        """k greedy draft forwards at the (k, B) slots: each proposes
        the next one's token."""
        cur, d_toks = toks, []
        for j in range(self._spec_k):
            h = self._forward(True, tables, posc[j], wblk[j], off[j], cur)
            cur = G._logits_of(self._dparams, h).argmax(dim=-1)
            d_toks.append(cur)
        return (torch.stack(d_toks, dim=1),)

    def _verify_body(self, tables, toks, d_toks, posc, wblk, off):
        """The target forward of every lane's window ``[tok, d_1 ..
        d_k]`` as B·(k+1) rows; greedy, the acceptance too: ``out`` is
        the argmax and the accepted length the leading run of drafts
        equal to it, packed as (B, k+2)."""
        k = self._spec_k
        B = toks.shape[0]
        win = torch.cat([toks.long()[:, None], d_toks], dim=1)
        h = self._forward(False, tables, posc, wblk, off, win.reshape(-1))
        logits = G._logits_of(self._params, h).reshape(B, k + 1, -1)
        if not self._spec_greedy:
            return (logits,)
        out = logits.argmax(dim=-1)
        alen = (d_toks == out[:, :k]).long().cumprod(dim=1).sum(dim=1)
        return logits, torch.cat([out, alen[:, None]], dim=1)

    def _chunk_slots(self, table_row, start, valid_len):
        """Positions ``start .. start+chunk-1`` of one sequence; those
        from ``valid_len`` on write to scratch."""
        posw = start + np.arange(self._chunk)
        return self._slots(np.tile(table_row, (self._chunk, 1)), posw,
                           posw < valid_len)

    # -- the programs --------------------------------------------------- #
    @torch.no_grad()
    def step(self, tables, toks, pos, active, seeds) -> np.ndarray:
        """One decode step for every lane (host arrays in: tables
        (B, nbps) int32, toks/pos (B,) int32, active (B,) bool, seeds
        (B,) int64); returns the next token of every lane.  The JAX
        package's `_build_step` program."""
        out = self.programs["step"].run(
            self.gather_params(), toks=toks,
            **self._slots(tables, pos, active))
        nxt = out[1] if len(out) > 1 else self._pick(out[0], pos, seeds)
        return nxt.cpu().numpy()

    @torch.no_grad()
    def prefill_chunk(self, table_row, toks, start: int, valid_len: int,
                      seed: int, final: bool):
        """Positions ``start .. start+chunk-1`` of one sequence's prompt
        (table_row (nbps,) int32, toks (chunk,) int32; positions past
        ``valid_len`` write to scratch).  On the ``final`` chunk,
        returns the first generated token (picked from the row of
        position ``valid_len - 1``, outside the graph); else None.  The
        JAX package's `_build_prefill_chunk` program."""
        (h,) = self.programs["prefill_chunk"].run(
            self.gather_params(), toks=toks,
            **self._chunk_slots(table_row, start, valid_len))
        if not final:
            return None
        li = min(max(valid_len - 1 - start, 0), self._chunk - 1)
        logits = G._logits_of(self._params, h[li:li + 1])
        return int(self._pick(logits, [valid_len - 1], [seed])[0])

    # -- speculative decoding ------------------------------------------ #
    @torch.no_grad()
    def draft_prefill_chunk(self, table_row, toks, start: int,
                            valid_len: int) -> None:
        """The chunk program on the draft weights and pools, without the
        pick (the target's chunk picks the first token).  The JAX
        package's `_build_draft_prefill_chunk` program."""
        self.programs["draft_prefill_chunk"].run(
            self.draft_params(), toks=toks,
            **self._chunk_slots(table_row, start, valid_len))

    @torch.no_grad()
    def draft_step(self, tables, toks, pos, active, seeds):
        """k draft token forwards at ``pos .. pos+k-1`` over the draft
        pools (host arrays in, as `step`).  Step j proposes d_{j+1}:
        the draft's argmax when greedy, else a draw from q_j = softmax
        of its temperature-scaled top-k logits, from the stream of
        (seed, pos+j), the plain pick's recipe.  Returns (d_toks (B, k)
        on the card, q (B, k, V) or None when greedy).  The JAX
        package's `_build_draft_step` program."""
        psig = self.draft_params()
        k = self._spec_k
        prog = self.programs["draft_step"]
        slots = [_host_slots(tables, pos + j, active, self._bs, self._msl)
                 for j in range(k)]
        if self._spec_greedy:
            posc, wblk, off = (np.stack(a) for a in zip(*slots))
            (d_toks,) = prog.run(psig, tables=tables, toks=toks, posc=posc,
                                 wblk=wblk, off=off)
            return d_toks.clone(), None
        cur, d_toks, q = toks, [], []
        for j, (posc, wblk, off) in enumerate(slots):
            (logits,) = prog.run(psig, tables=tables, toks=cur, posc=posc,
                                 wblk=wblk, off=off)
            lg = G._top_k_logits(logits, self._temperature, self._top_k)
            cur = _sample(lg, seeds, pos + j)
            q.append(torch.softmax(lg, dim=-1))
            d_toks.append(cur)
        return torch.stack(d_toks, dim=1), torch.stack(q, dim=1)

    @torch.no_grad()
    def spec_verify(self, tables, toks, pos, active, seeds, d_toks, q):
        """The verifier: ONE target forward of every lane's window
        ``[tok, d_1 .. d_k]`` at ``pos .. pos+k`` as B·(k+1) rows (lane
        b's row j is row b·(k+1)+j).  Per layer every row's K/V is
        written before any row attends, and each row's mask admits
        slots <= its own position, so row j's math is that of a step at
        pos+j.  Then acceptance on the card:

        * greedy: ``out = argmax``, and the accepted length is the
          leading run of drafts equal to it (inside the graph);
        * stochastic: accept d_j while ``u_j·q_j(d_j) < p_j(d_j)``, u_j
          from the `_ACCEPT_SALT` stream at pos+j; the first rejected
          position resamples from ``max(p - q, 0)`` (the `_RESID_SALT`
          stream at its position); a fully accepted window draws the
          bonus token from p_{k+1} with the plain pick at pos+k (after
          the graph: the draws come from host-seeded streams).

        Returns host ``(out (B, k+1), alen (B,))``, one copy from the
        card; the engine emits ``out[:, :alen+1]``.  Rejected
        positions' pages need no rollback: they are rewritten before
        any mask admits them.  The JAX package's `_build_spec_verify`
        program."""
        T = self._spec_k + 1
        posw = (pos[:, None] + np.arange(T)).reshape(-1)
        out = self.programs["spec_verify"].run(
            self.gather_params(), toks=toks, d_toks=d_toks,
            **self._slots(np.repeat(tables, T, axis=0), posw,
                          np.repeat(active, T)))
        if self._spec_greedy:
            res = out[1].cpu().numpy()
        else:
            o, alen = self._accept(out[0], d_toks, q, pos, seeds)
            res = torch.cat([o, alen[:, None]], dim=1).cpu().numpy()
        return res[:, :T], res[:, T]

    def _accept(self, logits, d_toks, q, pos, seeds):
        """Exact rejection sampling of the drafts against the target's
        distribution (see `spec_verify`)."""
        k = self._spec_k
        B, T, V = logits.shape
        dev = logits.device
        lg = G._top_k_logits(logits, self._temperature, self._top_k)
        p = torch.softmax(lg, dim=-1)                          # (B, T, V)
        # the k uniforms of each lane are scalars: drawn on the host
        u = torch.tensor([[_uniform(_stream(s, t + j, _ACCEPT_SALT))
                           for j in range(k)] for s, t in zip(seeds, pos)],
                         device=dev)
        pd = p[:, :k].gather(2, d_toks[..., None])[..., 0]
        qd = q.gather(2, d_toks[..., None])[..., 0]
        acc = (u * qd.clamp(min=1e-38) < pd).long()
        alen = acc.cumprod(dim=1).sum(dim=1)
        # the correction at every window position, each from its own
        # stream; the first rejected one is kept (host positions only,
        # so the card is not waited on)
        ts = (pos[:, None] + np.arange(k)).reshape(-1)
        resid = (p[:, :k] - q).clamp(min=0.0).reshape(B * k, V)
        corr = _sample(torch.log(resid + 1e-38), np.repeat(seeds, k), ts,
                       _RESID_SALT).reshape(B, k)
        corr = corr.gather(1, alen.clamp(max=k - 1)[:, None])[:, 0]
        bonus = _sample(lg[:, k], seeds, pos + k)
        last = torch.where(alen == k, bonus, corr)
        d_pad = torch.cat([d_toks, torch.zeros_like(d_toks[:, :1])], dim=1)
        idx = torch.arange(T, device=dev)[None, :]
        return torch.where(idx < alen[:, None], d_pad, last[:, None]), alen
