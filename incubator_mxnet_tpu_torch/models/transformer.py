"""Decoder-only Transformer language model (counterpart of the
`TransformerLM` of `incubator_mxnet_tpu/models/transformer.py`).

Pre-LN causal self-attention + gelu FFN layers, ``embed·√C + pe`` in,
``ln`` then ``head`` out.  The causal attention runs the flash kernel
on the card.  Parameter names are the JAX package's structural keys
(``embed.weight``, ``layer0.attn.qkv.weight``, ``ln.gamma``, ...), so
`convert.load_jax_params` carries a JAX model's weights over.
"""
from __future__ import annotations

import math

import torch

import torch.nn.functional as F

from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import Dense, Dropout, DropoutAdd, Embedding, LayerNorm
from ..ops.flash_attention import flash_attention
from ..ops.xent_kernel import fused_smoothed_xent, should_fuse
from .bert import (MultiHeadAttention, PositionwiseFFN, masked_attention,
                   valid_mask)
from .generation import _qkv_heads

__all__ = ["TransformerLM", "Transformer", "TransformerEncoder",
           "TransformerDecoder", "LabelSmoothedCELoss", "transformer_base",
           "transformer_big", "positional_encoding"]

# std of the normal initialization of weight matrices and embeddings
_INIT_STD = 0.02


def positional_encoding(T, C, dtype=torch.float32, device=None):
    """(T, C) sinusoids: sin on even columns, cos on odd."""
    pos = torch.arange(T, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(0, C, 2, device=device, dtype=torch.float32)
    angle = pos / torch.pow(10000.0, dim / C)
    pe = torch.zeros((T, C), device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, : (C // 2)])
    return pe.to(dtype)


class _CausalSelfAttention(MultiHeadAttention):
    """Causal self-attention through the flash kernel at every size, as
    the JAX package's `_CausalSelfAttention.forward` calls it (the
    crossover routing of `MultiHeadAttention` is BERT's)."""

    def forward(self, x):
        B, T, C = x.shape
        q, k, v = _qkv_heads(self.qkv(x), self._num_heads)   # (B, T, H, D)
        out = flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), causal=True)
        return self.proj(out.transpose(1, 2).reshape(B, T, C))


class _LMLayer(HybridBlock):
    """Decoder-only layer: pre-LN causal self-attention + FFN."""

    def __init__(self, units, hidden_size, num_heads, dropout, *, device,
                 dtype):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln1 = LayerNorm(units, **kw)
        self.attn = _CausalSelfAttention(units, num_heads, dropout, **kw)
        self.ln2 = LayerNorm(units, **kw)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                   activation="gelu", **kw)
        self.drop_add = DropoutAdd(dropout)

    def forward(self, x):
        x = self.drop_add(self.attn(self.ln1(x)), x)
        return self.drop_add(self.ffn(self.ln2(x)), x)


class TransformerLM(HybridBlock):
    """Decoder-only (GPT-style) language model.

    ``device`` defaults to ``cuda`` (`MXNetError` without a GPU unless
    ``device="cpu"``); weights are drawn from ``seed`` on the CPU, so a
    seed gives the same model on every device: normal(0, 0.02) matrices
    and embeddings, zero biases, unit LayerNorm gains.  Its parameters
    are trainable (``grad_req="write"``), as the JAX package's: the
    causal attention's backward is the flash backward kernels on the
    card.  Decoding (`generate`, `score`, the serving engine) runs under
    ``torch.no_grad()`` and records no graph.
    """

    def __init__(self, vocab=32000, units=512, hidden_size=2048,
                 num_layers=6, num_heads=8, max_len=4096, dropout=0.1, *,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        kw = {"device": dev, "dtype": dtype}
        self._units = units
        self._max_len = max_len
        self._num_layers = num_layers
        self.embed = Embedding(vocab, units, **kw)
        for i in range(num_layers):
            setattr(self, f"layer{i}",
                    _LMLayer(units, hidden_size, num_heads, dropout, **kw))
        self.ln = LayerNorm(units, **kw)
        self.head = Dense(vocab, units, flatten=False, **kw)
        self.register_buffer("_pe", positional_encoding(max_len, units,
                                                        device=dev),
                             persistent=False)
        self._init_weights(seed)
        # the int8 weight state of `quantize_for_decode` (None: float)
        self._decode_quant = None
        self.eval()

    @property
    def _layers(self):
        return [getattr(self, f"layer{i}") for i in range(self._num_layers)]

    @torch.no_grad()
    def _init_weights(self, seed):
        g = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.fill_(1.0)
            elif leaf in ("beta", "bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=g) * _INIT_STD)

    def forward(self, tokens):
        """Logits (B, T, vocab) in the model dtype for int tokens (B, T)."""
        T = tokens.shape[1]
        if T > self._max_len:
            raise ValueError(f"sequence {T} exceeds max_len {self._max_len}")
        h = self.embed(tokens) * math.sqrt(self._units)
        h = h + self._pe[:T].to(h.dtype)
        for lyr in self._layers:
            h = lyr(h)
        return self.head(self.ln(h))

    def generate(self, prompt, max_new_tokens, **kw):
        """KV-cache autoregressive decode; see
        `models.generation.lm_generate` (temperature / top_k / eos_id /
        seed / quantized)."""
        from .generation import lm_generate

        return lm_generate(self, prompt, max_new_tokens, **kw)

    def beam_search(self, prompt, max_new_tokens, **kw):
        """K-beam decode -> (sequences (B, K, P+N), scores (B, K)),
        best-first; see `models.generation.lm_beam_search` (beam_size /
        eos_id / GNMT length-penalty alpha / quantized)."""
        from .generation import lm_beam_search

        return lm_beam_search(self, prompt, max_new_tokens, **kw)

    def score(self, tokens, **kw):
        """Teacher-forced per-token log-probabilities through the decode
        stack's numerics; see `models.generation.lm_score`."""
        from .generation import lm_score

        return lm_score(self, tokens, **kw)

    def serve(self, **kw):
        """This net's shared continuous-batching serving engine, built on
        first use and reused after; see `serving.ServingEngine` (its
        ``quantized`` and ``kv_dtype`` pick the int8 weight path and the
        int8 KV pool)."""
        from ..serving import default_engine

        return default_engine(self, **kw)

    def quantize_for_decode(self, **kw):
        """Weight-quantize this net's transformer matmuls for decode
        (per-channel int8 + f32 scales, the scale in the matmul
        epilogue); see `contrib.quantization.quantize_for_decode`."""
        from ..contrib.quantization import quantize_for_decode

        return quantize_for_decode(self, **kw)

    def dequantize_decode(self):
        """Drop the decode-quantization marking: decode goes back to the
        float path."""
        from ..contrib.quantization import dequantize_decode

        return dequantize_decode(self)


# --------------------------------------------------------------------- #
# the encoder-decoder Transformer (WMT En-De)
# --------------------------------------------------------------------- #
class _CrossAttention(HybridBlock):
    """Attention of the decoder's states over the encoder memory
    (`models/transformer.py:67-104` of the JAX package): ``q_proj`` on
    the queries, ``kv_proj`` on the memory, f32 scores and softmax with
    the memory's padding mask, ``proj`` out."""

    def __init__(self, units, num_heads, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self._units = units
        self._num_heads = num_heads
        self.q_proj = Dense(units, units, flatten=False, **kw)
        self.kv_proj = Dense(2 * units, units, flatten=False, **kw)
        self.proj = Dense(units, units, flatten=False, **kw)

    def forward(self, x, mem, mem_mask=None):
        B, Tq, C = x.shape
        Tk = mem.shape[1]
        H = self._num_heads
        D = C // H
        q = self.q_proj(x).reshape(B, Tq, H, D).transpose(1, 2)
        k, v = self.kv_proj(mem).split(C, dim=-1)
        out = masked_attention(q, k.reshape(B, Tk, H, D).transpose(1, 2),
                               v.reshape(B, Tk, H, D).transpose(1, 2),
                               mem_mask)
        return self.proj(out.transpose(1, 2).reshape(B, Tq, C))


class _EncoderLayer(HybridBlock):
    """Pre-LN encoder layer (`:107-119`): ``x + drop(attn(ln1(x)))``,
    then ``x + drop(ffn(ln2(x)))``; the FFN drops its output itself
    first."""

    def __init__(self, units, hidden_size, num_heads, dropout, *, device,
                 dtype):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln1 = LayerNorm(units, **kw)
        self.attn = MultiHeadAttention(units, num_heads, dropout, **kw)
        self.ln2 = LayerNorm(units, **kw)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                   activation="relu", **kw)
        self.drop_add = DropoutAdd(dropout)

    def forward(self, x, mask=None):
        x = self.drop_add(self.attn(self.ln1(x), mask), x)
        return self.drop_add(self.ffn(self.ln2(x)), x)


class _DecoderLayer(HybridBlock):
    """Pre-LN decoder layer (`:122-137`): causal self-attention (the
    flash kernels), cross-attention over the memory, FFN, each added
    back through ``drop_add``."""

    def __init__(self, units, hidden_size, num_heads, dropout, *, device,
                 dtype):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln1 = LayerNorm(units, **kw)
        self.self_attn = _CausalSelfAttention(units, num_heads, dropout, **kw)
        self.ln2 = LayerNorm(units, **kw)
        self.cross_attn = _CrossAttention(units, num_heads, **kw)
        self.ln3 = LayerNorm(units, **kw)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                   activation="relu", **kw)
        self.drop_add = DropoutAdd(dropout)

    def forward(self, x, mem, mem_mask=None):
        x = self.drop_add(self.self_attn(self.ln1(x)), x)
        x = self.drop_add(self.cross_attn(self.ln2(x), mem, mem_mask), x)
        return self.drop_add(self.ffn(self.ln3(x)), x)


class TransformerEncoder(HybridBlock):
    """``num_layers`` `_EncoderLayer`s (``layer0``, ...), then ``ln``
    (`:140-153`)."""

    def __init__(self, num_layers, units, hidden_size, num_heads, dropout,
                 *, device=None, dtype=torch.float32):
        super().__init__()
        self._num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}", _EncoderLayer(
                units, hidden_size, num_heads, dropout, device=device,
                dtype=dtype))
        self.ln = LayerNorm(units, device=device, dtype=dtype)

    @property
    def _layers(self):
        return [getattr(self, f"layer{i}") for i in range(self._num_layers)]

    def forward(self, x, mask=None):
        for lyr in self._layers:
            x = lyr(x, mask)
        return self.ln(x)


class TransformerDecoder(HybridBlock):
    """``num_layers`` `_DecoderLayer`s, then ``ln`` (`:156-169`)."""

    def __init__(self, num_layers, units, hidden_size, num_heads, dropout,
                 *, device=None, dtype=torch.float32):
        super().__init__()
        self._num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}", _DecoderLayer(
                units, hidden_size, num_heads, dropout, device=device,
                dtype=dtype))
        self.ln = LayerNorm(units, device=device, dtype=dtype)

    @property
    def _layers(self):
        return [getattr(self, f"layer{i}") for i in range(self._num_layers)]

    def forward(self, x, mem, mem_mask=None):
        for lyr in self._layers:
            x = lyr(x, mem, mem_mask)
        return self.ln(x)


class Transformer(HybridBlock):
    """Encoder-decoder Transformer (`:291-351` of the JAX package):
    ``forward(src_tokens, tgt_tokens, src_valid_length=None)`` gives the
    (B, T, tgt_vocab) logits of the target given the source, the
    source's padding mask from ``src_valid_length`` applied in the
    encoder's self-attention and the decoder's cross-attention.

    With ``share_embed`` and one vocabulary, ``tgt_embed`` is
    ``src_embed`` (one parameter, ``src_embed.weight``; the JAX package
    also names it ``tgt_embed.weight``, which `convert.load_jax_params`
    takes as an alias).  ``device`` defaults to ``cuda`` (`MXNetError`
    without a GPU unless ``device="cpu"``); ``initialize()`` fills the
    weights.  The positional table is f32 and stays f32 under ``cast``:
    added to the embedding, it makes a bf16 model's residual stream, its
    ``DropoutAdd`` sums and the encoder memory f32, as in the JAX
    package, while the sublayers (LayerNorm's f32 output cast to the
    bf16 weights by each Dense) compute in bf16.  The cached decode step
    (`generation._nmt_decode_token`) casts the table to the parameters'
    dtype and keeps its residual stream bf16, as the JAX package's
    does."""

    def __init__(self, src_vocab=32000, tgt_vocab=32000, units=512,
                 hidden_size=2048, num_layers=6, num_heads=8, dropout=0.1,
                 max_length=1024, share_embed=True, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        kw = {"device": dev, "dtype": dtype}
        self._units = units
        self._max_length = max_length
        self.src_embed = Embedding(src_vocab, units, **kw)
        self.tgt_embed = self.src_embed \
            if share_embed and src_vocab == tgt_vocab \
            else Embedding(tgt_vocab, units, **kw)
        self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                          num_heads, dropout, **kw)
        self.decoder = TransformerDecoder(num_layers, units, hidden_size,
                                          num_heads, dropout, **kw)
        self.out_proj = Dense(tgt_vocab, units, flatten=False, **kw)
        self.drop = Dropout(dropout)
        self.register_buffer("_pe", positional_encoding(max_length, units,
                                                        device=dev),
                             persistent=False)
        # the int8 weight state of `quantize_for_decode` (None: float)
        self._decode_quant = None

    def _embed(self, embed, tokens):
        """``drop(embed(tokens)·√C + pe)``."""
        T = tokens.shape[1]
        if T > self._max_length:
            raise ValueError(f"sequence {T} exceeds max_length "
                             f"{self._max_length}")
        x = embed(tokens) * math.sqrt(self._units)
        return self.drop(x + self._pe[:T])

    def _apply(self, fn, recurse=True):
        """`nn.Module._apply` (``cast``, ``to``), the positional table
        kept f32 (the JAX package computes it in f32 at every call)."""
        pe = self._pe
        super()._apply(fn, recurse)
        if self._pe.dtype != pe.dtype:
            self._pe = pe.to(self._pe.device)
        return self

    def forward(self, src_tokens, tgt_tokens, src_valid_length=None):
        src = self._embed(self.src_embed, src_tokens)
        mask = None if src_valid_length is None \
            else valid_mask(src_valid_length, src.shape[1], src.device)
        mem = self.encoder(src, mask)
        dec = self.decoder(self._embed(self.tgt_embed, tgt_tokens), mem,
                           mask)
        return self.out_proj(dec)

    def translate(self, src, max_len, **kw):
        """Incremental translation: the encoder once through the public
        blocks, the decoder as captured programs; greedy by default,
        K-beam with ``beam_size=K``.  See
        `models.generation.nmt_translate`."""
        from .generation import nmt_translate

        return nmt_translate(self, src, max_len, **kw)

    def quantize_for_decode(self, **kw):
        """Weight-quantize the decoder's matmuls for translation
        (per-channel int8 + f32 scales; the encoder stays float); see
        `contrib.quantization.quantize_for_decode`."""
        from ..contrib.quantization import quantize_for_decode

        return quantize_for_decode(self, **kw)

    def dequantize_decode(self):
        """Drop the decode-quantization marking: translation goes back
        to the float path."""
        from ..contrib.quantization import dequantize_decode

        return dequantize_decode(self)


class LabelSmoothedCELoss(HybridBlock):
    """Label-smoothed cross-entropy averaged over the rows whose label is
    not ``ignore_index`` (`:353-387`): ``(1-eps)·nll + eps·mean(-logp)``
    per row, through the streamed kernels
    (`xent_kernel.fused_smoothed_xent`) for a vocabulary `should_fuse`
    takes, else ``log_softmax`` in the logits' dtype, as in the JAX
    package.  Ignored rows (the JAX package wraps their label; here it
    is 0) count nothing and get a zero gradient.  f32 scalar out.
    Hybridized at construction, as in the JAX package."""

    def __init__(self, smoothing=0.1, ignore_index=-1):
        super().__init__()
        self._eps = smoothing
        self._ignore = ignore_index
        self.hybridize()

    def forward(self, logits, labels):
        V = logits.shape[-1]
        lb = labels.long()
        valid = lb != self._ignore
        safe = torch.where(valid, lb, 0)
        if should_fuse(V):
            loss = fused_smoothed_xent(logits, safe, self._eps)
        else:
            logp = F.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, safe[..., None])[..., 0]
            smooth = -logp.mean(dim=-1)
            loss = (1 - self._eps) * nll + self._eps * smooth
        valid = valid.float()
        return (loss * valid).sum() / valid.sum().clamp(min=1.0)


def transformer_base(src_vocab=32000, tgt_vocab=32000, **kw):
    return Transformer(src_vocab, tgt_vocab, units=512, hidden_size=2048,
                       num_layers=6, num_heads=8, **kw)


def transformer_big(src_vocab=32000, tgt_vocab=32000, **kw):
    return Transformer(src_vocab, tgt_vocab, units=1024, hidden_size=4096,
                       num_layers=6, num_heads=16, **kw)
