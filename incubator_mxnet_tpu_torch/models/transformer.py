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

from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import DropoutAdd, Embedding, LayerNorm, Dense
from ..ops.flash_attention import flash_attention
from .bert import MultiHeadAttention, PositionwiseFFN
from .generation import _qkv_heads

__all__ = ["TransformerLM", "positional_encoding"]

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
        self.head = Dense(vocab, units, **kw)
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
