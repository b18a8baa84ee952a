"""BERT — encoder and pretraining heads (counterpart of
`incubator_mxnet_tpu/models/bert.py`).

Layout (batch, seq, hidden) throughout; children and parameter names
are the JAX package's structural names
(``bert.encoder.layer0.attention.qkv.weight``, ...), so
`convert.load_jax_params` carries a JAX model's weights one to one.

Attention routing is the JAX package's off the CPU: below the flash
crossover (`ops.flash_attention.kernel_active`; always on the CPU) the
heads stay in (B, T, H, D) and `attention_bthd` runs as torch ops,
which autograd differentiates; at or above it (T >= 512) the flash
kernels run, and under ``autograd.record()`` the backward goes through
the flash dK/dV and dQ kernels (`ops.flash_attention`).  A padding
mask (``valid_length``) always takes torch ops, at every T, as it takes
the XLA path in the JAX package (`masked_attention`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import ndarray as nd
from ..context import resolve_device
from ..gluon.block import HybridBlock
from ..gluon.nn import Dense, Dropout, DropoutAdd, Embedding, LayerNorm
from ..ops.flash_attention import (attention_bthd, flash_attention,
                                   kernel_active)
from .generation import _qkv_heads

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "BERTLayer",
           "BERTEncoder", "BERTModel", "BERTForPretraining", "bert_base",
           "bert_large", "masked_attention", "valid_mask"]

_F32_MIN = torch.finfo(torch.float32).min


def masked_attention(q, k, v, mask):
    """Attention of (B, H, Tq, D) queries over (B, H, Tk, D) keys and
    values where ``mask`` (B, Tk) is nonzero: f32 scores, masked keys at
    ``finfo(f32).min``, f32 softmax and P·V product, cast back to q's
    dtype (the masked branch of the JAX package's
    `MultiHeadAttention.forward`, `models/bert.py:119-127`, and of its
    `_CrossAttention`, `models/transformer.py:84-98`)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    if mask is not None:
        m = mask.reshape(mask.shape[0], 1, 1, mask.shape[-1]).bool()
        s = torch.where(m, s, _F32_MIN)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def valid_mask(valid_length, T, device):
    """(B, T) f32 mask, 1 where the position is below the row's valid
    length (the JAX package's ``arange(T) < valid_length``)."""
    vl = torch.as_tensor(valid_length, device=device).reshape(-1, 1)
    return (torch.arange(T, device=device)[None, :] < vl).float()


class MultiHeadAttention(HybridBlock):
    """Self-attention: ``qkv`` projects to (B, T, 3C), split in the order
    of `generation._qkv_heads`; ``proj`` maps the heads back."""

    def __init__(self, units, num_heads, dropout=0.0, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._dropout = dropout
        self.qkv = Dense(3 * units, units, flatten=False, device=device,
                         dtype=dtype)
        self.proj = Dense(units, units, flatten=False, device=device,
                          dtype=dtype)

    def forward(self, x, mask=None):
        B, T, C = x.shape
        q, k, v = _qkv_heads(self.qkv(x), self._num_heads)   # (B, T, H, D)
        if mask is not None:
            out = masked_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), mask)
            return self.proj(out.transpose(1, 2).reshape(B, T, C))
        if not kernel_active(T, T, x.device):
            return self.proj(attention_bthd(q, k, v).reshape(B, T, C))
        out = flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous())
        return self.proj(out.transpose(1, 2).reshape(B, T, C))


class PositionwiseFFN(HybridBlock):
    """``ffn_dense2(act(ffn_dense1(x)))``, then dropout unless
    ``drop_output=False`` (the parent fuses it with its residual add)."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 drop_output=True, *, device=None, dtype=torch.float32):
        super().__init__()
        self.ffn_dense1 = Dense(hidden_size, units, flatten=False,
                                device=device, dtype=dtype)
        self.ffn_dense2 = Dense(units, hidden_size, flatten=False,
                                device=device, dtype=dtype)
        self.drop = Dropout(dropout)
        self._act = activation
        self._drop_output = drop_output

    def forward(self, x):
        h = self.ffn_dense1(x)
        h = nd.gelu(h) if self._act == "gelu" \
            else nd.Activation(h, act_type=self._act)
        h = self.ffn_dense2(h)
        return self.drop(h) if self._drop_output else h


class BERTLayer(HybridBlock):
    """Post-LN encoder layer: ``ln1(x + drop(attn(x)))``, then
    ``ln2(x + drop(ffn(x)))``."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.1, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.attention = MultiHeadAttention(units, num_heads, dropout, **kw)
        self.ln1 = LayerNorm(units, **kw)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                   drop_output=False, **kw)
        self.ln2 = LayerNorm(units, **kw)
        self.drop_add = DropoutAdd(dropout)

    def forward(self, x, mask=None):
        x = self.ln1(self.drop_add(self.attention(x, mask), x))
        return self.ln2(self.drop_add(self.ffn(x), x))


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.1, *, device=None, dtype=torch.float32):
        super().__init__()
        self._num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer{i}",
                    BERTLayer(units, hidden_size, num_heads, dropout,
                              device=device, dtype=dtype))

    def forward(self, x, mask=None):
        for i in range(self._num_layers):
            x = getattr(self, f"layer{i}")(x, mask)
        return x


class BERTModel(HybridBlock):
    """Embeddings (word + position, + token type when given), LayerNorm,
    dropout, the encoder, and a tanh pooler over the first token.
    ``device`` defaults to ``cuda`` (`MXNetError` without a GPU unless
    ``device="cpu"``); ``initialize()`` fills the weights."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self._units = units
        self.word_embed = Embedding(vocab_size, units, **kw)
        self.token_type_embed = Embedding(type_vocab_size, units, **kw)
        self.position_embed = Embedding(max_length, units, **kw)
        self.embed_ln = LayerNorm(units, **kw)
        self.embed_drop = Dropout(dropout)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout, **kw)
        self.pooler = Dense(units, units, activation="tanh", flatten=False,
                            **kw)

    def forward(self, inputs, token_types=None, valid_length=None):
        B, T = inputs.shape
        pos = torch.arange(T, device=inputs.device).expand(B, T)
        emb = self.word_embed(inputs) + self.position_embed(pos)
        if token_types is not None:
            emb = emb + self.token_type_embed(token_types)
        emb = self.embed_drop(self.embed_ln(emb))
        mask = None if valid_length is None \
            else valid_mask(valid_length, T, inputs.device)
        seq = self.encoder(emb, mask)
        return seq, self.pooler(seq[:, 0])


class BERTForPretraining(HybridBlock):
    """MLM + NSP heads over a `BERTModel`: ``(mlm_logits (B, T, V),
    nsp_logits (B, 2))``."""

    def __init__(self, bert: Optional[BERTModel] = None, vocab_size=30522,
                 **bert_kwargs):
        super().__init__()
        self.bert = bert or BERTModel(vocab_size=vocab_size, **bert_kwargs)
        units = self.bert._units
        kw = {"device": self.bert.pooler.weight.device,
              "dtype": self.bert.pooler.weight.dtype}
        self.mlm_dense = Dense(units, units, flatten=False, **kw)
        self.mlm_ln = LayerNorm(units, **kw)
        self.mlm_decoder = Dense(vocab_size, units, flatten=False, **kw)
        self.nsp = Dense(2, units, flatten=False, **kw)

    def forward(self, inputs, token_types=None, valid_length=None):
        seq, pooled = self.bert(inputs, token_types, valid_length)
        h = self.mlm_ln(nd.gelu(self.mlm_dense(seq)))
        return self.mlm_decoder(h), self.nsp(pooled)


def bert_base(vocab_size=30522, **kw):
    return BERTModel(vocab_size, units=768, hidden_size=3072, num_layers=12,
                     num_heads=12, **kw)


def bert_large(vocab_size=30522, **kw):
    return BERTModel(vocab_size, units=1024, hidden_size=4096, num_layers=24,
                     num_heads=16, **kw)
