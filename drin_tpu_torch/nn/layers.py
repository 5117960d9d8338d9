# -*- coding: utf-8 -*-
"""Encoder-layer library (port of ``drin_tpu/nn/layers.py``): pooling,
attention and GHMFC's fusion.  ``TransformerEncoderLayer``,
``MultilayerTransformer`` and ``LSTM`` are not ported yet.

Initialization follows torch defaults (Linear: U(-1/sqrt(fan_in), ..) for
weight and bias; attention in-proj: Xavier-uniform with zero bias), drawn
from an explicit ``torch.Generator`` when one is given so a seed fixes the
weights.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

from drin_tpu_torch.ops.core import span_mean


class Linear(nn.Linear):
    """``nn.Linear`` whose torch-default init can draw from a generator."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features)
        if generator is not None:
            bound = 1.0 / math.sqrt(in_features)
            with torch.no_grad():
                nn.init.uniform_(self.weight, -bound, bound, generator=generator)
                nn.init.uniform_(self.bias, -bound, bound, generator=generator)


def LayerNorm(dim: int) -> nn.LayerNorm:
    """torch LayerNorm with its own eps, 1e-5 (the JAX module pins it)."""
    return nn.LayerNorm(dim, eps=1e-5)


def get_activation(name: str) -> Callable:
    """Activation by name; gelu is the exact erf form."""
    table = {
        "gelu": functools.partial(F.gelu, approximate="none"),
        "relu": F.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "silu": F.silu,
        "elu": F.elu,
        "identity": lambda x: x,
    }
    return table[name]


class MaxPool(nn.Module):
    """max over an axis."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, seq, *args):
        return torch.amax(seq, dim=self.dim)


class Avg(nn.Module):
    """Span-average of token features between per-sample begin:end."""

    def forward(self, seq, begin, end, *args):
        return span_mean(seq, begin, end)


class AvgLinear(nn.Module):
    """Span-average followed by a projection (parameters under ``linear``)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = Linear(in_features, out_features, generator)

    def forward(self, seq, begin, end, *args):
        return self.linear(span_mean(seq, begin, end))


# ---------------------------------------------------------------------------
# attention


def dropout(x, rate: float, deterministic: bool, rng: Optional[torch.Generator]):
    """Inverted dropout with the mask drawn from an explicit generator
    (``F.dropout`` takes none): keep with probability ``1 - rate``, scale
    the kept values by ``1 / (1 - rate)``.  The identity when
    ``deterministic`` or ``rate == 0``."""
    if deterministic or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


class MultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention``-compatible attention (batch first),
    written out: projections, masked softmax and the two products, so the
    numbers are the JAX module's.  Parameters carry the upstream names:
    ``in_proj_weight`` [3E, E] when ``kdim == vdim == embed_dim``, else
    ``q_proj_weight`` / ``k_proj_weight`` / ``v_proj_weight``;
    ``in_proj_bias`` [3E]; ``out_proj``.  Dropout on the attention weights
    is applied only when ``deterministic=False``, from ``rng``."""

    def __init__(self, embed_dim: int, num_heads: int, kdim: Optional[int] = None,
                 vdim: Optional[int] = None, generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__()
        assert embed_dim % num_heads == 0, "embed_dim must be divisible by num_heads"
        E = embed_dim
        self.embed_dim, self.num_heads, self.dropout = E, num_heads, dropout
        kdim = E if kdim is None else kdim
        vdim = E if vdim is None else vdim
        self.packed = kdim == E and vdim == E
        if self.packed:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * E, E))
            weights = [self.in_proj_weight]
        else:
            self.q_proj_weight = nn.Parameter(torch.empty(E, E))
            self.k_proj_weight = nn.Parameter(torch.empty(E, kdim))
            self.v_proj_weight = nn.Parameter(torch.empty(E, vdim))
            weights = [self.q_proj_weight, self.k_proj_weight, self.v_proj_weight]
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * E))
        self.out_proj = Linear(E, E, generator)
        with torch.no_grad():
            # torch: xavier_uniform_ over the packed [3E, E] matrix, or over
            # each separate matrix; every bias zero
            for w in weights:
                nn.init.xavier_uniform_(w, generator=generator)
            self.out_proj.bias.zero_()

    def forward(self, query, key, value, key_padding_mask=None, deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        E, H = self.embed_dim, self.num_heads
        hd = E // H
        if self.packed:
            qw, kw, vw = self.in_proj_weight.chunk(3, dim=0)
        else:
            qw, kw, vw = self.q_proj_weight, self.k_proj_weight, self.v_proj_weight
        qb, kb, vb = self.in_proj_bias.chunk(3, dim=0)
        B, Lq, Lk = query.shape[0], query.shape[1], key.shape[1]
        q = F.linear(query, qw, qb).reshape(B, Lq, H, hd).transpose(1, 2)
        k = F.linear(key, kw, kb).reshape(B, Lk, H, hd).transpose(1, 2)
        v = F.linear(value, vw, vb).reshape(B, Lk, H, hd).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if key_padding_mask is not None:  # True = the key is masked out
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        attn = dropout(torch.softmax(logits, dim=-1), self.dropout, deterministic, rng)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, Lq, E)
        return self.out_proj(out)


class CrossAttention(nn.Module):
    """Bidirectional two-step cross-attention block: a attends to b, then
    the attended-b sequence attends back to a; four LayerNorms
    (``layernorms.0-3``) and two residual linears along the way."""

    def __init__(self, dim_a: int, dim_b: int, num_heads: int,
                 generator: Optional[torch.Generator] = None, dropout: float = 0.1):
        super().__init__()
        self.a2b_attention = MultiheadAttention(dim_a, num_heads, kdim=dim_b, vdim=dim_b,
                                                generator=generator, dropout=dropout)
        self.b2a_attention = MultiheadAttention(dim_a, num_heads, generator=generator,
                                                dropout=dropout)
        self.a2b_ffn = Linear(dim_a, dim_a, generator)
        self.b2a_ffn = Linear(dim_a, dim_a, generator)
        self.layernorms = nn.ModuleList([LayerNorm(dim_a) for _ in range(4)])

    def forward(self, seq_a, mask_a, seq_b, mask_b=None, deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        # a mask of None: no key of that sequence is masked
        kpm_a = (mask_a == 0) if mask_a is not None else None
        kpm_b = (mask_b == 0) if mask_b is not None else None
        ln = self.layernorms
        attended_b = ln[0](self.a2b_attention(seq_a, seq_b, seq_b, kpm_b, deterministic, rng))
        attended_b = ln[1](self.a2b_ffn(attended_b) + attended_b)
        attended_a = ln[2](self.b2a_attention(attended_b, seq_a, seq_a, kpm_a, deterministic,
                                                  rng))
        return ln[3](self.b2a_ffn(attended_a) + attended_a)


class MultimodalFusion(nn.Module):
    """GHMFC's gated text/image fusion: two cross attentions, max-pool,
    per-modality projection + activation, a 2-way softmax gate, then the
    gate-weighted sum."""

    def __init__(self, text_dim: int, image_dim: int, output_dim: int, num_heads: int,
                 activation: str = "gelu", generator: Optional[torch.Generator] = None,
                 dropout: float = 0.1):
        super().__init__()
        self.act = get_activation(activation)
        self.t2v_attention = CrossAttention(text_dim, image_dim, num_heads, generator, dropout)
        self.v2t_attention = CrossAttention(image_dim, text_dim, num_heads, generator, dropout)
        self.text_linear = Linear(text_dim, output_dim, generator)
        self.image_linear = Linear(image_dim, output_dim, generator)
        self.score_linear = Linear(2 * output_dim, 2, generator)

    def forward(self, text_seq, text_mask, image_seq, deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        # every image region is a valid key: no image mask
        t = self.t2v_attention(text_seq, text_mask, image_seq, None, deterministic, rng)
        attended_text = self.act(self.text_linear(torch.amax(t, dim=1)))
        v = self.v2t_attention(image_seq, None, text_seq, text_mask, deterministic, rng)
        attended_image = self.act(self.image_linear(torch.amax(v, dim=1)))
        score = torch.softmax(
            self.score_linear(torch.cat([attended_text, attended_image], dim=1)), dim=-1)
        stacked = torch.stack([attended_text, attended_image], dim=1)  # [B, 2, D]
        return torch.einsum("bk,bkd->bd", score, stacked)
