# -*- coding: utf-8 -*-
"""granite-4.0-h-micro's decoder stack as a text tower: Mamba-2 state-space
layers beside causal grouped-query attention (``granitemoehybrid``,
huggingface.co/ibm-granite/granite-4.0-h-micro), no positions, muP
multipliers.  It encodes only: the last hidden states feed GHMFC's pooling
(``models/ghmfc.py``), the LM head is not used.

Parameters carry the upstream keys under the tower's own prefix:
``embed_tokens.weight``, ``layers.{i}.input_layernorm.weight``,
``layers.{i}.mamba.{in_proj,conv1d,dt_bias,A_log,D,norm,out_proj}`` or
``layers.{i}.self_attn.{q,k,v,o}_proj.weight``,
``layers.{i}.shared_mlp.{input,output}_linear.weight``,
``layers.{i}.post_attention_layernorm.weight`` and ``norm.weight``.

Per layer, with the mixer picked by ``layer_types``::

    x = x + residual_multiplier * mixer(rmsnorm(x))
    x = x + residual_multiplier * output_linear(silu(a) * b),  [a, b] = input_linear(rmsnorm(x))

after ``x = embed(ids) * embedding_multiplier``, and a last RMSNorm.  The
Mamba-2 mixer: ``in_proj`` gives ``[z, xBC, dt]``; ``xBC`` goes through a
causal depthwise conv (with bias) and silu and splits into ``x, B, C``;
``dt = softplus(dt + dt_bias)`` and ``A = -exp(A_log)`` in float32; the
chunked scan (``ops/cuda/ssd.py``, the kernel on CUDA); ``y * silu(z)``
normalised over all channels (one group); ``out_proj``.  Attention: q, k, v
without bias, each key head shared by ``num_attention_heads /
num_key_value_heads`` query heads, causal, ``softmax(q.k^T *
attention_multiplier)``, ``o_proj``; written out in plain PyTorch on every
device, in blocks of sequences.

The tower runs in the dtype its parameters are cast to; products accumulate
in float32, norms and the scan's decays and state are float32.  Sequences
are right-padded: the model is causal, so a real token never sees the
padding, and the mask is not read.
"""

from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from drin_tpu_torch.common.spans import span
from drin_tpu_torch.ops.cuda import ssd

# the published layer pattern: an attention layer at 5, 15, 25 and 35
_LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba" for i in range(40))


class GraniteHybridConfig:
    """The tower's settings under the upstream ``config.json`` keys; the
    defaults are granite-4.0-h-micro's.  :meth:`from_dict` takes the keys it
    knows from a larger dict (a benchmark configuration file) and leaves the
    rest."""

    def __init__(
        self,
        vocab_size: int = 100352,
        hidden_size: int = 2048,
        num_hidden_layers: int = 40,
        layer_types=_LAYER_TYPES,
        shared_intermediate_size: int = 8192,
        num_attention_heads: int = 32,
        num_key_value_heads: int = 8,
        attention_bias: bool = False,
        attention_multiplier: float = 0.015625,
        embedding_multiplier: float = 12.0,
        residual_multiplier: float = 0.22,
        rms_norm_eps: float = 1e-5,
        mamba_n_heads: int = 64,
        mamba_d_head: int = 64,
        mamba_d_state: int = 128,
        mamba_n_groups: int = 1,
        mamba_d_conv: int = 4,
        mamba_expand: int = 2,
        mamba_chunk_size: int = 256,
        mamba_conv_bias: bool = True,
        mamba_proj_bias: bool = False,
        num_local_experts: int = 0,
        position_embedding_type: str = "nope",
        hidden_act: str = "silu",
    ):
        layer_types = tuple(layer_types)
        if len(layer_types) != num_hidden_layers or not set(layer_types) <= {"mamba", "attention"}:
            raise ValueError(f"layer_types must name 'mamba' or 'attention' for each of the "
                             f"{num_hidden_layers} layers, got {layer_types}")
        if num_local_experts:
            raise ValueError("the tower has the shared MLP alone: num_local_experts must be 0")
        if position_embedding_type != "nope" or hidden_act != "silu":
            raise ValueError("the tower takes no positions ('nope') and silu, got "
                             f"{position_embedding_type!r}, {hidden_act!r}")
        if attention_bias or mamba_proj_bias:
            raise ValueError("the tower's projections have no bias")
        if mamba_n_groups != 1:
            raise ValueError(f"the scan takes one group of B and C, got {mamba_n_groups}")
        if mamba_n_heads * mamba_d_head != mamba_expand * hidden_size:
            raise ValueError("mamba_n_heads * mamba_d_head must equal mamba_expand * hidden_size")
        if hidden_size % num_attention_heads or num_attention_heads % num_key_value_heads:
            raise ValueError("the query heads must split the width and share the key heads")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.layer_types = layer_types
        self.shared_intermediate_size = shared_intermediate_size
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads
        self.attention_multiplier = attention_multiplier
        self.embedding_multiplier = embedding_multiplier
        self.residual_multiplier = residual_multiplier
        self.rms_norm_eps = rms_norm_eps
        self.mamba_n_heads = mamba_n_heads
        self.mamba_d_head = mamba_d_head
        self.mamba_d_state = mamba_d_state
        self.mamba_d_conv = mamba_d_conv
        self.mamba_chunk_size = mamba_chunk_size
        self.mamba_conv_bias = mamba_conv_bias

    @classmethod
    def from_dict(cls, d: dict) -> "GraniteHybridConfig":
        known = set(inspect.signature(cls.__init__).parameters) - {"self"}
        return cls(**{k: v for k, v in d.items() if k in known})


def _normal(shape, generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * 0.02)


def _linear(fan_in: int, fan_out: int, generator) -> nn.Linear:
    """A linear without bias, N(0, 0.02) from ``generator``."""
    lin = nn.Linear(fan_in, fan_out, bias=False)
    lin.weight = _normal((fan_out, fan_in), generator)
    return lin


class RMSNorm(nn.Module):
    """``weight * (x / rms(x))`` taken in float32, rounded back to the input's
    dtype before the weight (the upstream ``GraniteMoeHybridRMSNorm``)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x, gate=None):
        h = x.float()
        if gate is not None:  # the mixer's gated form: y * silu(z), then the norm
            h = h * F.silu(gate.float())
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * h.to(x.dtype)


class Mamba2Mixer(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        H, P, S = cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state
        self.d_inner = H * P
        self.conv_dim = self.d_inner + 2 * S
        self.in_proj = _linear(cfg.hidden_size, self.d_inner + self.conv_dim + H, generator)
        self.conv1d = nn.Conv1d(self.conv_dim, self.conv_dim, cfg.mamba_d_conv,
                                groups=self.conv_dim, bias=cfg.mamba_conv_bias,
                                padding=cfg.mamba_d_conv - 1)
        self.dt_bias = nn.Parameter(torch.zeros(H))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, H)))
        self.D = nn.Parameter(torch.ones(H))
        self.norm = RMSNorm(self.d_inner, cfg.rms_norm_eps)
        self.out_proj = _linear(self.d_inner, cfg.hidden_size, generator)

    def forward(self, x):
        with span("drin.granite.mamba"):
            cfg = self.cfg
            Nb, L, _ = x.shape
            H, P, S = cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state
            z, xBC, dt = self.in_proj(x).split([self.d_inner, self.conv_dim, H], dim=-1)
            xBC = self.conv1d(xBC.transpose(1, 2))[..., :L]  # causal: the left padding only
            xBC = F.silu(xBC).transpose(1, 2).contiguous()  # [N, L, conv_dim]
            xs, B, C = xBC.split([self.d_inner, S, S], dim=-1)
            dt = F.softplus(dt.float() + self.dt_bias.float())
            A = -torch.exp(self.A_log.float())
            y = ssd.ssd_scan(xs.view(Nb, L, H, P), dt, A, B, C, self.D.float(),
                             cfg.mamba_chunk_size)
            return self.out_proj(self.norm(y.reshape(Nb, L, self.d_inner), z))


def causal_attention(q, k, v, block_elems: int = 1 << 28):
    """softmax(q.k^T, causal) . v written out: q [N, Hk, G·L, d] (each key
    head's G query heads stacked along the rows, already scaled), k, v [N,
    Hk, L, d] -> [N, Hk, G·L, d].  The logits are taken in the inputs' dtype
    (float32 accumulation), the softmax in float32 and rounded back, a block
    of sequences at a time so that the logits hold at most ``block_elems``."""
    N, Hk, GL, _ = q.shape
    L = k.shape[2]
    future = torch.ones(L, L, dtype=torch.bool, device=q.device).triu(1).repeat(GL // L, 1)
    step = max(1, block_elems // (Hk * GL * L))
    out = []
    for i in range(0, N, step):
        logits = torch.matmul(q[i:i + step], k[i:i + step].transpose(-1, -2))
        logits.masked_fill_(future, float("-inf"))
        out.append(torch.matmul(torch.softmax(logits, dim=-1), v[i:i + step]))
    return torch.cat(out) if len(out) > 1 else out[0]


class GQAttention(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        D, Hq, Hk = cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads
        d = D // Hq
        self.q_proj = _linear(D, Hq * d, generator)
        self.k_proj = _linear(D, Hk * d, generator)
        self.v_proj = _linear(D, Hk * d, generator)
        self.o_proj = _linear(Hq * d, D, generator)

    def forward(self, x):
        with span("drin.granite.attention"):
            cfg = self.cfg
            Nb, L, D = x.shape
            Hq, Hk = cfg.num_attention_heads, cfg.num_key_value_heads
            G, d = Hq // Hk, D // Hq
            # query head j * G + g reads key head j (the upstream repeat_kv)
            q = (self.q_proj(x) * cfg.attention_multiplier).view(Nb, L, Hk, G, d)
            q = q.permute(0, 2, 3, 1, 4).reshape(Nb, Hk, G * L, d)
            k = self.k_proj(x).view(Nb, L, Hk, d).transpose(1, 2)
            v = self.v_proj(x).view(Nb, L, Hk, d).transpose(1, 2)
            out = causal_attention(q, k, v).view(Nb, Hk, G, L, d)
            return self.o_proj(out.permute(0, 3, 1, 2, 4).reshape(Nb, L, D))


class SharedMLP(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_linear = _linear(cfg.hidden_size, 2 * cfg.shared_intermediate_size, generator)
        self.output_linear = _linear(cfg.shared_intermediate_size, cfg.hidden_size, generator)

    def forward(self, x):
        a, b = self.input_linear(x).chunk(2, dim=-1)
        return self.output_linear(F.silu(a) * b)


class GraniteHybridLayer(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, kind: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.residual = cfg.residual_multiplier
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if kind == "mamba":
            self.mamba = Mamba2Mixer(cfg, generator)
        else:
            self.self_attn = GQAttention(cfg, generator)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.shared_mlp = SharedMLP(cfg, generator)

    def forward(self, x):
        mixer = self.mamba if hasattr(self, "mamba") else self.self_attn
        x = x + mixer(self.input_layernorm(x)) * self.residual
        return x + self.shared_mlp(self.post_attention_layernorm(x)) * self.residual


class GraniteHybridModel(nn.Module):
    """Returns (last_hidden_state [N, L, D], None): the call shape of
    ``BertModel``, which has a pooler output where this tower has none."""

    def __init__(self, cfg: GraniteHybridConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         _weight=_normal((cfg.vocab_size, cfg.hidden_size),
                                                         generator))
        self.layers = nn.ModuleList([GraniteHybridLayer(cfg, kind, generator)
                                     for kind in cfg.layer_types])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids, attention_mask=None):
        x = self.embed_tokens(input_ids) * self.cfg.embedding_multiplier
        for layer in self.layers:
            x = layer(x)
        return self.norm(x), None
