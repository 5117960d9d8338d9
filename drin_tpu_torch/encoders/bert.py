# -*- coding: utf-8 -*-
"""BERT encoder, numerics-compatible with HF ``BertModel`` in eval mode (port
of ``drin_tpu/encoders/bert.py``).

Parameters carry the HF ``BertModel.state_dict()`` keys
(``embeddings.word_embeddings.weight``,
``encoder.layer.{i}.attention.self.query.weight``, ..., ``pooler.dense.weight``),
the keys ``drin_tpu.encoders.bert.bert_params_from_torch`` reads.

Numerics: LayerNorm eps 1e-12, exact-erf gelu, additive attention mask with
finfo-min fill, no dropout.  Self-attention takes the hand-written kernel
(``ops/cuda/attention.py``) under the JAX package's gate, ``fused and
L % 8 == 0 and L >= FUSED_ATTENTION_MIN_LEN``, and the written-out product
otherwise (outside any kernel in the JAX package too).

In float32 a layer's four linears go through ``ops/cuda/linear.py``: query,
key and value as one product over their stacked weights (its three outputs
laid out as the separate products would lay them), the FFN's first linear
with its gelu and the two output linears with their residual in the
product's epilogue.  On the CPU
that is ``F.linear`` and the same epilogue; on the card the split-TF32
kernel.  Other dtypes (the bf16 bodies) keep ``F.linear``, as does the
pooler.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from drin_tpu_torch.common.spans import span
from drin_tpu_torch.nn.layers import Linear
from drin_tpu_torch.ops.cuda.attention import fused_attention
from drin_tpu_torch.ops.cuda.linear import SplitImage, linear


class BertConfig:
    def __init__(
        self,
        vocab_size: int = 28996,  # bert-base-cased
        hidden_size: int = 768,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        intermediate_size: int = 3072,
        max_position_embeddings: int = 512,
        type_vocab_size: int = 2,
        layer_norm_eps: float = 1e-12,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.layer_norm_eps = layer_norm_eps


# The JAX package's gate, kept so that both packages take the same path for
# the same sequence length; where the kernel starts to pay on this card has
# not been measured.
FUSED_ATTENTION_MIN_LEN = 256


def _normal(shape, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * 0.02)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = cfg
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size,
                                            _weight=_normal((c.vocab_size, c.hidden_size),
                                                            generator))
        self.position_embeddings = nn.Embedding(
            c.max_position_embeddings, c.hidden_size,
            _weight=_normal((c.max_position_embeddings, c.hidden_size), generator))
        self.token_type_embeddings = nn.Embedding(
            c.type_vocab_size, c.hidden_size,
            _weight=_normal((c.type_vocab_size, c.hidden_size), generator))
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, input_ids, token_type_ids):
        L = input_ids.shape[1]
        x = (self.word_embeddings(input_ids) + self.position_embeddings.weight[None, :L]
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    """``fused`` keeps ``Config.bert_fused_attention``'s tri-state and is
    settled at each call from the device the tensor lies on, so a model built
    on the CPU and moved to the card takes the kernel there."""

    def __init__(self, cfg: BertConfig, fused: Optional[bool] = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads, self.fused = cfg.num_attention_heads, fused
        self.query = Linear(D, D, generator)
        self.key = Linear(D, D, generator)
        self.value = Linear(D, D, generator)
        self.qkv_image = SplitImage()  # the float32 kernel's image of the three weights

    def takes_kernel(self, device, L: int) -> bool:
        """The JAX package's gate for a sequence of ``L`` tokens on ``device``."""
        return (resolve_fused_attention(self.fused, device) and L % 8 == 0
                and L >= FUSED_ATTENTION_MIN_LEN)

    def forward(self, x, additive_mask):
        with span("drin.bert.attention"):
            return self._forward(x, additive_mask)

    def _forward(self, x, additive_mask):
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H
        if x.dtype == torch.float32:  # one product over the stacked weights: [3, B, L, D]
            parts = (self.query, self.key, self.value)
            q, k, v = linear(x, [m.weight for m in parts], [m.bias for m in parts],
                             image=self.qkv_image).unbind(0)
        else:
            q, k, v = self.query(x), self.key(x), self.value(x)
        q = q.reshape(B, L, H, hd).transpose(1, 2)
        k = k.reshape(B, L, H, hd).transpose(1, 2)
        v = v.reshape(B, L, H, hd).transpose(1, 2)
        if self.takes_kernel(x.device, L):
            # the kernel reads the strided views in place and writes
            # [B, L, H, hd], so the transpose back below copies nothing
            flat = None if additive_mask is None else additive_mask[:, 0, 0, :]
            out = fused_attention(q, k, v, flat)
        else:
            logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
            if additive_mask is not None:
                logits = logits + additive_mask
            out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return out.transpose(1, 2).reshape(B, L, D)


class _SelfOutput(nn.Module):
    """dense + residual LayerNorm (HF ``BertSelfOutput`` / ``BertOutput``)."""

    def __init__(self, in_features: int, cfg: BertConfig, generator):
        super().__init__()
        self.dense = Linear(in_features, cfg.hidden_size, generator)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.image = SplitImage()

    def forward(self, h, residual):
        if h.dtype == torch.float32:  # the residual added in the product's epilogue
            return self.LayerNorm(linear(h, [self.dense.weight], [self.dense.bias],
                                         residual=residual, image=self.image))
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig, fused: Optional[bool], generator):
        super().__init__()
        self.self = BertSelfAttention(cfg, fused, generator)
        self.output = _SelfOutput(cfg.hidden_size, cfg, generator)


class _Dense(nn.Module):
    """A linear under the key ``dense`` (HF ``BertIntermediate`` / ``BertPooler``)."""

    def __init__(self, in_features: int, out_features: int, generator):
        super().__init__()
        self.dense = Linear(in_features, out_features, generator)
        self.image = SplitImage()  # the FFN's float32 product (the pooler never builds one)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, fused_attention: Optional[bool] = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attention = _Attention(cfg, fused_attention, generator)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size, generator)
        self.output = _SelfOutput(cfg.intermediate_size, cfg, generator)

    def forward(self, x, additive_mask):
        x = self.attention.output(self.attention.self(x, additive_mask), x)
        if x.dtype == torch.float32:  # gelu in the product's epilogue
            dense = self.intermediate.dense
            h = linear(x, [dense.weight], [dense.bias], gelu=True, image=self.intermediate.image)
        else:
            h = F.gelu(self.intermediate.dense(x), approximate="none")
        return self.output(h, x)


def resolve_fused_attention(flag, device) -> bool:
    """``Config.bert_fused_attention`` tri-state for a tensor on ``device``:
    None = auto, the kernel on a CUDA device and the written-out product on
    the CPU.  Short sequences are additionally gated per call in
    :class:`BertSelfAttention`."""
    if flag is None:
        return torch.device(device).type == "cuda"
    return bool(flag)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig, fused_attention: Optional[bool], generator):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg, fused_attention, generator)
                                    for _ in range(cfg.num_hidden_layers)])


class BertModel(nn.Module):
    """Returns (last_hidden_state [B, L, D], pooler_output [B, D]).

    ``fused_attention=True`` routes self-attention through the hand-written
    kernel where the gate allows; None does so for tensors on a CUDA device
    (:func:`resolve_fused_attention`).  ``remat`` recomputes each layer in
    the backward instead of keeping its activations
    (``torch.utils.checkpoint``, non-reentrant): the layer's forward, its
    attention kernel included, then runs a second time inside the backward.
    It is read only where a gradient is being recorded."""

    def __init__(self, cfg: BertConfig, remat: bool = False,
                 fused_attention: Optional[bool] = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.remat = cfg, remat
        self.embeddings = BertEmbeddings(cfg, generator)
        self.encoder = _Encoder(cfg, fused_attention, generator)
        self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        additive = None
        if attention_mask is not None:
            neg = torch.finfo(x.dtype).min
            additive = torch.zeros(attention_mask.shape, dtype=x.dtype, device=x.device)
            additive = additive.masked_fill(attention_mask == 0, neg)[:, None, None, :]
        remat = self.remat and torch.is_grad_enabled() and x.requires_grad
        for layer in self.encoder.layer:
            if remat:
                # The recompute runs inside the backward.  A caller that swapped
                # the parameters for this forward (the trainer's copies in the
                # compute dtype) has put the masters back by then, so the
                # recompute is handed the layer's tensors of this moment.
                x = checkpoint(torch.func.functional_call, layer, dict(layer.named_parameters()),
                               (x, additive), use_reentrant=False)
            else:
                x = layer(x, additive)
        pooled = torch.tanh(self.pooler.dense(x[:, 0]))
        return x, pooled
