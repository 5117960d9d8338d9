# -*- coding: utf-8 -*-
"""CLIP dual encoder, numerics-compatible with HF ``CLIPModel`` (port of
``drin_tpu/encoders/clip.py``; ``openai/clip-vit-base-patch32``).

The preprocessing stage runs it frozen to precompute the two cross-modal
edge matrices (mention image x entity texts, entity images x mention text).

Numerics: pre-LN transformer with quick_gelu, LayerNorm eps from the config
(1e-5), q scaled by hd^-0.5 before the product, a causal additive mask
(finfo.min above the diagonal) in the text tower, end-of-text pooling at
``argmax(input_ids)`` (the end token must hold the vocabulary's largest id;
padding repeats it, and argmax takes the first), the vision tower's patch
convolution (stride = patch, no bias), class token and ``pre_layrnorm``.
The products are ``torch.matmul``: the JAX package computes them outside any
kernel too.

Parameters carry HF ``CLIPModel.state_dict()``'s keys
(``text_model.encoder.layers.{i}.self_attn.q_proj.weight``,
``vision_model.embeddings.class_embedding``, ``visual_projection.weight``,
``logit_scale``, ...).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPTextConfig:
    def __init__(self, vocab_size=49408, hidden_size=512, num_layers=12, num_heads=8,
                 intermediate_size=2048, max_position_embeddings=77, layer_norm_eps=1e-5):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.layer_norm_eps = layer_norm_eps


class CLIPVisionConfig:
    def __init__(self, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
                 image_size=224, patch_size=32, layer_norm_eps=1e-5):
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.image_size = image_size
        self.patch_size = patch_size
        self.layer_norm_eps = layer_norm_eps


class CLIPConfig:
    def __init__(self, text=None, vision=None, projection_dim=512):
        self.text = text or CLIPTextConfig()
        self.vision = vision or CLIPVisionConfig()
        self.projection_dim = projection_dim


class CLIPAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x, causal_mask=None):
        B, L, E = x.shape
        H = self.num_heads
        hd = E // H
        q = (self.q_proj(x) * hd ** -0.5).reshape(B, L, H, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(B, L, H, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(B, L, H, hd).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2))
        if causal_mask is not None:
            logits = logits + causal_mask
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, E))


class _MLP(nn.Module):
    def __init__(self, embed_dim: int, intermediate_size: int):
        super().__init__()
        self.fc1 = nn.Linear(embed_dim, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, embed_dim)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, intermediate_size: int, eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(embed_dim, num_heads)
        self.layer_norm1 = nn.LayerNorm(embed_dim, eps=eps)
        self.mlp = _MLP(embed_dim, intermediate_size)
        self.layer_norm2 = nn.LayerNorm(embed_dim, eps=eps)

    def forward(self, x, causal_mask=None):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPEncoderLayer(c.hidden_size, c.num_heads, c.intermediate_size, c.layer_norm_eps)
            for _ in range(c.num_layers)])

    def forward(self, x, causal_mask=None):
        for layer in self.layers:
            x = layer(x, causal_mask)
        return x


class _TextEmbeddings(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Embedding(c.max_position_embeddings, c.hidden_size)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def hidden_states(self, input_ids):
        """input_ids [B, L] -> the final-LayerNormed states [B, L, D]."""
        L = input_ids.shape[1]
        e = self.embeddings
        x = e.token_embedding(input_ids) + e.position_embedding.weight[None, :L]
        causal = torch.triu(torch.full((L, L), torch.finfo(x.dtype).min, dtype=x.dtype,
                                       device=x.device), diagonal=1)[None, None]
        return self.final_layer_norm(self.encoder(x, causal))

    def forward(self, input_ids):
        """The end-of-text state of each row [B, D], at argmax(input_ids)."""
        x = self.hidden_states(input_ids)
        eot = torch.argmax(input_ids, dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot]


class _VisionEmbeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        p = c.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden_size))
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding((c.image_size // p) ** 2 + 1, c.hidden_size)

    def forward(self, pixel_values):
        x = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)  # [B, (H/p)(W/p), D]
        cls = self.class_embedding[None, None].expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding.weight[None, : x.shape[1]]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values):
        """pixel_values [B, 3, H, W], CLIP-normalized -> pooled [B, D]."""
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return self.post_layernorm(x[:, 0])


class CLIPModel(nn.Module):
    """The two towers and their projections; the stage normalizes the
    features and scales their products by ``exp(logit_scale)``."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg.text)
        self.vision_model = CLIPVisionTransformer(cfg.vision)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size, cfg.projection_dim, bias=False)
        self.text_projection = nn.Linear(cfg.text.hidden_size, cfg.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def get_text_features(self, input_ids):
        return self.text_projection(self.text_model(input_ids))

    def get_image_features(self, pixel_values):
        return self.visual_projection(self.vision_model(pixel_values))
