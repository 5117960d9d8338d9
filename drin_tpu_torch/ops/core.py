# -*- coding: utf-8 -*-
"""Core vectorized ops (port of ``drin_tpu/ops/core.py``).

Same closed forms and edge-case semantics as the JAX module:

  * ``cosine_similarity``      <- torch.nn.CosineSimilarity clamp on the
    product of the norms
  * ``span_mean``              <- span average; empty spans and spans past
    the window give 0
  * ``token_span_mean`` / ``token_span_max`` <- per-candidate entity pooling
  * ``object_pair_similarity`` <- score-weighted object-pair cosine
  * ``unzip_entities``         <- zipped-sentence features back to candidates

The reductions accumulate in float32 and return the input dtype (the JAX
module runs them at ``Precision.HIGHEST`` for the same reason).
"""

from __future__ import annotations

from typing import Optional

import torch


def cosine_similarity(x: torch.Tensor, y: torch.Tensor, dim: int = -1,
                      eps: float = 1e-8) -> torch.Tensor:
    """``dot(x, y) / max(||x|| * ||y||, eps)``."""
    dot = torch.sum(x * y, dim=dim)
    nx = torch.linalg.vector_norm(x, dim=dim)
    ny = torch.linalg.vector_norm(y, dim=dim)
    return dot / torch.clamp(nx * ny, min=eps)


def span_mean(seq: torch.Tensor, begin: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Mean of ``seq[i, begin[i]:end[i]]`` per batch row; seq [B, L, D].
    Empty spans and spans past the window return 0 instead of NaN."""
    L = seq.shape[-2]
    pos = torch.arange(L, device=seq.device)
    mask = (pos[None, :] >= begin[:, None]) & (pos[None, :] < end[:, None])
    maskf = mask.to(torch.float32)
    count = torch.clamp(maskf.sum(-1, keepdim=True), min=1.0)
    out = torch.einsum("bl,bld->bd", maskf, seq.to(torch.float32)) / count
    return out.to(seq.dtype)


def _token_mask(features: torch.Tensor, num_tokens: torch.Tensor, lo: int,
                hi_offset: int) -> torch.Tensor:
    Le = features.shape[-2]
    pos = torch.arange(Le, device=features.device).reshape((1,) * (features.ndim - 2) + (Le,))
    hi = (num_tokens - hi_offset)[..., None]
    return (pos >= lo) & (pos < hi)  # [..., Le]


def token_span_mean(features: torch.Tensor, num_tokens: torch.Tensor, lo: int = 1,
                    hi_offset: int = 1) -> torch.Tensor:
    """Mean over token positions ``lo : num_tokens - hi_offset`` along
    axis -2; features [..., Le, D]."""
    mask = _token_mask(features, num_tokens, lo, hi_offset).to(torch.float32)
    count = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    out = torch.einsum("...l,...ld->...d", mask, features.to(torch.float32)) / count
    return out.to(features.dtype)


def token_span_max(features: torch.Tensor, num_tokens: torch.Tensor, lo: int = 1,
                   hi_offset: int = 1) -> torch.Tensor:
    """Max over token positions ``lo : num_tokens - hi_offset`` along axis
    -2.  Empty spans pool to 0."""
    mask = _token_mask(features, num_tokens, lo, hi_offset)[..., None]  # [..., Le, 1]
    neg = torch.finfo(features.dtype).min
    out = torch.amax(torch.where(mask, features, torch.full_like(features, neg)), dim=-2)
    empty = ~torch.any(mask, dim=-2)
    return torch.where(empty, torch.zeros_like(out), out)


def object_pair_similarity(mention_obj: torch.Tensor,  # [B, Tm, D]
                           mention_score: torch.Tensor,  # [B, Tm]
                           entity_obj: torch.Tensor,  # [B, C, Te, D]
                           entity_score: torch.Tensor,  # [B, C, Te]
                           eps: float = 1e-9) -> torch.Tensor:
    """Score-weighted average of pairwise object cosine similarities,
    ``sum(cos_ij * ms_i * es_j) / (sum(ms_i * es_j) + eps)``; norms
    product clamped at 1e-8.  Output [B, C]."""
    f32 = torch.float32
    mo, eo = mention_obj.to(f32), entity_obj.to(f32)
    mdot = torch.einsum("bid,bcjd->bcij", mo, eo)
    mn = torch.linalg.vector_norm(mo, dim=-1)  # [B, Tm]
    en = torch.linalg.vector_norm(eo, dim=-1)  # [B, C, Te]
    denom = torch.clamp(mn[:, None, :, None] * en[:, :, None, :], min=1e-8)
    sim = mdot / denom
    w = mention_score.to(f32)[:, None, :, None] * entity_score.to(f32)[:, :, None, :]
    num = torch.sum(sim * w, dim=(-1, -2))
    den = torch.sum(w, dim=(-1, -2))
    return (num / (den + eps)).to(mention_obj.dtype)


def unzip_entities(zipped: torch.Tensor, sep_idx: torch.Tensor, num_candidates: Optional[int],
                   pooling: str = "avg") -> torch.Tensor:
    """Split zipped-sentence BERT features back into per-candidate vectors:
    candidate k of sentence j spans token positions ``[prev_sep + 1, sep_jk)``
    (position 0 is CLS; spans start at 1).

    zipped [B, S, L, D], sep_idx [B, S, E] -> [B, num_candidates, D], the
    slots sentence-major (sentence s holds slots s*E .. s*E+E-1), so a block
    of sentences pools to its own contiguous block of slots: with
    ``num_candidates=None`` every one of the S*E slots is kept (a model
    rank's block, cut to C after the gather).  Zero-width spans (padding
    seps) pool to 0 instead of NaN."""
    B, S, L, D = zipped.shape
    sep_idx = sep_idx.to(torch.int32)
    E = sep_idx.shape[-1]
    pos = torch.arange(L, device=zipped.device).reshape(1, 1, 1, L)
    lo = torch.cat([torch.ones((B, S, 1), dtype=torch.int32, device=zipped.device),
                    sep_idx[..., :-1] + 1], dim=-1)
    mask = (pos >= lo[..., None]) & (pos < sep_idx[..., None])  # [B, S, E, L]
    if pooling == "avg":
        m = mask.to(torch.float32)
        count = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
        pooled = (torch.einsum("bsel,bsld->bsed", m, zipped.to(torch.float32))
                  / count).to(zipped.dtype)
    else:  # max; zero-width spans pool to 0
        neg = torch.finfo(zipped.dtype).min
        pooled = torch.amax(zipped[:, :, None].masked_fill(~mask[..., None], neg), dim=-2)
        pooled = pooled.masked_fill(~torch.any(mask, dim=-1)[..., None], 0.0)
    pooled = pooled.reshape(B, S * E, D)
    return pooled if num_candidates is None else pooled[:, :num_candidates]
