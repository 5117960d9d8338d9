# -*- coding: utf-8 -*-
"""Batch layouts and the global WikiMEL entity tables (the serving subset of
``drin_tpu/data/dataset.py``; the feature-store datasets come with the
training port).

Batches are NamedTuples in the reference's positional field order, so
``batch[:-1]`` / ``batch[-1]`` splits features from the answer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from drin_tpu_torch.common import npy_io
from drin_tpu_torch.common.config import Config


class DrinBatch(NamedTuple):
    """15-tensor DRIN batch."""

    mention_text_feature: np.ndarray  # [B, L, D]
    mention_text_mask: np.ndarray  # [B, L]
    mention_start_pos: np.ndarray  # [B] (CLS-shifted)
    mention_end_pos: np.ndarray  # [B]
    mention_image_feature: np.ndarray  # [B, R, Dr]
    mention_object_feature: np.ndarray  # [B, Tm, Dr]
    mention_object_score: np.ndarray  # [B, Tm]
    entity_text_feature: np.ndarray  # [B, C, Le, D] (wikimel) / [B, C, D] (wikidiverse)
    entity_text_mask: np.ndarray  # [B, C, Le] (wikimel) / [B] zeros (wikidiverse)
    entity_image_feature: np.ndarray  # [B, C, 1, Dr] or [B, C, Dr]
    entity_object_feature: np.ndarray  # [B, C, Te, (1,) Dr]
    entity_object_score: np.ndarray  # [B, C, Te]
    miet_similarity: np.ndarray  # [B, C]
    mtei_similarity: np.ndarray  # [B, C]
    answer: np.ndarray  # [B, C-1] one-hot (all-zero when answer absent)


class BaselineBatch(NamedTuple):
    """9-tensor offline baseline batch."""

    mention_text_feature: np.ndarray
    mention_text_mask: np.ndarray
    mention_start_pos: np.ndarray
    mention_end_pos: np.ndarray
    mention_image_feature: np.ndarray
    entity_text_feature: np.ndarray
    entity_text_mask: np.ndarray
    entity_image_feature: np.ndarray
    answer: np.ndarray


def pool_entity_table(features: np.ndarray, mask: np.ndarray, chunk: int = 4096) -> np.ndarray:
    """Pool the frozen global entity-text table once: [N, Le, D] ->
    [N, 2, D] stacked (span-mean over tokens 1..n-1, CLS); the same numbers
    as the per-batch pooling (``token_span_mean``)."""
    N, Le, D = features.shape
    out = np.empty((N, 2, D), features.dtype)
    pos = np.arange(Le)
    for i in range(0, N, chunk):
        f = np.asarray(features[i : i + chunk])
        n = np.asarray(mask[i : i + chunk]).sum(-1)
        m = ((pos[None] >= 1) & (pos[None] < (n - 1)[:, None])).astype(f.dtype)
        count = np.maximum(m.sum(-1, keepdims=True), 1.0)
        out[i : i + chunk, 0] = np.einsum("nl,nld->nd", m, f) / count
        out[i : i + chunk, 1] = f[:, 0]
    return out


def load_wikimel_entity_tables(cfg: Config, include: tuple = None) -> dict:
    """Load the global WikiMEL entity arrays once.  With
    ``cfg.entity_pooling_cached`` the token-level text table is replaced by
    its (pooled, CLS) cache.  ``include`` (the ``device_store.include_for``
    layout) skips reading the image/object arrays a narrowed store never
    uploads."""
    d = cfg.preprocess_dir
    include = include or ("text", "image", "obj")
    etf = npy_io.load_field(d, f"entity_{cfg.entity_text_type}_feature", mmap=cfg.entity_mmap)
    etm = npy_io.load_field(d, f"entity_{cfg.entity_text_type}_mask")
    tables = {"entity_text_feature": etf, "entity_text_mask": etm}
    if "image" in include:
        tables["entity_image_feature"] = npy_io.load_field(
            d, "entity_image_feature", "all", cfg.entity_mmap)
    if "obj" in include:
        tables["entity_object_feature"] = npy_io.load_field(
            d, "entity_object_feature", "all", cfg.entity_mmap)
        tables["entity_object_score"] = npy_io.load_field(d, "entity_object_score", "all")
    if cfg.entity_pooling_cached:
        tables["entity_text_feature"] = pool_entity_table(etf, etm)
    return tables
