# -*- coding: utf-8 -*-
"""Feature-store datasets with vectorized, columnar batch assembly, the
batch layouts and the global WikiMEL entity tables (the port's own copy of
``drin_tpu/data/dataset.py``; table rows are gathered by the native threaded
gather, ``drin_tpu_torch.native.gather_rows``, as the JAX package gathers
them).

  * a one-time vectorized qid->row join producing an ``[N, C]`` int32 index
    matrix,
  * whole-batch numpy gathers (one fancy-index per field per batch),
  * the CLS +1 position shift and one-hot answer lookup applied columnar.

Batches are NamedTuples in the reference's positional field order, so
``batch[:-1]`` / ``batch[-1]`` splits features from the answer.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, NamedTuple, Optional

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


def make_onehot_lookup(num_candidates_data: int, dtype=np.float32) -> np.ndarray:
    """Answer-index -> one-hot row; index ``num_candidates_data`` maps to the
    all-zero row for "answer not in candidates" (drin/data.py:159-161)."""
    eye = np.eye(num_candidates_data, dtype=dtype)
    return np.concatenate([eye, np.zeros((1, num_candidates_data), dtype=dtype)], axis=0)


def iter_batch_indices(n: int, batch_size: int, shuffle: bool = False,
                       seed: int = 0, drop_remainder: bool = False,
                       pad_to_full: bool = False) -> Iterator[np.ndarray]:
    """The shared batch-iteration contract (one permutation per epoch; the
    ragged tail is dropped, padded by cycling ``np.resize`` — fills even
    when n < the shortfall — or yielded short).  Both the feature-store and
    online datasets iterate through this single implementation so the
    contract cannot drift between them."""
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    for i in range(0, n, batch_size):
        idx = order[i : i + batch_size]
        if len(idx) < batch_size:
            if drop_remainder:
                return
            if pad_to_full:
                idx = np.concatenate([idx, np.resize(order, batch_size - len(idx))])
        yield idx


def gold_labels(answer: np.ndarray, num_onehot_rows: int) -> np.ndarray:
    """Gold candidate index per mention, matching argmax over the one-hot
    answer row (the 'answer absent' sentinel row is all-zero, so argmax —
    like the reference's test-result dump — reports 0 for it)."""
    a = np.asarray(answer)
    return np.where(a >= num_onehot_rows - 1, 0, a)


def _gather(table: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Batch gather rows from a (possibly huge, mmap'd) table, output
    ``rows.shape + table.shape[1:]``: the native threaded gather where the
    rows are large and many, numpy indexing otherwise."""
    from drin_tpu_torch.native import gather_rows

    return gather_rows(table, rows)


def _check_shape(name: str, arr, expected_tail: tuple, knobs: str):
    """Clear config-vs-store mismatch errors instead of raw reshape
    tracebacks: names the field, the shapes, and the config knobs to fix."""
    if tuple(arr.shape[1:]) != tuple(expected_tail):
        raise ValueError(
            f"feature store field '{name}' has per-item shape {tuple(arr.shape[1:])} "
            f"but the config expects {tuple(expected_tail)} — check {knobs} "
            f"(or point preprocess_dir at a store built with this config)"
        )


class MELFeatureDataset:
    """Columnar view over one split of the preprocessed feature store."""

    def __init__(self, cfg: Config, split: str, entity_tables: Optional[dict] = None):
        self.cfg = cfg
        self.split = split
        d = cfg.preprocess_dir
        ld = lambda f, mmap=None: npy_io.load_field(d, f, split, mmap)
        C = cfg.num_candidates_model

        self.mention_text_feature = ld("mention_text_feature", cfg.mention_mmap)
        self.mention_text_mask = ld("mention_text_mask")
        self.start_pos = ld("start_pos")
        self.end_pos = ld("end_pos")
        self.mention_image_feature = ld("mention_image_feature", cfg.mention_mmap)
        self.mention_object_feature = ld("mention_object_feature", cfg.mention_mmap)
        self.mention_object_score = ld("mention_object_score")
        self.miet_similarity = ld("similarity_miet")
        self.mtei_similarity = ld("similarity_eimt")
        self.answer = ld("answer")
        self.onehot = make_onehot_lookup(cfg.num_candidates_data)

        _check_shape("mention_text_feature", self.mention_text_feature,
                     (cfg.max_mention_sentence_len, cfg.bert_embed_dim),
                     "max_mention_sentence_len / bert_embed_dim")
        _check_shape("similarity_miet", self.miet_similarity, (C,), "num_candidates_data")

        if cfg.dataset_name == "wikidiverse":
            # mention-aligned entity arrays, reshaped over the candidate dim
            # (drin/data.py:30-38); the text-feature field is parameterized by
            # entity_text_type like the reference's offline baseline loader
            # (baselines/data.py:100-105: entity-{attr|name|brief}-feature)
            text_field = f"entity_{cfg.entity_text_type}_feature"
            eaf = ld(text_field, cfg.entity_mmap)
            n_rows = len(self.answer) * C
            if len(eaf) != n_rows:
                raise ValueError(
                    f"{text_field}_{split} has {len(eaf)} rows; expected "
                    f"{len(self.answer)} mentions x {C} candidates = {n_rows} — "
                    f"check num_candidates_data against the store"
                )
            self.entity_text_feature = eaf.reshape(-1, C, cfg.bert_embed_dim)
            self.entity_text_mask = None
            self.entity_image_feature = ld("entity_image_feature", cfg.entity_mmap).reshape(
                -1, C, cfg.resnet_embed_dim
            )
            self.entity_object_feature = ld("entity_object_feature", cfg.entity_mmap).reshape(
                -1, C, cfg.entity_object_topk, cfg.resnet_embed_dim
            )
            self.entity_object_score = ld("entity_object_score").reshape(-1, C, cfg.entity_object_topk)
            self.entity_row_idx = None
        else:  # wikimel: global entity table + per-mention qid join
            assert entity_tables is not None, "wikimel needs the shared global entity tables"
            self.tables = entity_tables
            qids = npy_io.load_field(d, "entity_name_raw", split).reshape(-1, C)
            with open(os.path.join(d, "qid2idx.json")) as f:
                qid2idx = json.load(f)
            # vectorized join: the [N, C] row-index matrix is computed ONCE
            # here instead of per-example dict lookups in workers
            # (drin/data.py:88)
            lut = np.vectorize(qid2idx.__getitem__, otypes=[np.int64])
            self.entity_row_idx = lut(qids).astype(np.int32)

        n = len(self.answer)
        assert (
            n
            == len(self.mention_text_feature)
            == len(self.start_pos)
            == len(self.mention_image_feature)
            == len(self.mention_object_feature)
            == len(self.miet_similarity)
        ), "split arrays misaligned"

    def __len__(self) -> int:
        return len(self.answer)

    # ------------------------------------------------------------------
    def drin_batch(self, idx: np.ndarray) -> DrinBatch:
        """Assemble one DRIN batch for mention indices ``idx`` — all
        whole-batch numpy ops."""
        cfg = self.cfg
        if cfg.dataset_name == "wikimel":
            rows = self.entity_row_idx[idx]  # [B, C]
            etf = _gather(self.tables["entity_text_feature"], rows)
            # pooled cache: the mask was consumed at pooling time
            etm = (np.zeros((len(idx),), dtype=np.int64) if cfg.entity_pooling_cached
                   else _gather(self.tables["entity_text_mask"], rows))
            eif = _gather(self.tables["entity_image_feature"], rows)
            eof = _gather(self.tables["entity_object_feature"], rows)
            eos = _gather(self.tables["entity_object_score"], rows)
        else:
            etf = np.asarray(self.entity_text_feature[idx])
            etm = np.zeros((len(idx),), dtype=np.int64)
            eif = np.asarray(self.entity_image_feature[idx])
            eof = np.asarray(self.entity_object_feature[idx])
            eos = np.asarray(self.entity_object_score[idx])
        return DrinBatch(
            mention_text_feature=np.asarray(self.mention_text_feature[idx]),
            mention_text_mask=np.asarray(self.mention_text_mask[idx]),
            # +1: CLS shift (drin/data.py:113-114)
            mention_start_pos=self.start_pos[idx] + 1,
            mention_end_pos=self.end_pos[idx] + 1,
            mention_image_feature=np.asarray(self.mention_image_feature[idx]),
            mention_object_feature=np.asarray(self.mention_object_feature[idx]),
            mention_object_score=np.asarray(self.mention_object_score[idx]),
            entity_text_feature=etf,
            entity_text_mask=etm,
            entity_image_feature=eif,
            entity_object_feature=eof,
            entity_object_score=eos,
            miet_similarity=np.asarray(self.miet_similarity[idx]),
            mtei_similarity=np.asarray(self.mtei_similarity[idx]),
            answer=self.onehot[self.answer[idx]],
        )

    def baseline_batch(self, idx: np.ndarray) -> BaselineBatch:
        """Assemble one offline GHMFC/MELHI batch (baselines/data.py:169-192)."""
        cfg = self.cfg
        if cfg.dataset_name == "wikimel":
            rows = self.entity_row_idx[idx]
            etf = _gather(self.tables["entity_text_feature"], rows)
            etm = (np.zeros((len(idx),), dtype=np.int64) if cfg.entity_pooling_cached
                   else _gather(self.tables["entity_text_mask"], rows))
            eif = _gather(self.tables["entity_image_feature"], rows)
        else:
            etf = np.asarray(self.entity_text_feature[idx])
            etm = np.zeros((len(idx),), dtype=np.int64)
            eif = np.asarray(self.entity_image_feature[idx])
        if eif.ndim == 4:  # [B, C, 1, Dr] resnet pooler -> [B, C, Dr]
            eif = eif.reshape(eif.shape[0], eif.shape[1], -1)
        return BaselineBatch(
            mention_text_feature=np.asarray(self.mention_text_feature[idx]),
            mention_text_mask=np.asarray(self.mention_text_mask[idx]),
            mention_start_pos=self.start_pos[idx] + 1,
            mention_end_pos=self.end_pos[idx] + 1,
            mention_image_feature=np.asarray(self.mention_image_feature[idx]),
            entity_text_feature=etf,
            entity_text_mask=etm,
            entity_image_feature=eif,
            answer=self.onehot[self.answer[idx]],
        )

    # ------------------------------------------------------------------
    def drin_rows_batch(self, idx: np.ndarray):
        """DRIN batch carrying [B, C] entity row indices instead of gathered
        entity features (device-resident tables, data/device_store.py)."""
        from drin_tpu_torch.data.device_store import DrinRowsBatch

        assert self.entity_row_idx is not None, "rows batches need the wikimel qid join"
        return DrinRowsBatch(
            mention_text_feature=np.asarray(self.mention_text_feature[idx]),
            mention_text_mask=np.asarray(self.mention_text_mask[idx]),
            mention_start_pos=self.start_pos[idx] + 1,
            mention_end_pos=self.end_pos[idx] + 1,
            mention_image_feature=np.asarray(self.mention_image_feature[idx]),
            mention_object_feature=np.asarray(self.mention_object_feature[idx]),
            mention_object_score=np.asarray(self.mention_object_score[idx]),
            entity_rows=self.entity_row_idx[idx],
            miet_similarity=np.asarray(self.miet_similarity[idx]),
            mtei_similarity=np.asarray(self.mtei_similarity[idx]),
            answer=self.onehot[self.answer[idx]],
        )

    def baseline_rows_batch(self, idx: np.ndarray):
        """Offline baseline batch carrying [B, C] entity row indices instead
        of gathered entity features (device-resident tables)."""
        from drin_tpu_torch.data.device_store import BaselineRowsBatch

        assert self.entity_row_idx is not None, "rows batches need the wikimel qid join"
        return BaselineRowsBatch(
            mention_text_feature=np.asarray(self.mention_text_feature[idx]),
            mention_text_mask=np.asarray(self.mention_text_mask[idx]),
            mention_start_pos=self.start_pos[idx] + 1,
            mention_end_pos=self.end_pos[idx] + 1,
            mention_image_feature=np.asarray(self.mention_image_feature[idx]),
            entity_rows=self.entity_row_idx[idx],
            answer=self.onehot[self.answer[idx]],
        )

    def labels(self, idx: np.ndarray) -> np.ndarray:
        """Gold candidate index per mention (:func:`gold_labels`)."""
        return gold_labels(self.answer[idx], self.onehot.shape[0])

    def make_batch(self, idx: np.ndarray, kind: str = "drin"):
        """Assemble the batch for explicit mention indices (the hook the
        trainer's host-sharded iterator uses: each process builds only the
        rows its devices own, parallel/distributed.py)."""
        return {
            "drin": self.drin_batch,
            "baseline": self.baseline_batch,
            "drin_rows": self.drin_rows_batch,
            "baseline_rows": self.baseline_rows_batch,
        }[kind](idx)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        kind: str = "drin",
        drop_remainder: bool = False,
        pad_to_full: bool = False,
    ) -> Iterator[tuple]:
        """Iterate batches.  ``pad_to_full`` repeats the last examples so every
        batch has exactly ``batch_size`` rows (static shapes for jit); the
        returned batch carries a ``valid`` count via the iterator protocol of
        :func:`padded_batches` instead when needed."""
        for idx in iter_batch_indices(len(self), batch_size, shuffle, seed,
                                      drop_remainder, pad_to_full):
            yield self.make_batch(idx, kind)


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


def create_datasets(cfg: Config) -> list:
    """Build the train/valid/test datasets."""
    tables = load_wikimel_entity_tables(cfg) if cfg.dataset_name == "wikimel" else None
    return [MELFeatureDataset(cfg, split, tables) for split in ("train", "valid", "test")]
