# -*- coding: utf-8 -*-
"""Online-BERT request layout (the numpy-only part of
``drin_tpu/data/online.py``): the batch NamedTuple, the zipped entity
packing and the length-bucket trim.  What a caller needs to build a valid
token-id ``/rank`` request; the tokenizer-bound assembly from raw text is
not ported yet.

Two entity batching modes:

  * zipped (``num_entity_sentence = S > 0``): all C candidate texts packed
    into S synthetic ``[CLS e1 SEP e2 SEP ...]`` sentences with a SEP-index
    matrix.  Candidates packed into one sentence attend to each other inside
    BERT, so the numbers differ from per-candidate encoding; it is the
    reference's semantics.
  * direct (``num_entity_sentence = 0``): per-candidate [B, C, Le] batches.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np


class OnlineBatch(NamedTuple):
    mention_ids: np.ndarray  # [B, Lm]
    mention_mask: np.ndarray  # [B, Lm]
    mention_start_pos: np.ndarray  # [B] (CLS-shifted)
    mention_end_pos: np.ndarray  # [B]
    mention_image_feature: np.ndarray  # [B, R, Dr] (zeros when not multimodal)
    entity_ids: np.ndarray  # [B, S, L] zipped | [B, C, Le] direct
    entity_mask: np.ndarray
    entity_sep_idx: np.ndarray  # [B, S, E] zipped | [B] zeros direct
    entity_image_feature: np.ndarray  # [B, C, Dr] or [B] zeros
    answer: np.ndarray  # [B, C-1] one-hot


def zip_entities(token_lists: List[List[int]], num_sentences: int, max_len: int, cls_id: int):
    """Pack C tokenized candidate texts (each ``[CLS ... SEP]``) into
    ``num_sentences`` synthetic sentences.

    Returns (input_ids [S, max_len], attention_mask [S, max_len],
    sep_idx [S, E])."""
    total = len(token_lists)
    per = (total + num_sentences - 1) // num_sentences
    ids = np.zeros((num_sentences, max_len), np.int64)
    ids[:, 0] = cls_id
    mask = np.zeros((num_sentences, max_len), np.int64)
    sep_idx = np.zeros((num_sentences, per), np.int64)
    for i in range(num_sentences):
        group = token_lists[i * per : (i + 1) * per]
        cur = 0
        for j, sample in enumerate(group):
            body = sample[1:]  # drop CLS, keep trailing SEP
            if cur + 1 + len(body) > max_len:
                raise ValueError(
                    f"zipped candidate texts overflow max_bert_len={max_len} "
                    f"(sentence {i}, candidate {j}); raise num_entity_sentence "
                    f"or max_bert_len, or shorten max_entity_attr_char_len"
                )
            ids[i, cur + 1 : cur + 1 + len(body)] = body
            cur += len(body)
            sep_idx[i, j] = cur
        mask[i, : cur + 1] = 1
    return ids, mask, sep_idx


def bucket_trim(ids: np.ndarray, mask: np.ndarray, bucket: int, floor: int = 1,
                used: Optional[int] = None):
    """Trim trailing all-padding token columns down to the batch's max
    content length rounded up to ``bucket`` (>= ``floor``).

    Exact: the removed columns are padding in every row, already excluded
    from each kept position by the additive attention mask, so their softmax
    terms are exact zeros.  ``used`` overrides the batch-derived max content
    length."""
    if not bucket:
        return ids, mask
    if used is None:
        used = int(mask.sum(-1).max()) if mask.size else 1
    L = ids.shape[-1]
    new_len = min(L, max(floor, ((max(int(used), 1) + bucket - 1) // bucket) * bucket))
    return ids[..., :new_len], mask[..., :new_len]
