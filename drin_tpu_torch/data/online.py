# -*- coding: utf-8 -*-
"""Online-BERT request layout (port of ``drin_tpu/data/online.py``, the
serving part): the batch NamedTuple, the zipped entity packing, the
length-bucket trim, and the assembly of a request from raw strings
(:func:`assemble_online_feats`, behind ``Ranker.rank_text``).  The online
training dataset is not ported yet.

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


def extract_mention(tokens: np.ndarray, start: int, end: int, max_len: int,
                    cls_id: int, sep_id: int):
    """Mention tokens -> standalone [CLS mention SEP] sentence."""
    ids = np.zeros((max_len,), np.int64)
    ids[0] = cls_id
    ids[1 : end - start + 1] = tokens[start + 1 : end + 1]
    ids[end - start + 1] = sep_id
    mask = np.zeros((max_len,), np.int64)
    mask[: end - start + 2] = 1
    return ids, mask, 1, end - start + 1


def assemble_online_feats(cfg, tokenizer, sentences, char_spans, candidate_texts,
                          mention_images=None):
    """Serving-time batch assembly from raw strings, no feature store.

    ``char_spans``: per-mention (start, end) CHARACTER offsets into the
    sentence, converted to token positions as the prepare stage does
    (``MentionPositionProcessor``).  ``candidate_texts``: per-mention list
    of candidate strings, padded with empty strings or truncated to
    ``num_candidates_model``.  ``mention_images``: [B, R, Dr] region
    features when the mention encoder is multimodal (zeros otherwise).
    Returns the model feature tuple (``OnlineBatch`` minus the answer)."""
    from drin_tpu_torch.preprocess.prepare import MentionPositionProcessor

    B = len(sentences)
    C = cfg.num_candidates_model
    sentences = [str(s) for s in sentences]
    starts = [int(s) for s, _ in char_spans]
    ends = [int(e) for _, e in char_spans]
    s_tok, e_tok = MentionPositionProcessor(tokenizer)(sentences, starts, ends)

    mention_ids, mention_mask, start_pos, end_pos = mention_tokens(
        cfg, tokenizer, sentences, s_tok, e_tok, cfg.online_length_buckets)
    cands = [list(map(str, row))[:C] + [""] * max(0, C - len(row))
             for row in candidate_texts]
    ids, mask, sep = entity_tokens(cfg, tokenizer, cands, cfg.online_length_buckets)

    if mention_images is not None:
        mi = np.asarray(mention_images, np.float32)
    elif cfg.mention_final_layer_name == "multimodal":
        mi = np.zeros((B, cfg.resnet_num_region, cfg.resnet_embed_dim), np.float32)
    else:
        mi = np.zeros((B,), np.float32)
    return (mention_ids, mention_mask, start_pos, end_pos, mi,
            ids, mask, sep, np.zeros((B,), np.float32))


def mention_tokens(cfg, tokenizer, sentences, starts_tok, ends_tok, bucket: int):
    """Mention-side token assembly: tokenize padded to ``max_bert_len``,
    CLS-shift the raw token positions, optionally re-pack as standalone
    ``[CLS mention SEP]`` sentences (``pre_extract_mention``), then
    length-bucket."""
    B = len(sentences)
    enc = tokenizer(sentences, padding="max_length", truncation=True,
                    max_length=cfg.max_bert_len)
    ids, mask = enc["input_ids"], enc["attention_mask"]
    start = np.asarray(starts_tok, np.int64) + 1
    end = np.asarray(ends_tok, np.int64) + 1
    if cfg.pre_extract_mention:
        new_ids = np.zeros_like(ids)
        new_mask = np.zeros_like(mask)
        s = np.ones((B,), np.int64)
        e = np.ones((B,), np.int64)
        for b in range(B):
            new_ids[b], new_mask[b], s[b], e[b] = extract_mention(
                ids[b], int(starts_tok[b]), int(ends_tok[b]),
                cfg.max_bert_len, tokenizer.cls_id, tokenizer.sep_id)
        ids, mask, start, end = new_ids, new_mask, s, e
    # floor: the model slices the mention tower to max_mention_sentence_len
    ids, mask = bucket_trim(ids, mask, bucket, floor=cfg.max_mention_sentence_len)
    return ids, mask, start, end


def entity_tokens(cfg, tokenizer, texts_rows, bucket: int):
    """Entity-side token assembly: zipped candidate sentences
    (:func:`zip_entities` + length bucket) when ``num_entity_sentence`` is
    set, else direct per-candidate ``[B, C, Le]`` batches tokenized at
    ``max_bert_len``; :func:`bucket_trim` then drops all-padding columns."""
    B = len(texts_rows)
    C = cfg.num_candidates_model
    if cfg.num_entity_sentence:
        S = cfg.num_entity_sentence
        per = (C + S - 1) // S
        ids = np.zeros((B, S, cfg.max_bert_len), np.int64)
        mask = np.zeros((B, S, cfg.max_bert_len), np.int64)
        sep = np.zeros((B, S, per), np.int64)
        for b in range(B):
            ids[b], mask[b], sep[b] = zip_entities(
                tokenizer.encode_batch(texts_rows[b], truncation=True), S,
                cfg.max_bert_len, tokenizer.cls_id)
        ids, mask = bucket_trim(ids, mask, bucket)
    else:
        flat = [str(t) for row in texts_rows for t in row]
        e = tokenizer(flat, padding="max_length", truncation=True,
                      max_length=cfg.max_bert_len)
        ids = e["input_ids"].reshape(B, C, -1)
        mask = e["attention_mask"].reshape(B, C, -1)
        ids, mask = bucket_trim(ids, mask, bucket)
        sep = np.zeros((B,), np.int64)
    return ids, mask, sep
