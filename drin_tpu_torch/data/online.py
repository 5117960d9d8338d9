# -*- coding: utf-8 -*-
"""Online-BERT data path (port of ``drin_tpu/data/online.py``): raw text ->
token batches, assembled columnar.  The batch NamedTuple, the zipped entity
packing, the length-bucket trim, the assembly of a request from raw strings
(:func:`assemble_online_feats`, behind ``Ranker.rank_text``) and the
training dataset over the intermediate store of raw strings
(:class:`OnlineMELDataset`, with its tokenizer process pool).

Two entity batching modes:

  * zipped (``num_entity_sentence = S > 0``): all C candidate texts packed
    into S synthetic ``[CLS e1 SEP e2 SEP ...]`` sentences with a SEP-index
    matrix.  Candidates packed into one sentence attend to each other inside
    BERT, so the numbers differ from per-candidate encoding; it is the
    reference's semantics.
  * direct (``num_entity_sentence = 0``): per-candidate [B, C, Le] batches.

This module imports numpy only: the tokenizer pool's ``spawn`` workers
import it, and must not pay for torch.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, NamedTuple, Optional

import numpy as np

from drin_tpu_torch.common import npy_io
from drin_tpu_torch.data.dataset import gold_labels, iter_batch_indices, make_onehot_lookup


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


_WORKER_TOK = None


def _init_tok_worker(vocab, max_len):
    global _WORKER_TOK
    from drin_tpu_torch.text.wordpiece import BertTokenizer

    _WORKER_TOK = BertTokenizer(vocab=vocab, model_max_length=max_len)


def _worker_ready(_):
    return os.getpid()


def _zip_row(args):
    texts, S, max_len = args
    tok = _WORKER_TOK
    token_lists = tok.encode_batch(texts, truncation=True)
    return zip_entities(token_lists, S, max_len, tok.cls_id)


def _zip_len_row(args):
    """Pool worker: max used length over the S zipped sentences of one
    example (the per-example piece of ``_precompute_lengths``)."""
    texts, S, per = args
    tok = _WORKER_TOK
    body = [len(ids) - 1 for ids in tok.encode_batch(texts, truncation=True)]
    return max(1 + sum(body[s * per : (s + 1) * per]) for s in range(S))


def _flat_len_row(texts):
    """Pool worker: max per-candidate token length of one example (the
    direct-mode piece of ``_precompute_lengths``)."""
    return max(len(ids) for ids in _WORKER_TOK.encode_batch(texts, truncation=True))


def _terminate_pool(pool):
    """Module-level so a ``weakref.finalize`` callback never references the
    dataset it guards (that would keep the dataset alive)."""
    pool.terminate()
    pool.join()


def mention_tokens(cfg, tokenizer, sentences, starts_tok, ends_tok, bucket: int,
                   used: Optional[int] = None):
    """Mention-side token assembly: tokenize padded to ``max_bert_len``,
    CLS-shift the raw token positions, optionally re-pack as standalone
    ``[CLS mention SEP]`` sentences (``pre_extract_mention``), then
    length-bucket (``used`` overrides the batch's own content length)."""
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
    ids, mask = bucket_trim(ids, mask, bucket, floor=cfg.max_mention_sentence_len, used=used)
    return ids, mask, start, end


def entity_tokens(cfg, tokenizer, texts_rows, bucket: int, pool=None,
                  used: Optional[int] = None):
    """Entity-side token assembly: zipped candidate sentences
    (:func:`zip_entities` + length bucket) when ``num_entity_sentence`` is
    set, else direct per-candidate ``[B, C, Le]`` batches tokenized at
    ``max_bert_len``; :func:`bucket_trim` then drops all-padding columns.
    ``pool`` tokenizes and packs the zipped rows in worker processes: the
    same arrays as without it."""
    B = len(texts_rows)
    C = cfg.num_candidates_model
    if cfg.num_entity_sentence:
        S = cfg.num_entity_sentence
        per = (C + S - 1) // S
        ids = np.zeros((B, S, cfg.max_bert_len), np.int64)
        mask = np.zeros((B, S, cfg.max_bert_len), np.int64)
        sep = np.zeros((B, S, per), np.int64)
        if pool is not None:
            jobs = [(list(map(str, texts_rows[b])), S, cfg.max_bert_len) for b in range(B)]
            for b, (i_, m_, s_) in enumerate(pool.map(_zip_row, jobs)):
                ids[b], mask[b], sep[b] = i_, m_, s_
        else:
            for b in range(B):
                ids[b], mask[b], sep[b] = zip_entities(
                    tokenizer.encode_batch(texts_rows[b], truncation=True), S,
                    cfg.max_bert_len, tokenizer.cls_id)
        ids, mask = bucket_trim(ids, mask, bucket, used=used)
    else:
        flat = [str(t) for row in texts_rows for t in row]
        e = tokenizer(flat, padding="max_length", truncation=True,
                      max_length=cfg.max_bert_len)
        ids = e["input_ids"].reshape(B, C, -1)
        mask = e["attention_mask"].reshape(B, C, -1)
        ids, mask = bucket_trim(ids, mask, bucket, used=used)
        sep = np.zeros((B,), np.int64)
    return ids, mask, sep


class OnlineMELDataset:
    """Columnar online dataset over the intermediate store (raw texts and
    precomputed image features).

    Tokenization runs on the host, so ``cfg.dataloader_workers`` worker
    processes pack the zipped candidate rows of a batch in parallel (the
    reference uses DataLoader worker processes for the same reason).  The
    pool is a ``spawn`` pool: the training process holds a CUDA context and
    the prefetcher's thread, and forking such a process is unsafe.  Its
    workers import numpy and the tokenizer only."""

    def __init__(self, cfg, split: str, tokenizer=None):
        from drin_tpu_torch.text.wordpiece import BertTokenizer

        self.cfg = cfg
        d = cfg.preprocess_dir
        C = cfg.num_candidates_model
        self.tokenizer = tokenizer or BertTokenizer(
            vocab_file=cfg.bert_vocab, do_lower_case=False, model_max_length=cfg.max_bert_len)
        self.mention_text = npy_io.load_field(d, "mention_text_raw", split)
        if cfg.dataset_name == "wikimel":
            qids = npy_io.load_field(d, "entity_name_raw", split).reshape(-1, C)
            with open(cfg.qid2entity_path) as f:
                qid2name = json.load(f)
            if cfg.entity_text_type == "brief":
                # the WikiMEL store has no brief source (the reference reads a
                # file none of its stages write); never fall back to names
                raise ValueError(
                    "entity_text_type='brief' needs the wikidiverse store "
                    "(prepare's entity2brief join); wikimel has 'attr'/'name'")
            if cfg.entity_text_type == "attr":
                with open(cfg.qid2attr_path) as f:
                    qid2attr = json.load(f)
                text = np.vectorize(
                    lambda q: (qid2name[q] + ". " + str(qid2attr[q]).replace(".", ";"))[: cfg.max_entity_attr_char_len]
                )
            else:  # name
                text = np.vectorize(qid2name.__getitem__)
            self.entity_text = text(qids)
        else:  # wikidiverse: prepare materialized the briefs
            self.entity_text = npy_io.load_field(d, "entity_attr_raw", split).reshape(-1, C)
        self.start_pos = npy_io.load_field(d, "start_pos", split)
        self.end_pos = npy_io.load_field(d, "end_pos", split)
        self.answer = npy_io.load_field(d, "answer", split)
        self.onehot = make_onehot_lookup(cfg.num_candidates_data)
        self.mention_image = None
        self.entity_image = None
        if cfg.mention_final_layer_name == "multimodal":
            self.mention_image = npy_io.load_field(d, "mention_image_feature", split, cfg.mention_mmap)
        if cfg.entity_final_layer_name == "multimodal":
            self.entity_image = npy_io.load_field(d, "entity_image_feature", split, cfg.entity_mmap)
        self._pool = None
        self._pool_finalizer = None
        # a pool pays only with cores to spread the tokenizer over; batches
        # are bit-equal either way
        if cfg.num_entity_sentence and cfg.dataloader_workers > 0 and (os.cpu_count() or 1) > 1:
            import multiprocessing as mp
            import weakref

            n = min(cfg.dataloader_workers, os.cpu_count())
            t0 = time.perf_counter()
            self._pool = mp.get_context("spawn").Pool(
                n, initializer=_init_tok_worker,
                initargs=(self.tokenizer.vocab, cfg.max_bert_len))
            # weakref.finalize, not atexit.register(self.close): an atexit
            # registration would keep the dataset, its arrays and the
            # workers alive for the process's life after the dataset is
            # dropped.  The finalizer holds only the pool, runs when the
            # dataset is collected or at exit, and close() detaches it.
            self._pool_finalizer = weakref.finalize(self, _terminate_pool, self._pool)
            try:
                # a worker that dies while it starts is replaced without end,
                # and a plain map would wait for ever
                self._pool.map_async(_worker_ready, range(n), chunksize=1).get(timeout=300)
            except mp.TimeoutError:
                self.close()
                raise RuntimeError(
                    "the tokenizer pool's spawn workers did not start within 300 s (a spawn "
                    "worker imports the parent's __main__ again: is its entry point under an "
                    "`if __name__ == '__main__':` guard?)") from None
            print(f"[{split}] tokenizer pool: {n} spawn workers, first answers after "
                  f"{time.perf_counter() - t0:.2f} s")
        # length bucketing over several processes needs one global batch
        # shape: from per-example token lengths precomputed once from the
        # (identical) store, every process derives the same global batch
        # max without communication (the trainer passes the global batch
        # indices as ``bucket_idx``).  The lengths are cached on disk next
        # to the store, keyed by what determines them.
        self._bucket = cfg.online_length_buckets
        self._men_len = self._ent_len = None
        if self._bucket and cfg.num_processes > 1:
            self._men_len, self._ent_len = self._cached_lengths(split)

    def _lengths_cache_key(self, split: str) -> str:
        """Hash of everything the precomputed lengths depend on: the
        tokenizer's vocab, the knobs that shape tokenization and packing,
        and (size, mtime) of the source files the texts come from, so that
        a rewritten store invalidates the cache."""
        import hashlib

        cfg = self.cfg
        h = hashlib.md5()
        h.update("\n".join(sorted(self.tokenizer.vocab)).encode())
        h.update(repr((cfg.num_candidates_model, cfg.num_entity_sentence,
                       cfg.max_bert_len, cfg.max_entity_attr_char_len,
                       cfg.pre_extract_mention, cfg.entity_text_type)).encode())
        d = cfg.preprocess_dir
        sources = [os.path.join(d, f"mention-text-raw_{split}.npy"),
                   os.path.join(d, f"start-pos_{split}.npy"),
                   os.path.join(d, f"end-pos_{split}.npy")]
        if cfg.dataset_name == "wikimel":
            sources += [os.path.join(d, f"entity-name-raw_{split}.npy"),
                        cfg.qid2entity_path, cfg.qid2attr_path]
        else:
            sources += [os.path.join(d, f"entity-attr-raw_{split}.npy")]
        for p in sources:
            try:
                st = os.stat(p)
                h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}".encode())
            except OSError:
                h.update(f"{p}:absent".encode())
        return h.hexdigest()[:16]

    def _cached_lengths(self, split: str):
        """The per-example lengths from the cache beside the store, or
        computed and written there (atomic replace: processes that compute
        at once write identical bytes)."""
        path = os.path.join(self.cfg.preprocess_dir,
                            f".lengths-{split}-{self._lengths_cache_key(split)}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return z["men"], (z["ent"] if "ent" in z.files else None)
        men, ent = self._precompute_lengths()
        # np.savez appends .npz unless the name already ends with it
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        arrays = {"men": men} if ent is None else {"men": men, "ent": ent}
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
        return men, ent

    def _precompute_lengths(self):
        """Per-example token content lengths.

        Mention: the attention-mask content length of the padded encoding
        (or the re-packed [CLS mention SEP] length under
        ``pre_extract_mention``).  Entity, zipped: the longest of the S
        packed sentences (one CLS column plus the candidates' bodies);
        direct: the longest candidate.  The trim stays above every row's
        content, so the numbers do not change.  The entity pass goes
        through the pool when there is one."""
        cfg, tok = self.cfg, self.tokenizer
        if cfg.pre_extract_mention:
            men = (np.asarray(self.end_pos, np.int64)
                   - np.asarray(self.start_pos, np.int64) + 2)
        else:
            men = np.array([len(tok.encode(str(t), truncation=True))
                            for t in self.mention_text], np.int64)
        men = np.minimum(men, cfg.max_bert_len)
        if cfg.num_entity_sentence:
            S = cfg.num_entity_sentence
            C = cfg.num_candidates_model
            per = (C + S - 1) // S
            if self._pool is not None:
                jobs = [(list(map(str, self.entity_text[i])), S, per)
                        for i in range(len(self))]
                ent = np.asarray(self._pool.map(_zip_len_row, jobs), np.int64)
            else:
                ent = np.zeros((len(self),), np.int64)
                for i in range(len(self)):
                    body = [len(ids) - 1 for ids in
                            tok.encode_batch(self.entity_text[i], truncation=True)]
                    ent[i] = max(1 + sum(body[s * per : (s + 1) * per])
                                 for s in range(S))
        else:
            if self._pool is not None:
                jobs = [list(map(str, self.entity_text[i])) for i in range(len(self))]
                ent = np.asarray(self._pool.map(_flat_len_row, jobs), np.int64)
            else:
                ent = np.array(
                    [max(len(ids) for ids in
                         tok.encode_batch(self.entity_text[i], truncation=True))
                     for i in range(len(self))], np.int64)
            ent = np.minimum(ent, cfg.max_bert_len)
        return men, ent

    def close(self):
        """Stop the tokenizer pool (also done when the dataset is collected)."""
        if self._pool_finalizer is not None:
            self._pool_finalizer.detach()
            self._pool_finalizer = None
        if self._pool is not None:
            _terminate_pool(self._pool)
            self._pool = None

    def __len__(self):
        return len(self.answer)

    def online_batch(self, idx: np.ndarray, bucket_idx: Optional[np.ndarray] = None) -> OnlineBatch:
        cfg = self.cfg
        tok = self.tokenizer
        B = len(idx)
        C = cfg.num_candidates_model
        used_m = used_e = None
        if self._men_len is not None:
            # the global batch's bucket: the same trim in every process,
            # whichever rows this one assembles
            bidx = np.asarray(idx if bucket_idx is None else bucket_idx)
            used_m = int(self._men_len[bidx].max())
            if self._ent_len is not None:
                used_e = int(self._ent_len[bidx].max())
        mention_ids, mention_mask, start_pos, end_pos = mention_tokens(
            cfg, tok, [str(t) for t in self.mention_text[idx]],
            self.start_pos[idx], self.end_pos[idx], self._bucket, used=used_m)
        ids, mask, sep = entity_tokens(
            cfg, tok, [self.entity_text[idx[b]] for b in range(B)],
            self._bucket, self._pool, used=used_e)
        mi = (np.asarray(self.mention_image[idx]) if self.mention_image is not None
              else np.zeros((B,), np.float32))
        ei = (np.asarray(self.entity_image[idx]).reshape(B, C, -1) if self.entity_image is not None
              else np.zeros((B,), np.float32))
        return OnlineBatch(
            mention_ids=mention_ids,
            mention_mask=mention_mask,
            mention_start_pos=start_pos,
            mention_end_pos=end_pos,
            mention_image_feature=mi,
            entity_ids=ids,
            entity_mask=mask,
            entity_sep_idx=sep,
            entity_image_feature=ei,
            answer=self.onehot[self.answer[idx]],
        )

    def labels(self, idx: np.ndarray) -> np.ndarray:
        """Gold candidate index per mention."""
        return gold_labels(self.answer[idx], self.onehot.shape[0])

    # the trainer passes the global batch indices as ``bucket_idx`` so that
    # every process derives the same length bucket (see _precompute_lengths)
    accepts_bucket_idx = True

    def make_batch(self, idx: np.ndarray, kind: str = "online",
                   bucket_idx: Optional[np.ndarray] = None):
        """The batch for explicit mention indices (the trainer's hook)."""
        return self.online_batch(idx, bucket_idx=bucket_idx)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                kind: str = "online", drop_remainder: bool = False, pad_to_full: bool = False):
        for idx in iter_batch_indices(len(self), batch_size, shuffle, seed,
                                      drop_remainder, pad_to_full):
            yield self.online_batch(idx)
