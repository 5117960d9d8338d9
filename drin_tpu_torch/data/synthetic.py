# -*- coding: utf-8 -*-
"""Synthetic feature-store fixtures.

Fabricates a tiny ``preprocess_dir`` obeying the ``.npy`` naming contract the
real preprocessing pipeline writes (reference ``preprocess/prepare.py:24-28``,
``bert.py:95-109``, ``resnet.py:148-162``, ``clip.py:163-172``) so the whole
training/eval path can be exercised without the 100GB real store.

Array shapes follow the reference feature schema exactly
(``drin/data.py:47-71``, ``baselines/data.py:73-122``); magnitudes are chosen
to look like the real features (BERT activations ~N(0,1), CLIP logits ~[0,40],
detector scores in [0,1] descending).

The port's own copy of ``drin_tpu/data/synthetic.py``: the same seed writes
the same files byte for byte, the raw-text online store
(``make_synthetic_online_store``) included.
"""

from __future__ import annotations

import json
import os

import numpy as np

from drin_tpu_torch.common.config import Config


def make_synthetic_store(cfg: Config, n_mentions: dict | int = 12, n_entities: int = 64,
                         seed: int = 0, learnable: bool = False) -> str:
    """Write a synthetic feature store for ``cfg.dataset_name`` into
    ``cfg.preprocess_dir``.  Returns the directory.

    ``learnable=True``: each mention carries a latent concept vector that its
    text features AND its gold candidate's text features share (distractors
    get other concepts), so a matching model can drive top-1 far above chance
    by learning, not memorizing — purely random features only reward
    memorization, which a 16-dim tiny model cannot do at hundreds of
    mentions.  For wikidiverse the concepts live in the mention-aligned
    entity rows; for wikimel they live in the GLOBAL token-level entity text
    table (reference drin/data.py:164-167) and reach the mention only through
    the qid join (drin/data.py:88) — so a convergence run through this store
    exercises the [N, C] gather-join input path end to end.  Used by the
    convergence-scale trajectory A/Bs (tests/test_training_parity.py)."""
    if isinstance(n_mentions, int):
        n_mentions = {"train": n_mentions, "valid": max(2, n_mentions // 3), "test": max(2, n_mentions // 3)}
    rng = np.random.default_rng(seed)
    d = cfg.preprocess_dir
    os.makedirs(d, exist_ok=True)
    C = cfg.num_candidates_model
    L = cfg.max_mention_sentence_len
    D = cfg.bert_embed_dim
    R = cfg.resnet_num_region
    Dr = cfg.resnet_embed_dim
    Lm = cfg.max_entity_attr_token_len
    Tm, Te = cfg.mention_object_topk, cfg.entity_object_topk
    if learnable:
        n_concepts = 10
        concepts = rng.standard_normal((n_concepts, D)).astype(np.float32)
        if cfg.dataset_name == "wikimel":
            # round-robin concept per GLOBAL entity: neighbours always carry
            # different concepts, so "+1" below moves a clashing distractor
            # onto a fresh concept deterministically
            entity_concept = np.arange(n_entities) % n_concepts

    def _save(name: str, arr: np.ndarray):
        np.save(os.path.join(d, name + ".npy"), arr)

    for split, n in n_mentions.items():
        # mention-side arrays (shared by both datasets)
        if learnable:
            if cfg.dataset_name == "wikimel":
                gold_entity = rng.integers(0, n_entities, size=n)
                concept_ids = entity_concept[gold_entity]
            else:
                concept_ids = rng.integers(0, n_concepts, size=n)
            mtf = (0.5 * rng.standard_normal((n, L, D))
                   + concepts[concept_ids][:, None, :]).astype(np.float32)
        else:
            mtf = rng.standard_normal((n, L, D), dtype=np.float32)
        _save(f"mention-text-feature_{split}", mtf)
        # include L itself: real stores are full of all-ones masks (every
        # sentence longer than the window truncates to exactly L tokens,
        # bert.py:79), and a fixture that never generates them would let
        # last-valid-token arithmetic that assumes a padding position pass
        lens = rng.integers(4, L + 1, size=n)
        mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int64)
        _save(f"mention-text-mask_{split}", mask)
        start = rng.integers(0, np.maximum(lens - 2, 1))
        end = np.minimum(start + rng.integers(1, 3, size=n), lens - 1)
        end = np.maximum(end, start + 1)
        _save(f"start-pos_{split}", start.astype(np.int64))
        _save(f"end-pos_{split}", end.astype(np.int64))
        _save(f"mention-image-feature_{split}", rng.standard_normal((n, R, Dr), dtype=np.float32))
        _save(f"mention-object-feature_{split}", rng.standard_normal((n, Tm, Dr), dtype=np.float32))
        scores = np.sort(rng.uniform(0, 1, size=(n, Tm)).astype(np.float32), axis=-1)[:, ::-1]
        _save(f"mention-object-score_{split}", np.ascontiguousarray(scores))
        _save(f"similarity-miet_{split}", rng.uniform(0, 40, size=(n, C)).astype(np.float32))
        _save(f"similarity-eimt_{split}", rng.uniform(0, 40, size=(n, C)).astype(np.float32))
        # answer index in [0, num_candidates_data]; the top value means
        # "answer not among candidates" -> all-zero one-hot row
        # (reference drin/data.py:159-161)
        answer = rng.integers(0, cfg.num_candidates_data, size=n)
        if not learnable:  # learnable mode keeps every label trainable
            answer[rng.uniform(size=n) < 0.1] = cfg.num_candidates_data
        _save(f"answer_{split}", answer.astype(np.int64))

        if cfg.dataset_name == "wikidiverse":
            # entity features stored mention-aligned and flattened over the
            # candidate dim (reference drin/data.py:30-38); the text-feature
            # field name carries entity_text_type (baselines/data.py:100-105)
            if learnable:
                cand_c = rng.integers(0, n_concepts, size=(n, C))
                clash = cand_c == concept_ids[:, None]  # distractors differ
                cand_c[clash] = (cand_c[clash] + 1) % n_concepts
                cand_c[np.arange(n), answer] = concept_ids  # gold shares it
                etf = (concepts[cand_c]
                       + 0.4 * rng.standard_normal((n, C, D))).astype(np.float32)
            else:
                etf = rng.standard_normal((n * C, D), dtype=np.float32)
            _save(f"entity-{cfg.entity_text_type}-feature_{split}",
                  etf.reshape(n * C, D))
            _save(f"entity-image-feature_{split}", rng.standard_normal((n * C, 1, Dr), dtype=np.float32))
            _save(f"entity-object-feature_{split}", rng.standard_normal((n * C, Te, 1, Dr), dtype=np.float32))
            _save(f"entity-object-score_{split}", rng.uniform(0, 1, size=(n * C, Te)).astype(np.float32))
        else:  # wikimel: per-mention candidate qids into a global table
            cand_e = rng.integers(0, n_entities, size=n * C).reshape(n, C)
            if learnable:
                # distractors must NOT share the gold's concept; round-robin
                # assignment makes "+1 mod N" cycle concepts, so this
                # converges in < n_concepts passes
                clash = entity_concept[cand_e] == concept_ids[:, None]
                while clash.any():
                    cand_e[clash] = (cand_e[clash] + 1) % n_entities
                    clash = entity_concept[cand_e] == concept_ids[:, None]
                # the gold entity sits at the answer position (prepare.py
                # roster contract); the appended final column is stripped by
                # loss/metrics either way (utils.py:36-37)
                cand_e[np.arange(n), answer] = gold_entity
            qids = np.array([f"Q{i}" for i in cand_e.ravel()])
            _save(f"entity-name-raw_{split}", qids)

    if cfg.dataset_name == "wikimel":
        # global entity table + qid2idx join key (reference bert.py:60-63,
        # drin/data.py:41-46, :164-175)
        if learnable:
            getf = (concepts[entity_concept][:, None, :]
                    + 0.4 * rng.standard_normal((n_entities, Lm, D))).astype(np.float32)
        else:
            getf = rng.standard_normal((n_entities, Lm, D), dtype=np.float32)
        _save(f"entity-{cfg.entity_text_type}-feature", getf)
        elens = rng.integers(3, Lm, size=n_entities)
        emask = (np.arange(Lm)[None, :] < elens[:, None]).astype(np.int64)
        _save(f"entity-{cfg.entity_text_type}-mask", emask)
        _save("entity-image-feature_all", rng.standard_normal((n_entities, 1, Dr), dtype=np.float32))
        _save("entity-object-feature_all", rng.standard_normal((n_entities, Te, 1, Dr), dtype=np.float32))
        _save("entity-object-score_all", rng.uniform(0, 1, size=(n_entities, Te)).astype(np.float32))
        with open(os.path.join(d, "qid2idx.json"), "w") as f:
            json.dump({f"Q{i}": i for i in range(n_entities)}, f)
    return d


def make_synthetic_online_store(preprocess_dir: str, n: int = 8, C: int = 3,
                                max_len: int = 32, write: bool = True, **cfg_kw):
    """Tiny ONLINE intermediate store (raw mention texts + qid candidates,
    the fields OnlineMELDataset reads) plus a matching config + tokenizer.

    Deterministic: a second process can rebuild the identical cfg/tokenizer
    with ``write=False`` against a store another process already wrote (the
    multi-process bucketing tests rely on this).  Splits: train = ``n``
    mentions, valid/test = max(2, n // 3).  The same arguments write the same
    files and return the same config and tokenizer as the JAX package's."""
    import json

    from drin_tpu_torch.common import npy_io
    from drin_tpu_torch.text.wordpiece import BertTokenizer, build_tiny_vocab

    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
             "theta", "iota", "kappa"]
    vocab = build_tiny_vocab(words + ["name", "attr", "text"]
                             + [f"Q{i}" for i in range(4)])
    tok = BertTokenizer(vocab=vocab, model_max_length=max_len)
    rng = np.random.default_rng(11)
    splits = {"train": n, "valid": max(2, n // 3), "test": max(2, n // 3)}
    if write:
        os.makedirs(preprocess_dir, exist_ok=True)
        for split, ns in splits.items():
            sentences = [" ".join(rng.choice(words, size=int(rng.integers(3, 9))))
                         for _ in range(ns)]
            npy_io.save_field(preprocess_dir, "mention_text_raw",
                              np.asarray(sentences), split)
            npy_io.save_field(preprocess_dir, "start_pos", np.ones(ns, np.int64), split)
            npy_io.save_field(preprocess_dir, "end_pos", np.full(ns, 2, np.int64), split)
            answers = (np.arange(ns) % (C - 1)).astype(np.int64)
            if ns > 1:
                # one answer-absent sentinel per split (index C-1 -> the
                # all-zero one-hot row) — common in real wikimel data
                # (first-stage retrieval misses); the reference's online
                # loader handles it through the same one-hot lookup
                # (baselines/data.py:132)
                answers[-1] = C - 1
            npy_io.save_field(preprocess_dir, "answer", answers, split)
            npy_io.save_field(preprocess_dir, "entity_name_raw",
                              np.asarray([f"Q{i % 4}" for i in range(ns * C)]), split)
        with open(os.path.join(preprocess_dir, "qid2ne.json"), "w") as f:
            json.dump({f"Q{i}": f"name Q{i}" + " attr" * i for i in range(4)}, f)
        with open(os.path.join(preprocess_dir, "qid2abs.json"), "w") as f:
            json.dump({f"Q{i}": "attr text" * (i + 1) for i in range(4)}, f)
    cfg = tiny_config("wikimel", "ghmfc", preprocess_dir=preprocess_dir).replace(
        num_candidates_data=C - 1, online_bert=True, max_bert_len=max_len,
        num_entity_sentence=2, online_length_buckets=4,
        mention_final_layer_name="linear", entity_final_layer_name="linear",
        qid2entity_path=os.path.join(preprocess_dir, "qid2ne.json"),
        qid2attr_path=os.path.join(preprocess_dir, "qid2abs.json"), **cfg_kw)
    return cfg, tok


def tiny_config(dataset_name: str = "wikidiverse", model_type: str = "drin", preprocess_dir: str = "/tmp/drin-synth", **kw) -> Config:
    """A small-dimension Config for fast tests; shapes stay structurally
    faithful to the reference schema."""
    from drin_tpu_torch.common.config import make_config

    defaults = dict(
        bert_embed_dim=16,
        resnet_embed_dim=24,
        gcn_embed_dim=16,
        mention_final_output_dim=16,
        entity_final_output_dim=16,
        max_mention_sentence_len=12,
        max_entity_attr_token_len=8,
        resnet_num_region=4,
        batch_size=4,
        transformer_num_layers=2,
        transformer_num_heads=2,
        transformer_ffn_hidden_size=16,
        dataloader_workers=0,
        use_device="cpu",
    )
    if dataset_name == "wikimel":
        defaults["num_candidates_data"] = 7
        # the real wikimel topk list reaches 50; clamp to the shrunken
        # candidate count (top_k requires k <= C, like torch.topk)
        defaults["metrics_topk"] = (1, 5, 7)
    else:
        defaults["num_candidates_data"] = 5
    defaults.update(kw)
    return make_config(
        model_type=model_type,
        dataset_name=dataset_name,
        dataset_root="/tmp/drin-synth-raw",
        preprocess_dir=preprocess_dir,
        **defaults,
    )
