# -*- coding: utf-8 -*-
"""The port's raw-text training data against ``drin_tpu.data.online``:
``OnlineMELDataset`` batches bit for bit (zipped and direct, ``attr`` and
``name`` texts, WikiMEL and WikiDiverse, the image fields, with the
tokenizer pool and without, the global-batch bucket), the pool workers, the
length cache, the pool's lifetime, and ``make_synthetic_online_store`` file
for file."""

import dataclasses
import filecmp
import gc
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

from drin_tpu.data import online as jonline
from drin_tpu.data import synthetic as jsyn
from drin_tpu_torch.common.config import make_config
from drin_tpu_torch.data import online as tonline
from drin_tpu_torch.data import synthetic as tsyn
from drin_tpu_torch.text.wordpiece import BertTokenizer

ROOT = Path(__file__).resolve().parents[1]


def _port_cfg(cfg):
    d = dataclasses.asdict(cfg)
    return make_config(d.pop("model_type"), d.pop("dataset_name"), **d)


def _store(path, dataset="wikimel", multimodal=False, **cfg_kw):
    """The JAX package's tiny online store (C=4 candidates, 7 train mentions),
    with WikiDiverse's materialized candidate texts and the image fields
    added where asked.  Returns (JAX config, port config, vocab)."""
    C = 4
    sentences = cfg_kw.pop("num_entity_sentence", 2)  # the store's config sets it itself
    cfg, tok = jsyn.make_synthetic_online_store(str(path), n=7, C=C, max_len=32, **cfg_kw)
    cfg = cfg.replace(num_entity_sentence=sentences)
    rng = np.random.default_rng(3)
    words = ["alpha", "beta", "gamma", "delta", "name", "attr", "text"]
    for split in ("train", "valid", "test"):
        n = len(np.load(path / f"answer_{split}.npy"))
        if dataset == "wikidiverse":
            texts = [" ".join(rng.choice(words, int(rng.integers(1, 7)))) for _ in range(n * C)]
            np.save(path / f"entity-attr-raw_{split}.npy", np.asarray(texts))
        if multimodal:
            np.save(path / f"mention-image-feature_{split}.npy",
                    rng.standard_normal((n, cfg.resnet_num_region, cfg.resnet_embed_dim),
                                        dtype=np.float32))
            np.save(path / f"entity-image-feature_{split}.npy",
                    rng.standard_normal((n, C, cfg.resnet_embed_dim), dtype=np.float32))
    if dataset == "wikidiverse":
        cfg = cfg.replace(dataset_name="wikidiverse")
    if multimodal:
        cfg = cfg.replace(mention_final_layer_name="multimodal",
                          entity_final_layer_name="multimodal")
    return cfg, _port_cfg(cfg), tok.vocab


def _assert_batches_equal(got, want):
    assert type(got)._fields == type(want)._fields
    for name, x, y in zip(want._fields, got, want):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (name, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=name)


CASES = {
    "wikimel-zipped-attr": dict(),
    "wikimel-zipped-name": dict(entity_text_type="name"),
    "wikimel-direct-attr": dict(num_entity_sentence=0),
    "wikimel-zipped-images": dict(multimodal=True),
    "wikimel-extract-mention": dict(pre_extract_mention=True),
    "wikidiverse-zipped": dict(dataset="wikidiverse"),
    "wikidiverse-direct-images": dict(dataset="wikidiverse", multimodal=True,
                                      num_entity_sentence=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_online_batch_bit_equal_to_jax(tmp_path, case):
    kw = dict(CASES[case])
    jcfg, tcfg, vocab = _store(tmp_path, kw.pop("dataset", "wikimel"), kw.pop("multimodal", False),
                               **kw)
    for split in ("train", "valid"):
        theirs = jonline.OnlineMELDataset(jcfg, split, tokenizer=jwp_tokenizer(vocab))
        ours = tonline.OnlineMELDataset(tcfg, split, tokenizer=BertTokenizer(
            vocab=vocab, model_max_length=32))
        assert len(ours) == len(theirs)
        assert ours._pool is None and ours._men_len is None
        np.testing.assert_array_equal(ours.entity_text, theirs.entity_text)
        n = len(ours)
        for idx in (np.arange(min(4, n)), np.array([n - 1, 0]), np.array([1])):
            _assert_batches_equal(ours.online_batch(idx), theirs.online_batch(idx))
            _assert_batches_equal(ours.make_batch(idx, "online", bucket_idx=idx),
                                  theirs.make_batch(idx, "online", bucket_idx=idx))
            np.testing.assert_array_equal(ours.labels(idx), theirs.labels(idx))
        for a, b in zip(ours.batches(3, shuffle=True, seed=2, pad_to_full=True),
                        theirs.batches(3, shuffle=True, seed=2, pad_to_full=True)):
            _assert_batches_equal(a, b)
    answers = theirs.onehot[theirs.answer]
    assert (answers.sum(-1) == 0).any()  # the answer-absent sentinel, an all-zero row
    if tcfg.mention_final_layer_name == "multimodal":
        assert ours.online_batch(np.arange(2)).mention_image_feature.ndim == 3


def jwp_tokenizer(vocab):
    from drin_tpu.text.wordpiece import BertTokenizer as JaxTokenizer

    return JaxTokenizer(vocab=vocab, model_max_length=32)


@pytest.mark.parametrize("dataset", ["wikimel", "wikidiverse"])
def test_pool_batches_bit_equal(tmp_path, monkeypatch, dataset):
    """A spawn pool of two tokenizer workers gives the in-process arrays and
    the JAX package's; its workers never import torch; vocab read from
    ``cfg.bert_vocab``."""
    jcfg, tcfg, vocab = _store(tmp_path, dataset)
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    pooled = tonline.OnlineMELDataset(tcfg.replace(dataloader_workers=2, bert_vocab=str(path)),
                                      "train")
    try:
        assert pooled._pool is not None
        plain = tonline.OnlineMELDataset(tcfg, "train", tokenizer=BertTokenizer(vocab=vocab,
                                                                                model_max_length=32))
        theirs = jonline.OnlineMELDataset(jcfg, "train", tokenizer=jwp_tokenizer(vocab))
        for idx in (np.arange(4), np.array([6, 2, 5])):
            got = pooled.online_batch(idx)
            _assert_batches_equal(got, plain.online_batch(idx))
            _assert_batches_equal(got, theirs.online_batch(idx))
        assert pooled._pool.apply(eval, ("'torch' in __import__('sys').modules",)) is False
        # the length pass through the pool equals the in-process one
        for a, b in zip(pooled._precompute_lengths(), plain._precompute_lengths()):
            np.testing.assert_array_equal(a, b)
    finally:
        pooled.close()


def test_worker_functions_equal_jax():
    texts = ["alpha beta", "gamma", "", "delta alpha alpha beta", "beta"]
    from drin_tpu.text.wordpiece import build_tiny_vocab

    vocab = build_tiny_vocab(texts)
    jonline._init_tok_worker(vocab, 16)
    tonline._init_tok_worker(vocab, 16)
    for got, want in zip(tonline._zip_row((texts, 2, 16)), jonline._zip_row((texts, 2, 16))):
        np.testing.assert_array_equal(got, want)
    assert tonline._zip_len_row((texts, 2, 3)) == jonline._zip_len_row((texts, 2, 3))
    assert tonline._flat_len_row(texts) == jonline._flat_len_row(texts)


def test_brief_raises(tmp_path):
    jcfg, tcfg, vocab = _store(tmp_path)
    tok = BertTokenizer(vocab=vocab, model_max_length=32)
    with pytest.raises(ValueError, match="brief"):
        tonline.OnlineMELDataset(tcfg.replace(entity_text_type="brief"), "train", tokenizer=tok)
    with pytest.raises(ValueError, match="brief"):
        jonline.OnlineMELDataset(jcfg.replace(entity_text_type="brief"), "train",
                                 tokenizer=jwp_tokenizer(vocab))


def test_discarded_dataset_is_collected_with_its_pool(tmp_path, monkeypatch):
    _, tcfg, vocab = _store(tmp_path)
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    cfg = tcfg.replace(dataloader_workers=2)
    tok = BertTokenizer(vocab=vocab, model_max_length=32)
    ds = tonline.OnlineMELDataset(cfg, "train", tokenizer=tok)
    workers = list(ds._pool._pool)
    assert len(workers) == 2 and all(w.is_alive() for w in workers)
    assert ds.online_batch(np.arange(2)).entity_ids.shape[0] == 2
    fin, ref = ds._pool_finalizer, weakref.ref(ds)
    del ds
    gc.collect()
    assert ref() is None, "the dataset is kept alive after it was dropped"
    assert not fin.alive
    for w in workers:
        w.join(timeout=30)
    assert not any(w.is_alive() for w in workers)
    # close() stops the pool at once and detaches the finalizer; twice is fine
    ds2 = tonline.OnlineMELDataset(cfg, "train", tokenizer=tok)
    fin2 = ds2._pool_finalizer
    ds2.close()
    assert ds2._pool is None and ds2._pool_finalizer is None and not fin2.alive
    ds2.close()


@pytest.mark.parametrize("zipped", [True, False], ids=["zipped", "direct"])
def test_length_cache_equals_jax(tmp_path, zipped):
    kw = {} if zipped else dict(num_entity_sentence=0)
    jcfg, tcfg, vocab = _store(tmp_path, **kw)
    theirs = jonline.OnlineMELDataset(jcfg, "train", tokenizer=jwp_tokenizer(vocab))
    ours = tonline.OnlineMELDataset(tcfg, "train", tokenizer=BertTokenizer(vocab=vocab,
                                                                          model_max_length=32))
    assert ours._lengths_cache_key("train") == theirs._lengths_cache_key("train")
    assert ours._lengths_cache_key("valid") != ours._lengths_cache_key("train")
    men, ent = ours._precompute_lengths()
    jmen, jent = theirs._precompute_lengths()
    assert men.dtype == jmen.dtype == ent.dtype == jent.dtype == np.int64
    np.testing.assert_array_equal(men, jmen)
    np.testing.assert_array_equal(ent, jent)
    # several processes: the lengths come from (and go to) the cache beside
    # the store, and the global batch's bucket gives the local batch's arrays
    multi = tonline.OnlineMELDataset(tcfg.replace(num_processes=2), "train",
                                     tokenizer=BertTokenizer(vocab=vocab, model_max_length=32))
    np.testing.assert_array_equal(multi._men_len, men)
    cached = [f for f in os.listdir(tmp_path) if f.startswith(".lengths-train-")]
    assert cached == [f".lengths-train-{ours._lengths_cache_key('train')}.npz"]
    np.testing.assert_array_equal(multi._cached_lengths("train")[1], ent)
    for idx in (np.arange(3), np.array([3, 4, 5])):
        _assert_batches_equal(multi.online_batch(idx, bucket_idx=idx), ours.online_batch(idx))
    gidx = np.arange(4)
    halves = [multi.online_batch(gidx[:2], bucket_idx=gidx),
              multi.online_batch(gidx[2:], bucket_idx=gidx)]
    full = multi.online_batch(gidx, bucket_idx=gidx)
    for name, a, b, f in zip(full._fields, *halves, full):
        np.testing.assert_array_equal(np.concatenate([a, b]), f, err_msg=name)


def test_make_synthetic_online_store_equals_jax(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jcfg, jtok = jsyn.make_synthetic_online_store(str(jdir), n=9, C=4, max_len=24, batch_size=3)
    tcfg, ttok = tsyn.make_synthetic_online_store(str(tdir), n=9, C=4, max_len=24, batch_size=3)
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir)) and len(files) == 17
    match, mismatch, errors = filecmp.cmpfiles(jdir, tdir, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(tcfg)
    for key in ("preprocess_dir", "qid2entity_path", "qid2attr_path"):
        assert got.pop(key).replace(str(tdir), str(jdir)) == want.pop(key)
    assert got == want
    assert ttok.vocab == jtok.vocab and ttok.model_max_length == jtok.model_max_length
    # write=False builds the same config and tokenizer and writes nothing
    again, tok2 = tsyn.make_synthetic_online_store(str(tmp_path / "none"), n=9, C=4, max_len=24,
                                                   write=False, batch_size=3)
    assert not (tmp_path / "none").exists() and tok2.vocab == ttok.vocab
    assert dataclasses.asdict(again)["max_bert_len"] == 24


def test_train_main_module_imports_no_torch():
    """The spawn workers import the parent's ``__main__`` again: under
    ``python -m drin_tpu_torch.train`` that is ``train/__main__.py``, and the
    online data module the workers run must not pull in torch either."""
    code = ("import sys, runpy\n"
            "runpy.run_module('drin_tpu_torch.train.__main__', run_name='__mp_main__')\n"
            "import drin_tpu_torch.data.online\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr
