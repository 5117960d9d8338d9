# -*- coding: utf-8 -*-
"""The port's raw-text front against ``drin_tpu``'s: the WordPiece
tokenizer id for id (with the JAX package's native fast path on and off),
``build_tiny_vocab``, ``MentionPositionProcessor``, ``assemble_online_feats``
bit for bit, and ``Ranker.rank_text`` against the JAX ``Ranker.rank_text`` on
the same strings and converted weights (float32, rtol 2e-4)."""

import numpy as np
import pytest

from drin_tpu.data import online as jonline
from drin_tpu.preprocess.prepare import MentionPositionProcessor as JaxMPP
from drin_tpu.text import wordpiece as jwp
from drin_tpu_torch.data import online as tonline
from drin_tpu_torch.preprocess.prepare import MentionPositionProcessor
from drin_tpu_torch.text import wordpiece as twp

F32 = dict(rtol=2e-4, atol=1e-5)


def _corpus():
    """Seeded sentences plus the cases the tokenizer's rules single out."""
    rng = np.random.default_rng(0)
    words = ["Paris", "river", "walking", "walked", "runs", "Obama", "U.S.", "state-of-art",
             "x86", "(note)", "naïve", "Café", "Müller", "ÉCOLE", "东京", "日本語", "k-pop"]
    seeded = [" ".join(rng.choice(words, rng.integers(1, 12))) for _ in range(30)]
    special = [
        "", "   ", "\t\n\r", "Hello, world! It's 3:45 p.m.", "Ångström über façade",
        "東京は日本の首都です。", "mixed漢字and中文text", "nul\x00byte�replaced",
        "bell\x07and\x1bescape", "zero​width", "nbsp\xa0and　ideographic space",
        "a" * 101, "b" * 100, "emoji 🙂 astral 𝒜 codepoints", "ﬁ ligature ＡＢＣ fullwidth",
        "trailing punctuation!!!", "--dashes-- and __under__", "unknownword zzqx",
    ]
    return seeded + special


def _vocab(corpus, lower=False):
    basic = jwp.BasicTokenizer(lower)
    words = sorted({w for t in corpus for w in basic.tokenize(t)})
    # keep a third of the words whole; the rest must split into pieces or
    # become [UNK]
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    for w in words[::3] + ["walk", "##ing", "##ed", "run", "##s", "Par", "##is", "b" * 100]:
        vocab.setdefault(w, len(vocab))
    return vocab


@pytest.mark.parametrize("lower", [False, True], ids=["cased", "lower"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_tokenizer_ids_equal_the_jax_package(lower, native):
    corpus = _corpus()
    vocab = _vocab(corpus, lower)
    theirs = jwp.BertTokenizer(vocab=vocab, do_lower_case=lower, model_max_length=12)
    if not native:
        theirs._native = None
    elif theirs._native is None and not lower:
        pytest.skip("the JAX package's native tokenizer library is not built")
    ours = twp.BertTokenizer(vocab=vocab, do_lower_case=lower, model_max_length=12)
    for text in corpus:
        assert ours.tokenize(text) == theirs.tokenize(text), text
        for trunc in (False, True):
            assert ours.encode(text, truncation=trunc) == theirs.encode(text, truncation=trunc)
    for trunc in (False, True):
        assert ours.encode_batch(corpus, truncation=trunc) == theirs.encode_batch(
            corpus, truncation=trunc)
    for kw in (dict(), dict(truncation=True), dict(padding="max_length", truncation=True),
               dict(padding="max_length", truncation=True, max_length=20)):
        got, want = ours(corpus, **kw), theirs(corpus, **kw)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{kw} {key}")
    assert ours("single")["input_ids"].shape == theirs("single")["input_ids"].shape
    # a word longer than 100 characters is one [UNK]; one of 100 is matched
    assert ours.tokenize("a" * 101) == ["[UNK]"] and ours.tokenize("b" * 100) == ["b" * 100]


def test_tokenizer_reads_vocab_file_and_tiny_vocab_equal(tmp_path):
    corpus = _corpus()
    extra = ["##x", "zz"]
    vocab = twp.build_tiny_vocab(corpus, extra)
    assert vocab == jwp.build_tiny_vocab(corpus, extra)
    path = tmp_path / "vocab.txt"
    inv = {i: w for w, i in vocab.items()}
    path.write_text("".join(inv[i] + "\n" for i in range(len(inv))), encoding="utf-8")
    ours = twp.BertTokenizer(vocab_file=str(path), model_max_length=16)
    theirs = jwp.BertTokenizer(vocab_file=str(path), model_max_length=16)
    assert ours.vocab == theirs.vocab == vocab
    assert (ours.cls_id, ours.sep_id, ours.pad_id) == (theirs.cls_id, theirs.sep_id,
                                                       theirs.pad_id)
    np.testing.assert_array_equal(ours(corpus)["input_ids"], theirs(corpus)["input_ids"])
    for name in ("_is_whitespace", "_is_control", "_is_punctuation"):
        for cp in list(range(0x250)) + [0x3000, 0x200B, 0xFEFF, 0x2028, 0x1F642]:
            assert getattr(twp, name)(chr(cp)) == getattr(jwp, name)(chr(cp)), (name, hex(cp))
    for cp in (0x4E00, 0x9FFF, 0x3400, 0x20000, 0x2B740, 0xF900, 0x2F800, 0x3042, 0xAC00):
        assert twp._is_chinese_char(cp) == jwp._is_chinese_char(cp)


def test_mention_positions_equal_the_jax_package():
    """Character spans -> token spans, including a prefix longer than
    ``model_max_length`` (clipped by the truncation, not counted)."""
    corpus = _corpus()
    vocab = _vocab(corpus)
    long_prefix = "Paris river walking " * 6
    sentences = ["Obama walked to Paris.", "The naïve Café Müller runs", "東京は日本の首都です",
                 long_prefix + "Obama there", "x86 k-pop (note) U.S. state-of-art"]
    starts = [0, 10, 0, len(long_prefix), 9]
    ends = [5, 21, 2, len(long_prefix) + 5, 22]
    for max_len in (8, 64):
        ours = MentionPositionProcessor(twp.BertTokenizer(vocab=vocab, model_max_length=max_len))
        theirs = JaxMPP(jwp.BertTokenizer(vocab=vocab, model_max_length=max_len))
        got, want = ours(sentences, starts, ends), theirs(sentences, starts, ends)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got[0][3] > 6  # 64 tokens: the long prefix counted ...
    assert MentionPositionProcessor(twp.BertTokenizer(vocab=vocab, model_max_length=8))(
        sentences, starts, ends)[0][3] == 6  # ... 8 tokens: clipped to 8 - 2


# ---------------------------------------------------------------------------
# raw strings -> the online request


def _texts(seed, B, n_cands):
    rng = np.random.default_rng(seed)
    words = ["Alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta", "iota",
             "kappa", "lambda", "mu", ",", "."]
    sentences, spans, cands = [], [], []
    for _ in range(B):
        ws = list(rng.choice(words[:12], rng.integers(3, 14)))
        i = int(rng.integers(0, len(ws)))
        start = len(" ".join(ws[:i])) + (1 if i else 0)
        sentences.append(" ".join(ws))
        spans.append((start, start + len(ws[i])))
        cands.append([" ".join(rng.choice(words, rng.integers(1, 5))) for _ in range(n_cands)])
    return sentences, spans, cands


def _online_cfgs(zipped, layer, pre_extract=False):
    from drin_tpu.data.synthetic import tiny_config

    kw = dict(online_bert=True, finetune_bert=False, max_bert_len=32,
              num_entity_sentence=3 if zipped else 0, max_entity_attr_token_len=12,
              mention_final_layer_name=layer, pre_extract_mention=pre_extract,
              online_length_buckets=8)
    return tiny_config("wikimel", "ghmfc", preprocess_dir="unused-online", **kw).replace(
        compute_dtype="float32")


@pytest.mark.parametrize("zipped", [True, False], ids=["zipped", "direct"])
@pytest.mark.parametrize("n_cands", [3, 8, 11], ids=["fewer", "C", "more"])
def test_assemble_online_feats_bit_equal(zipped, n_cands):
    cfg = _online_cfgs(zipped, "multimodal")
    assert cfg.num_candidates_model == 8
    sentences, spans, cands = _texts(n_cands, 4, n_cands)
    vocab = jwp.build_tiny_vocab(sentences + [c for row in cands for c in row])
    ours = twp.BertTokenizer(vocab=vocab, model_max_length=cfg.max_bert_len)
    theirs = jwp.BertTokenizer(vocab=vocab, model_max_length=cfg.max_bert_len)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((4, cfg.resnet_num_region, cfg.resnet_embed_dim))
    cases = [(cfg, None), (cfg, images), (_online_cfgs(zipped, "linear"), None),
             (_online_cfgs(zipped, "linear", pre_extract=True), None)]
    for c, img in cases:
        got = tonline.assemble_online_feats(c, ours, sentences, spans, cands, img)
        want = jonline.assemble_online_feats(c, theirs, sentences, spans, cands, img)
        assert len(got) == len(want) == 9
        for name, g, w in zip(tonline.OnlineBatch._fields, got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, (name, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=name)
    # the buckets trimmed the entity sentences below max_bert_len
    assert got[5].shape[-1] < cfg.max_bert_len and got[5].shape[-1] % 8 == 0


def test_assemble_online_feats_refuses_an_overflow_like_jax():
    """Zipped candidate texts that overflow a sentence raise in both."""
    cfg = _online_cfgs(True, "linear")
    long = ["alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu nu"] * 8
    vocab = jwp.build_tiny_vocab(long + ["x"])
    for mod, wp in ((tonline, twp), (jonline, jwp)):
        with pytest.raises(ValueError, match="overflow"):
            mod.assemble_online_feats(cfg, wp.BertTokenizer(vocab=vocab, model_max_length=32),
                                      ["x"], [(0, 1)], [long])


@pytest.fixture(scope="module")
def text_online(tmp_path_factory):
    """A tiny zipped online model with a vocabulary file written from the
    request strings: (cfg, bert_cfg, flax module, params, strings)."""
    import jax

    from drin_tpu.encoders.bert import BertConfig as JaxBertConfig
    from drin_tpu.models.ghmfc import GHMFCOnline as JaxGHMFCOnline
    from drin_tpu_torch.encoders.bert import BertConfig
    from tests.test_torch_ghmfc import BERT_DIMS

    sentences, spans, cands = _texts(5, 3, 8)
    vocab = jwp.build_tiny_vocab(sentences + [c for row in cands for c in row])
    assert len(vocab) < BERT_DIMS["vocab_size"]
    path = tmp_path_factory.mktemp("torch-text") / "vocab.txt"
    inv = {i: w for w, i in vocab.items()}
    path.write_text("".join(inv[i] + "\n" for i in range(len(inv))), encoding="utf-8")
    cfg = _online_cfgs(True, "linear").replace(bert_vocab=str(path))
    tok = jwp.BertTokenizer(vocab_file=str(path), model_max_length=cfg.max_bert_len)
    feats = jonline.assemble_online_feats(cfg, tok, sentences, spans, cands)
    jmodel = JaxGHMFCOnline(cfg, JaxBertConfig(**BERT_DIMS))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(3), feats)["params"])
    return cfg, BertConfig(**BERT_DIMS), jmodel, params, (sentences, spans, cands)


def test_rank_text_matches_jax_ranker(text_online):
    from drin_tpu.serve import Ranker as JaxRanker
    from drin_tpu_torch.models.convert import ghmfc_online_state_dict_from_jax
    from drin_tpu_torch.serve import Ranker

    cfg, bert_cfg, jmodel, params, (sentences, spans, cands) = text_online
    jr = JaxRanker(cfg, params=params, model=jmodel)
    tr = Ranker(cfg, ghmfc_online_state_dict_from_jax(params, cfg, bert_cfg), device="cpu",
                bert_cfg=bert_cfg)
    js, ji = jr.rank_text(sentences, spans, cands, k=3)
    ts, ti = tr.rank_text(sentences, spans, cands, k=3)
    np.testing.assert_allclose(ts, js, **F32)
    np.testing.assert_array_equal(ti, ji)
    # the scores are those of rank on the assembled request
    feats = tonline.assemble_online_feats(cfg, tr._ensure_tokenizer(), sentences, spans, cands)
    np.testing.assert_array_equal(tr.rank(feats, k=3)[0], ts)
    # short candidate lists pad with empty strings, long ones are cut to C
    short = [row[:2] for row in cands]
    longer = [row + ["alpha beta"] * 3 for row in cands]
    for rows in (short, longer):
        np.testing.assert_allclose(tr.rank_text(sentences, spans, rows, k=2)[0],
                                   jr.rank_text(sentences, spans, rows, k=2)[0], **F32)
    with pytest.raises(ValueError, match="k must be"):
        tr.rank_text(sentences, spans, cands, k=99)
