# -*- coding: utf-8 -*-
"""The port's preprocessing pipeline against ``drin_tpu.preprocess``.

Both packages' CLIs (``python -m drin_tpu.preprocess all`` and ``python -m
drin_tpu_torch.preprocess all ... device=cpu``, called through ``main``)
run on the same tiny raw corpora (WikiDiverse and WikiMEL, images
included) with the same seeded checkpoints (BERT, ResNet and CLIP written
as HF-style directories, a WordPiece vocabulary, a CLIP BPE vocabulary and
merges): every file name, shape and dtype is equal, masks, ints, strings
and JSON exactly, floats at rtol 2e-4.  The WikiMEL corpus holds an
abstract long enough for a BERT bucket of 256 (the port's plain attention
on the CPU, JAX's XLA path).  The port's ``create_datasets`` reads the
result.  Also the host pieces on their own (``NpyWriter`` bytes, image
loading and preprocessing, ``run_prepare``) and the edge paths: imported
object arrays and their refusals, the stub detector's warning, the Faster
R-CNN detector from a written torchvision checkpoint (the detector itself,
``TorchDetector``, the ResNet stage with it and the CLI at TINY widths,
against the JAX package's), a detector checkpoint refused by name,
resumable CLIP, the entity text types, the
CLI's validation and ``device=cuda`` without CUDA, and each stage's encoder
held to full float32 whatever the caller's TF32 flags."""

import filecmp
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from drin_tpu.common import npy_io as jnpy
from drin_tpu.common.config import make_config as jmake_config
from drin_tpu.encoders import bert as jbert
from drin_tpu.encoders import clip as jclip
from drin_tpu.encoders import resnet as jresnet
from drin_tpu.preprocess import __main__ as jcli
from drin_tpu.preprocess import detector as jdetector
from drin_tpu.preprocess import images as jimages
from drin_tpu.preprocess import prepare as jprepare
from drin_tpu.preprocess import stages as jstages
from drin_tpu.text.clip_bpe import bytes_to_unicode
from drin_tpu.text.wordpiece import build_tiny_vocab
from drin_tpu_torch.common import npy_io as tnpy
from drin_tpu_torch.common.config import make_config
from drin_tpu_torch.models.convert import (bert_state_dict_from_jax, clip_state_dict_from_jax,
                                           resnet_state_dict_from_jax)
from drin_tpu_torch.preprocess import __main__ as tcli
from drin_tpu_torch.preprocess import detector as tdetector
from drin_tpu_torch.preprocess import images as timages
from drin_tpu_torch.preprocess import prepare as tprepare
from drin_tpu_torch.preprocess import stages as tstages
from test_preprocess import wd_raw  # noqa: F401  (the JAX suite's WikiDiverse raw corpus)
from test_frcnn import TINY as JTINY, _fabricate_torchvision_sd
from test_torch_encoders import _randomized

F32 = dict(rtol=2e-4, atol=1e-5)  # the parity tests' convention (test_torch_checkpoints)
SPLITS = ("train", "valid", "test")
LONG_ABSTRACT = " ".join(["the museum holds paintings sculptures and manuscripts"] * 24)


def _write_image(path, rng, size, format=None):
    Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)).save(
        path, format=format)


# ---------------------------------------------------------------------------
# raw corpora and checkpoints


@pytest.fixture(scope="module")
def wm_raw(tmp_path_factory):
    """A WikiMEL raw corpus: mentions per split (one whose surface is not in
    its sentence, dropped by prepare), a candidates TSV, qid2ne / qid2abs
    (one abstract of ~170 words: a BERT bucket of 256), mention and entity
    images of several non-square sizes, one too small and some missing (the
    default image stands in)."""
    rng = np.random.default_rng(17)
    root = tmp_path_factory.mktemp("wm-raw")
    (root / "mimg").mkdir()
    (root / "eimg").mkdir()
    qids = [f"Q{i}" for i in range(8)]
    (root / "qid2ne.json").write_text(json.dumps({q: f"name {q}" for q in qids}))
    abstracts = {q: f"attribute text for {q}. more about it" for q in qids}
    abstracts["Q5"] = LONG_ABSTRACT + ". The end"
    (root / "qid2abs.json").write_text(json.dumps(abstracts))
    mentions = {
        "m1-x": {"sentence": "Alpha beta gamma delta", "mentions": "beta", "answer": "Q1"},
        "m2-x": {"sentence": "Epsilon zeta eta theta iota", "mentions": "zeta", "answer": "Q7"},
        "m3-x": {"sentence": "No mention here at all", "mentions": "zzz", "answer": "Q0"},
        "m4-x": {"sentence": "Kappa lambda mu", "mentions": "mu", "answer": "Q5"},
    }
    for split in SPLITS:
        (root / f"WIKIMEL_{split}.json").write_text(json.dumps(mentions))
    (root / "cands.tsv").write_text("m1-x\tQ0\tQ1\nm2-x\tQ2\tQ3\nm3-x\tQ4\tQ5\nm4-x\tQ5\tQ6")
    _write_image(root / "default.jpg", rng, (90, 70))
    for mid, size in (("m1", (120, 80)), ("m2", (64, 100)), ("m4", (30, 30))):
        _write_image(root / "mimg" / f"{mid}.jpg", rng, size)
    for i, q in enumerate(qids[:5]):
        _write_image(root / "eimg" / f"{q}.png", rng, (70 + 9 * i, 96 - 5 * i))
    texts = [m["sentence"] for m in mentions.values()] + list(abstracts.values()) + [
        f"name {q}" for q in qids] + [LONG_ABSTRACT.replace(".", ";")]
    return root, texts


def _save_checkpoint(d, sd, config):
    d.mkdir()
    torch.save(sd, d / "pytorch_model.bin")
    (d / "config.json").write_text(json.dumps(config))
    return str(d)


def _checkpoints(root, texts):
    """Seeded tiny BERT, ResNet and CLIP as HF-style directories (their flax
    params through the port's converters, which write HF's keys), the
    WordPiece vocabulary of ``texts`` and a byte-level CLIP vocabulary whose
    end token has the largest id."""
    d = root / "assets"
    if d.exists():
        return json.loads((d / "paths.json").read_text())
    d.mkdir()
    vocab = build_tiny_vocab(texts + [t.replace(".", ";") for t in texts])
    inv = sorted(vocab, key=vocab.get)
    (d / "vocab.txt").write_text("\n".join(inv) + "\n")

    bc = jbert.BertConfig(vocab_size=len(vocab), hidden_size=16, num_hidden_layers=1,
                          num_attention_heads=2, intermediate_size=32,
                          max_position_embeddings=512)
    ids = np.zeros((1, 8), np.int32)
    bp = _randomized(jax.jit(jbert.BertModel(bc).init)(jax.random.key(0), ids, ids + 1)["params"],
                     seed=1)
    bert = _save_checkpoint(d / "bert", bert_state_dict_from_jax(bp, bc), dict(
        model_type="bert", vocab_size=bc.vocab_size, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32, max_position_embeddings=512,
        type_vocab_size=2, layer_norm_eps=1e-12))

    rc = jresnet.ResNetConfig(embedding_size=8, hidden_sizes=(8, 12, 16, 24), depths=(1, 1, 1, 1))
    rp = jax.jit(jresnet.ResNetModel(rc).init)(jax.random.key(1), np.zeros((1, 64, 64, 3),
                                                                          np.float32))["params"]
    resnet = _save_checkpoint(d / "resnet", resnet_state_dict_from_jax(_randomized(rp, 2), rc), dict(
        embedding_size=8, hidden_sizes=[8, 12, 16, 24], depths=[1, 1, 1, 1],
        downsample_in_first_stage=False, downsample_in_bottleneck=False))

    b2u = bytes_to_unicode()
    alphabet = sorted(set(b2u.values()))
    cvocab = {ch: i for i, ch in enumerate(alphabet)}
    cvocab.update({ch + "</w>": len(alphabet) + i for i, ch in enumerate(alphabet)})
    merges = [("t", "h"), ("th", "e</w>"), ("a", "l"), ("n", "a")]
    for a, b in merges:
        cvocab.setdefault(a + b, len(cvocab))
    cvocab["<|startoftext|>"] = len(cvocab)
    cvocab["<|endoftext|>"] = len(cvocab)
    (d / "clip_vocab.json").write_text(json.dumps(cvocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    cc = jclip.CLIPConfig(
        text=jclip.CLIPTextConfig(vocab_size=len(cvocab), hidden_size=16, num_layers=1,
                                  num_heads=2, intermediate_size=32, max_position_embeddings=77),
        vision=jclip.CLIPVisionConfig(hidden_size=16, num_layers=1, num_heads=2,
                                      intermediate_size=32, image_size=32, patch_size=8),
        projection_dim=12)
    cp = jax.jit(jclip.CLIPModel(cc).init)(jax.random.key(2), np.zeros((1, 8), np.int32),
                                           np.zeros((1, 32, 32, 3), np.float32))["params"]
    t, v = cc.text, cc.vision
    clip = _save_checkpoint(d / "clip", clip_state_dict_from_jax(_randomized(cp, 3), cc), dict(
        text_config=dict(vocab_size=t.vocab_size, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=32, max_position_embeddings=77),
        vision_config=dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=32, image_size=32, patch_size=8),
        projection_dim=12))
    paths = dict(bert_checkpoint=bert, bert_vocab=str(d / "vocab.txt"), resnet_checkpoint=resnet,
                 clip_checkpoint=clip, clip_vocab=str(d / "clip_vocab.json"),
                 clip_merges=str(d / "merges.txt"))
    (d / "paths.json").write_text(json.dumps(paths))
    return paths


TINY = dict(bert_embed_dim=16, resnet_embed_dim=24, gcn_embed_dim=16,
            mention_final_output_dim=16, entity_final_output_dim=16,
            image_input_size=(64, 64), resnet_num_region=4, max_entity_attr_token_len=8,
            max_mention_sentence_len=12, image_decode_workers=2, preprocess_data_parallel=False,
            batch_size=2, metrics_topk=(1,))


def _wd_args(root, n_cand):
    return dict(dataset_name="wikidiverse", num_candidates_data=n_cand,
                preprocess_batch_size=8, max_entity_attr_char_len=64,
                mention_text_path=str(root / "%s_cands.json"),
                entity2brief_path=str(root / "brief_%s.json"),
                entity2image_path=str(root / "entity2imgs.tsv"),
                image_dir=str(root / "images"), default_image=str(root / "default.jpg"))


def _wm_args(root):
    return dict(dataset_name="wikimel", num_candidates_data=2, preprocess_batch_size=4,
                mention_text_path=str(root / "WIKIMEL_%s.json"),
                candidate_path=str(root / "cands.tsv"),
                qid2entity_path=str(root / "qid2ne.json"), qid2attr_path=str(root / "qid2abs.json"),
                mention_image_dir=str(root / "mimg"), entity_image_dir=str(root / "eimg"),
                default_image=str(root / "default.jpg"))


def _argv(kw):
    return [f"{k}={v}" for k, v in kw.items()]


def _run_both(tmp, kw):
    """Both packages' CLIs, ``all`` stages, into two stores; returns them."""
    jdir, tdir = str(tmp / "jax-store"), str(tmp / "port-store")
    jcli.main(["all"] + _argv(dict(kw, preprocess_dir=jdir)))
    ran = tcli.main(["all"] + _argv(dict(kw, preprocess_dir=tdir)) + ["device=cpu"])
    assert sorted(ran) == ["bert", "clip", "resnet"]
    return jdir, tdir


@pytest.fixture(scope="module")
def wd_stores(wd_raw, tmp_path_factory):  # noqa: F811
    root, sentences, names, n_cand = wd_raw
    tmp = tmp_path_factory.mktemp("wd-stores")
    texts = sentences + [f"{n}: a thing called {n.lower()} with properties" for n in names]
    kw = dict(TINY, **_wd_args(root, n_cand), **_checkpoints(root, texts))
    return (kw,) + _run_both(tmp, kw)


@pytest.fixture(scope="module")
def wm_stores(wm_raw, tmp_path_factory):
    root, texts = wm_raw
    tmp = tmp_path_factory.mktemp("wm-stores")
    kw = dict(TINY, **_wm_args(root), **_checkpoints(root, texts))
    return (kw,) + _run_both(tmp, kw)


def _same_store(jdir, tdir):
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for name in names:
        a, b = os.path.join(jdir, name), os.path.join(tdir, name)
        if name.endswith(".json"):
            assert json.loads(open(a).read()) == json.loads(open(b).read()), name
            continue
        want, got = np.load(a), np.load(b)
        assert (got.shape, got.dtype) == (want.shape, want.dtype), name
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, err_msg=name, **F32)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    return names


def test_pipeline_wikidiverse_equals_jax(wd_stores):
    kw, jdir, tdir = wd_stores
    names = _same_store(jdir, tdir)
    for field in ("mention-text-feature", "mention-text-mask", "entity-attr-feature",
                  "mention-image-feature", "entity-image-feature", "mention-object-feature",
                  "mention-object-score", "entity-object-feature", "entity-object-score",
                  "similarity-miet", "similarity-eimt", "answer", "start-pos"):
        assert all(f"{field}_{s}.npy" in names for s in SPLITS), field


def test_pipeline_wikimel_equals_jax(wm_stores):
    kw, jdir, tdir = wm_stores
    names = _same_store(jdir, tdir)
    assert {"entity-attr-feature.npy", "entity-attr-mask.npy", "qid2idx.json",
            "entity-image-feature_all.npy", "entity-object-feature_all.npy"} <= set(names)
    # the long abstract's chunk ran at a bucket of 256 (the plain attention here)
    cfg = make_config("drin", **dict(kw, preprocess_dir=tdir))
    stage = tstages.BertStage(cfg, device="cpu")
    texts, _ = tstages.wikimel_entity_texts(cfg)
    enc = stage.tokenizer(texts[4:8], padding=True, truncation=True, max_length=cfg.max_bert_len)
    ids, mask = stage.bucket(enc["input_ids"], enc["attention_mask"])
    assert ids.shape[1] == 256 and mask[1].sum() > 128
    assert stage.model.encoder.layer[0].attention.self.takes_kernel("cpu", 256) is False


@pytest.mark.parametrize("dataset", ["wikidiverse", "wikimel"])
def test_port_datasets_read_the_store(dataset, wd_stores, wm_stores):
    from drin_tpu_torch.data.dataset import create_datasets

    kw, _, tdir = wd_stores if dataset == "wikidiverse" else wm_stores
    cfg = make_config("drin", **dict(kw, preprocess_dir=tdir))
    train, valid, test = create_datasets(cfg)
    batch = next(test.batches(2, kind="drin"))
    C = cfg.num_candidates_model
    assert batch.mention_text_feature.shape == (2, cfg.max_mention_sentence_len, 16)
    assert batch.miet_similarity.shape == (2, C)
    assert np.isfinite(batch.mention_text_feature).all()


# ---------------------------------------------------------------------------
# host pieces


def test_npy_writer_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    items = rng.standard_normal((6, 2, 3)).astype(np.float32)
    for mod, tag in ((jnpy, "jax"), (tnpy, "port")):
        with mod.NpyWriter(str(tmp_path / f"{tag}-plain.npy")) as w:
            w.extend(items)
        w = mod.NpyWriter(str(tmp_path / f"{tag}-reshaped.npy"))
        w.extend(items.astype(np.int64))
        w.reshape([-1, 3, *w.shape])
        w.close()
        mod.NpyWriter(str(tmp_path / f"{tag}-empty.npy")).close()
        with pytest.raises(RuntimeError):  # closed on error: a loadable partial file
            with mod.NpyWriter(str(tmp_path / f"{tag}-error.npy")) as w:
                w.append(items[0])
                raise RuntimeError("stage failed")
        w = mod.NpyWriter(str(tmp_path / f"{tag}-bad.npy"))
        w.append(items[0])
        with pytest.raises(ValueError, match="item shape"):
            w.append(items[0, :1])
        with pytest.raises(ValueError, match="cannot infer"):
            w.reshape([-1, 4])
        with pytest.raises(TypeError, match="numeric"):
            w.append(np.asarray(["a"]))
        w.close()
    for tag in ("plain", "reshaped", "empty", "error", "bad"):
        assert filecmp.cmp(tmp_path / f"jax-{tag}.npy", tmp_path / f"port-{tag}.npy",
                           shallow=False), tag
    np.testing.assert_array_equal(np.load(tmp_path / "port-plain.npy"), items)
    assert np.load(tmp_path / "port-reshaped.npy").shape == (2, 3, 2, 3)
    np.testing.assert_array_equal(np.load(tmp_path / "port-error.npy"), items[:1])


@pytest.mark.parametrize("size", [(300, 200), (200, 301), (333, 251), (225, 224), (97, 410)])
def test_image_preprocessing_bit_equal_to_jax(size):
    img = Image.fromarray(np.random.default_rng(size[0]).integers(
        0, 255, (size[1], size[0], 3), dtype=np.uint8))
    for kw in (dict(crop_pct=0.875, resample="bilinear"), dict(crop_pct=0.875, resample="bicubic"),
               dict(crop_pct=0.0)):
        got = timages.resnet_preprocess(img, (224, 224), **kw)
        assert got.dtype == np.float32 and got.shape == (224, 224, 3)
        np.testing.assert_array_equal(got, jimages.resnet_preprocess(img, (224, 224), **kw))
    for s in (224, 32):
        got = timages.clip_preprocess(img, s)
        assert got.shape == (s, s, 3)
        np.testing.assert_array_equal(got, jimages.clip_preprocess(img, s))


def test_load_image_and_batcher_equal_jax(tmp_path):
    """Suffix probing in the reference's order, a too-small or corrupt file
    and a missing one give the default; chunked decode with crops."""
    rng = np.random.default_rng(3)
    _write_image(tmp_path / "default.jpg", rng, (60, 64))
    _write_image(tmp_path / "a.png", rng, (80, 70))
    _write_image(tmp_path / "a.jpeg", rng, (70, 80))  # .jpeg comes before .png
    _write_image(tmp_path / "small.jpg", rng, (40, 90))
    (tmp_path / "corrupt.jpg").write_bytes(b"not an image")
    _write_image(tmp_path / "b", rng, (120, 55), "PNG")  # no suffix: found first
    default = str(tmp_path / "default.jpg")
    size = lambda p: timages.load_image(str(tmp_path / p), default).size
    assert size("a") == (70, 80) and size("b") == (120, 55)
    for name in ("small", "corrupt", "missing"):
        assert size(name) == (60, 64), name
    for name in ("a", "b", "small", "corrupt", "missing"):
        np.testing.assert_array_equal(
            np.asarray(timages.load_image(str(tmp_path / name), default)),
            np.asarray(jimages.load_image(str(tmp_path / name), default)))
    paths = [str(tmp_path / n) for n in ("a", "b", "small", "corrupt", "missing")] * 2
    crops = [(0, 0, 30, 20), (0, 0, 0, 0)] * 5
    pre = lambda im: timages.clip_preprocess(im, 32)
    ours = timages.ImageBatcher(default, (50, 50), workers=2)
    theirs = jimages.ImageBatcher(default, (50, 50), workers=2)
    try:
        got = ours.load_batch_chunked(paths, pre, crops, chunk=3)
        np.testing.assert_array_equal(got, theirs.load_batch(paths, pre, crops))
        np.testing.assert_array_equal(got, ours.load_batch(paths, pre, crops))
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("dataset", ["wikidiverse", "wikimel"])
def test_run_prepare_equals_jax(dataset, wd_raw, wm_raw, tmp_path):  # noqa: F811
    if dataset == "wikidiverse":
        root, sentences, names, n_cand = wd_raw
        kw = dict(_wd_args(root, n_cand), **_checkpoints(
            root, sentences + [f"{n}: a thing called {n.lower()} with properties" for n in names]))
    else:
        root, texts = wm_raw
        kw = dict(_wm_args(root), **_checkpoints(root, texts))
    kw.pop("dataset_name")
    outs = {}
    for tag, mod, mk in (("jax", jprepare, jmake_config), ("port", tprepare, make_config)):
        cfg = mk("drin", dataset, **dict(kw, preprocess_dir=str(tmp_path / tag)))
        mod.run_prepare(cfg)
        outs[tag] = cfg.preprocess_dir
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"])) and len(names) >= 15
    for name in names:
        assert filecmp.cmp(os.path.join(outs["jax"], name), os.path.join(outs["port"], name),
                           shallow=False), name
    assert tprepare.wiki_title("http://x/wiki/New%20York") == "New York"
    assert tprepare.roster_with_answer(["a", "b"], "b", 3) == (["a", "b", "__nil__", "b"], 1)
    assert tprepare.brief_text("__nil__", {}, 9) == ("", False)
    assert tprepare.locate_mention("abc def", "zz") is None


# ---------------------------------------------------------------------------
# edge paths


def _cfg(kw, d, **extra):
    return make_config("drin", **dict(kw, preprocess_dir=str(d), **extra))


def test_import_objects_copies_bytes(wd_stores, tmp_path):
    kw, _, src = wd_stores
    cfg = _cfg(kw, tmp_path / "dst", import_objects_from=src)
    tprepare.run_prepare(cfg)
    stage = tstages.ResnetStage(cfg, device="cpu")
    assert stage.detector is None  # never built: no stub warning for an unused detector
    stage.run()
    for name in ("mention", "entity"):
        for split in SPLITS:
            for field in ("object-feature", "object-score"):
                f = f"{name}-{field}_{split}.npy"
                assert filecmp.cmp(os.path.join(src, f), os.path.join(cfg.preprocess_dir, f),
                                   shallow=False), f
            f = f"{name}-image-feature_{split}.npy"
            np.testing.assert_array_equal(np.load(os.path.join(cfg.preprocess_dir, f)),
                                          np.load(os.path.join(src, f)))


def _bad_source(src, dst, fault):
    os.makedirs(dst)
    for f in os.listdir(src):
        if "-object-" in f:
            a = np.load(os.path.join(src, f))
            if fault == "rows":
                a = a[:-1]
            elif fault == "score shape" and "score" in f:
                a = np.concatenate([a, a], 1)
            elif fault == "feature shape" and "feature" in f:
                a = a[..., :-1]
            np.save(os.path.join(dst, f), a)


@pytest.mark.parametrize("fault,error,match", [
    ("missing", FileNotFoundError, "import_objects_from"),
    ("rows", ValueError, "rows"),
    ("score shape", ValueError, "object_topk"),
    ("feature shape", ValueError, "resnet_embed_dim")])
def test_import_objects_refusals(wd_stores, tmp_path, fault, error, match):
    kw, _, src = wd_stores
    bad = tmp_path / "bad-src"
    if fault == "missing":
        bad.mkdir()
    else:
        _bad_source(src, str(bad), fault)
    cfg = _cfg(kw, tmp_path / "dst", import_objects_from=str(bad))
    tprepare.run_prepare(cfg)
    with pytest.raises(error, match=match):
        tstages.ResnetStage(cfg, device="cpu").run(splits=("train",))


def test_stub_detector_warns_and_matches_jax(wd_stores, capsys):
    kw, _, _ = wd_stores
    cfg = make_config("drin", **kw)
    with pytest.warns(UserWarning, match="WholeImageDetector"):
        det = tdetector.make_detector(cfg)
    err = capsys.readouterr().err
    assert "WARNING: detector_checkpoint is unset" in err and "Faster R-CNN" in err
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = jdetector.make_detector(cfg)
    images = np.zeros((3, 64, 64, 3), np.float32)
    for k in (1, 3):
        for a, b in zip(det(images, k), theirs(images, k)):
            np.testing.assert_array_equal(a, b)


def test_detector_checkpoint_refused_by_name(wd_stores, tmp_path):
    """A detector checkpoint that is missing, or that is not the
    architecture ``drin_object_detector`` names, is refused naming it, by
    ``make_detector`` and by the stage that builds one."""
    kw, _, _ = wd_stores
    cfg = make_config("drin", **dict(kw, detector_checkpoint=str(tmp_path / "frcnn.pt")))
    with pytest.raises(FileNotFoundError, match="frcnn.pt"):
        tdetector.make_detector(cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match="frcnn.pt"):
        tstages.ResnetStage(cfg, device="cpu")
    path = _detector_checkpoint(tmp_path)
    cfg = make_config("drin", **dict(kw, detector_checkpoint=path,
                                     drin_object_detector="mask_rcnn"))
    with pytest.raises(ValueError, match="mask_rcnn.*no roi_heads.mask"):
        tdetector.make_detector(cfg, device="cpu")


def _detector_checkpoint(d, name="frcnn.pt"):
    """The JAX suite's fabricated torchvision Faster R-CNN state dict at its
    TINY widths (the 0.13 key layout), saved as a file."""
    path = d / name
    if not path.exists():
        sd = _fabricate_torchvision_sd(JTINY, new_style=True)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


def _port_tiny():
    from drin_tpu_torch.encoders.frcnn import FRCNNConfig

    return FRCNNConfig(**{k: getattr(JTINY, k) for k in (
        "depths", "stem_width", "fpn_channels", "anchor_sizes", "pre_nms_topk",
        "post_nms_topk", "detections_per_img", "num_classes", "representation_size",
        "min_size")})


def test_make_detector_builds_the_port_frcnn(wd_stores, tmp_path):
    """With a checkpoint, ``make_detector`` builds ``FRCNNDetector`` on the
    stage's device, with no stub warning; its boxes and scores equal the JAX
    package's ``FRCNNDetector`` on the same images (k under and over the
    detections kept, so the default_box / 0 padding is held too)."""
    kw, _, _ = wd_stores
    kw = dict(kw, detector_checkpoint=_detector_checkpoint(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no stub warning
        det = tdetector.make_detector(make_config("drin", **kw), frcnn_cfg=_port_tiny(),
                                      device="cpu")
    assert isinstance(det, tdetector.FRCNNDetector) and det.device.type == "cpu"
    theirs = jdetector.make_detector(jmake_config("drin", **kw), frcnn_cfg=JTINY)
    # 11 images: two forwards (8 + 3) through the port's detector
    images = np.random.default_rng(8).uniform(0, 1, (11, 48, 40, 3)).astype(np.float32)
    for k in (2, JTINY.detections_per_img + 2):
        (b, s), (jb, js) = det(images, k), theirs(images, k)
        assert (s > 0).any()
        if k > JTINY.detections_per_img:
            assert (s[:, -1] == 0).all() and (b[:, -1] == det.cfg.default_box).all()
        np.testing.assert_allclose(s, js, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(b, jb, rtol=1e-3, atol=1e-3)


def test_torch_detector_matches_jax_detector(wd_stores):
    """``TorchDetector`` against ``JaxDetector`` over the same proposals:
    the score threshold, NMS and the top-k padding."""
    kw, _, _ = wd_stores
    rng = np.random.default_rng(9)
    xy = rng.uniform(0, 50, (3, 30, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (3, 30, 2))], -1).astype(np.float32)
    scores = rng.uniform(0, 0.3, (3, 30)).astype(np.float32)
    ours = tdetector.TorchDetector(make_config("drin", **kw),
                                   lambda im: (torch.from_numpy(boxes), torch.from_numpy(scores)))
    theirs = jdetector.JaxDetector(jmake_config("drin", **kw), lambda im: (boxes, scores))
    for k in (3, 40):
        for a, b in zip(ours(None, k), theirs(None, k)):
            np.testing.assert_array_equal(a, b)


def test_resnet_stage_with_the_detector_equals_jax(wd_stores, tmp_path):
    """Both packages' ResNet stages with ``make_detector(cfg, frcnn_cfg=TINY)``
    over one written checkpoint write the same store: the object scores hold
    detections, and the object features are the crops at those boxes."""
    kw, _, _ = wd_stores
    kw = dict(kw, detector_checkpoint=_detector_checkpoint(tmp_path))
    cfg, jcfg = _cfg(kw, tmp_path / "port"), jmake_config("drin", **dict(
        kw, preprocess_dir=str(tmp_path / "jax")))
    tprepare.run_prepare(cfg)
    jprepare.run_prepare(jcfg)
    tstages.ResnetStage(cfg, device="cpu", detector=tdetector.make_detector(
        cfg, frcnn_cfg=_port_tiny(), device="cpu")).run()
    jstages.ResnetStage(jcfg, detector=jdetector.make_detector(jcfg, frcnn_cfg=JTINY)).run()
    names = _same_store(jcfg.preprocess_dir, cfg.preprocess_dir)
    scores = np.load(os.path.join(cfg.preprocess_dir, "mention-object-score_test.npy"))
    assert "entity-object-feature_train.npy" in names and (scores > 0).all()


def test_resnet_cli_with_detector_checkpoint_equals_jax(wm_stores, tmp_path, monkeypatch):
    """``python -m drin_tpu_torch.preprocess resnet ... detector_checkpoint=``
    builds ``FRCNNDetector`` from the checkpoint and writes the object files
    the JAX package's stage writes with the same detector.  The CLI's
    detector is ``FRCNNConfig()``, as the JAX package's is, so a TINY file is
    refused by the CLI as it is; with ``make_detector`` handed TINY's widths
    the CLI runs at TINY."""
    kw, _, _ = wm_stores
    kw = dict(kw, detector_checkpoint=_detector_checkpoint(tmp_path))
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tcli.main(["prepare"] + _argv(dict(kw, preprocess_dir=str(tdir))))
    argv = ["resnet"] + _argv(dict(kw, preprocess_dir=str(tdir))) + ["device=cpu"]
    with pytest.raises(KeyError, match="layer1.1.conv1.weight"):
        tcli.main(argv)
    built, make = [], tdetector.make_detector

    def tiny_detector(cfg, frcnn_cfg=None, device="cuda"):
        assert frcnn_cfg is None and cfg.detector_checkpoint == kw["detector_checkpoint"]
        built.append(make(cfg, _port_tiny(), device))
        return built[-1]

    monkeypatch.setattr(tdetector, "make_detector", tiny_detector)
    ran = tcli.main(argv)
    assert [type(d) for d in built] == [tdetector.FRCNNDetector] and built[0].device.type == "cpu"
    assert ran["resnet"].clock.detected and ran["resnet"].clock.seconds["detector"] > 0
    jcfg = jmake_config("drin", **dict(kw, preprocess_dir=str(jdir)))
    jprepare.run_prepare(jcfg)
    jstages.ResnetStage(jcfg, detector=jdetector.make_detector(jcfg, frcnn_cfg=JTINY)).run()
    _same_store(str(jdir), str(tdir))
    scores = np.load(tdir / "entity-object-score_all.npy")
    assert (scores > 0).any()


@pytest.mark.parametrize("name", ["bert", "resnet", "clip"])
def test_stages_hold_their_encoders_to_full_float32(name, wm_stores, tmp_path):
    """Whatever the caller's TF32 settings (here both on: cuDNN's is on by
    PyTorch's default), every module call inside a stage's ``run`` sees both
    off, and the caller's values are back after it."""
    kw, _, src = wm_stores
    cfg = _cfg(kw, tmp_path / "store", import_objects_from=src)
    tprepare.run_prepare(cfg)
    stage = {"bert": tstages.BertStage, "resnet": tstages.ResnetStage,
             "clip": tstages.ClipStage}[name](cfg, device="cpu")
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    saved, seen = flags(), []
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    hook = torch.nn.modules.module.register_module_forward_hook(lambda m, a, o: seen.append(flags()))
    try:
        stage.run()
        after = flags()
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen and set(seen) == {(False, False)}, set(seen)
    assert after == (True, True)


def test_clip_stage_resumable(wd_stores, tmp_path):
    """An existing similarity file is kept; the missing ones are written,
    equal to a full run's."""
    kw, _, full = wd_stores
    cfg = _cfg(kw, tmp_path / "store")
    tprepare.run_prepare(cfg)
    sentinel = np.full((4, 4), 7.0, np.float32)
    np.save(os.path.join(cfg.preprocess_dir, "similarity-miet_train.npy"), sentinel)
    tstages.ClipStage(cfg, device="cpu").run()
    np.testing.assert_array_equal(
        np.load(os.path.join(cfg.preprocess_dir, "similarity-miet_train.npy")), sentinel)
    for f in ("similarity-eimt_train.npy", "similarity-miet_valid.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(cfg.preprocess_dir, f)),
                                      np.load(os.path.join(full, f)))


def test_entity_text_types(wd_stores, wm_stores, tmp_path):
    """WikiDiverse 'brief' encodes the prepared brief strings under the
    entity-brief-feature name; WikiMEL 'name' writes entity-name-* equal to
    JAX's; 'brief' on WikiMEL and an unknown type are refused."""
    from drin_tpu.preprocess.stages import BertStage as JaxBertStage

    kw, _, wd = wd_stores
    cfg = _cfg(kw, wd, entity_text_type="brief")
    tstages.BertStage(cfg, device="cpu").run(splits=("train",))
    np.testing.assert_array_equal(np.load(os.path.join(wd, "entity-brief-feature_train.npy")),
                                  np.load(os.path.join(wd, "entity-attr-feature_train.npy")))
    with pytest.raises(ValueError, match="brief"):
        tstages.BertStage(_cfg(kw, wd, entity_text_type="brief", dataset_name="wikimel"),
                          device="cpu").run(splits=())
    with pytest.raises(ValueError, match="entity_text_type='bogus'"):
        tstages.BertStage(_cfg(kw, wd, entity_text_type="bogus"), device="cpu").run(splits=())

    kw, jdir, tdir = wm_stores
    tcfg = _cfg(kw, tdir, entity_text_type="name")
    tstages.BertStage(tcfg, device="cpu").run(splits=())
    jcfg = jmake_config("drin", **dict(kw, preprocess_dir=jdir, entity_text_type="name"))
    JaxBertStage(jcfg).run(splits=())
    for f in ("entity-name-feature.npy", "entity-name-mask.npy", "qid2idx.json"):
        a, b = os.path.join(jdir, f), os.path.join(tdir, f)
        if f.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b))
        elif "mask" in f:
            np.testing.assert_array_equal(np.load(b), np.load(a))
        else:
            np.testing.assert_allclose(np.load(b), np.load(a), **F32)
    assert np.load(os.path.join(tdir, "entity-name-mask.npy")).sum() < np.load(
        os.path.join(tdir, "entity-attr-mask.npy")).sum()


def test_cli_validation_and_device(wd_stores, monkeypatch):
    with pytest.raises(SystemExit, match="unknown stage: bogus"):
        tcli.main(["bogus", "no_such_field=1"])  # the stage first, before the config
    with pytest.raises(SystemExit, match="python -m drin_tpu_torch.preprocess"):
        tcli.main([])
    with pytest.raises(Exception):
        tcli.main(["bert", "no_such_field=1"])
    kw, _, tdir = wd_stores
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["bert"] + _argv(dict(kw, preprocess_dir=tdir)))  # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstages.ResnetStage(make_config("drin", **kw), device="cuda")
    assert tcli.STAGES == jcli.STAGES
