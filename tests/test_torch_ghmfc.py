# -*- coding: utf-8 -*-
"""The port's GHMFC models against ``drin_tpu.models.ghmfc`` with the same
weights (through the converters) and the same numpy inputs, float32 at rtol
2e-4 (the same math in another association order); the numpy request
packers (``zip_entities``, ``bucket_trim``) bit for bit."""

import jax
import numpy as np
import pytest
import torch

from drin_tpu.data import online as jonline
from drin_tpu.data.synthetic import tiny_config
from drin_tpu.encoders.bert import BertConfig as JaxBertConfig
from drin_tpu.models.ghmfc import GHMFC as JaxGHMFC, GHMFCOnline as JaxGHMFCOnline
from drin_tpu.models.torch_import import ghmfc_params_from_torch
from drin_tpu.ops.core import unzip_entities as jax_unzip
from drin_tpu_torch.data import online as tonline
from drin_tpu_torch.encoders.bert import BertConfig
from drin_tpu_torch.models import get_model
from drin_tpu_torch.models.convert import (ghmfc_online_state_dict_from_jax,
                                           ghmfc_state_dict_from_jax)
from drin_tpu_torch.models.ghmfc import GHMFC, GHMFCOnline
from drin_tpu_torch.ops.core import unzip_entities

F32 = dict(rtol=2e-4, atol=1e-5)
BERT_DIMS = dict(vocab_size=97, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=32, max_position_embeddings=32)
CLS, SEP = 101 % 97, 102 % 97


def online_cfg(zipped=True, **kw):
    """Tiny online-BERT GHMFC config: C=8 candidates in S=3 zipped sentences
    of 32 tokens, or per candidate in 12 tokens."""
    base = dict(online_bert=True, finetune_bert=False, max_bert_len=32,
                num_entity_sentence=3 if zipped else 0, max_entity_attr_token_len=12)
    base.update(kw)
    return tiny_config("wikimel", "ghmfc", preprocess_dir="unused-online", **base).replace(
        compute_dtype="float32")


def online_batch(cfg, B, seed, packer=tonline):
    """Numpy ``OnlineBatch`` features (answer stripped), zipped or direct."""
    rng = np.random.default_rng(seed)
    V, C, Lb = BERT_DIMS["vocab_size"], cfg.num_candidates_model, cfg.max_bert_len
    Lm = cfg.max_mention_sentence_len + 4  # longer than the clip the model applies
    ids = np.zeros((B, Lm), np.int64)
    mask = np.zeros((B, Lm), np.int64)
    for b in range(B):
        n = rng.integers(6, Lm + 1)
        ids[b, :n] = rng.integers(3, V, n)
        mask[b, :n] = 1
    begin = rng.integers(1, 4, B).astype(np.int64)
    end = begin + rng.integers(1, 3, B)
    image = rng.standard_normal((B, cfg.resnet_num_region, cfg.resnet_embed_dim)).astype(np.float32)
    texts = [[[CLS] + list(rng.integers(3, V, rng.integers(1, 6))) + [SEP] for _ in range(C)]
             for _ in range(B)]
    if cfg.num_entity_sentence:
        packed = [packer.zip_entities(t, cfg.num_entity_sentence, Lb, CLS) for t in texts]
        eids, emask, sep = (np.stack(x) for x in zip(*packed))
    else:
        Le = cfg.max_entity_attr_token_len
        eids = np.zeros((B, C, Le), np.int64)
        emask = np.zeros((B, C, Le), np.int64)
        for b in range(B):
            for c, t in enumerate(texts[b]):
                eids[b, c, :len(t)], emask[b, c, :len(t)] = t, 1
        sep = np.zeros((B,), np.int64)
    return (ids, mask, begin, end, image, eids, emask, sep, np.zeros((B,), np.float32))


def jax_online(cfg, batch):
    """(flax module, params as numpy) for the tiny online model."""
    model = JaxGHMFCOnline(cfg, JaxBertConfig(**BERT_DIMS))
    params = model.init(jax.random.key(1), batch)["params"]
    return model, jax.tree.map(np.asarray, params)


def _tensors(batch):
    return tuple(torch.from_numpy(np.asarray(x)) for x in batch)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pooling", ["avg", "max"])
def test_unzip_entities_matches_jax(pooling):
    rng = np.random.default_rng(0)
    B, S, L, D, E, C = 2, 3, 20, 8, 3, 8
    zipped = rng.standard_normal((B, S, L, D)).astype(np.float32)
    sep = np.sort(rng.integers(2, L, (B, S, E)), axis=-1)
    sep[0, 0] = [3, 3, 9]   # a zero-width span between equal seps
    sep[1, 2] = [5, 0, 0]   # padding seps: spans [6, 0) and [1, 0) are empty
    want = np.asarray(jax_unzip(zipped, sep, C, pooling))
    got = unzip_entities(torch.from_numpy(zipped), torch.from_numpy(sep), C, pooling).numpy()
    assert got.shape == (B, C, D)  # S * E = 9 cut to the 8 candidates
    np.testing.assert_allclose(got, want, **F32)
    assert not got[0, 1].any() and not got[1, 7].any()  # zero-width spans pool to 0


def _baseline_batch(cfg, B, seed, layout):
    rng = np.random.default_rng(seed)
    C, D, L = cfg.num_candidates_model, cfg.bert_embed_dim, cfg.max_mention_sentence_len
    lens = rng.integers(4, L + 1, B)
    begin = rng.integers(1, 3, B).astype(np.int64)
    feats = [rng.standard_normal((B, L, D)).astype(np.float32),
             (np.arange(L)[None] < lens[:, None]).astype(np.int64), begin, begin + 2,
             rng.standard_normal((B, cfg.resnet_num_region, cfg.resnet_embed_dim)).astype(np.float32)]
    if layout == "tokens":
        Le = cfg.max_entity_attr_token_len
        n = rng.integers(3, Le + 1, (B, C))
        feats += [rng.standard_normal((B, C, Le, D)).astype(np.float32),
                  (np.arange(Le)[None, None] < n[..., None]).astype(np.int64)]
    elif layout == "pooled":
        feats += [rng.standard_normal((B, C, 2, D)).astype(np.float32), np.zeros((B,), np.int64)]
    else:  # wikidiverse: mention-aligned pooled rows
        feats += [rng.standard_normal((B, C, D)).astype(np.float32), np.zeros((B,), np.int64)]
    return tuple(feats + [np.zeros((B,), np.float32)])


OFFLINE = {
    "wikimel-pooled-fusion": ("wikimel", "pooled", {}),
    "wikimel-tokens-max": ("wikimel", "tokens", {"entity_final_pooling": "max"}),
    "wikimel-tokens-avg-textonly": ("wikimel", "tokens", {"cache_entity_pooling": False,
                                                          "mention_multimodal_attention": "text"}),
    "wikidiverse-fusion": ("wikidiverse", "rows", {}),
    "wikidiverse-textonly-avg": ("wikidiverse", "rows", {"mention_multimodal_attention": "text",
                                                         "mention_final_representation": "avg"}),
    "wikidiverse-linear": ("wikidiverse", "rows", {"mention_final_layer_name": "linear"}),
    "wikimel-none-nolinear": ("wikimel", "pooled", {"mention_final_layer_name": "none",
                                                    "entity_final_layer_name": "none"}),
    "wikimel-transformer-avg": ("wikimel", "pooled", {"mention_final_layer_name": "transformer",
                                                      "mention_final_representation": "avg"}),
    "wikidiverse-transformer-maxpool": ("wikidiverse", "rows", {
        "mention_final_layer_name": "transformer", "mention_final_representation": "max pool",
        "transformer_num_layers": 3, "transformer_ffn_activation": "relu"}),
}


@pytest.mark.parametrize("name", list(OFFLINE))
def test_ghmfc_offline_matches_flax(name):
    ds, layout, kw = OFFLINE[name]
    cfg = tiny_config(ds, "ghmfc", preprocess_dir="unused-ghmfc", **kw).replace(
        compute_dtype="float32")
    batch = _baseline_batch(cfg, 3, 11, layout)
    jmodel = JaxGHMFC(cfg)
    # a model without any weight initialises to no "params" collection
    params = jax.tree.map(np.asarray,
                          dict(jmodel.init(jax.random.key(0), batch).get("params", {})))
    want = np.asarray(jmodel.apply({"params": params}, batch))
    model, kind = get_model(cfg)
    assert isinstance(model, GHMFC) and kind == "baseline"
    sd = ghmfc_state_dict_from_jax(params, cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    with torch.inference_mode():
        got = model.eval()(_tensors(batch)).numpy()
    assert got.shape == want.shape == (3, cfg.num_candidates_model)
    np.testing.assert_allclose(got, want, **F32)
    # the port's names are the upstream state_dict's: the JAX importer reads them back
    back = ghmfc_params_from_torch({k: v.numpy() for k, v in sd.items()}, cfg)
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(params), flat(back)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


ONLINE = {
    "zipped-avg": (True, {}),
    "zipped-max": (True, {"entity_final_pooling": "max"}),
    "direct-avg": (False, {}),
    "direct-max": (False, {"entity_final_pooling": "max"}),
    "direct-bert-default": (False, {"entity_final_pooling": "bert default"}),
    "zipped-avg-nolinear-textonly": (True, {"entity_final_layer_name": "none",
                                            "mention_multimodal_attention": "text"}),
}


@pytest.mark.parametrize("name", list(ONLINE))
def test_ghmfc_online_matches_flax(name):
    zipped, kw = ONLINE[name]
    cfg = online_cfg(zipped, **kw)
    batch = online_batch(cfg, 3, 5)
    jmodel, params = jax_online(cfg, batch)
    want = np.asarray(jmodel.apply({"params": params}, batch))
    bert_cfg = BertConfig(**BERT_DIMS)
    model, kind = get_model(cfg, bert_cfg=bert_cfg)
    assert isinstance(model, GHMFCOnline) and kind == "online"
    sd = ghmfc_online_state_dict_from_jax(params, cfg, bert_cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    with torch.inference_mode():
        got = model.eval()(_tensors(batch)).numpy()
    assert got.shape == want.shape == (3, cfg.num_candidates_model)
    np.testing.assert_allclose(got, want, **F32)


def test_online_zipped_bert_default_is_refused_by_both():
    cfg = online_cfg(True, entity_final_pooling="bert default")
    with pytest.raises(ValueError, match="bert default"):
        GHMFCOnline(cfg, BertConfig(**BERT_DIMS))
    batch = online_batch(cfg.replace(entity_final_pooling="avg"), 2, 0)
    with pytest.raises(ValueError, match="bert default"):  # traced only: nothing to run
        jax.eval_shape(JaxGHMFCOnline(cfg, JaxBertConfig(**BERT_DIMS)).init,
                       jax.random.key(0), batch)


def test_get_model_registry_and_what_is_not_ported():
    cfg = online_cfg()
    with torch.device("meta"):  # no weights made: bert-base width by default
        model, _ = get_model(cfg)
        pinned, _ = get_model(cfg.replace(bert_fused_attention=False))
    assert model.bert.cfg.hidden_size == 768 and model.bert.cfg.max_position_embeddings == 32
    # no device is named at build time: the tri-state stays on the module and
    # is settled by where each call's tensor lies, so a model moved to the
    # card cannot keep the CPU's written-out product there
    attention = model.bert.encoder.layer[0].attention.self
    assert attention.fused is None
    assert attention.takes_kernel(torch.device("cuda", 0), 512)
    assert not attention.takes_kernel(torch.device("cpu"), 512)
    assert not pinned.bert.encoder.layer[0].attention.self.takes_kernel(torch.device("cuda"), 512)
    # BERT's dims come from a named checkpoint (tests/test_torch_checkpoints.py):
    # one that is not there raises
    with pytest.raises(FileNotFoundError, match="some/dir"):
        get_model(cfg.replace(bert_checkpoint="some/dir"))
    # MELHI and the transformer mention layer are ported; MELHI keeps the
    # JAX package's WikiDiverse-only guard
    from drin_tpu_torch.models.melhi import MELHI
    from drin_tpu_torch.nn.layers import MultilayerTransformer

    assert isinstance(get_model(tiny_config("wikidiverse", "melhi", preprocess_dir="unused"))[0],
                      MELHI)
    with pytest.raises(NotImplementedError, match="only implemented for wikidiverse"):
        get_model(tiny_config("wikimel", "melhi", preprocess_dir="unused"))
    ghmfc, _ = get_model(tiny_config("wikimel", "ghmfc", preprocess_dir="unused",
                                     mention_final_layer_name="transformer"))
    assert isinstance(ghmfc.mention_encoder.intermediate_layer, MultilayerTransformer)
    with pytest.raises(ValueError, match="unknown model_type"):
        get_model(cfg.replace(model_type="nope"))


def test_frozen_bert_takes_no_gradient():
    cfg = online_cfg()
    model = GHMFCOnline(cfg, BertConfig(**BERT_DIMS), torch.Generator().manual_seed(0))
    model(_tensors(online_batch(cfg, 2, 1))).sum().backward()
    assert all(p.grad is None for p in model.bert.parameters())
    assert model.entity_final_layer.weight.grad is not None


# ---------------------------------------------------------------------------
# numpy request packers, bit for bit


@pytest.mark.parametrize("n_texts,S,max_len", [(8, 3, 32), (9, 3, 40), (5, 2, 64), (4, 4, 16)])
def test_zip_entities_equals_jax(n_texts, S, max_len):
    rng = np.random.default_rng(n_texts)
    texts = [[CLS] + list(rng.integers(3, 90, rng.integers(1, 6))) + [SEP] for _ in range(n_texts)]
    got = tonline.zip_entities(texts, S, max_len, CLS)
    want = jonline.zip_entities(texts, S, max_len, CLS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[1][:, 0].all()  # position 0 (CLS) is always kept


def test_zip_entities_overflow_raises_like_jax():
    texts = [[CLS] + [5] * 10 + [SEP] for _ in range(4)]
    for mod in (tonline, jonline):
        with pytest.raises(ValueError, match="overflow max_bert_len=16"):
            mod.zip_entities(texts, 2, 16, CLS)


@pytest.mark.parametrize("bucket,floor,used", [(0, 1, None), (8, 1, None), (128, 1, None),
                                               (8, 24, None), (8, 1, 30), (16, 1, 0)])
def test_bucket_trim_equals_jax(bucket, floor, used):
    rng = np.random.default_rng(3)
    lens = rng.integers(1, 20, (2, 3))
    mask = (np.arange(40)[None, None] < lens[..., None]).astype(np.int64)
    ids = rng.integers(1, 90, (2, 3, 40)) * mask
    got = tonline.bucket_trim(ids, mask, bucket, floor, used)
    want = jonline.bucket_trim(ids, mask, bucket, floor, used)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_online_batch_fields_equal_jax():
    assert tonline.OnlineBatch._fields == jonline.OnlineBatch._fields
