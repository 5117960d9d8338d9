# -*- coding: utf-8 -*-
"""The port's rank stage as a whole, held against the JAX package's.

The port ``Ranker`` (int8 fused store, plain versions on the CPU) and the
JAX ``Ranker`` (int8 fused store, Pallas gather in interpret mode) serve the
same weights and tables; f32 scores agree at rtol 2e-4 (the repo's f32
convention: both sides run exact float32 math in different association
orders)."""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from drin_tpu.data.dataset import MELFeatureDataset, load_wikimel_entity_tables
from drin_tpu.data.synthetic import make_synthetic_store, tiny_config
from drin_tpu.models.drin import DRIN as JaxDRIN
from drin_tpu.serve import Ranker as JaxRanker
from drin_tpu_torch.models.convert import drin_state_dict_from_jax
from drin_tpu_torch.ops.cuda import gather as tgather
from drin_tpu_torch.serve import Ranker, _encode_arrays, main, rank_feat_fields, serve_http

F32_RTOL, F32_ATOL = 2e-4, 1e-6


@pytest.fixture(scope="module")
def wm128(tmp_path_factory):
    """128-lane-aligned feature dims (the fused layout's rule); everything
    else the tiny wikimel schema."""
    d = str(tmp_path_factory.mktemp("torch-serve-wm128"))
    cfg = tiny_config("wikimel", "drin", preprocess_dir=d, bert_embed_dim=128,
                      resnet_embed_dim=128, gcn_embed_dim=128, entity_final_output_dim=128,
                      mention_final_output_dim=128).replace(compute_dtype="float32")
    make_synthetic_store(cfg, n_mentions=8, n_entities=40, seed=13)
    tables = load_wikimel_entity_tables(cfg)
    ds = MELFeatureDataset(cfg, "train", tables)
    params = JaxDRIN(cfg).init(jax.random.key(0), ds.drin_batch(np.arange(2))[:-1])["params"]
    params = jax.tree.map(np.asarray, params)
    batch = ds.drin_rows_batch(np.arange(6))
    return cfg, tables, params, batch


def _rankers(wm128):
    cfg, tables, params, _ = wm128
    jr = JaxRanker(cfg, params=params, entity_tables=tables, quantize_store=True,
                   fused_gather=True)
    tr = Ranker(cfg, drin_state_dict_from_jax(params, cfg), tables, device="cpu",
                quantize_store=True, fused_gather=True)
    return jr, tr


def _assert_topk_equal_away_from_ties(scores, got_idx, want_idx, k, margin=1e-4):
    """Top-k indices agree wherever the k-th and (k+1)-th scores are apart."""
    srt = np.sort(scores, axis=-1)[:, ::-1]
    for b in range(scores.shape[0]):
        gaps = np.abs(np.diff(srt[b, : k + 1]))
        if gaps.min() > margin:
            assert list(got_idx[b]) == list(want_idx[b]), (b, got_idx[b], want_idx[b])


def test_port_ranker_matches_jax_ranker(wm128):
    cfg, tables, params, batch = wm128
    jr, tr = _rankers(wm128)
    assert tr.store.fused and tr.store.text is None
    np.testing.assert_array_equal(tr.store.packed.numpy(), np.asarray(jr.store.packed))
    want = jr.score(batch[:-1])
    got = tr.score(batch[:-1])
    assert got.shape == want.shape == (6, cfg.num_candidates_model)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
    js, ji = jr.rank(batch[:-1], k=3)
    ts, ti = tr.rank(batch[:-1], k=3)
    np.testing.assert_allclose(ts, js, rtol=F32_RTOL, atol=F32_ATOL)
    _assert_topk_equal_away_from_ties(want, ti, ji, 3)


def test_set_store_rebinds_tables(wm128):
    """set_store swaps the tables the ranker reads: a float store scores
    like the JAX float-store ranker."""
    from drin_tpu_torch.data.device_store import DeviceEntityStore

    cfg, tables, params, batch = wm128
    _, tr = _rankers(wm128)
    tr.set_store(DeviceEntityStore(cfg, tables, device="cpu", dtype=torch.float32), tables)
    assert not tr.store.quantized
    jr = JaxRanker(cfg, params=params, entity_tables=tables)
    np.testing.assert_allclose(tr.score(batch[:-1]), jr.score(batch[:-1]),
                               rtol=F32_RTOL, atol=F32_ATOL)
    tr.set_store(tr.store)  # no host tables: a later projection fails loudly
    with pytest.raises(AssertionError, match="needs entity tables"):
        tr.precompute_entity_projection()


def test_projection_keeps_fused_layout_and_scores(wm128):
    cfg, tables, params, batch = wm128
    jr, tr = _rankers(wm128)
    before = tr.score(batch[:-1])
    jr.precompute_entity_projection()
    tr.precompute_entity_projection()
    assert tr.cfg.entity_projected and tr.store.fused and tr.store.quantized
    np.testing.assert_allclose(tr.score(batch[:-1]), jr.score(batch[:-1]),
                               rtol=F32_RTOL, atol=F32_ATOL)
    # idempotent: a second call projects nothing twice
    packed = tr.store.packed
    tr.precompute_entity_projection()
    assert tr.store.packed is packed
    # projection is exact math: only the int8 rounding of the projected
    # table moves the scores (per-element error <= max|row| / 254)
    np.testing.assert_allclose(tr.score(batch[:-1]), before, atol=5e-2)


def test_http_rank_matches_ranker_and_rejects_malformed(wm128):
    cfg, tables, params, batch = wm128
    _, tr = _rankers(wm128)
    fields = rank_feat_fields(tr)
    assert fields == list(type(batch)._fields[:-1])
    server = serve_http(tr, port=0, feat_fields=fields)
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(body: bytes):
        req = urllib.request.Request(url + "/rank", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    def status(body: bytes) -> int:
        try:
            post(body)
        except urllib.error.HTTPError as e:
            assert "error" in json.loads(e.read())
            return e.code
        return 200

    try:
        with urllib.request.urlopen(url + "/health", timeout=10) as resp:
            assert json.loads(resp.read())["status"] == "ok"
        with urllib.request.urlopen(url + "/stats", timeout=10) as resp:
            assert json.loads(resp.read())["entity_rows"] == tr.store.n_rows
        feats = {n: np.asarray(v) for n, v in zip(fields, batch[:-1])}
        out = post(json.dumps({"features": _encode_arrays(feats), "k": 3}).encode())
        want_s, want_i = tr.rank(batch[:-1], k=3)
        np.testing.assert_array_equal(np.asarray(out["scores"]), want_s)
        np.testing.assert_array_equal(np.asarray(out["indices"]), want_i)
        # malformed payloads are the client's fault: 400, server stays up
        assert status(b'{"features": "!!!"}') == 400
        bad = dict(feats, entity_rows=feats["entity_rows"].astype(np.float32))
        assert status(json.dumps({"features": _encode_arrays(bad)}).encode()) == 400
        short = {k: v for k, v in feats.items() if k != "mtei_similarity"}
        assert status(json.dumps({"features": _encode_arrays(short)}).encode()) == 400
        assert status(json.dumps({"features": _encode_arrays(feats), "k": 99}).encode()) == 400
        # out-of-range rows degrade like jnp indexing (wrap once, clamp)
        oob = dict(feats, entity_rows=feats["entity_rows"] + 10 * tr.store.n_rows)
        got = post(json.dumps({"features": _encode_arrays(oob), "k": 3}).encode())
        clamp = dict(feats, entity_rows=np.full_like(feats["entity_rows"], tr.store.n_rows - 1))
        np.testing.assert_array_equal(
            np.asarray(got["scores"]),
            tr.rank(tuple(clamp[n] for n in fields), k=3)[0])
        with urllib.request.urlopen(url + "/health", timeout=10) as resp:
            assert resp.status == 200
    finally:
        server.shutdown()
        server.server_close()


def test_serve_main_checkpoint_mode_and_device_guard(wm128, tmp_path, monkeypatch):
    cfg, tables, params, batch = wm128
    torch.save(drin_state_dict_from_jax(params, cfg), tmp_path / "params.pt")
    common = ["model_type=drin", "dataset_name=wikimel", f"preprocess_dir={cfg.preprocess_dir}",
              f"checkpoint_dir={tmp_path}", "compute_dtype=float32", "port=0",
              "quantize_store=true", "fused_gather=true", "bert_embed_dim=128",
              "resnet_embed_dim=128", "gcn_embed_dim=128", "entity_final_output_dim=128",
              "mention_final_output_dim=128", f"num_candidates_data={cfg.num_candidates_data}",
              f"max_mention_sentence_len={cfg.max_mention_sentence_len}",
              f"max_entity_attr_token_len={cfg.max_entity_attr_token_len}",
              f"resnet_num_region={cfg.resnet_num_region}"]
    # device defaults to cuda and never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(common)
    with pytest.raises(SystemExit, match="not ported"):
        main(common + ["micro_batch=true", "device=cpu"])
    server = main(common + ["device=cpu"])
    try:
        fields = list(type(batch)._fields[:-1])
        body = json.dumps({"features": _encode_arrays(
            {n: np.asarray(v) for n, v in zip(fields, batch[:-1])}), "k": 2}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/rank",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        _, tr = _rankers(wm128)
        np.testing.assert_array_equal(np.asarray(out["scores"]), tr.rank(batch[:-1], k=2)[0])
    finally:
        server.shutdown()
        server.server_close()


def test_cpu_serving_never_launches_kernels(wm128):
    """On CPU tensors the wrappers take their plain versions: no launch."""
    cfg, tables, params, batch = wm128
    _, tr = _rankers(wm128)
    tgather.launches = 0
    tr.rank(batch[:-1], k=2)
    assert tgather.launches == 0


# ---------------------------------------------------------------------------
# GHMFC with online BERT behind the same entry points


@pytest.fixture(scope="module")
def online():
    """Tiny zipped online model: (cfg, port bert_cfg, flax module, params, batch)."""
    from drin_tpu_torch.encoders.bert import BertConfig
    from tests.test_torch_ghmfc import BERT_DIMS, jax_online, online_batch, online_cfg

    cfg = online_cfg(zipped=True)
    batch = online_batch(cfg, 3, 9)  # the shapes of test_torch_ghmfc: its compiles are reused
    jmodel, params = jax_online(cfg, batch)
    return cfg, BertConfig(**BERT_DIMS), jmodel, params, batch


def _online_ranker(online, **kw):
    from drin_tpu_torch.models.convert import ghmfc_online_state_dict_from_jax

    cfg, bert_cfg, _, params, _ = online
    return Ranker(cfg, ghmfc_online_state_dict_from_jax(params, cfg, bert_cfg), device="cpu",
                  bert_cfg=bert_cfg, **kw)


def test_online_ranker_matches_jax_ranker(online):
    from drin_tpu.data.online import OnlineBatch

    cfg, _, jmodel, params, batch = online
    jr = JaxRanker(cfg, params=params, model=jmodel)
    tr = _online_ranker(online)
    assert tr.kind == jr.kind == "online" and tr.store is None and tr._feats_fn is None
    assert rank_feat_fields(tr) == list(OnlineBatch._fields[:-1])
    want = jr.score(batch)
    got = tr.score(batch)
    assert got.shape == want.shape == (3, cfg.num_candidates_model)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=1e-5)
    js, ji = jr.rank(batch, k=3)
    ts, ti = tr.rank(batch, k=3)
    np.testing.assert_allclose(ts, js, rtol=F32_RTOL, atol=1e-5)
    _assert_topk_equal_away_from_ties(want, ti, ji, 3)
    # token ids stay integer on their way in; float fields take the compute dtype
    prepared = tr._prepare(batch)
    assert [t.dtype for t in prepared[:4]] == [torch.int64] * 4
    assert prepared[4].dtype == torch.float32 and prepared[5].dtype == torch.int64


def test_online_http_rank_and_field_count(online):
    cfg, _, _, _, batch = online
    tr = _online_ranker(online)
    fields = rank_feat_fields(tr)
    server = serve_http(tr, port=0, feat_fields=fields)
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(feats: dict, k=3):
        req = urllib.request.Request(
            url + "/rank", data=json.dumps({"features": _encode_arrays(feats), "k": k}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    try:
        feats = {n: np.asarray(v) for n, v in zip(fields, batch)}
        out = post(feats)
        want_s, want_i = tr.rank(batch, k=3)
        np.testing.assert_array_equal(np.asarray(out["scores"]), want_s)
        np.testing.assert_array_equal(np.asarray(out["indices"]), want_i)
        with urllib.request.urlopen(url + "/stats", timeout=10) as resp:
            stats = json.loads(resp.read())
        assert stats["model"] == "ghmfc" and stats["entity_rows"] is None
        for bad in ({k: v for k, v in feats.items() if k != "entity_sep_idx"},  # 8 fields
                    dict(feats, entity_ids=feats["entity_ids"][:2])):           # ragged batch
            with pytest.raises(urllib.error.HTTPError) as exc:
                post(bad)
            assert exc.value.code == 400 and "error" in json.loads(exc.value.read())
        with pytest.raises(ValueError, match="expected 9 feature fields, got 14"):
            tr.score(tuple(batch) + tuple(batch[:5]))
    finally:
        server.shutdown()
        server.server_close()


def test_online_ranker_with_tables_installs_no_rows_feats_fn(online, wm128):
    """An online model's requests carry token ids even when a store is
    given, and the host tables are kept only for DRIN."""
    from drin_tpu_torch.data.device_store import DeviceEntityStore

    cfg, _, _, _, batch = online
    dcfg, tables, _, _ = wm128
    tr = _online_ranker(online)
    before = tr.score(batch)
    tr.set_store(DeviceEntityStore(dcfg, tables, device="cpu", dtype=torch.float32), tables)
    assert tr.store is not None and tr._feats_fn is None and tr._tables is None
    assert len(rank_feat_fields(tr)) == 9
    np.testing.assert_array_equal(tr.score(batch), before)


def test_offline_ghmfc_ranker(wm128):
    """GHMFC over precomputed features serves full batches; with device
    entity tables it needs baseline_feats_fn, which is not ported."""
    from drin_tpu.models.ghmfc import GHMFC as JaxGHMFC
    from drin_tpu_torch.data.dataset import BaselineBatch
    from drin_tpu_torch.models.convert import ghmfc_state_dict_from_jax
    from tests.test_torch_ghmfc import _baseline_batch

    dcfg, tables, _, _ = wm128
    cfg = dcfg.replace(model_type="ghmfc", mention_final_layer_name="multimodal",
                       transformer_num_heads=2)
    batch = _baseline_batch(cfg, 3, 2, "pooled")
    jmodel = JaxGHMFC(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), batch)["params"])
    sd = ghmfc_state_dict_from_jax(params, cfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        Ranker(cfg, sd, tables, device="cpu")
    tr = Ranker(cfg, sd, device="cpu")
    assert tr.kind == "baseline" and rank_feat_fields(tr) == list(BaselineBatch._fields[:-1])
    np.testing.assert_allclose(tr.score(batch), np.asarray(jmodel.apply({"params": params}, batch)),
                               rtol=F32_RTOL, atol=1e-5)


def test_serve_main_online(online, tmp_path, monkeypatch):
    """The CLI stands up the online model from a checkpoint; bert-base dims
    are its default, so the tiny checkpoint is refused loudly, and the
    unported serving keys still are."""
    from drin_tpu_torch import serve as tserve
    from drin_tpu_torch.models.convert import ghmfc_online_state_dict_from_jax

    cfg, bert_cfg, _, params, batch = online
    torch.save(ghmfc_online_state_dict_from_jax(params, cfg, bert_cfg), tmp_path / "params.pt")
    argv = ["model_type=ghmfc", "dataset_name=wikimel", "online_bert=true", "finetune_bert=false",
            f"checkpoint_dir={tmp_path}", "compute_dtype=float32", "port=0", "device=cpu",
            f"num_candidates_data={cfg.num_candidates_data}", "num_entity_sentence=3",
            f"max_bert_len={cfg.max_bert_len}", f"bert_embed_dim={cfg.bert_embed_dim}",
            f"resnet_embed_dim={cfg.resnet_embed_dim}", "transformer_num_heads=2",
            f"mention_final_output_dim={cfg.mention_final_output_dim}",
            f"entity_final_output_dim={cfg.entity_final_output_dim}",
            f"max_mention_sentence_len={cfg.max_mention_sentence_len}"]
    with pytest.raises(SystemExit, match="not ported"):
        main(argv + ["bundle=some.bundle"])
    with pytest.raises(RuntimeError, match="size mismatch"):
        main(argv)  # a bert-base model does not load the tiny checkpoint
    real = tserve.Ranker
    monkeypatch.setattr(tserve, "Ranker", lambda *a, **kw: real(*a, bert_cfg=bert_cfg, **kw))
    server = main(argv)
    try:
        fields = list(tserve.OnlineBatch._fields[:-1])
        body = json.dumps({"features": _encode_arrays(dict(zip(fields, map(np.asarray, batch)))),
                           "k": 2}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/rank",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        np.testing.assert_array_equal(np.asarray(out["scores"]),
                                      _online_ranker(online).rank(batch, k=2)[0])
    finally:
        server.shutdown()
        server.server_close()
