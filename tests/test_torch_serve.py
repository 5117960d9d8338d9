# -*- coding: utf-8 -*-
"""The port's rank stage as a whole, held against the JAX package's.

The port ``Ranker`` (int8 fused store, plain versions on the CPU) and the
JAX ``Ranker`` (int8 fused store, Pallas gather in interpret mode) serve the
same weights and tables; f32 scores agree at rtol 2e-4 (the repo's f32
convention: both sides run exact float32 math in different association
orders)."""

import json
import urllib.error
from dataclasses import asdict
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
    # shard_retrieval: one shard on the ranker's own device, the one-device
    # caches released
    sharded = main(common + ["shard_retrieval=true", "device=cpu"])
    try:
        assert sharded.front._sharded.n == 1 and sharded.front._retrieval_table is None
        assert _get(f"http://127.0.0.1:{sharded.server_address[1]}", "/stats")["sharded_retrieval"]
    finally:
        sharded.shutdown()
        sharded.server_close()
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


@pytest.fixture(scope="module")
def ghmfc128(wm128):
    """Offline GHMFC (multimodal-bi fusion) over the wm128 store:
    (cfg, flax module, params, dense batch, rows batch)."""
    from drin_tpu.models.ghmfc import GHMFC as JaxGHMFC

    dcfg, tables, _, _ = wm128
    cfg = dcfg.replace(model_type="ghmfc", mention_final_layer_name="multimodal",
                       transformer_num_heads=2)
    ds = MELFeatureDataset(cfg, "train", tables)
    dense = ds.baseline_batch(np.arange(6))
    jmodel = JaxGHMFC(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(4), dense[:-1])["params"])
    return cfg, jmodel, params, dense, ds.baseline_rows_batch(np.arange(6))


def test_offline_ghmfc_ranker(wm128, ghmfc128):
    """GHMFC over precomputed features serves full batches without tables,
    and rows batches over device entity tables, text-only as in JAX."""
    from drin_tpu_torch.data.dataset import BaselineBatch
    from drin_tpu_torch.data.device_store import BaselineRowsBatch
    from drin_tpu_torch.models.convert import ghmfc_state_dict_from_jax

    _, tables, _, _ = wm128
    cfg, jmodel, params, dense, rows = ghmfc128
    sd = ghmfc_state_dict_from_jax(params, cfg)
    tr = Ranker(cfg, sd, device="cpu")
    assert tr.kind == "baseline" and rank_feat_fields(tr) == list(BaselineBatch._fields[:-1])
    want = np.asarray(jmodel.apply({"params": params}, dense[:-1]))
    np.testing.assert_allclose(tr.score(dense[:-1]), want, rtol=F32_RTOL, atol=1e-5)
    stored = Ranker(cfg, sd, tables, device="cpu")
    assert stored.store.include == ("text",) and stored._tables is None
    assert rank_feat_fields(stored) == list(BaselineRowsBatch._fields[:-1])
    np.testing.assert_allclose(stored.score(rows[:-1]), want, rtol=F32_RTOL, atol=1e-5)
    with pytest.raises(ValueError, match="entity_rows must be"):
        stored.score(rows[:5] + (rows.entity_rows[:, 0],))


@pytest.mark.parametrize("layout", ["float", "int8", "fused"])
def test_offline_ghmfc_store_ranker_matches_jax_ranker(wm128, ghmfc128, layout):
    from drin_tpu_torch.models.convert import ghmfc_state_dict_from_jax

    _, tables, _, _ = wm128
    cfg, _, params, _, rows = ghmfc128
    kw = {"float": {}, "int8": dict(quantize_store=True),
          "fused": dict(quantize_store=True, fused_gather=True)}[layout]
    jr = JaxRanker(cfg, params=params, entity_tables=tables, **kw)
    tr = Ranker(cfg, ghmfc_state_dict_from_jax(params, cfg), tables, device="cpu", **kw)
    assert tr.store.include == jr.store.include == ("text",)
    assert tr.store.fused == (layout == "fused") and tr.store.nbytes == jr.store.nbytes
    want = jr.score(rows[:-1])
    tgather.launches = 0
    got = tr.score(rows[:-1])
    assert tgather.launches == 0
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=1e-5)
    ts, ti = tr.rank(rows[:-1], k=3)
    js, ji = jr.rank(rows[:-1], k=3)
    np.testing.assert_allclose(ts, js, rtol=F32_RTOL, atol=1e-5)
    _assert_topk_equal_away_from_ties(want, ti, ji, 3)


@pytest.mark.parametrize("fused", [False, True], ids=["float", "fused"])
def test_entity_precompute_and_rank_rows_match_jax(wm128, ghmfc128, fused):
    """precompute_entity_reprs encodes the table in uneven chunks through
    float_rows; rank_rows (mention encoding, row gather, cosine) gives the
    full forward's top-k, as the JAX Ranker's does."""
    from drin_tpu_torch.data.device_store import DeviceEntityStore
    from drin_tpu_torch.models.convert import ghmfc_state_dict_from_jax

    _, tables, _, _ = wm128
    cfg, _, params, _, rows = ghmfc128
    kw = dict(quantize_store=True, fused_gather=True) if fused else {}
    jr = JaxRanker(cfg, params=params, entity_tables=tables, **kw)
    tr = Ranker(cfg, ghmfc_state_dict_from_jax(params, cfg), tables, device="cpu", **kw)
    with pytest.raises(AssertionError, match="precompute_entity_reprs"):
        tr.rank_rows(rows[:5], rows.entity_rows)
    want_reprs = np.asarray(jr.precompute_entity_reprs(chunk=7))
    reprs = tr.precompute_entity_reprs(chunk=7)
    assert reprs.shape == want_reprs.shape == (tr.store.n_rows, cfg.entity_final_output_dim)
    np.testing.assert_allclose(reprs, want_reprs, rtol=F32_RTOL, atol=1e-5)
    js, ji = jr.rank_rows(rows[:5], rows.entity_rows, k=3)
    ts, ti = tr.rank_rows(rows[:5], rows.entity_rows, k=3)
    np.testing.assert_allclose(ts, js, rtol=F32_RTOL, atol=1e-5)
    full = tr.score(rows[:-1])
    _assert_topk_equal_away_from_ties(full, ti, ji, 3)
    # the fast path ranks like the full forward: same top-k, same scores
    fs, fi = tr.rank(rows[:-1], k=3)
    np.testing.assert_allclose(ts, fs, rtol=1e-5, atol=1e-6)
    _assert_topk_equal_away_from_ties(full, ti, fi, 3)
    # out-of-range rows follow the store's rule (wrap once, clamp)
    oob = rows.entity_rows.copy()
    oob[0, 0], oob[1, 1] = -1, 10 * tr.store.n_rows
    clamp = oob.copy()
    clamp[0, 0], clamp[1, 1] = tr.store.n_rows - 1, tr.store.n_rows - 1
    np.testing.assert_array_equal(tr.rank_rows(rows[:5], oob, k=3)[0],
                                  tr.rank_rows(rows[:5], clamp, k=3)[0])
    with pytest.raises(ValueError, match="k must be"):
        tr.rank_rows(rows[:5], rows.entity_rows, k=99)
    # a new store drops the representations encoded from the old one
    tr.set_store(DeviceEntityStore(cfg, tables, device="cpu", include=("text",)))
    with pytest.raises(AssertionError, match="precompute_entity_reprs"):
        tr.rank_rows(rows[:5], rows.entity_rows)


def test_entity_precompute_refuses_what_jax_refuses(online, wm128):
    from drin_tpu_torch.data.device_store import DeviceEntityStore

    dcfg, tables, params, _ = wm128
    _, tr = _rankers(wm128)
    with pytest.raises(AssertionError, match="GHMFC fast path"):
        tr.precompute_entity_reprs()
    on = _online_ranker(online)
    with pytest.raises(AssertionError, match="needs device entity tables"):
        on.precompute_entity_reprs()
    on.set_store(DeviceEntityStore(dcfg, tables, device="cpu", include=("text",)))
    with pytest.raises(NotImplementedError, match="offline GHMFC"):
        on.precompute_entity_reprs()


def test_serve_main_offline_ghmfc_fused_with_precompute(wm128, ghmfc128, tmp_path):
    """The CLI starts offline GHMFC over a fused text-only store, encodes the
    entity table (``precompute_entities``), and /rank keeps its contract."""
    from drin_tpu_torch.models.convert import ghmfc_state_dict_from_jax

    dcfg, tables, _, _ = wm128
    cfg, _, params, _, rows = ghmfc128
    sd = ghmfc_state_dict_from_jax(params, cfg)
    torch.save(sd, tmp_path / "params.pt")
    argv = ["model_type=ghmfc", "dataset_name=wikimel", f"preprocess_dir={cfg.preprocess_dir}",
            f"checkpoint_dir={tmp_path}", "compute_dtype=float32", "port=0", "device=cpu",
            "quantize_store=true", "fused_gather=true", "precompute_entities=true",
            "mention_final_layer_name=multimodal", "transformer_num_heads=2",
            "bert_embed_dim=128", "resnet_embed_dim=128", "entity_final_output_dim=128",
            "mention_final_output_dim=128", f"num_candidates_data={cfg.num_candidates_data}",
            f"max_mention_sentence_len={cfg.max_mention_sentence_len}",
            f"resnet_num_region={cfg.resnet_num_region}"]
    server = main(argv)
    try:
        fields = list(type(rows)._fields[:-1])
        body = json.dumps({"features": _encode_arrays(
            {n: np.asarray(v) for n, v in zip(fields, rows[:-1])}), "k": 2}).encode()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        req = urllib.request.Request(url + "/rank", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        with urllib.request.urlopen(url + "/stats", timeout=10) as resp:
            assert json.loads(resp.read())["entity_rows"] == len(tables["entity_text_feature"])
        want = Ranker(cfg, sd, tables, device="cpu", quantize_store=True, fused_gather=True)
        np.testing.assert_array_equal(np.asarray(out["scores"]), want.rank(rows[:-1], k=2)[0])
    finally:
        server.shutdown()
        server.server_close()


def test_melhi_ranker_and_cli_match_jax(tmp_path):
    """MELHI (WikiDiverse) is served from the full 8-field baseline batch,
    with no store, by Ranker and by the CLI."""
    from drin_tpu.data.synthetic import tiny_config as jtiny
    from drin_tpu.models.melhi import MELHI as JaxMELHI
    from drin_tpu_torch.data.dataset import BaselineBatch
    from drin_tpu_torch.models.convert import melhi_state_dict_from_jax
    from tests.test_torch_melhi import melhi_batch

    cfg = jtiny("wikidiverse", "melhi", preprocess_dir=str(tmp_path),
                thres_tmim=-0.1, thres_imie=0.1).replace(compute_dtype="float32")
    batch = melhi_batch(cfg, 4, 8)
    jmodel = JaxMELHI(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(5), batch)["params"])
    jr = JaxRanker(cfg, params=params)
    sd = melhi_state_dict_from_jax(params)
    tr = Ranker(cfg, sd, device="cpu")
    assert tr.kind == "baseline" and tr.store is None
    assert rank_feat_fields(tr) == list(BaselineBatch._fields[:-1])
    np.testing.assert_allclose(tr.score(batch), jr.score(batch), rtol=F32_RTOL, atol=1e-5)
    torch.save(sd, tmp_path / "params.pt")
    argv = ["model_type=melhi", "dataset_name=wikidiverse", f"checkpoint_dir={tmp_path}",
            "compute_dtype=float32", "port=0", "device=cpu", "thres_tmim=-0.1",
            "thres_imie=0.1", "bert_embed_dim=16", "resnet_embed_dim=24",
            f"num_candidates_data={cfg.num_candidates_data}",
            f"max_mention_sentence_len={cfg.max_mention_sentence_len}",
            f"resnet_num_region={cfg.resnet_num_region}"]
    # no entity tables: sharded retrieval has nothing to scan, refused at start
    with pytest.raises(RuntimeError, match="retrieve\\(\\) needs device entity tables"):
        main(argv + ["shard_retrieval=true"])
    server = main(argv)
    try:
        fields = rank_feat_fields(tr)
        body = json.dumps({"features": _encode_arrays(dict(zip(fields, batch))), "k": 3}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/rank",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        np.testing.assert_array_equal(np.asarray(out["scores"]), tr.rank(batch, k=3)[0])
    finally:
        server.shutdown()
        server.server_close()


def test_serve_main_online(online, wm128, tmp_path, monkeypatch):
    """The CLI stands up the online model from a checkpoint; bert-base dims
    are its default, so the tiny checkpoint is refused loudly.  The server
    loads the WikiMEL text table for /retrieve, as the JAX CLI does, and
    ``shard_retrieval=true`` answers it from the row-sharded table."""
    from drin_tpu_torch import serve as tserve
    from drin_tpu_torch.models.convert import ghmfc_online_state_dict_from_jax

    cfg, bert_cfg, _, params, batch = online
    torch.save(ghmfc_online_state_dict_from_jax(params, cfg, bert_cfg), tmp_path / "params.pt")
    argv = ["model_type=ghmfc", "dataset_name=wikimel", "online_bert=true", "finetune_bert=false",
            f"checkpoint_dir={tmp_path}", "compute_dtype=float32", "port=0", "device=cpu",
            f"preprocess_dir={wm128[0].preprocess_dir}",
            f"num_candidates_data={cfg.num_candidates_data}", "num_entity_sentence=3",
            f"max_bert_len={cfg.max_bert_len}", f"bert_embed_dim={cfg.bert_embed_dim}",
            f"resnet_embed_dim={cfg.resnet_embed_dim}", "transformer_num_heads=2",
            f"mention_final_output_dim={cfg.mention_final_output_dim}",
            f"entity_final_output_dim={cfg.entity_final_output_dim}",
            f"max_mention_sentence_len={cfg.max_mention_sentence_len}"]
    with pytest.raises(RuntimeError, match="size mismatch"):
        main(argv)  # a bert-base model does not load the tiny checkpoint
    real = tserve.Ranker
    monkeypatch.setattr(tserve, "Ranker", lambda *a, **kw: real(*a, bert_cfg=bert_cfg, **kw))
    sharded = main(argv + ["shard_retrieval=true"])
    try:
        q = np.asarray(wm128[1]["entity_text_feature"][[1, 6], 0], np.float32)
        code, out = _post(f"http://127.0.0.1:{sharded.server_address[1]}", "/retrieve",
                          {"query": _encode_arrays({"q": q}), "k": 2})
        assert code == 200 and [r[0] for r in out["indices"]] == [1, 6]
        assert sharded.front._sharded is not None
    finally:
        sharded.shutdown()
        sharded.server_close()
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
        text = wm128[1]["entity_text_feature"]
        assert server.front.store.include == ("text",) and server.front._feats_fn is None
        assert _get(f"http://127.0.0.1:{server.server_address[1]}", "/stats")[
            "entity_rows"] == len(text)
        q = np.asarray(text[[1, 6], 0], np.float32)
        code, out = _post(f"http://127.0.0.1:{server.server_address[1]}", "/retrieve",
                          {"query": _encode_arrays({"q": q}), "k": 2})
        assert code == 200 and [r[0] for r in out["indices"]] == [1, 6]
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# the micro-batching front, raw text and retrieval over HTTP, bundles


def _concurrently(fns, timeout=120):
    """Run the callables on their own threads, released together by a
    barrier (thread start-up alone can outlast a flush window); their
    results, or the exceptions they raised, in order."""
    import concurrent.futures as cf
    import threading

    bar = threading.Barrier(len(fns))

    def run(fn):
        bar.wait(timeout=60)
        return fn()

    with cf.ThreadPoolExecutor(len(fns)) as ex:
        futs = [ex.submit(run, fn) for fn in fns]
        cf.wait(futs, timeout=timeout)
        return [f.exception(timeout=0) or f.result(timeout=0) for f in futs]


def test_batching_ranker_coalesces_and_matches_alone(wm128):
    """Concurrent rank() calls of 1-3 rows coalesce into fewer device calls,
    each caller gets the rows of its own request, equal to the request
    ranked alone; the batch trace accounts for every call."""
    from drin_tpu_torch.serve import BatchingRanker

    cfg, tables, params, batch = wm128
    _, tr = _rankers(wm128)
    front = BatchingRanker(tr, max_batch=16, wait_ms=150.0)
    reqs = [tuple(np.asarray(x)[i % 5 : i % 5 + 1 + i % 3] for x in batch[:-1])
            for i in range(12)]
    alone = [tr.rank(f, k=3) for f in reqs]
    try:
        got = _concurrently([lambda f=f: front.rank(f, k=3) for f in reqs])
        for (gs, gi), (ws, wi), f in zip(got, alone, reqs):
            np.testing.assert_allclose(gs, ws, rtol=F32_RTOL, atol=F32_ATOL)
            _assert_topk_equal_away_from_ties(tr.score(f), gi, wi, 3)
        assert front._rows_run == sum(f[0].shape[0] for f in reqs)
        assert front._batches_run < len(reqs), front.batch_trace()
        trace = front.batch_trace()
        assert sum(trace.values()) == front._batches_run and all(k.startswith("rank:") for k in trace)
        assert sum(int(k.split(":")[1]) * c for k, c in trace.items()) >= front._rows_run
        assert front.latency_quantiles()["count"] == len(reqs)
    finally:
        front.close()


def test_batching_ranker_mixed_k_bad_requests_and_retrieves(wm128):
    """Requests with another k are grouped apart, a malformed request fails
    only its own caller, and retrieves coalesce beside ranks in one window."""
    from drin_tpu_torch.serve import BatchingRanker

    cfg, tables, params, batch = wm128
    _, tr = _rankers(wm128)
    one = tuple(np.asarray(x)[:1] for x in batch[:-1])
    table = np.asarray(tables["entity_text_feature"][:, 0])
    want = [tr.retrieve(table[[i]], k=3, mode="exact") for i in range(8)]
    front = BatchingRanker(tr, max_batch=32, wait_ms=150.0)
    try:
        calls = [lambda: front.rank(one, 2), lambda: front.rank(one, 5),
                 lambda: front.rank(one[:3], 2),                       # wrong arity
                 lambda: front.rank(one[:9] + (one[9][:, :2],), 2)]    # ragged [B, C]
        calls += [lambda i=i: front.retrieve(table[[i]], 3, "exact") for i in range(8)]
        out = _concurrently(calls)
        assert out[0][1].shape == (1, 2) and out[1][1].shape == (1, 5)
        assert isinstance(out[2], ValueError) and isinstance(out[3], ValueError)
        for i, ((gs, gi), (ws, wi)) in enumerate(zip(out[4:], want)):
            assert gi[0, 0] == i
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gs, ws, rtol=F32_RTOL, atol=F32_ATOL)
        assert front._batches_run < len(calls)
        assert any(k.startswith("retrieve:") for k in front.batch_trace())
        # the dispatcher survives the failed group
        np.testing.assert_array_equal(front.rank(one, 2)[0], out[0][0])
        with pytest.raises(ValueError, match="leading batch dim"):
            front.rank((np.float32(1.0),) * 10, 2)  # refused on the caller's thread
    finally:
        front.close()
    with pytest.raises(RuntimeError, match="closed"):
        front.rank(one, 2)


def test_batching_ranker_close_resolves_taken_window(wm128):
    """close() must not strand a window the dispatcher has taken but not yet
    submitted: with both pipeline slots held by blocked flushes, the
    dispatcher holds window 3; close() shuts the pool and the window is
    flushed inline, so every caller's future resolves."""
    import concurrent.futures as cf
    import threading
    import time
    import types

    from drin_tpu_torch.serve import BatchingRanker

    release = threading.Event()
    started = []

    def rank(feats, k):
        started.append(None)
        release.wait(timeout=30)
        b = feats[0].shape[0]
        return np.zeros((b, k), np.float32), np.zeros((b, k), np.int64)

    dummy = types.SimpleNamespace(cfg=wm128[0], rank=rank)
    br = BatchingRanker(dummy, max_batch=1, wait_ms=1.0, buckets=(1,), pipeline_depth=2)
    feats = (np.zeros((1, 3), np.float32),)

    def wait_for(cond, what, deadline=20.0):
        t0 = time.monotonic()
        while not cond():
            assert time.monotonic() - t0 < deadline, f"waiting for {what}"
            time.sleep(0.01)

    with cf.ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(br.rank, feats, 2)]
        wait_for(lambda: len(started) >= 1, "flush 1 in flight")
        futs.append(ex.submit(br.rank, feats, 2))
        wait_for(lambda: len(started) >= 2, "flush 2 in flight")
        futs.append(ex.submit(br.rank, feats, 2))
        wait_for(br._q.empty, "window 3 taken by the dispatcher")
        t = threading.Timer(0.5, release.set)
        t.start()
        try:
            br.close(timeout=0.2)
            for f in futs:
                s, i = f.result(timeout=30)
                assert s.shape == (1, 2)
        finally:
            t.cancel()
            release.set()
    assert not br._thread.is_alive()


def _text_server_ranker(tables, tmp_path, buckets=8):
    """A tiny online model with the port's own random weights, a vocabulary
    file written from the request strings and length buckets of 8 tokens:
    (ranker, sentences, spans, candidates)."""
    from drin_tpu.text.wordpiece import build_tiny_vocab
    from drin_tpu_torch.encoders.bert import BertConfig
    from drin_tpu_torch.models import get_model
    from tests.test_torch_ghmfc import BERT_DIMS, online_cfg

    sentences = ["Alpha beta gamma delta", "Epsilon zeta eta theta"]
    spans = [(0, 5), (8, 12)]
    cands = [["Alpha thing", "beta thing", "gamma"], ["zeta item", "eta item", "theta"]]
    vocab = build_tiny_vocab(sentences + [c for row in cands for c in row] + ["iota " * 3])
    path = tmp_path / "vocab.txt"
    inv = {i: w for w, i in vocab.items()}
    path.write_text("".join(inv[i] + "\n" for i in range(len(inv))), encoding="utf-8")
    cfg = online_cfg(zipped=True, online_length_buckets=buckets).replace(bert_vocab=str(path))
    bert_cfg = BertConfig(**BERT_DIMS)
    torch.manual_seed(0)
    weights = get_model(cfg, bert_cfg=bert_cfg)[0].state_dict()
    return (Ranker(cfg, weights, tables, device="cpu", bert_cfg=bert_cfg),
            sentences, spans, cands)


def _post(url, path, obj, timeout=60):
    """(status, reply) of a JSON POST."""
    req = urllib.request.Request(url + path, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as resp:
        return json.loads(resp.read())


def test_http_rank_text_retrieve_and_stats_through_the_batcher(wm128, tmp_path):
    """/rank_text, /retrieve and /stats behind a BatchingRanker answer as the
    ranker does; requests of another length bucket get their own device
    call; 400 for the request's faults, 500 for the server's."""
    from drin_tpu_torch.serve import BatchingRanker

    _, tables, _, _ = wm128
    tr, sentences, spans, cands = _text_server_ranker(tables, tmp_path)
    want_s, want_i = tr.rank_text(sentences, spans, cands, k=2)
    q = np.asarray(tables["entity_text_feature"][[4, 11], 0], np.float32)
    want_r = tr.retrieve(q, k=3, mode="int8")
    front = BatchingRanker(tr, wait_ms=150.0)
    server = serve_http(front, port=0, feat_fields=rank_feat_fields(front))
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert server.front is front and rank_feat_fields(front) == rank_feat_fields(tr)
        body = {"sentences": sentences, "spans": [list(s) for s in spans], "candidates": cands,
                "k": 2}
        code, out = _post(url, "/rank_text", body)
        assert code == 200
        np.testing.assert_array_equal(np.asarray(out["scores"], np.float32), want_s)
        np.testing.assert_array_equal(np.asarray(out["indices"]), want_i)
        longer = "iota iota iota " + sentences[0] + " iota iota iota iota"
        calls = [lambda b=b: front.rank_text([sentences[b]], [spans[b]], [cands[b]], 2)
                 for b in (0, 1)]
        calls.append(lambda: front.rank_text([longer], [(15, 20)], [cands[0]], 2))
        out3 = _concurrently(calls)
        for b in (0, 1):
            np.testing.assert_allclose(out3[b][0][0], want_s[b], rtol=F32_RTOL, atol=F32_ATOL)
            np.testing.assert_array_equal(out3[b][1][0], want_i[b])
        assert out3[2][0].shape == (1, 2)
        code, out = _post(url, "/retrieve", {"query": _encode_arrays({"q": q}), "k": 3,
                                             "mode": "int8", "expand": 2})
        assert code == 200
        np.testing.assert_array_equal(np.asarray(out["indices"]), want_r[1])
        assert [row[0] for row in out["indices"]] == [4, 11]
        stats = _get(url, "/stats")
        assert stats["micro_batched"] and not stats["sharded_retrieval"]
        assert stats["entity_rows"] == tr.store.n_rows and stats["device"] == "cpu"
        assert stats["rows_run"] >= 7 and sum(stats["batch_buckets"].values()) == \
            stats["batches_run"]
        assert stats["latency"]["count"] >= 5 and stats["latency"]["p50_ms"] > 0
        # the request's faults
        for path, bad in (("/rank_text", dict(body, spans=[[0]] * 2)),
                          ("/rank_text", {"sentences": sentences}),
                          ("/retrieve", {"query": _encode_arrays({"q": q}), "mode": "fuzzy"}),
                          ("/retrieve", {"query": _encode_arrays({"q": q[:, :7]})}),
                          ("/retrieve", {"query": _encode_arrays({"q": q}), "expand": 0}),
                          ("/retrieve", {"query": "!!!"})):
            code, out = _post(url, path, bad)
            assert code == 400 and "error" in out, (path, bad, code, out)
    finally:
        server.shutdown()
        server.server_close()
        front.close()
    # the server's faults: a closed batcher, a ranker without tables or vocab
    server = serve_http(front, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    bare, *_ = _text_server_ranker(None, tmp_path)
    bare.cfg = bare.cfg.replace(bert_vocab="")
    server2 = serve_http(bare, port=0)
    url2 = f"http://127.0.0.1:{server2.server_address[1]}"
    try:
        code, out = _post(url, "/rank_text", body)
        assert code == 500 and "closed" in out["error"]
        code, out = _post(url2, "/retrieve", {"query": _encode_arrays({"q": q})})
        assert code == 500 and "entity tables" in out["error"]
        code, out = _post(url2, "/rank_text", body)
        assert code == 500 and "bert_vocab" in out["error"]
    finally:
        for s in (server, server2):
            s.shutdown()
            s.server_close()
    # raw text on a model that does not take it is the request's fault
    _, dr = _rankers(wm128)
    server = serve_http(dr, port=0)
    try:
        code, out = _post(f"http://127.0.0.1:{server.server_address[1]}", "/rank_text", body)
        assert code == 400 and "online" in out["error"]
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("kind", ["float", "quantized", "online"])
def test_bundle_round_trip(wm128, tmp_path, kind):
    """save_bundle -> from_bundle reproduces the ranker: float and fused int8
    DRIN stores (a quantized store persists its dequantized floats, and
    re-quantized reloads score as it did), and an online ranker with its
    text-only retrieval store."""
    from drin_tpu_torch.serve import Ranker as TRanker

    cfg, tables, params, batch = wm128
    d = str(tmp_path / "bundle")
    if kind == "online":
        src, *_ = _text_server_ranker({"entity_text_feature": tables["entity_text_feature"]},
                                      tmp_path)
        src.save_bundle(d)
        back = TRanker.from_bundle(d, device="cpu", bert_cfg=src._bert_cfg)
        assert asdict(back.cfg) == asdict(src.cfg)
        assert back._feats_fn is None and back.store.include == ("text",)
        q = np.asarray(tables["entity_text_feature"][[4, 9], 0], np.float32)
        for mode in ("exact", "int8"):
            s1, i1 = src.retrieve(q, k=3, mode=mode)
            s2, i2 = back.retrieve(q, k=3, mode=mode)
            np.testing.assert_array_equal(i2, i1)
            np.testing.assert_array_equal(s2, s1)
        sd, sd2 = src.model.state_dict(), back.model.state_dict()
        assert all(torch.equal(sd[k], sd2[k]) for k in sd)
        return
    kw = dict(quantize_store=True, fused_gather=True) if kind == "quantized" else {}
    src = TRanker(cfg, drin_state_dict_from_jax(params, cfg), tables, device="cpu", **kw)
    want = src.score(batch[:-1])
    src.save_bundle(d)
    src.save_bundle(d)  # refreshing in place overwrites
    back = TRanker.from_bundle(d, device="cpu", **kw)
    assert asdict(back.cfg) == asdict(src.cfg) and back.store.fused == (kind == "quantized")
    np.testing.assert_array_equal(back.score(batch[:-1]), want)
    if kind == "quantized":
        as_float = TRanker.from_bundle(d, device="cpu")
        assert not as_float.store.quantized
        np.testing.assert_allclose(as_float.score(batch[:-1]), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(as_float.store.text.numpy(),
                                      src.store.float_table("text").numpy())
    # a projected bundle stays projected: projecting again changes nothing
    src.precompute_entity_projection()
    want = src.score(batch[:-1])
    src.save_bundle(d)
    back = TRanker.from_bundle(d, device="cpu", **kw)
    assert back.cfg.entity_projected
    back.precompute_entity_projection()
    np.testing.assert_allclose(back.score(batch[:-1]), want, rtol=1e-6, atol=1e-7)


def test_serve_main_from_bundle_micro_batched(wm128, tmp_path):
    """The CLI serves a bundle behind the micro-batching front: /rank with
    named fields, /retrieve over the int8 cache, /stats; bundle mode takes
    no config overrides; ``shard_retrieval`` with ``quantize_retrieval``
    builds the shards' int8 caches instead of the one-device cache."""
    from drin_tpu_torch.serve import Ranker as TRanker

    cfg, tables, params, batch = wm128
    src = TRanker(cfg, drin_state_dict_from_jax(params, cfg), tables, device="cpu")
    src.save_bundle(str(tmp_path / "b"))
    argv = [f"bundle={tmp_path / 'b'}", "micro_batch=true", "device=cpu", "port=0"]
    with pytest.raises(SystemExit, match="no config overrides"):
        main(argv + ["batch_size=4"])
    sharded = main(argv + ["shard_retrieval=true", "quantize_retrieval=true"])
    try:
        ranker = sharded.front.ranker
        assert ranker._sharded.quant is not None and ranker._retrieval_q is None
        q = np.asarray(tables["entity_text_feature"][[2, 9], 0], np.float32)
        code, out = _post(f"http://127.0.0.1:{sharded.server_address[1]}", "/retrieve",
                          {"query": _encode_arrays({"q": q}), "k": 3})
        assert code == 200 and [r[0] for r in out["indices"]] == [2, 9]
    finally:
        sharded.shutdown()
        sharded.server_close()
        sharded.front.close()
    server = main(argv + ["quantize_store=true", "fused_gather=true", "quantize_retrieval=true",
                          "retrieve_expand=3", "wait_ms=5", "max_batch=8"])
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        front = server.front
        assert front.max_batch == 8 and front.ranker.store.fused
        assert front.ranker._retrieval_q is not None and front.ranker._retrieval_expand == 3
        fields = rank_feat_fields(front)
        code, out = _post(url, "/rank", {"features": _encode_arrays(
            {n: np.asarray(v) for n, v in zip(fields, batch[:-1])}), "k": 3})
        assert code == 200  # padded to the bucket of 8: not bit-equal to B=6 alone
        np.testing.assert_allclose(np.asarray(out["scores"]), front.ranker.rank(batch[:-1], k=3)[0],
                                   rtol=F32_RTOL, atol=F32_ATOL)
        q = np.asarray(tables["entity_text_feature"][[2, 9], 0], np.float32)
        code, out = _post(url, "/retrieve", {"query": _encode_arrays({"q": q}), "k": 3})
        assert code == 200 and [r[0] for r in out["indices"]] == [2, 9]
        stats = _get(url, "/stats")
        assert stats["micro_batched"] and stats["entity_rows"] == src.store.n_rows
        assert set(stats["batch_buckets"]) == {"rank:8", "retrieve:2"}
    finally:
        server.shutdown()
        server.server_close()
        server.front.close()
