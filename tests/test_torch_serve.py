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
