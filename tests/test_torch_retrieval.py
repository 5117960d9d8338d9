# -*- coding: utf-8 -*-
"""Stage-1 retrieval of the port against ``drin_tpu``'s: ``quantize_rows``
and the int8 coarse scan bit for bit, and ``Ranker.retrieve`` in the three
modes over every store kind the Ranker builds (float, int8, fused; a
projected DRIN store, which reads the raw CLS slot; precomputed GHMFC
representations; an online model's text-only store) with the indices equal
to the JAX Ranker's and the scores at rtol 2e-4 (float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu import serve as jserve
from drin_tpu.serve import Ranker as JaxRanker
from drin_tpu_torch import serve as tserve
from drin_tpu_torch.models.convert import drin_state_dict_from_jax, ghmfc_state_dict_from_jax
from drin_tpu_torch.serve import BatchingRanker, Ranker
from tests.test_torch_serve import ghmfc128, wm128  # noqa: F401 (fixtures)

F32 = dict(rtol=2e-4, atol=1e-5)
MODES = ("exact", "approx", "int8")


def _queries(table_rows, D, seed):
    """Random queries and two of the table's own rows (each must find itself)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.standard_normal((3, D)).astype(np.float32),
                           np.asarray(table_rows, np.float32)])


def _online_ranker(tables=None):
    """A tiny online model with the port's own random weights: retrieval
    never runs the model, so the JAX side needs none (as in the JAX
    package's own online retrieval test)."""
    from drin_tpu_torch.encoders.bert import BertConfig
    from drin_tpu_torch.models import get_model
    from tests.test_torch_ghmfc import BERT_DIMS, online_cfg

    cfg, bert_cfg = online_cfg(zipped=True), BertConfig(**BERT_DIMS)
    torch.manual_seed(0)
    weights = get_model(cfg, bert_cfg=bert_cfg)[0].state_dict()
    return cfg, Ranker(cfg, weights, tables, device="cpu", bert_cfg=bert_cfg)


def _assert_same_retrieval(jr, tr, q, k, **kw):
    js, ji = jr.retrieve(q, k=k, **kw)
    ts, ti = tr.retrieve(q, k=k, **kw)
    assert ts.dtype == np.float32 and ti.shape == np.asarray(ji).shape
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js, np.float32), **F32)
    return ts, ti


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_and_coarse_scan_bit_equal(dtype):
    rng = np.random.default_rng(0)
    t = rng.standard_normal((300, 24)).astype(np.float32)
    t[[4, 77]] = 0  # zero rows keep scale 1
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-30)
    jt = jnp.asarray(t, dtype)
    tt = torch.from_numpy(t).to(getattr(torch, dtype))
    jq, js = jserve.quantize_rows(jt)
    tq, ts = tserve.quantize_rows(tt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (300, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    q = rng.standard_normal((5, 24)).astype(np.float32)
    q[2] = 0  # a zero query quantizes with scale 1 too
    qn = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-30)
    want = np.asarray(jserve._coarse_int8(jnp.asarray(qn), jq, js).astype(jnp.float32))
    got = tserve._coarse_int8(torch.from_numpy(qn), tq, ts)
    assert got.dtype == torch.bfloat16 and got.shape == (5, 300)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("M,K,N", [(1, 24, 300), (17, 16, 40), (3, 13, 9)])
def test_int8_product_pads_what_cuda_needs(M, K, N):
    """The int32 product equals numpy's at shapes that are not multiples of
    8 and at M <= 16, where the card's int8 product needs padding."""
    rng = np.random.default_rng(M)
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    b = rng.integers(-127, 128, (N, K)).astype(np.int8)
    got = tserve._int8_product(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


def _drin_rankers(wm128, layout):
    cfg, tables, params, _ = wm128
    kw = {"float": {}, "int8": dict(quantize_store=True),
          "fused": dict(quantize_store=True, fused_gather=True)}[layout]
    jr = JaxRanker(cfg, params=params, entity_tables=tables, **kw)
    tr = Ranker(cfg, drin_state_dict_from_jax(params, cfg), tables, device="cpu", **kw)
    return jr, tr


@pytest.mark.parametrize("layout", ["float", "int8", "fused", "projected"])
def test_drin_retrieve_matches_jax(wm128, layout):
    """Every mode over every DRIN store layout; the projected store
    retrieves over its raw CLS slot.  A table row finds itself first."""
    cfg, tables, _, _ = wm128
    jr, tr = _drin_rankers(wm128, "fused" if layout == "projected" else layout)
    slot = 0
    if layout == "projected":
        jr.precompute_entity_projection()
        tr.precompute_entity_projection()
        slot = 1
    text = np.asarray(tables["entity_text_feature"])
    q = _queries(text[[3, 17], slot], cfg.bert_embed_dim, seed=1)
    for mode in MODES:
        ts, ti = _assert_same_retrieval(jr, tr, q, 5, mode=mode)
        assert list(ti[3:, 0]) == [3, 17], (mode, ti)
        # self-retrieval scores 1 up to the int8 store's rounding
        np.testing.assert_allclose(ts[3:, 0], 1.0, atol=2e-3 if layout != "float" else 1e-5)
    # the default mode: exact until the int8 cache exists (built by the int8
    # call above), int8 after it
    np.testing.assert_array_equal(tr.retrieve(q, k=5)[1], tr.retrieve(q, k=5, mode="int8")[1])
    assert tr._retrieval_q is not None


def test_retrieve_over_precomputed_ghmfc_reprs(ghmfc128, wm128):
    _, tables, _, _ = wm128
    cfg, _, params, _, _ = ghmfc128
    jr = JaxRanker(cfg, params=params, entity_tables=tables, quantize_store=True,
                   fused_gather=True)
    tr = Ranker(cfg, ghmfc_state_dict_from_jax(params, cfg), tables, device="cpu",
                quantize_store=True, fused_gather=True)
    q = _queries(np.zeros((0, 128)), 128, seed=2)
    before = tr.retrieve(q, k=4, mode="exact")
    tr.quantize_retrieval()
    reprs = tr.precompute_entity_reprs(chunk=16)
    jr.precompute_entity_reprs(chunk=16)
    assert tr._retrieval_q is None and tr._retrieval_table is None  # caches dropped
    q = _queries(reprs[[5, 30]], reprs.shape[1], seed=2)
    for mode in MODES:
        _, ti = _assert_same_retrieval(jr, tr, q, 4, mode=mode)
        assert list(ti[3:, 0]) == [5, 30]
    assert not np.array_equal(tr.retrieve(q[:3], k=4, mode="exact")[1], before[1])


def test_online_retrieve_over_a_large_table(monkeypatch):
    """An online ranker with a store and no rows feats_fn retrieves like the
    JAX one over a table wider than 4096 rows (where the JAX package takes
    ApproxTopK, exact on the CPU), with a zero row, an ``expand`` override
    that reaches the shortlist, and ``k`` clamped to the row count."""
    rng = np.random.default_rng(3)
    N, D = 5000, 16
    tables = {"entity_text_feature": rng.standard_normal((N, 2, D)).astype(np.float32)}
    tables["entity_text_feature"][123] = 0
    cfg, tr = _online_ranker(tables)
    jr = JaxRanker(cfg, params={"w": np.zeros((2, 2), np.float32)}, entity_tables=tables)
    assert tr.store is not None and tr.store.include == ("text",) and tr._feats_fn is None
    q = _queries(tables["entity_text_feature"][[9, 4321], 0], D, seed=4)
    widths = []
    real = tserve._shortlist
    monkeypatch.setattr(tserve, "_shortlist", lambda s, kc: widths.append(kc) or real(s, kc))
    for mode in MODES:
        _, ti = _assert_same_retrieval(jr, tr, q, 6, mode=mode)
        assert list(ti[3:, 0]) == [9, 4321] and 123 not in ti[:, :6]
    assert widths == [24, 24]  # approx and int8: k * 4
    widths.clear()
    for mode in ("approx", "int8"):
        _assert_same_retrieval(jr, tr, q, 6, mode=mode, expand=7)
    assert widths == [42, 42]
    # the zero row scores exactly 0 against every query
    s, i = tr.retrieve(q, k=N, mode="exact")
    assert s.shape == (5, N) and (s[i == 123] == 0).all() and np.isfinite(s).all()


def test_retrieve_k_clamp_and_refusals(wm128):
    cfg, tables, params, _ = wm128
    jr, tr = _drin_rankers(wm128, "float")
    n = tables["entity_text_feature"].shape[0]
    q = _queries(tables["entity_text_feature"][[2], 0], cfg.bert_embed_dim, seed=5)
    for mode in MODES:  # k clamps to the row count in every mode
        s, i = _assert_same_retrieval(jr, tr, q, n + 7, mode=mode)
        assert i.shape == (4, n) and sorted(i[0]) == list(range(n))
    with pytest.raises(ValueError, match="expand"):
        tr.retrieve(q, k=3, mode="approx", expand=0)
    with pytest.raises(ValueError, match="expand"):
        tr.quantize_retrieval(expand=0)
    with pytest.raises(ValueError, match="unknown retrieval mode"):
        tr.retrieve(q, k=3, mode="fuzzy")
    with pytest.raises(ValueError, match="query must be"):
        tr.retrieve(q[:, :5], k=3)
    with pytest.raises(ValueError, match="k must be"):
        tr.retrieve(q, k=-1)
    # set_store drops both caches
    tr.quantize_retrieval(expand=2)
    assert tr._retrieval_q is not None and tr._retrieval_table is not None
    tr.set_store(tr.store, tables)
    assert tr._retrieval_q is None and tr._retrieval_table is None
    # a ranker without a store: a fault of the server, RuntimeError (HTTP 500)
    _, bare = _online_ranker()
    for call in (lambda: bare.retrieve(q, k=3), bare.quantize_retrieval):
        with pytest.raises(RuntimeError, match="entity tables"):
            call()
    front = BatchingRanker(tr, wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="expand"):
            front.retrieve(q, 3, "int8", expand=0)
        np.testing.assert_array_equal(front.retrieve(q, 3, "int8")[1],
                                      tr.retrieve(q, k=3, mode="int8")[1])
    finally:
        front.close()
