# -*- coding: utf-8 -*-
"""Sharded stage-1 retrieval and the preprocessing stages' data-parallel
dispatch on the CPU.  ``ShardedRetrieval`` over ``[cpu] * 4`` against the
one-device exact scan and against ``drin_tpu.serve.ShardedRetrieval`` on 4
virtual devices (scores equal, indices equal wherever the scores are not
tied; the port's merge orders ties by row), its exact mode above 4096 rows
a shard, padded tail rows that never surface, and ``shard_retrieval``
releasing the one-device caches.  The stages through the dispatch on
``[cpu, cpu]`` against the one-device stage and against the JAX stages on
the 8-device mesh (``test_stages_data_parallel_match_single_device``'s
setup)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu import serve as jserve
from drin_tpu.preprocess import __main__ as jcli
from drin_tpu_torch.common.config import make_config
from drin_tpu_torch.models.convert import drin_state_dict_from_jax
from drin_tpu_torch.serve import Ranker, ShardedRetrieval, _merge_topk, _unit
from test_preprocess import wd_raw  # noqa: F401 (fixture)
from test_torch_preprocess import TINY, _argv, _checkpoints, _same_store, _wd_args
from tests.test_torch_serve import wm128  # noqa: F401 (fixture)

MODES = ("exact", "approx", "int8")


def _table(n, D, seed, ties=True):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n, D)).astype(np.float32)
    if ties:  # rows equal in pairs: equal scores to tie-break
        t[7] = t[2]
        t[n - 1] = t[1]
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


def _one_device_exact(t, q, k):
    qn = _unit(torch.from_numpy(q))
    s, i = torch.topk(qn @ torch.from_numpy(t).T, k, dim=-1)
    return s.numpy(), i.numpy()


def _assert_same(got, want, t, q, atol=1e-6):
    """Scores equal (to float32 rounding); indices equal wherever the score
    has no tie in the row, and every returned row scores what it says."""
    (gs, gi), (ws, wi) = got, want
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_allclose(gs, ws, rtol=0, atol=atol)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    full = qn @ t.T
    for b in range(len(gs)):
        for j in range(gs.shape[1]):
            tied = np.sum(np.abs(full[b] - ws[b, j]) <= atol) > 1
            if not tied:
                assert gi[b, j] == wi[b, j], (b, j)
            np.testing.assert_allclose(full[b, gi[b, j]], gs[b, j], atol=2e-6)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_equals_one_device_and_jax(mode):
    n, D, k = 103, 16, 9  # 103 rows over 4 shards: a padded tail
    t = _table(n, D, 0)
    q = np.concatenate([np.random.default_rng(1).standard_normal((3, D)).astype(np.float32),
                        t[[1, 2]]])  # queries that tie: rows 1 = 102, 2 = 7
    port = ShardedRetrieval(torch.from_numpy(t), devices=["cpu"] * 4)
    assert port.n == 4 and port.rows == 26 and all(s.shape == (26, D) for s in port.shards)
    kc = k if mode == "exact" else 4 * k
    got = port(q, k, kc, quantized=mode == "int8", exact=mode == "exact")
    got = (got[0].numpy(), got[1].numpy())
    js, ji = jserve.ShardedRetrieval(jnp.asarray(t), devices=jax.devices()[:4])(
        jnp.asarray(q), k, kc, quantized=mode == "int8", exact=mode == "exact")
    _assert_same(got, (np.asarray(js), np.asarray(ji)), t, q)
    _assert_same(got, _one_device_exact(t, q, k), t, q)
    # the merge orders ties by row: rows 1 and 102 are equal, 1 first
    row = list(got[1][3])
    assert row.index(1) < row.index(n - 1) and row[0] == 1


def test_exact_mode_above_4096_rows_a_shard():
    n, D, k = 4 * 4096 + 100, 8, 50
    t = _table(n, D, 2, ties=False)
    q = np.random.default_rng(3).standard_normal((4, D)).astype(np.float32)
    s, i = ShardedRetrieval(torch.from_numpy(t), devices=["cpu"] * 4)(q, k, k, exact=True)
    assert s.shape == (4, k)
    _assert_same((s.numpy(), i.numpy()), _one_device_exact(t, q, k), t, q)


@pytest.mark.parametrize("mode", MODES)
def test_padded_tail_rows_never_surface(mode):
    """Every real row scores below the zero padding rows would score, and k
    asks for every row: the padding must still not appear."""
    n, D = 10, 6
    t = np.abs(_table(n, D, 4, ties=False))
    q = -np.ones((2, D), np.float32)
    s, i = ShardedRetrieval(torch.from_numpy(t), devices=["cpu"] * 4)(
        q, n, n, quantized=mode == "int8", exact=mode == "exact")
    assert sorted(i[0].tolist()) == list(range(n)) and np.isfinite(s.numpy()).all()
    assert (s.numpy() < 0).all()


def test_merge_orders_ties_by_row():
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]])
    rows = torch.tensor([[40, 30, 10, 20, 0]])
    s, r = _merge_topk(scores, rows, 4)
    assert r.tolist() == [[20, 30, 10, 40]]
    np.testing.assert_array_equal(s.numpy(), np.float32([[0.9, 0.9, 0.5, 0.5]]))


def test_shard_retrieval_releases_the_one_device_caches(wm128):  # noqa: F811
    cfg, tables, params, _ = wm128
    ranker = Ranker(cfg, drin_state_dict_from_jax(params, cfg), tables, device="cpu")
    q = np.asarray(tables["entity_text_feature"][[3, 11], 0], np.float32)
    want = ranker.retrieve(q, k=5, mode="exact")
    ranker.quantize_retrieval()
    assert ranker._retrieval_table is not None and ranker._retrieval_q is not None
    sharded = ranker.shard_retrieval(devices=["cpu"] * 3, expand=2, quantize=True)
    assert ranker._retrieval_table is None and ranker._retrieval_q is None
    assert sharded.quant is not None and ranker._sharded_expand == 2
    got = ranker.retrieve(q, k=5, mode="exact")
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    np.testing.assert_array_equal(got[1][:, 0], [3, 11])
    assert ranker._retrieval_table is None  # the sharded path builds no one-device table
    for mode in (None, "approx", "int8"):  # None: int8, the shards' caches exist
        assert ranker.retrieve(q, k=5, mode=mode)[1][:, 0].tolist() == [3, 11]
    with pytest.raises(ValueError, match="unknown retrieval mode"):
        ranker.retrieve(q, k=5, mode="fast")
    ranker.set_store(ranker.store, tables)  # a new store drops the shards
    assert ranker._sharded is None
    np.testing.assert_array_equal(ranker.retrieve(q, k=5, mode="exact")[1], want[1])


# ------------------------------------------------- the stages' dispatch


def _port_store(kw, d, devices):
    from drin_tpu_torch.preprocess import stages
    from drin_tpu_torch.preprocess.prepare import run_prepare

    kw = dict(kw, preprocess_dir=d)
    cfg = make_config("drin", kw.pop("dataset_name"), **kw)
    os.makedirs(d, exist_ok=True)
    run_prepare(cfg)
    runs = [stages.BertStage(cfg, device="cpu", devices=devices),
            stages.ResnetStage(cfg, device="cpu", devices=devices),
            stages.ClipStage(cfg, device="cpu", devices=devices)]
    for stage in runs:
        assert (stage.dp is not None) == (devices is not None)
        stage.run()
    return d, runs


def test_stage_dispatch_writes_the_one_device_store(wd_raw, tmp_path):  # noqa: F811
    root, sentences, names, n_cand = wd_raw
    texts = sentences + [f"{n}: a thing called {n.lower()} with properties" for n in names]
    kw = dict(TINY, **_wd_args(root, n_cand), **_checkpoints(root, texts))
    one, one_runs = _port_store(kw, str(tmp_path / "one"), None)
    dp, runs = _port_store(kw, str(tmp_path / "dp"), ["cpu", "cpu"])
    assert runs[0].dp.n == 2 and len(runs[0].dp.replicas) == 1  # one replica a device
    # a dispatch takes preprocess_batch_size rows a device, as the JAX stages do
    assert runs[0].clock.items == one_runs[0].clock.items
    assert runs[0].clock.chunks < one_runs[0].clock.chunks
    _same_store(one, dp)
    # the JAX stages row-sharded over the 8 virtual devices write the same store
    jdp = str(tmp_path / "jax-dp")
    jcli.main(["all"] + _argv(dict(kw, preprocess_dir=jdp, preprocess_data_parallel=True)))
    _same_store(jdp, dp)
