# -*- coding: utf-8 -*-
"""The port over several ranks on the CPU (gloo), against one process and
against the JAX package: a tiny DRIN fit chunk and test on a ragged
WikiDiverse store over four ranks, on (4, 1) and (2, 2) meshes, equal to the
port's one-process run and to the JAX ``Trainer`` on a (4, 1) mesh of
virtual devices from the same weights (rtol 2e-4: the same math in another
association order); the local in-batch loss, a planted fault, must not pass
that check.  Two ranks: WikiMEL's token-level tables row-sharded over
``mesh_model=2`` against the one-process run that gathers on the host (the
gathered batch bit-equal to the full table's rows), checkpoints saved by one
rank and restored by both, and online GHMFC with length bucketing.  The
counters' sum over four ranks against ``drin_tpu.train.metrics.psum_state``
on four devices; the training entry point with ``num_processes=2``; and
NCCL's refusal of two ranks on one device.

The model axis: DRIN candidate-parallel on a (2, 2) mesh with a prime C = 11
padded to 12, against the JAX ``Trainer`` on a padded (2, 2) mesh of
virtual devices at rtol 2e-4 and against one process's first-step
gradients, with two planted faults that must fail (the message sum without
its collective in the backward; the model axis's gradient shares averaged
where the rule sums them); the row-sharded WikiMEL run candidate-parallel
too (C = 11 -> 12), against the JAX ``Trainer`` on one device; a ``Ranker``
over a row-sharded store on two ranks, held to every check of
``tests/test_serve.py::test_ranker_over_row_sharded_store`` and
``::test_save_load_bundle_roundtrip`` and to the JAX ``Ranker``'s scores;
and the HTTP front over it, its clean shutdown and a follower's failure.
One single-process test holds the split plain GCN layer against
``drin_tpu``'s ``GCNLayer`` on padded candidates.

The baselines on the model axis: offline GHMFC and MELHI on a (1, 4) mesh
with C = 10 padded to 12 (``test_multichip.py::test_baseline_padding_on_mesh_matches_single``'s
setup, the images laid out so that MELHI's gate opens through the last
rank's block alone for some mentions), against one process and the JAX
``Trainer`` on a (1, 4) mesh; GHMFC through the training entry point over
row-sharded token-level tables (C = 11 -> 12); the online GHMFC in direct
mode on a (2, 2) mesh (C = 7 -> 8) against the JAX step, in zipped mode on
(1, 2) (its sentences split) and with S = 3 (replicated) against one
process; a GHMFC ``Ranker`` over a row-sharded store behind the HTTP front
against the JAX ``Ranker``; and four planted faults that must fail their
checks (MELHI's gate without its OR, its padded candidates masked at local
indices, the score gather's backward summing over the group, the loss
backpropagated by the replicated rule while the entity side is split).

The ranks are processes of ``tests/torch_dist_worker.py`` (file rendezvous,
one launch a world size for the whole module, a timeout on every wait)."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.data.dataset import MELFeatureDataset as JaxMELFeatureDataset
from drin_tpu.data.dataset import create_datasets as jax_create_datasets
from drin_tpu.data.dataset import load_wikimel_entity_tables as jax_load_tables
from drin_tpu.common.config import make_config as jax_make_config
from drin_tpu.data.synthetic import make_synthetic_online_store, make_synthetic_store, tiny_config
from drin_tpu.encoders.bert import BertConfig as JaxBertConfig
from drin_tpu.models import get_model as jax_get_model
from drin_tpu.models.drin import GCNLayer as JaxGCNLayer
from drin_tpu.models.ghmfc import GHMFCOnline as JaxGHMFCOnline
from drin_tpu.parallel import mesh as jax_mesh
from drin_tpu.serve import Ranker as JaxRanker
from drin_tpu.train import metrics as JM
from drin_tpu.train.trainer import Trainer as JaxTrainer
from drin_tpu.train.trainer import build_step_fns as jax_build_step_fns
from drin_tpu.train.trainer import create_train_state as jax_create_train_state
from drin_tpu_torch.common.config import make_config
from drin_tpu_torch.encoders.bert import BertConfig
from drin_tpu_torch.models import get_model
from drin_tpu_torch.models.convert import (drin_state_dict_from_jax, ghmfc_online_state_dict_from_jax,
                                           ghmfc_state_dict_from_jax, melhi_state_dict_from_jax)
from drin_tpu_torch.parallel import distributed

import torch_dist_worker as W

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_dist_worker.py")
RTOL = 2e-4
TIMEOUT = 300
FOUR = ("drin@4x1,drin@2x2,psum@4x1,drin_local_loss@4x1,drin_cand@2x2,drin_cand_nosum@2x2,"
        "drin_cand_avg@2x2,ghmfc_cand@1x4,melhi_cand@1x4,ghmfc_cand_gsum@1x4,"
        "melhi_cand_noor@1x4,melhi_cand_localmask@1x4,online_cand@2x2")
# http_front leaves the process group: it runs last
TWO = ("wm_rows@1x2,ckpt@2x1,online@2x1,serve_rows@1x2,ghmfc_rows_cand@1x2,online_zip@1x2,"
       "online_zip3@1x2,online_zip_replicated@1x2,serve_ghmfc_rows@1x2,http_front@1x2")


def _port_cfg(cfg):
    d = dataclasses.asdict(cfg)
    return make_config(d.pop("model_type"), d.pop("dataset_name"), **d)


def _jax_cfg(cfg):
    """The JAX package's Config of a port Config (the same fields)."""
    d = dataclasses.asdict(cfg)
    return jax_make_config(d.pop("model_type"), d.pop("dataset_name"), **d)


def _port_weights(params, cfg):
    """A JAX model's params -> the port's state_dict of the same model."""
    if cfg.model_type == "drin":
        return drin_state_dict_from_jax(params, _port_cfg(cfg))
    if cfg.model_type == "melhi":
        return melhi_state_dict_from_jax(params)
    return ghmfc_state_dict_from_jax(params, _port_cfg(cfg))


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(world: int, runs: str, spec_path: str, root: pathlib.Path):
    out = root / f"out{world}"
    out.mkdir()
    rdv = str(root / f"rendezvous{world}")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), rdv, spec_path, str(out),
                               runs], cwd=str(REPO), env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    return out, procs


def _collect(out, procs):
    results = []
    try:
        for r, p in enumerate(procs):
            so, se = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank {r} failed:\n{so[-4000:]}\n{se[-8000:]}"
    finally:
        for p in procs:
            p.kill()
    for r in range(len(procs)):
        with open(out / f"rank{r}.json") as f:
            results.append(json.load(f))
    return results


def _jax_run(cfg, params, dump, shape=(4, 1)):
    """The JAX Trainer of ``cfg``'s model (DRIN, GHMFC or MELHI) on a (data,
    model) mesh of virtual CPU devices, or on one device (``shape`` None).
    A model axis that does not divide C pads it (the JAX Trainer's own
    padding, logged)."""
    train, valid, test = jax_create_datasets(cfg)
    model, kind = jax_get_model(cfg)
    example = next(test.batches(cfg.batch_size, kind=kind, pad_to_full=True))
    mesh = None
    if shape is not None:
        mesh = jax_mesh.make_mesh(devices=jax.devices()[:shape[0] * shape[1]], data=shape[0],
                                  model=shape[1])
    logs = []
    tr = JaxTrainer(cfg, lambda p, f: model.apply({"params": p}, f), params, mesh,
                    batch_fields=type(example)._fields, example_batch=example, log=logs.append,
                    output_test_result_path=dump)
    epochs = []
    W._record_epochs(tr, epochs)
    tr.fit(train, valid, W.FIT_EPOCHS, kind=kind)
    test_out = tr.test(test, kind=kind)
    sd = _port_weights(jax.device_get(tr.state.params), cfg)
    out = {"epochs": epochs, "test_loss": test_out["loss"],
           "test_accs": {str(k): v for k, v in test_out["accs"].items()},
           "digest": W.digest(sd), "step": int(tr.state.step), "cand_pad": tr._cand_pad,
           "logs": [str(x) for x in logs]}
    if cfg.output_test_result:
        with open(dump) as f:
            out["dump"] = f.read()
    return out


def _jax_init(cfg, seed=0):
    """A JAX model's initial params (its init jitted: one compile, where the
    op-by-op init compiles every op)."""
    model, kind = jax_get_model(cfg)
    example = next(jax_create_datasets(cfg)[2].batches(cfg.batch_size, kind=kind, pad_to_full=True))
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(seed), tuple(np.asarray(x) for x in example[:-1]))["params"])


def _jax_online_step(cfg, params, batch, shape=(2, 2)):
    """One JAX train step of the online GHMFC on a (data, model) mesh of
    virtual CPU devices, C padded to the model axis as the JAX Trainer pads
    it: the loss, the counters and the scores after the step."""
    model = JaxGHMFCOnline(cfg, JaxBertConfig(**W.ONLINE_MESH_BERT))
    apply_fn = lambda p, f: model.apply({"params": p}, f)
    fields = type(batch)._fields
    C, nm = cfg.num_candidates_model, shape[1]
    batch = tuple(jax_mesh.pad_candidates_to(tuple(batch), fields, C,
                                             jax_mesh.padded_candidate_count(C, nm)))
    mesh = jax_mesh.make_mesh(devices=jax.devices()[:shape[0] * nm], data=shape[0], model=nm)
    st, tx = jax_create_train_state(jax.tree.map(jnp.asarray, params), cfg)
    fns = jax_build_step_fns(apply_fn, cfg, tx, mesh, fields, batch)
    put = jax_mesh.put_batch(batch, fns.batch_shardings)
    valid = jax.device_put(np.ones((cfg.batch_size,), np.float32), fns.valid_sharding)
    init = lambda: jax.device_put(JM.init_state(cfg.metrics_topk), fns.replicated)
    st, loss, m = fns.train_step(jax.device_put(st, fns.replicated), put, valid, init())
    _, _, scores = fns.eval_step(st.params, put, valid, init())
    return {"loss": float(loss), "counters": {k: float(v) for k, v in jax.device_get(m).items()},
            "scores": np.asarray(jax.device_get(scores))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch-dist")
    wd, wm, online = (str(root / n) for n in ("wd", "wm", "online"))
    wd_cfg = tiny_config("wikidiverse", "drin", preprocess_dir=wd).replace(
        batch_size=8, learning_rate=3e-3, transformer_dropout=0.0, output_test_result=True)
    make_synthetic_store(wd_cfg, n_mentions=19, seed=6)  # ragged tails in every split
    wm_cfg = tiny_config("wikimel", "drin", preprocess_dir=wm, num_candidates_data=10).replace(
        batch_size=8, learning_rate=3e-3, transformer_dropout=0.0, cache_entity_pooling=False)
    make_synthetic_store(wm_cfg, n_mentions=14, n_entities=30, seed=27)
    make_synthetic_online_store(online, n=8, write=True)
    wd11 = str(root / "wd11")
    cand_cfg = wd_cfg.replace(preprocess_dir=wd11, num_candidates_data=10)  # C = 11, prime
    make_synthetic_store(cand_cfg, n_mentions=19, seed=6)
    serve = str(root / "serve")  # tests/test_serve.py's served store
    serve_cfg = tiny_config("wikimel", "drin", preprocess_dir=serve).replace(compute_dtype="float32")
    make_synthetic_store(serve_cfg, n_mentions=10, n_entities=25, seed=13)
    params = _jax_init(wd_cfg)  # DRIN's parameters do not depend on C: drin_cand takes them too
    wm_params = _jax_init(wm_cfg)
    serve_params = _jax_init(serve_cfg)
    # the baselines on the model axis: one WikiDiverse store (C = 10) with
    # MELHI's gate images, GHMFC and MELHI weights, the online model's, and
    # GHMFC's over the served store
    base = str(root / "base")
    base_cfgs = {mt: _jax_cfg(W.baseline_cfg(base, mt)) for mt in ("ghmfc", "melhi")}
    make_synthetic_store(base_cfgs["ghmfc"], n_mentions=8, seed=23)
    W.melhi_gate_store(base, base_cfgs["ghmfc"].num_candidates_model)
    base_params = {mt: _jax_init(c) for mt, c in base_cfgs.items()}
    online_cfg = W.online_mesh_cfg()
    online_batch = W.online_mesh_batch(online_cfg)
    online_params = jax.tree.map(np.asarray, jax.jit(JaxGHMFCOnline(
        _jax_cfg(online_cfg), JaxBertConfig(**W.ONLINE_MESH_BERT)).init)(
            jax.random.key(0), tuple(online_batch[:-1]))["params"])
    ghmfc_serve_cfg = _jax_cfg(W.ghmfc_serve_cfg(serve))
    ghmfc_serve_params = _jax_init(ghmfc_serve_cfg)
    scratch = root / "scratch"
    scratch.mkdir()
    spec = {"wd": wd, "wm": wm, "online": online, "wd11": wd11, "serve": serve,
            "scratch": str(scratch), "drin_weights": str(root / "drin.pt"),
            "wm_weights": str(root / "wm.pt"), "serve_weights": str(root / "serve.pt"),
            "base_cand": base, "ghmfc_weights": str(root / "ghmfc.pt"),
            "melhi_weights": str(root / "melhi.pt"), "online_weights": str(root / "online.pt"),
            "ghmfc_serve_weights": str(root / "ghmfc-serve.pt")}
    torch.save(drin_state_dict_from_jax(params, _port_cfg(wd_cfg)), spec["drin_weights"])
    torch.save(drin_state_dict_from_jax(wm_params, _port_cfg(wm_cfg)), spec["wm_weights"])
    torch.save(drin_state_dict_from_jax(serve_params, _port_cfg(serve_cfg)), spec["serve_weights"])
    for mt, c in base_cfgs.items():
        torch.save(_port_weights(base_params[mt], c), spec[f"{mt}_weights"])
    torch.save(ghmfc_online_state_dict_from_jax(online_params, online_cfg,
                                                BertConfig(**W.ONLINE_MESH_BERT)),
               spec["online_weights"])
    torch.save(_port_weights(ghmfc_serve_params, ghmfc_serve_cfg), spec["ghmfc_serve_weights"])
    spec_path = str(root / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    # both worlds run while this process computes the references
    four, two = _launch(4, FOUR, spec_path, root), _launch(2, TWO, spec_path, root)
    torch.set_num_threads(1)
    tables = jax_load_tables(serve_cfg)
    ds = JaxMELFeatureDataset(serve_cfg, "train", tables)
    jr = JaxRanker(serve_cfg, params=serve_params, entity_tables=tables)
    gds = JaxMELFeatureDataset(ghmfc_serve_cfg, "train", tables)
    gjr = JaxRanker(ghmfc_serve_cfg, params=ghmfc_serve_params, entity_tables=tables)
    single = {"drin": W.scenario_drin(spec, None), "wm_rows": W.scenario_wm_rows(spec, None),
              "online": W.scenario_online(spec, None),
              "drin_cand": W.scenario_drin_cand(spec, None),
              "jax": _jax_run(wd_cfg, params, str(scratch / "jax-dump.txt")),
              "jax_cand": _jax_run(cand_cfg, params, str(scratch / "jax-cand-dump.txt"),
                                    shape=(2, 2)),
              "jax_wm": _jax_run(wm_cfg, wm_params, str(scratch / "jax-wm-dump.txt"), shape=None),
              "jax_serve": {"score4": np.asarray(jr.score(ds.drin_rows_batch(np.arange(4))[:-1])),
                            "score3": np.asarray(jr.score(ds.drin_rows_batch(np.arange(3))[:-1]))},
              "ghmfc_cand": W.scenario_ghmfc_cand(spec, None),
              "melhi_cand": W.scenario_melhi_cand(spec, None),
              "ghmfc_rows_cand": W.scenario_ghmfc_rows_cand(spec, None),
              "online_zip": W._online_zip(None, 4), "online_zip3": W._online_zip(None, 3),
              "jax_online_cand": _jax_online_step(_jax_cfg(online_cfg), online_params, online_batch),
              "jax_serve_ghmfc": {
                  "score4": np.asarray(gjr.score(gds.baseline_rows_batch(np.arange(4))[:-1])),
                  "score3": np.asarray(gjr.score(gds.baseline_rows_batch(np.arange(3))[:-1]))}}
    for mt, c in base_cfgs.items():
        single[f"jax_{mt}_cand"] = _jax_run(c, base_params[mt], str(scratch / f"jax-{mt}-dump.txt"),
                                            shape=(1, 4))
    return {"single": single, "four": _collect(*four), "two": _collect(*two)}


def _assert_same_run(got, want, rtol=RTOL):
    assert [e["split"] for e in got["epochs"]] == [e["split"] for e in want["epochs"]]
    np.testing.assert_allclose([e["loss"] for e in got["epochs"]],
                               [e["loss"] for e in want["epochs"]], rtol=rtol)
    for g, w in zip(got["epochs"], want["epochs"]):
        assert g["accs"] == pytest.approx(w["accs"], rel=1e-6), (g, w)
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=rtol)
    assert got["test_accs"] == pytest.approx(want["test_accs"], rel=1e-6)
    np.testing.assert_allclose(got["digest"], want["digest"], rtol=rtol)
    assert got["step"] == want["step"]


def _dump_rows(text):
    return [(np.array([float(v) for v in left.split()]), int(right))
            for left, right in (line.split(" | ") for line in text.splitlines())]


@pytest.mark.parametrize("shape", ["4x1", "2x2"])
def test_four_rank_drin_equals_one_process_and_jax(runs, shape):
    ranks = [r[f"drin@{shape}"] for r in runs["four"]]
    single, jax_run = runs["single"]["drin"], runs["single"]["jax"]
    _assert_same_run(single, jax_run)  # the one-process port against JAX
    _assert_same_run(ranks[0], single)
    _assert_same_run(ranks[0], jax_run)
    # every rank holds the same weights after every step
    assert len({r["digest"] for r in ranks}) == 1
    # the test dump: rank 0 writes every row, in order, as one process does
    got, want = _dump_rows(ranks[0]["dump"]), _dump_rows(single["dump"])
    assert len(got) == len(want) == 6 and "dump" not in ranks[1]
    for (gs, gl), (ws, wl) in zip(got, want):
        assert gl == wl
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=2e-6)


def test_local_loss_fault_fails_the_check(runs):
    """Each rank's negatives from its own rows: a different loss, which the
    check above must refuse."""
    faulty = runs["four"][0]["drin_local_loss@4x1"]
    with pytest.raises(AssertionError):
        _assert_same_run(faulty, runs["single"]["jax"])
    losses = [e["loss"] for e in faulty["epochs"] if e["split"] == "train"]
    want = [e["loss"] for e in runs["single"]["jax"]["epochs"] if e["split"] == "train"]
    assert np.max(np.abs(np.array(losses) / np.array(want) - 1)) > 10 * RTOL


def test_psum_state_matches_jax(runs):
    from functools import partial

    mesh = jax_mesh.make_mesh(devices=jax.devices()[:4], data=4, model=1)
    d = np.arange(4, dtype=np.float32)
    per_device = {"correct_1": d + 1, "total": 8.0 + d, "loss_sum": 0.25 * d, "n_batches": np.ones(4, np.float32)}
    spec = jax.sharding.PartitionSpec("data")

    @partial(jax.shard_map, mesh=mesh, in_specs=(spec,), out_specs=jax.sharding.PartitionSpec())
    def summed(st):
        return JM.psum_state({k: v[0] for k, v in st.items()}, "data")

    want = {k: float(v) for k, v in summed({k: jnp.asarray(v) for k, v in per_device.items()}).items()}
    for rank in runs["four"]:
        assert rank["psum@4x1"] == want


def test_row_sharded_token_tables_equal_the_host_gather(runs):
    ranks = [r["wm_rows@1x2"] for r in runs["two"]]
    assert all(r["gather_bit_equal"] for r in ranks)
    # each rank holds half the (padded) rows of every table
    assert ranks[0]["nbytes"] == ranks[1]["nbytes"] > 0
    _assert_same_run(ranks[0], runs["single"]["wm_rows"])
    assert ranks[0]["digest"] == ranks[1]["digest"]


def test_row_sharded_candidate_parallel_run_equals_jax(runs):
    """The row-sharded WikiMEL run is candidate-parallel (C = 11 padded to
    12 over the model axis of 2; each rank's gather a reduce-scatter that
    keeps its block, bit-equal to the full tables' rows) and equals the
    JAX Trainer's unpadded one-device run, as
    ``tests/test_multichip.py::test_device_tables_with_candidate_padding``
    holds the JAX package's padded row-sharded step."""
    ranks = [r["wm_rows@1x2"] for r in runs["two"]]
    assert all(r["block_gather_bit_equal"] for r in ranks)
    _assert_same_run(runs["single"]["wm_rows"], runs["single"]["jax_wm"])
    _assert_same_run(ranks[0], runs["single"]["jax_wm"])


def _grads_close(got, want, rtol=RTOL):
    """Relative L2 of every parameter's gradient within ``rtol``."""
    assert set(got) == set(want)
    worst = max(float(np.linalg.norm(np.subtract(got[k], want[k]))
                      / max(np.linalg.norm(want[k]), 1e-30)) for k in want)
    assert worst <= rtol, worst
    return worst


def test_candidate_parallel_drin_equals_jax_padded_mesh(runs):
    """DRIN on a (2, 2) mesh, its candidates split over the model axis (C =
    11 padded to 12), equals the JAX Trainer on a padded (2, 2) mesh, as
    ``tests/test_multichip.py::test_candidate_padding_matches_unpadded`` and
    ``::test_trainer_autopads_candidates`` hold JAX; its first step's
    gradients equal one process's; every rank ends with the same weights."""
    ranks = [r["drin_cand@2x2"] for r in runs["four"]]
    jax_run = runs["single"]["jax_cand"]
    assert tuple(jax_run["cand_pad"]) == (11, 12)
    assert any("padded 11 -> 12" in line for line in jax_run["logs"])
    _assert_same_run(runs["single"]["drin_cand"], jax_run)  # one process, unpadded
    _assert_same_run(ranks[0], jax_run)
    assert len({r["digest"] for r in ranks}) == 1
    _grads_close(ranks[0]["grads"], runs["single"]["drin_cand"]["grads"])


@pytest.mark.parametrize("fault", ["nosum", "avg"])
def test_candidate_parallel_faults_fail_the_check(runs, fault):
    """Planted faults of the model axis must fail the check above: the
    message sum without its collective in the backward, and the gradient
    shares averaged over the model axis where the rule sums them.  Adam
    divides every gradient element by its own running scale, so a gradient
    off by one constant factor moves its steps by no more than Adam's eps
    does: the first step's gradients are where the averaged fault shows."""
    faulty = runs["four"][0][f"drin_cand_{fault}@2x2"]
    with pytest.raises(AssertionError):
        _grads_close(faulty["grads"], runs["single"]["drin_cand"]["grads"])
    if fault == "nosum":
        with pytest.raises(AssertionError):
            _assert_same_run(faulty, runs["single"]["jax_cand"])


def test_ranker_over_row_sharded_store_equals_jax(runs):
    """Every check of ``tests/test_serve.py::test_ranker_over_row_sharded_store``
    and ``::test_save_load_bundle_roundtrip``, on two ranks of the port."""
    want = runs["single"]["jax_serve"]
    for rank in runs["two"]:
        r = rank["serve_rows@1x2"]
        assert r["split"]  # C = 8 splits over the model axis: the reduce-scatter path
        np.testing.assert_allclose(r["base4"], want["score4"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["score4"], r["base4"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["score4"], want["score4"], rtol=1e-5, atol=1e-6)
        got3 = np.asarray(r["score3"])
        assert got3.shape == np.asarray(r["base3"]).shape == (3, 8)
        np.testing.assert_allclose(got3, r["base3"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got3, want["score3"], rtol=1e-5, atol=1e-6)
        s, i = (np.asarray(x) for x in r["rank3"])
        assert s.shape == (3, 3)
        np.testing.assert_allclose(s[:, 0], got3.max(-1), rtol=1e-6)
        # the store pads 25 -> 26 rows (13 a rank); nothing past n surfaces
        n = 25
        assert r["n_rows"] == n and r["block"] == r["text_rows"] == 13
        assert r["retrieval_rows"] == n and r["retrieval_finite"]
        for mode, (rs, ri) in r["retrieve"].items():
            rs, ri = np.asarray(rs), np.asarray(ri)
            assert ri.max() < n and np.isfinite(rs).all(), mode
            assert ri[0, 0] == 3 and ri[1, 0] == 17, mode
        # the bundle: n rows of every table and of obj_score, no phantom rows
        b = r["bundle"]
        assert b["n_rows"] == b["text_rows"] == b["obj_score_rows"] == n
        assert b["obj_score_equal"]
        np.testing.assert_allclose(b["score4"], want["score4"], rtol=1e-6, atol=1e-7)


def test_http_front_over_row_sharded_store(runs):
    """The front answers /rank (B=1, equal to one process's rank),
    /retrieve and /stats, refuses a bad k with 400, and stops its follower
    cleanly; a follower that fails makes the front answer 500 and stop with
    its fault set and its socket closed."""
    front, follower = (r["http_front@1x2"] for r in runs["two"])
    clean = front["clean"]
    code, body = clean["rank"]
    assert code == 200
    np.testing.assert_allclose(body["scores"], front["want"][0], rtol=1e-5, atol=1e-6)
    assert body["indices"] == front["want"][1]
    code, body = clean["retrieve"]
    assert code == 200 and [row[0] for row in body["indices"]] == [3, 17]
    assert max(max(row) for row in body["indices"]) < 25
    code, body = clean["stats"]
    assert code == 200 and body["entity_rows"] == 25
    assert clean["bad"][0] == 400
    assert clean["stopped"] and clean["fault"] is None
    assert follower["clean"] == {"returned": None}
    fault = front["fault"]
    assert fault["rank"][0] == 500 and "FollowerFault" in fault["rank"][1]["error"]
    assert fault["stopped"] and "FollowerFault" not in (fault["fault"] or "") and fault["fault"]
    assert fault["refused"]  # a later client is refused, not left waiting
    assert follower["fault"] == {"raised": "planted follower fault"}


def test_split_plain_gcn_layer_equals_jax_on_padded_candidates():
    """The plain GCN layer's split (part 1's message sums over two halves
    of the candidates, added, then part 2) against ``drin_tpu``'s
    ``GCNLayer`` on C = 11 padded to 12, and the whole layer likewise."""
    from drin_tpu_torch.models.drin import GCNLayer
    from drin_tpu_torch.ops.cuda import gcn_layer as tgcn

    cfg = tiny_config("wikimel", "drin", preprocess_dir="/tmp/unused-split-gcn",
                      num_candidates_data=10)
    C, Cp, B, D = cfg.num_candidates_model, 12, 3, cfg.gcn_embed_dim
    rng = np.random.default_rng(5)
    vertexes = [rng.standard_normal(s).astype(np.float32)
                for s in ((B, D), (B, D), (B, Cp, D), (B, Cp, D))]
    edges = [rng.uniform(0, 1, (B, Cp)).astype(np.float32) for _ in range(4)]
    jl = JaxGCNLayer(cfg)
    jparams = jl.init(jax.random.key(3), [jnp.asarray(v) for v in vertexes],
                      [jnp.asarray(e) for e in edges])
    want_v, want_e = jl.apply(jparams, [jnp.asarray(v) for v in vertexes],
                              [jnp.asarray(e) for e in edges])
    layer = GCNLayer(_port_cfg(cfg))
    sd = drin_state_dict_from_jax(
        {"vertex_encoder": {}, "gcn_0": jax.tree.map(np.asarray, jparams["params"])},
        cfg.replace(num_gcn_layers=1))
    layer.load_state_dict({k[len("gcn_layers.0."):]: v for k, v in sd.items()})
    T = lambda x: torch.from_numpy(x)
    edges_t = [T(e) * (torch.arange(Cp) < C).float()[None] for e in edges]  # the model's mask
    w = lambda m: m.detach()
    weights = [w(layer.w_h.weight), w(layer.w_h.bias), w(layer.layer_norm.weight),
               w(layer.layer_norm.bias), w(layer.w_u.weight), w(layer.w_u.bias),
               w(layer.w_v.weight), w(layer.w_v.bias)]
    kw = dict(vact=cfg.gcn_vertex_activation, eact=cfg.gcn_edge_activation, eps=1e-5)
    whole = tgcn.gcn_layer_plain([T(v) for v in vertexes], edges_t, *weights, num_candidates=C, **kw)
    # two halves of 6 candidates: part 1 on each, the sums added, part 2
    halves = []
    for lo, hi in ((0, 6), (6, 12)):
        halves.append(tgcn.gcn_layer_plain_entities(
            [T(vertexes[0]), T(vertexes[1])] + [T(v[:, lo:hi]).contiguous() for v in vertexes[2:]],
            [e[:, lo:hi].contiguous() for e in edges_t], *weights, **kw))
    msg = halves[0][0] + halves[1][0]
    men = tgcn.gcn_layer_plain_mentions(T(vertexes[0]), T(vertexes[1]), msg, *weights[:4], C,
                                        vact=kw["vact"], eps=1e-5)
    split_v = men + [torch.cat([halves[0][1][i], halves[1][1][i]], 1) for i in range(2)]
    split_e = [torch.cat([halves[0][2][i], halves[1][2][i]], 1) for i in range(4)]
    for got in ((whole[0], whole[1]), (split_v, split_e)):
        for g, w_ in zip(list(got[0]) + list(got[1]), list(want_v) + list(want_e)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=RTOL, atol=1e-6)


def test_two_rank_checkpoint_save_and_restore(runs):
    for rank in runs["two"]:
        r = rank["ckpt@2x1"]
        assert r["restored_epoch"] == W.FIT_EPOCHS and r["restored_step"] == r["step"] > 0
        assert r["restored_digest"] == r["digest"]
        assert r["files"] == [f"step_{r['step'] // 2}.pt", f"step_{r['step']}.pt"]
    assert runs["two"][0]["ckpt@2x1"]["digest"] == runs["two"][1]["ckpt@2x1"]["digest"]


def test_two_rank_online_bucketing_matches_single(runs):
    ranks = [r["online@2x1"] for r in runs["two"]]
    _assert_same_run(ranks[0], runs["single"]["online"])
    assert ranks[0]["digest"] == ranks[1]["digest"]


def _test_line(out: str) -> str:
    return [line for line in out.splitlines() if " test epoch " in line and " done: " in line][-1]


def test_train_entry_two_processes(tmp_path):
    """``python -m drin_tpu_torch.train ... num_processes=2`` on the CPU ends
    with exit 0 and the one-process run's test metrics."""
    from test_torch_train import _entry_args

    d = str(tmp_path / "store")
    cfg = tiny_config("wikidiverse", "drin", preprocess_dir=d)
    make_synthetic_store(cfg, n_mentions=10, seed=3)
    args = _entry_args(cfg, d, num_epoch=1, transformer_dropout=0.0)
    cmd = [sys.executable, "-m", "drin_tpu_torch.train"] + args
    one = subprocess.run(cmd, cwd=str(REPO), env=_env(), capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert one.returncode == 0, one.stderr[-4000:]
    rdv = tempfile.mktemp(dir=str(tmp_path))
    procs = [subprocess.Popen(cmd + ["num_processes=2", f"process_id={r}", "mesh_data=2",
                                     f"coordinator_address=file://{rdv}"],
                              cwd=str(REPO), env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            p.kill()
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se[-4000:]
    assert "model: drin" not in outs[1][0] and " test epoch " not in outs[1][0]  # rank 1 is quiet
    got, want = _test_line(outs[0][0]), _test_line(one.stdout)
    assert got.split(" done: ")[1].split(" (")[0] == want.split(" done: ")[1].split(" (")[0]


def test_nccl_refuses_two_ranks_on_one_device(monkeypatch):
    with pytest.raises(ValueError, match="dist_backend=gloo"):
        distributed.check_backend("nccl", local_ranks=2, n_devices=1)
    distributed.check_backend("nccl", local_ranks=2, n_devices=2)
    distributed.check_backend("gloo", local_ranks=2, n_devices=1)
    # through initialize: refused by name before any process group is joined
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: pytest.fail("joined before the check"))
    with pytest.raises(ValueError, match="NCCL cannot run two ranks on one device"):
        distributed.initialize(coordinator_address="127.0.0.1:1", num_processes=2, process_id=0,
                               device="cuda")
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")  # one rank a host: nothing shared
    assert distributed.local_world_size(2, "127.0.0.1:1") == 1
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert distributed.local_world_size(2, "10.0.0.9:1") == 1
    assert distributed.local_world_size(2, "localhost:1") == 2


@pytest.mark.parametrize("model_type", ["ghmfc", "melhi"])
def test_candidate_parallel_baseline_equals_one_process_and_jax(runs, model_type):
    """Offline GHMFC and MELHI on a (1, 4) mesh, their candidates split over
    the model axis (C = 10 padded to 12, 3 a rank), equal one process and
    the JAX Trainer on a (1, 4) mesh, as
    ``tests/test_multichip.py::test_baseline_padding_on_mesh_matches_single``
    holds JAX: both Trainers pad (10, 12) and log it; every rank ends with
    the same weights, and the first step's gradients equal one process's."""
    ranks = [r[f"{model_type}_cand@1x4"] for r in runs["four"]]
    single, jax_run = runs["single"][f"{model_type}_cand"], runs["single"][f"jax_{model_type}_cand"]
    assert tuple(jax_run["cand_pad"]) == tuple(ranks[0]["cand_pad"]) == (10, 12)
    assert all(r["split"] for r in ranks) and single["cand_pad"] is None
    for logs in (jax_run["logs"], ranks[0]["logs"]):
        assert any("candidate dim padded 10 -> 12" in line for line in logs), logs
    _assert_same_run(single, jax_run)
    _assert_same_run(ranks[0], single)
    _assert_same_run(ranks[0], jax_run)
    assert len({r["digest"] for r in ranks}) == 1
    _grads_close(ranks[0]["grads"], single["grads"])


@pytest.mark.parametrize("fault", ["melhi_cand_noor", "melhi_cand_localmask", "ghmfc_cand_gsum"])
def test_baseline_candidate_parallel_faults_fail_the_check(runs, fault):
    """Planted faults of the baselines' model axis must fail the first-step
    gradient check above: MELHI's gate without its OR over the group (some
    mentions' only open candidate lies in the last rank's block), MELHI's
    padded candidates masked at the block's local indices (the last rank's
    fakes then open a closed gate), and the score gather's backward summing
    the gradient over the group where it keeps the block."""
    faulty = runs["four"][0][f"{fault}@1x4"]
    with pytest.raises(AssertionError):
        _grads_close(faulty["grads"], runs["single"][f"{fault.split('_')[0]}_cand"]["grads"])


def test_row_sharded_ghmfc_candidate_parallel_equals_one_process(runs):
    """Offline GHMFC through the training entry point over WikiMEL's
    token-level tables row-sharded on a model axis of 2: candidate-parallel
    (C = 11 padded to 12), each gather a reduce-scatter that keeps the
    rank's block, equal to one process gathering on the host."""
    ranks = [r["ghmfc_rows_cand@1x2"] for r in runs["two"]]
    assert all(r["split"] and r["scattered"] and tuple(r["cand_pad"]) == (11, 12) for r in ranks)
    single = runs["single"]["ghmfc_rows_cand"]
    assert not single["split"] and not single["scattered"]
    _assert_same_run(ranks[0], single)
    assert ranks[0]["digest"] == ranks[1]["digest"]


def _no_key_bias(grads):
    """Every gradient but BERT's key biases: adding a constant to every key
    leaves the softmax as it is, so their exact gradient is 0 and both
    sides hold rounding noise (~1e-10 here)."""
    return {k: v for k, v in grads.items() if not k.endswith("attention.self.key.bias")}


def _same_step(got, want, rtol=RTOL):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=rtol)
    for k, v in want["counters"].items():
        assert got["counters"][k] == pytest.approx(v, rel=rtol, abs=1e-6), (k, got["counters"], v)


def test_candidate_parallel_online_direct_equals_jax_step(runs):
    """The online GHMFC in direct mode on a (2, 2) mesh (C = 7 padded to 8:
    each rank's BERT encodes 4 candidates of its 4 rows, rank 1 of each
    model group one all-masked fake) against the JAX step on a padded (2, 2)
    mesh, as ``tests/test_multichip.py::test_online_ghmfc_on_mesh_matches_single_device``
    holds JAX: the loss and counters of the step, and the scores after it
    (the parameters are not compared, for the reason that test gives)."""
    ranks = [r["online_cand@2x2"] for r in runs["four"]]
    want = runs["single"]["jax_online_cand"]
    assert all(r["split"] and tuple(r["cand_pad"]) == (7, 8) for r in ranks)
    for r in ranks:
        _same_step(r, want)
    # model index 0 of data rows 0 and 1; its model group holds the same scores
    assert ranks[0]["scores"] == ranks[1]["scores"] and ranks[2]["scores"] == ranks[3]["scores"]
    assert [ranks[0]["rows"], ranks[2]["rows"]] == [[0, 4], [4, 8]]
    scores = np.concatenate([ranks[0]["scores"], ranks[2]["scores"]])
    np.testing.assert_allclose(scores, want["scores"], rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("S", [4, 3])
def test_online_zipped_on_the_model_axis_equals_one_process(runs, S):
    """The online GHMFC in zipped mode on a (1, 2) mesh: with S = 4 each
    rank's BERT encodes its 2 sentences and they pool to its 2 * E candidate
    slots; with S = 3, which the axis does not divide, the model runs
    replicated.  Both equal one process: the loss, the counters, the first
    step's gradients and the scores after the step."""
    name = "online_zip" if S == 4 else "online_zip3"
    ranks = [r[f"{name}@1x2"] for r in runs["two"]]
    single = runs["single"][name]
    assert [r["split"] for r in ranks] == [S == 4] * 2 and not single["split"]
    for r in ranks:
        _same_step(r, single)
        np.testing.assert_allclose(r["scores"], single["scores"], rtol=RTOL, atol=1e-6)
        _grads_close(_no_key_bias(r["grads"]), _no_key_bias(single["grads"]))


def test_online_replicated_rule_under_a_split_fails_the_check(runs):
    """The loss backpropagated over the model width, the replicated rule,
    while the entity side is split (zipped, S = 4): the first step's
    gradients must fail the check above."""
    faulty = runs["two"][0]["online_zip_replicated@1x2"]
    assert faulty["split"]
    with pytest.raises(AssertionError):
        _grads_close(_no_key_bias(faulty["grads"]), _no_key_bias(runs["single"]["online_zip"]["grads"]))


def test_ghmfc_ranker_over_row_sharded_store_equals_jax(runs):
    """A GHMFC ``Ranker`` over the served store row-sharded on two ranks,
    candidate-parallel (every gather a reduce-scatter on both ranks), behind
    the HTTP front and its follower: ``score`` at B = 4 and B = 3, ``rank``
    and /rank B = 1 equal the one-device JAX ``Ranker``'s."""
    front, follower = (r["serve_ghmfc_rows@1x2"] for r in runs["two"])
    want = runs["single"]["jax_serve_ghmfc"]
    assert front["scattered"] and follower["scattered"] and follower["returned"] is None
    assert front["stopped"]
    np.testing.assert_allclose(front["score4"], want["score4"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(front["score3"], want["score3"], rtol=1e-5, atol=1e-6)
    s, i = (np.asarray(x) for x in front["rank3"])
    np.testing.assert_allclose(s, -np.sort(-want["score3"], -1)[:, :3], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.take_along_axis(want["score3"], i, -1), s, rtol=1e-5, atol=1e-6)
    code, body = front["http_rank"]
    assert code == 200
    np.testing.assert_allclose(body["scores"], -np.sort(-want["score4"][:1], -1)[:, :3], rtol=1e-5,
                               atol=1e-6)
