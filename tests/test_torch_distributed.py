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

from drin_tpu.data.dataset import create_datasets as jax_create_datasets
from drin_tpu.data.synthetic import make_synthetic_online_store, make_synthetic_store, tiny_config
from drin_tpu.models.drin import DRIN as JaxDRIN
from drin_tpu.parallel import mesh as jax_mesh
from drin_tpu.train import metrics as JM
from drin_tpu.train.trainer import Trainer as JaxTrainer
from drin_tpu_torch.common.config import make_config
from drin_tpu_torch.models import get_model
from drin_tpu_torch.models.convert import drin_state_dict_from_jax
from drin_tpu_torch.parallel import distributed

import torch_dist_worker as W

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_dist_worker.py")
RTOL = 2e-4
TIMEOUT = 300
FOUR = "drin@4x1,drin@2x2,psum@4x1,drin_local_loss@4x1"
TWO = "wm_rows@1x2,ckpt@2x1,online@2x1"


def _port_cfg(cfg):
    d = dataclasses.asdict(cfg)
    return make_config(d.pop("model_type"), d.pop("dataset_name"), **d)


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


def _jax_drin(cfg, params, dump):
    """The JAX Trainer on a (4, 1) mesh of virtual CPU devices."""
    train, valid, test = jax_create_datasets(cfg)
    model = JaxDRIN(cfg)
    example = next(test.batches(cfg.batch_size, kind="drin", pad_to_full=True))
    mesh = jax_mesh.make_mesh(devices=jax.devices()[:4], data=4, model=1)
    tr = JaxTrainer(cfg, lambda p, f: model.apply({"params": p}, f), params, mesh,
                    batch_fields=type(example)._fields, example_batch=example, log=lambda *a: None,
                    output_test_result_path=dump)
    epochs = []
    W._record_epochs(tr, epochs)
    tr.fit(train, valid, W.FIT_EPOCHS, kind="drin")
    test_out = tr.test(test, kind="drin")
    sd = drin_state_dict_from_jax(jax.device_get(tr.state.params), _port_cfg(cfg))
    with open(dump) as f:
        text = f.read()
    return {"epochs": epochs, "test_loss": test_out["loss"],
            "test_accs": {str(k): v for k, v in test_out["accs"].items()},
            "digest": W.digest(sd), "step": int(tr.state.step), "dump": text}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch-dist")
    wd, wm, online = (str(root / n) for n in ("wd", "wm", "online"))
    wd_cfg = tiny_config("wikidiverse", "drin", preprocess_dir=wd).replace(
        batch_size=8, learning_rate=3e-3, transformer_dropout=0.0, output_test_result=True)
    make_synthetic_store(wd_cfg, n_mentions=19, seed=6)  # ragged tails in every split
    wm_cfg = tiny_config("wikimel", "drin", preprocess_dir=wm).replace(cache_entity_pooling=False)
    make_synthetic_store(wm_cfg, n_mentions=14, n_entities=30, seed=27)
    make_synthetic_online_store(online, n=8, write=True)
    example = next(jax_create_datasets(wd_cfg)[2].batches(8, kind="drin", pad_to_full=True))
    params = jax.tree.map(np.asarray, JaxDRIN(wd_cfg).init(
        jax.random.key(0), tuple(np.asarray(x) for x in example[:-1]))["params"])
    scratch = root / "scratch"
    scratch.mkdir()
    spec = {"wd": wd, "wm": wm, "online": online, "scratch": str(scratch),
            "drin_weights": str(root / "drin.pt"), "wm_weights": str(root / "wm.pt")}
    torch.save(drin_state_dict_from_jax(params, _port_cfg(wd_cfg)), spec["drin_weights"])
    torch.save(get_model(W.wm_cfg(wm), torch.Generator().manual_seed(0))[0].state_dict(),
               spec["wm_weights"])
    spec_path = str(root / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    # both worlds run while this process computes the references
    four, two = _launch(4, FOUR, spec_path, root), _launch(2, TWO, spec_path, root)
    torch.set_num_threads(1)
    single = {"drin": W.scenario_drin(spec, None), "wm_rows": W.scenario_wm_rows(spec, None),
              "online": W.scenario_online(spec, None),
              "jax": _jax_drin(wd_cfg, params, str(scratch / "jax-dump.txt"))}
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
