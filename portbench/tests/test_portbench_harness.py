"""The harness itself: the import guard, the data-driven registry, the CPU
rehearsal of every cell, a measuring run without a card, and the check
seeing each fault a cell can have."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness

ROOT = os.path.dirname(harness.PKG)
RUN = os.path.join(harness.PKG, "run.py")
BENCH = harness.Bench(ROOT)
CELLS = [w["name"] for w in BENCH.spec["workloads"]] + BENCH.parked()


def _imports(path: str) -> set:
    """Top-level names of every module a file imports."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def _sources(*parts):
    top = os.path.join(harness.PKG, *parts)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_jax_or_the_jax_package():
    for path in _sources():
        found = harness.forbidden_modules(_imports(path))
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = _imports(path)
        assert not names & {"drin_tpu_torch", "drin_tpu", "jax", "jaxlib", "flax"}, (path, names)


def test_the_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(["drin_tpu_torch", "drin_tpu_torch.serve", "jaxtyping",
                                      "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["drin_tpu.models", "jax.numpy", "jaxlib", "flax"]) == \
        ["drin_tpu", "flax", "jax", "jaxlib"]


def test_benchmark_json_validates():
    assert harness.Bench(ROOT).validate() == []


def test_a_parked_cell_runs_but_is_no_workload():
    """``drin-train-b64`` is parked: the driver's check never runs it, and a
    run of it by hand reports only ``setup_s``."""
    bench = harness.Bench(ROOT)
    assert bench.parked() == ["drin-train-b64"]
    assert "drin-train-b64" not in [w["name"] for w in bench.spec["workloads"]]
    assert bench.workload("drin-train-b64") == {"name": "drin-train-b64",
                                                "config": "drin-wikimel", "chips": 1}
    assert [m["name"] for m in bench.metrics_for("drin-train-b64", "end_to_end")] == ["setup_s"]
    assert bench.metrics_for("drin-train-b64", "per_layer") == []
    with pytest.raises(KeyError):
        bench.workload("no-such-cell")


def _rehearse(workload, root=ROOT, seed=3_000_000_021, seconds=1, extra=()):
    proc = subprocess.run([sys.executable, os.path.join(root, "portbench", "run.py"),
                           "--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", "0", "--rehearse", *extra],
                          cwd=root, capture_output=True, text=True, timeout=600)
    return proc


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_rehearses_on_the_cpu(workload):
    proc = _rehearse(workload)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out
    assert out["metrics"] == {} and out["device"] == {"platform": "cpu"}  # no device metric
    assert list(out)[-1] == "checks" and out["attempted"] > 0 and out["failed"] == 0
    last = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in last), last


def test_a_measuring_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run([sys.executable, RUN, "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_run_without_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _rehearse(CELLS[0], root=str(tmp_path))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_new_cells_and_metrics_come_as_new_files(tmp_path):
    """A copy gains a configuration, a cell and a metric as new files (and
    their entries in BENCHMARK.json); the harness finds, validates and runs
    them with no edit to a file it had."""
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in _sources_in(tmp_path / "portbench")}
    pb = tmp_path / "portbench"
    cfg = json.load(open(pb / "configs" / "drin-wikimel.json"))
    cfg["num_gcn_layers"] = 1
    json.dump(cfg, open(pb / "configs" / "drin-one-layer.json", "w"))
    shutil.copy(pb / "rehearsal" / "drin-wikimel.json", pb / "rehearsal" / "drin-one-layer.json")
    cell = json.load(open(pb / "cells" / "drin-rank-b64.json"))
    cell.update(config="drin-one-layer", batch=32)
    json.dump(cell, open(pb / "cells" / "drin-one-layer-rank-b32.json", "w"))
    shutil.copy(pb / "rehearsal" / "drin-rank-b64.json", pb / "rehearsal" / "drin-one-layer-rank-b32.json")
    (pb / "metrics" / "calls_per_s.rank.py").write_text(
        "def read(m):\n    return m.rec['calls'] / m.trace.window_s()\n")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["configs"].append({"name": "drin-one-layer", "source": "a test", "reduced": ["num_gcn_layers"],
                            "file": "portbench/configs/drin-one-layer.json", "why": "a test"})
    spec["workloads"].append({"name": "drin-one-layer-rank-b32", "config": "drin-one-layer",
                              "traffic": "rank-b32", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "calls_per_s.rank", "unit": "calls/s", "better": "higher",
                              "source": "device_trace", "layer": "serve", "moves": "rank_pairs_per_s",
                              "workloads": ["drin-one-layer-rank-b32"]})
    for w in spec["end_to_end"]:
        if w["name"] == "rank_pairs_per_s":
            w["workloads"].append("drin-one-layer-rank-b32")
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    bench = harness.Bench(str(tmp_path), str(pb))
    assert bench.validate() == []
    assert "calls_per_s.rank" in [m["name"] for m in
                                  bench.metrics_for("drin-one-layer-rank-b32", "per_layer")]
    assert {p: open(p, "rb").read() for p in before} == before
    os.symlink(os.path.join(ROOT, "drin_tpu_torch"), tmp_path / "drin_tpu_torch")
    proc = _rehearse("drin-one-layer-rank-b32", root=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True


def _sources_in(top):
    for d, _, files in os.walk(top):
        for f in files:
            yield os.path.join(d, f)


# -- the check sees each fault a cell can have -------------------------------
def _execute(workload, seconds=0.5):
    bench = harness.Bench(ROOT)
    run = harness.Run(bench, workload, 3_000_000_023, seconds, False, True, False,
                      torch.device("cpu"))
    driver = bench.module("drivers", run.cell["driver"])
    result, checks = harness.execute(run, driver, harness.now())
    return result, checks


def _alter_answer(monkeypatch):
    """A top-k index altered where the ranker produces it."""
    from drin_tpu_torch.serve import Ranker

    rank = Ranker._rank

    def altered(self, feats, k):
        vals, idx = rank(self, feats, k)
        idx = idx.copy()
        idx[0, 0] = (idx[0, 0] + 1) % self.cfg.num_candidates_model
        return vals, idx

    monkeypatch.setattr(Ranker, "_rank", altered)


@pytest.mark.parametrize("workload", [w for w in CELLS if w != "drin-train-b64"])
def test_an_altered_answer_fails_the_check(monkeypatch, workload):
    assert _execute(workload)[0]["correct"] is True
    _alter_answer(monkeypatch)
    result, checks = _execute(workload)
    assert result["correct"] is False, checks


def test_a_step_that_leaves_the_state_unchanged_fails_the_check(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result, checks = _execute("drin-train-b64")
    assert result["correct"] is False and checks["step_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_fails_the_check(monkeypatch):
    from drin_tpu_torch.train import trainer as tr

    loss = tr.triplet_loss

    def half(y_true, y_pred, margin, valid=None, rows=None):
        n = y_pred.shape[0] // 2
        return loss(y_true[:n], y_pred[:n], margin, None if valid is None else valid[:n])

    monkeypatch.setattr(tr, "triplet_loss", half)
    result, checks = _execute("drin-train-b64")
    assert result["correct"] is False, checks


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products need a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_check(cuda_device, workload):
    """The reference in one TF32 pass in the program's place, at the cell's
    own sizes, a short window: ``correct`` comes out false."""
    proc = subprocess.run([sys.executable, RUN, "--workload", workload, "--seed", "3000000031",
                           "--seconds", "2", "--trace", "0", "--control", "1"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is False
