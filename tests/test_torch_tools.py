# -*- coding: utf-8 -*-
"""The port's data tools and native row gather against the JAX package's.

``drin_tpu_torch.tools.data_tools`` encodes and decodes the same archives
into the same bytes as ``drin_tpu.tools.data_tools`` (files, ``md5.json``,
the CLI's ``main(argv)``, a corrupted archive, a missing one).
``drin_tpu_torch.native.gather_rows`` returns what ``drin_tpu.native``'s
returns on ``tests/test_native.py``'s cases (dtypes, an mmap'd table, rows
below the native thresholds, out-of-range and negative rows, boolean and
float indices), and the port's ThreadSanitizer stress binary, built from
its own sources into ``build/``, runs clean."""

import os
import subprocess
import sys

import numpy as np
import pytest

import drin_tpu.native as jnative
from drin_tpu.tools import data_tools as jtools
from drin_tpu_torch import native as tnative
from drin_tpu_torch.tools import data_tools as ttools

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


def _archives(d, seed):
    rng = np.random.default_rng(seed)
    d.mkdir()
    for i, n in enumerate((4096, 33, 100_000)):
        (d / f"part{i}.zip").write_bytes(rng.integers(0, 256, n, dtype=np.uint8).tobytes())


@pytest.mark.parametrize("skip_checksum", [False, True])
def test_data_tools_bytes_equal_the_jax_packages(tmp_path, skip_checksum):
    raw, enc = ["part0.zip", "part1.zip", "part2.zip", "gone.zip"], [
        "a.mp4", "b.mp4", "c.mp4", "d.mp4"]
    logs, sums = {}, {}
    for name, tools in (("jax", jtools), ("port", ttools)):
        d = tmp_path / name
        _archives(d, seed=3)
        logs[name] = []
        sums[name] = tools.encode(str(d), raw, enc, skip_checksum, log=logs[name].append)
    assert sums["jax"] == sums["port"] and len(sums["port"]) == (0 if skip_checksum else 3)
    assert _tree(tmp_path / "jax") == _tree(tmp_path / "port")
    for name, tools in (("jax", jtools), ("port", ttools)):
        got = tools.decode(str(tmp_path / name), raw, enc, skip_checksum,
                           log=logs[name].append)
        assert got == {f: True for f in raw[:3]}
    assert _tree(tmp_path / "jax") == _tree(tmp_path / "port")
    assert [ln.replace("jax", "") for ln in logs["jax"]] == [
        ln.replace("port", "") for ln in logs["port"]]


def test_data_tools_cli_and_corruption_equal_the_jax_packages(tmp_path):
    for name in ("jax", "port"):
        _archives(tmp_path / name, seed=4)
    args = ["--raw_files", "part0.zip", "part2.zip", "--encoded_files", "x.mp4", "y.mp4"]
    jtools.main(["--encode", "--dir", str(tmp_path / "jax")] + args)
    out = subprocess.run([sys.executable, "-m", "drin_tpu_torch.tools.data_tools", "--encode",
                          "--dir", str(tmp_path / "port")] + args,
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "encoded part0.zip as x.mp4" in out.stdout
    assert _tree(tmp_path / "jax") == _tree(tmp_path / "port")
    for name, tools in (("jax", jtools), ("port", ttools)):
        data = bytearray((tmp_path / name / "y.mp4").read_bytes())
        data[100] ^= 0xFF
        (tmp_path / name / "y.mp4").write_bytes(bytes(data))
        got = tools.decode(str(tmp_path / name), ["part0.zip", "part2.zip"], ["x.mp4", "y.mp4"],
                           log=lambda *a: None)
        assert got == {"part0.zip": True, "part2.zip": False}
    assert _tree(tmp_path / "jax") == _tree(tmp_path / "port")


def _same(table, rows):
    """The port's gather against drin_tpu.native.gather_rows, which takes its
    library where tests/test_native.py has built it and numpy where not:
    the same rows either way (this file builds nothing in drin_tpu/)."""
    got = tnative.gather_rows(table, rows)
    want = jnative.gather_rows(table, rows)
    assert got.shape == want.shape and got.dtype == want.dtype and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64])
def test_gather_rows_matches_the_jax_package(dtype):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((700, 96)).astype(dtype)  # rows of 384 B: the native route
    rows = rng.integers(0, 700, size=(8, 33)).astype(np.int64)
    np.testing.assert_array_equal(_same(table, rows), table[rows])
    _same(table[:, :2], rows)  # rows of 8 B: numpy
    _same(table, rows[:1, :10])  # fewer than 64 rows: numpy
    _same(table, rows.astype(np.int32))


def test_gather_rows_mmap_table(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((300, 128)).astype(np.float32)
    np.save(tmp_path / "t.npy", arr)
    table = np.load(tmp_path / "t.npy", mmap_mode="r")
    rows = rng.integers(0, 300, size=(4, 50))
    np.testing.assert_array_equal(_same(table, rows), arr[rows])


def test_gather_rows_out_of_range_and_non_integer_rows():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((700, 96)).astype(np.float32)
    rows = rng.integers(0, 700, size=(8, 33)).astype(np.int64)
    rows[3, 7] = 700
    for gather in (tnative.gather_rows, jnative.gather_rows):
        with pytest.raises(IndexError):
            gather(table, rows)
    rows[3, 7] = -1  # numpy wraps a negative row
    _same(table, rows)
    _same(table, rng.uniform(size=700) < 0.5)  # a boolean mask selects
    for gather in (tnative.gather_rows, jnative.gather_rows):
        with pytest.raises(IndexError):
            gather(table, np.arange(64.0) + 0.5)


def test_gather_rows_native_failure_raises(monkeypatch):
    """Where the JAX package falls back to numpy when its C++ call fails,
    the port raises."""

    class Failing:
        def drin_gather_rows(self, *args):
            return 1

    monkeypatch.setattr(tnative, "load", lambda: Failing())
    table = np.zeros((100, 96), np.float32)
    with pytest.raises(RuntimeError, match="native row gather failed"):
        tnative.gather_rows(table, np.arange(64))
    assert tnative.gather_rows(table, np.arange(8)).shape == (8, 96)  # numpy's route


def test_create_datasets_gathers_natively(wm_cfg, monkeypatch):
    """The port's create_datasets reads the global WikiMEL tables through
    gather_rows, as the JAX package's does."""
    from drin_tpu_torch.data import dataset

    calls = []
    real = tnative.gather_rows
    monkeypatch.setattr(tnative, "gather_rows", lambda t, r: calls.append(r.shape) or real(t, r))
    train, _, _ = dataset.create_datasets(wm_cfg)
    next(train.batches(4, kind="drin"))
    assert calls


def test_sources_are_the_jax_packages():
    theirs = os.path.join(os.path.dirname(jnative.__file__), "src")
    for src in (tnative.GATHER_SRC, tnative.TSAN_SRC, tnative.SRC):
        with open(os.path.join(theirs, src.name), "rb") as f:
            assert src.read_bytes() == f.read(), src.name


def test_tsan_stress_runs_clean():
    """The ThreadSanitizer stress binary over the gather and the tokenizer,
    built from the port's sources into build/ (skipped where TSan cannot
    build, as tests/test_native.py skips)."""
    try:
        binary = tnative.build_tsan_stress()
    except RuntimeError as e:
        pytest.skip(f"tsan build unsupported here: {str(e)[-500:]}")
    assert binary.parent == tnative.BUILD_DIR
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1 exitcode=66")
    run = subprocess.run([str(binary)], capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, f"tsan: {run.stdout}\n{run.stderr}"
    assert "ThreadSanitizer" not in run.stderr and "ok" in run.stdout
