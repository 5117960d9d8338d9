# -*- coding: utf-8 -*-
"""Package rules of the PyTorch port: no JAX anywhere in ``drin_tpu_torch``
or ``chip_smoke.py``, nothing built at import, no CPU fallback on CUDA."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax"}
JAX_MODULES = ("drin_tpu.data.device_store", "drin_tpu.serve", "drin_tpu.ops",
               "drin_tpu.nn", "drin_tpu.models.drin", "drin_tpu.models.ghmfc",
               "drin_tpu.parallel", "drin_tpu.train", "drin_tpu.encoders")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "drin_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
        assert not mod.startswith(JAX_MODULES), (path, mod)


def test_import_builds_nothing_and_pulls_in_no_jax(tmp_path):
    """Importing every port module in a fresh interpreter loads no jax and
    starts no kernel build."""
    code = (
        "import sys, importlib, pkgutil, drin_tpu_torch\n"
        "for m in pkgutil.walk_packages(drin_tpu_torch.__path__, 'drin_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from drin_tpu_torch.ops.cuda import _build\n"
        "assert not _build._libs, _build._libs\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_build_without_nvcc_raises_and_never_falls_back(tmp_path, monkeypatch):
    from drin_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("gcn_layer")
    lib = _build.library_path("gather_dequant")
    assert lib.parent == tmp_path / "build" and lib.name.startswith("libgather_dequant-")
    assert _build.library_path("gather_dequant") == lib  # keyed by the sources


def test_ranker_on_cuda_without_cuda_raises(monkeypatch):
    import torch

    from drin_tpu.data.synthetic import tiny_config
    from drin_tpu_torch.models.drin import DRIN
    from drin_tpu_torch.serve import Ranker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config("wikimel", "drin", preprocess_dir="/tmp/unused-torch-pkg")
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        Ranker(cfg, DRIN(cfg).state_dict(), device="cuda")


def test_package_data_lists_kernel_sources():
    text = (ROOT / "pyproject.toml").read_text()
    assert '"drin_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh"]' in text
    assert sorted(p.name for p in (ROOT / "drin_tpu_torch" / "csrc").iterdir()) == [
        "common.cuh", "gather_dequant.cu", "gcn_layer.cu"]
