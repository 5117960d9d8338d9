# -*- coding: utf-8 -*-
"""Package rules of the PyTorch port: no JAX and nothing of the JAX package
``drin_tpu`` anywhere in ``drin_tpu_torch`` or ``chip_smoke.py``, nothing
built at import, no CPU fallback on CUDA, no library attention; and the
port's own copies of the jax-free ``drin_tpu/common`` modules stay equal to
their originals."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the five JAX distributions, and the JAX package itself: the port keeps its
# own copy of whatever it needs from there, jax-free modules included
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "drin_tpu"}
PORT_FILES = sorted((ROOT / "drin_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_the_scan_covers_every_port_subpackage():
    scanned = {p.parent.name for p in PORT_FILES}
    packages = {p.parent.name for p in (ROOT / "drin_tpu_torch").rglob("__init__.py")}
    assert packages <= scanned and {"text", "preprocess", "data", "ops", "parallel"} <= packages


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
    # nor by name at run time (importlib.import_module("drin_tpu..."), __import__)
    text = path.read_text()
    for call in ("import_module(", "__import__("):
        assert call not in text, (path, call)


def test_import_builds_nothing_and_pulls_in_no_jax(tmp_path):
    """Importing every port module in a fresh interpreter loads no jax,
    nothing of ``drin_tpu``, and starts no kernel build."""
    code = (
        "import sys, importlib, pkgutil, drin_tpu_torch\n"
        "for m in pkgutil.walk_packages(drin_tpu_torch.__path__, 'drin_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from drin_tpu_torch.ops.cuda import _build\n"
        "from drin_tpu_torch import native\n"
        "assert not _build._libs and native._lib is None, (_build._libs, native._lib)\n"
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
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(("gather_dequant", "gcn_layer", "attention"))


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
        "attention.cu", "attention_bwd.cu", "attention_common.cuh", "common.cuh",
        "gather_dequant.cu", "gcn_layer.cu", "hopper.cuh", "linear_f32.cu", "nms.cu", "ssd_scan.cu"]
    from drin_tpu_torch.ops.cuda import _build

    assert _build.KERNELS == ("gather_dequant", "gcn_layer", "attention", "attention_bwd", "nms",
                              "ssd_scan", "linear_f32")
    # the native sources (tokenizer, row gather, TSan harness) are the port's
    # own copies, built from its own directory, and include nothing but the
    # C++ standard library
    assert '"drin_tpu_torch.native" = ["src/*.cpp"]' in text
    from drin_tpu_torch import native

    assert native.SRC.parent == ROOT / "drin_tpu_torch" / "native" / "src"
    assert sorted(p.name for p in native.SRC.parent.iterdir()) == [
        "gather.cpp", "tsan_stress.cpp", "wordpiece.cpp"]
    for src in native.SRC.parent.iterdir():
        includes = [ln for ln in src.read_text().splitlines() if ln.startswith("#include")]
        assert includes and all(ln.split()[1].startswith("<") for ln in includes), (src, includes)


def test_no_library_attention_in_the_port():
    """The attention kernel is the port's own: no fused PyTorch attention
    and no compiler stands in for it anywhere in the package.  The one file
    that names PyTorch's fused attention is the sweep tool, which times it as
    a yardstick beside the kernels, is run by hand on the card, and is
    imported by nothing else in the package."""
    yardstick = ROOT / "drin_tpu_torch" / "tools" / "attention_sweep.py"
    assert "scaled_dot_product_attention" in yardstick.read_text()
    for path in (ROOT / "drin_tpu_torch").rglob("*"):
        if path.suffix in (".py", ".cu", ".cuh"):
            text = path.read_text()
            if path != yardstick:
                for word in ("scaled_dot_product_attention", "torch.compile",
                             "nn.MultiheadAttention("):
                    assert word not in text, (path, word)
                imports = [ln for ln in text.splitlines()
                           if ln.lstrip().startswith(("import ", "from "))]
                assert not any("drin_tpu_torch.tools" in ln or "attention_sweep" in ln for ln in imports), path
            else:
                assert "torch.compile" not in text and "nn.MultiheadAttention(" not in text


CONFIG_CASES = [(m, d, {}) for m in ("drin", "ghmfc", "melhi") for d in ("wikimel", "wikidiverse")]
CONFIG_CASES += [("drin", "wikimel", {"debug": True}),
                 ("ghmfc", "wikimel", {"online_bert": True, "finetune_bert": False,
                                       "compute_dtype": "bfloat16", "num_candidates_data": 50}),
                 ("ghmfc", "wikidiverse", {"debug": True, "entity_final_pooling": "max"})]


@pytest.mark.parametrize("model_type,dataset,kw", CONFIG_CASES,
                         ids=[f"{m}-{d}-{'-'.join(k) or 'defaults'}" for m, d, k in CONFIG_CASES])
def test_make_config_equals_the_jax_package(model_type, dataset, kw):
    """The port's copy of the configuration cannot drift unseen: every
    field, property and default equals ``drin_tpu``'s."""
    import dataclasses

    from drin_tpu.common import config as jconfig
    from drin_tpu_torch.common import config as tconfig

    ours = tconfig.make_config(model_type, dataset, **kw)
    theirs = jconfig.make_config(model_type, dataset, **kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    for prop in ("num_candidates_model", "entity_pooling_cached", "object_topk"):
        assert getattr(ours, prop) == getattr(theirs, prop)
    assert tconfig.config_summary(ours) == jconfig.config_summary(theirs)
    assert (tconfig.CLS_TOKEN_ID, tconfig.SEP_TOKEN_ID) == (jconfig.CLS_TOKEN_ID,
                                                            jconfig.SEP_TOKEN_ID)
    # either package's Config serves the port: it reads attributes only
    assert dataclasses.asdict(ours.replace(batch_size=3)) == dataclasses.asdict(
        theirs.replace(batch_size=3))


def test_make_config_rejects_what_the_jax_package_rejects():
    from drin_tpu.common import config as jconfig
    from drin_tpu_torch.common import config as tconfig

    for mod in (tconfig, jconfig):
        with pytest.raises(Exception):
            mod.make_config("drin", "wikimel", no_such_field=1)
        with pytest.raises(Exception):
            mod.make_config("drin", "no-such-dataset")


@pytest.mark.parametrize("argv", [
    [], ["a=1", "b=2.5", "c=true", "d=False", "e=none", "f=text"], ["--port=0", "--host=::1"],
    ["topk=(1,5,10)", "edges=[1,0,0,1]", "name='quoted'"], ["path=/data/wikimel", "x=1e-3"],
    ["k=a=b"], ["novalue"]])
def test_parse_overrides_equals_the_jax_package(argv):
    from drin_tpu.common.cli import parse_overrides as theirs
    from drin_tpu_torch.common.cli import parse_overrides as ours

    if argv == ["novalue"]:
        for fn in (ours, theirs):
            with pytest.raises(SystemExit, match="expected key=value"):
                fn(argv)
        return
    got, want = ours(argv), theirs(argv)
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]


def test_port_data_copies_equal_the_jax_package(tmp_path):
    """Batch layouts, the entity-table pooling and the .npy naming contract
    of the port's own data modules equal their originals."""
    import numpy as np

    from drin_tpu.common import npy_io as jnpy
    from drin_tpu.data import dataset as jdata
    from drin_tpu_torch.common import npy_io as tnpy
    from drin_tpu_torch.data import dataset as tdata

    assert tdata.DrinBatch._fields == jdata.DrinBatch._fields
    assert tdata.BaselineBatch._fields == jdata.BaselineBatch._fields
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((9, 6, 4)).astype(np.float32)
    mask = (np.arange(6)[None] < rng.integers(0, 7, 9)[:, None]).astype(np.int64)
    np.testing.assert_array_equal(tdata.pool_entity_table(feats, mask, chunk=4),
                                  jdata.pool_entity_table(feats, mask, chunk=4))
    jnpy.save_field(str(tmp_path), "entity_attr_feature", feats)
    jnpy.save_field(str(tmp_path), "entity_object_score", mask, "all")
    np.testing.assert_array_equal(tnpy.load_field(str(tmp_path), "entity_attr_feature"), feats)
    got = tnpy.load_field(str(tmp_path), "entity_object_score", "all", mmap="r")
    np.testing.assert_array_equal(got, mask)
    assert isinstance(got, np.memmap)


@pytest.mark.parametrize("ds", ["wikidiverse", "wikimel"])
def test_synthetic_store_and_datasets_equal_the_jax_package(tmp_path, ds):
    """``tiny_config`` field for field, ``make_synthetic_store`` byte for
    byte, and every batch kind of ``MELFeatureDataset`` bit for bit."""
    import dataclasses
    import filecmp

    import numpy as np

    from drin_tpu.data import dataset as jdata, synthetic as jsyn
    from drin_tpu.data.device_store import BaselineRowsBatch as JaxBaselineRows
    from drin_tpu.data.device_store import DrinRowsBatch as JaxRows
    from drin_tpu_torch.data import dataset as tdata, synthetic as tsyn
    from drin_tpu_torch.data.device_store import BaselineRowsBatch, DrinRowsBatch

    assert DrinRowsBatch._fields == JaxRows._fields
    assert BaselineRowsBatch._fields == JaxBaselineRows._fields
    kw = dict(entity_text_type="name") if ds == "wikidiverse" else {}
    for model_type in ("drin", "ghmfc"):
        assert dataclasses.asdict(tsyn.tiny_config(ds, model_type, preprocess_dir="x", **kw)) == \
            dataclasses.asdict(jsyn.tiny_config(ds, model_type, preprocess_dir="x", **kw))
    dirs = {}
    for name, syn in (("jax", jsyn), ("port", tsyn)):
        for learnable in (False, True):
            d = str(tmp_path / f"{name}-{learnable}")
            cfg = syn.tiny_config(ds, "drin", preprocess_dir=d, **kw)
            assert syn.make_synthetic_store(cfg, n_mentions=9, n_entities=20, seed=4,
                                            learnable=learnable) == d
            dirs[name, learnable] = d
    for learnable in (False, True):
        a, b = dirs["jax", learnable], dirs["port", learnable]
        files = sorted(os.listdir(a))
        assert files == sorted(os.listdir(b)) and len(files) >= 12
        match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
        assert not mismatch and not errors, (mismatch, errors)
    for cache in (True, False):
        d = dirs["port", False]
        jcfg = jsyn.tiny_config(ds, "drin", preprocess_dir=d, cache_entity_pooling=cache, **kw)
        tcfg = tsyn.tiny_config(ds, "drin", preprocess_dir=d, cache_entity_pooling=cache, **kw)
        for jsplit, tsplit in zip(jdata.create_datasets(jcfg), tdata.create_datasets(tcfg)):
            assert len(jsplit) == len(tsplit)
            idx = np.array([2, 0, 1])
            kinds = ["drin", "baseline"] + (["drin_rows", "baseline_rows"] if ds == "wikimel"
                                            else [])
            for kind in kinds:
                jb, tb = jsplit.make_batch(idx, kind), tsplit.make_batch(idx, kind)
                assert type(jb)._fields == type(tb)._fields
                for name, x, y in zip(type(jb)._fields, jb, tb):
                    assert x.dtype == y.dtype and x.shape == y.shape, (kind, name)
                    np.testing.assert_array_equal(x, y, err_msg=f"{kind}.{name}")
            np.testing.assert_array_equal(jsplit.labels(idx), tsplit.labels(idx))
            jall = list(jsplit.batches(2, shuffle=True, seed=5, kind="drin", pad_to_full=True))
            tall = list(tsplit.batches(2, shuffle=True, seed=5, kind="drin", pad_to_full=True))
            assert len(jall) == len(tall)
            for jb, tb in zip(jall, tall):
                np.testing.assert_array_equal(jb.mention_text_feature, tb.mention_text_feature)
    with pytest.raises(ValueError, match="num_candidates_data"):
        tdata.MELFeatureDataset(tcfg.replace(num_candidates_data=9), "train",
                                getattr(tsplit, "tables", None))


def test_batch_index_helpers_equal_the_jax_package():
    import numpy as np

    from drin_tpu.data import dataset as jdata
    from drin_tpu_torch.data import dataset as tdata

    for kw in (dict(), dict(shuffle=True, seed=3), dict(drop_remainder=True),
               dict(shuffle=True, seed=1, pad_to_full=True)):
        for n, b in ((10, 4), (3, 8), (8, 4)):
            got = list(tdata.iter_batch_indices(n, b, **kw))
            want = list(jdata.iter_batch_indices(n, b, **kw))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tdata.make_onehot_lookup(5), jdata.make_onehot_lookup(5))
    ans = np.array([0, 3, 5, 4])
    np.testing.assert_array_equal(tdata.gold_labels(ans, 6), jdata.gold_labels(ans, 6))


def test_prefetcher_equals_the_jax_package():
    """Order, transform, error propagation and close, for both copies."""
    import threading

    from drin_tpu.data.prefetch import Prefetcher as Theirs
    from drin_tpu_torch.data.prefetch import Prefetcher as Ours

    for cls in (Ours, Theirs):
        assert list(cls(range(7), lambda x: x * x, depth=2)) == [i * i for i in range(7)]
        assert list(cls([], None)) == []

        def boom():
            yield 1
            raise KeyError("source failed")

        it = cls(boom())
        assert next(it) == 1
        with pytest.raises(KeyError, match="source failed"):
            next(it)
        before = threading.active_count()
        with cls(iter(range(1000)), depth=1) as pf:  # abandoned early: close() joins the worker
            assert next(pf) == 0
        assert not pf._thread.is_alive() and pf._q.empty()
        assert threading.active_count() <= before


def test_text_copies_equal_the_jax_package():
    """The tokenizer's rules and the span conversion are the JAX package's
    code line for line (its native fast path is held id for id in
    tests/test_torch_native.py), and ``BertTokenizer`` gives the same ids on
    a few strings of each kind."""
    import inspect

    import numpy as np

    from drin_tpu.preprocess import prepare as jprep
    from drin_tpu.text import wordpiece as jwp
    from drin_tpu_torch.preprocess import prepare as tprep
    from drin_tpu_torch.text import wordpiece as twp

    same = [lambda m: m._is_whitespace, lambda m: m._is_control, lambda m: m._is_punctuation,
            lambda m: m._is_chinese_char, lambda m: m.BasicTokenizer,
            lambda m: m.WordPieceTokenizer.tokenize, lambda m: m.BertTokenizer.tokenize]
    for get in same:
        assert inspect.getsource(get(twp)) == inspect.getsource(get(jwp)), get(twp)
    assert inspect.getsource(tprep.MentionPositionProcessor.__call__) == inspect.getsource(
        jprep.MentionPositionProcessor.__call__)
    texts = ["Café naïve", "東京 x", "a\x00b\u3000c", "x" * 101, "", "end."]
    vocab = jwp.build_tiny_vocab(texts)
    assert twp.build_tiny_vocab(texts) == vocab
    ours = twp.BertTokenizer(vocab=vocab, model_max_length=4)
    theirs = jwp.BertTokenizer(vocab=vocab, model_max_length=4)
    for kw in (dict(), dict(padding="max_length", truncation=True)):
        np.testing.assert_array_equal(ours(texts, **kw)["input_ids"],
                                      theirs(texts, **kw)["input_ids"])
