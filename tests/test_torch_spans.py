# -*- coding: utf-8 -*-
"""The port's spans (``drin_tpu_torch/common/spans.py``): nothing with the
profiler off, nested ranges under a CPU ``torch.profiler``, and the spans of
a traced ``Ranker.rank`` (DRIN and the online GHMFC) and of a traced
``Trainer`` epoch.  Nesting is read from the times: a span lies inside
another when its interval does."""

import gc
import threading
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from drin_tpu_torch.common import spans as S
from drin_tpu_torch.common.spans import span
from drin_tpu_torch.models.convert import drin_state_dict_from_jax
from drin_tpu_torch.serve import Ranker
from tests.test_torch_serve import _online_ranker, online, wm128  # noqa: F401

SERVE = ("drin.serve.prepare", "drin.serve.gather", "drin.serve.forward", "drin.serve.result")


def _profiled(fn):
    """(fn's result, the spans it closed, the profiler's range names)."""
    S.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, S.spans(), {e.name for e in prof.events()}


def _inside(log, outer, names=None):
    """The spans of ``log`` inside ``outer``'s interval, by start."""
    return sorted((s for s in log if s is not outer and (names is None or s.name in names)
                   and outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns),
                  key=lambda s: s.start_ns)


def _ranker(wm128):
    cfg, tables, params, _ = wm128
    return Ranker(cfg, drin_state_dict_from_jax(params, cfg), tables, device="cpu",
                  quantize_store=True, fused_gather=True)


def _one(log, name):
    found = [s for s in log if s.name == name]
    assert len(found) == 1, (name, found)
    return found[0]


def test_off_records_nothing_and_never_enters_record_function(monkeypatch, wm128):
    entered = []
    monkeypatch.setattr(S, "_record_function", lambda name: entered.append(name))
    S.clear()
    with span("drin.test.off") as s:
        pass
    assert s is S.OFF and S.spans() == [] and entered == []
    ranker = _ranker(wm128)
    ranker.rank(tuple(wm128[3][:-1]), 3)
    ranker.score(tuple(wm128[3][:-1]))
    assert S.spans() == [] and entered == []


def test_spans_nest_and_show_as_profiler_ranges():
    def worker():
        with span("drin.test.thread"):
            with span("drin.test.thread.child"):
                pass

    def run():
        with span("drin.test.outer"):
            with span("drin.test.inner"):
                th = threading.Thread(target=worker)
                th.start()
                th.join(timeout=30)
                assert not th.is_alive()
            with span("drin.test.second"):
                pass
        with span("drin.test.next"):
            pass

    _, log, ranges = _profiled(run)
    # in the order they closed; the worker's inside inner, which was open
    assert [s.name for s in log] == ["drin.test.thread.child", "drin.test.thread",
                                     "drin.test.inner", "drin.test.second", "drin.test.outer",
                                     "drin.test.next"]
    outer, nxt = _one(log, "drin.test.outer"), _one(log, "drin.test.next")
    assert [s.name for s in _inside(log, outer)] == [
        "drin.test.inner", "drin.test.thread", "drin.test.thread.child", "drin.test.second"]
    assert _inside(log, nxt) == [] and outer.end_ns <= nxt.start_ns
    thread = _one(log, "drin.test.thread")
    assert [s.name for s in _inside(log, thread)] == ["drin.test.thread.child"]
    # the calling thread's ranges are on the profiler's timeline under their names
    assert {"drin.test.outer", "drin.test.inner", "drin.test.second", "drin.test.next"} <= ranges


def test_a_span_closes_on_an_exception():
    def run():
        with pytest.raises(KeyError):
            with span("drin.test.fails"):
                raise KeyError("x")
        with span("drin.test.after"):
            pass

    _, log, _ = _profiled(run)
    fails, after = _one(log, "drin.test.fails"), _one(log, "drin.test.after")
    assert fails.start_ns <= fails.end_ns <= after.start_ns <= after.end_ns


def test_the_log_keeps_the_newest_spans_and_no_object_the_collector_tracks():
    """A closed span leaves no container behind in the log: a log of tuples
    and dicts set off collections over the whole heap inside traced loops."""
    n = S.LOG_SIZE // 2 - 1

    def run():
        for _ in range(7):
            with span("drin.test.old"):
                pass
        gc.disable()
        try:
            before = gc.get_count()[0]
            for _ in range(n):
                with span("drin.test.a"):
                    with span("drin.test.b"):
                        pass
            return gc.get_count()[0] - before
        finally:
            gc.enable()

    grown, log, _ = _profiled(run)
    assert grown < 100, grown  # 2 a span before the log was flat
    # 7 + 2n = LOG_SIZE + 5 closed: the oldest five are gone
    assert len(log) == S.LOG_SIZE
    assert [s.name for s in log[:4]] == ["drin.test.old", "drin.test.old", "drin.test.b",
                                         "drin.test.a"]
    assert all(a.end_ns <= b.end_ns for a, b in zip(log, log[1:]))  # in the order they closed
    assert _inside(log, log[-1]) == [log[-2]]


def test_traced_drin_rank_spans(wm128):
    cfg = wm128[0]
    ranker = _ranker(wm128)
    feats = tuple(wm128[3][:-1])
    ranker.rank(feats, 3)  # warm
    _, log, ranges = _profiled(lambda: ranker.rank(feats, 3))
    root = _one(log, "drin.serve.rank")
    assert log[-1] is root  # the outermost: every span lies inside it
    assert len(_inside(log, root)) == len(log) - 1
    kids = _inside(log, root, SERVE)
    assert [s.name for s in kids] == list(SERVE)
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    forward = kids[2]
    layers = [s for s in log if s.name == "drin.gcn_layer"]
    assert len(layers) == cfg.num_gcn_layers
    assert _inside(log, forward) == layers
    assert {s.name for s in log} <= ranges
    # score() opens the same root and children, gather and forward included
    _, log, _ = _profiled(lambda: ranker.score(feats))
    root = _one(log, "drin.serve.rank")
    assert [s.name for s in _inside(log, root, SERVE)] == list(SERVE)


def test_traced_online_rank_spans(online):
    _, bert_cfg, _, _, batch = online
    ranker = _online_ranker(online)
    ranker.rank(batch, 3)
    _, log, _ = _profiled(lambda: ranker.rank(batch, 3))
    root = _one(log, "drin.serve.rank")
    kids = _inside(log, root, SERVE)
    assert [s.name for s in kids] == ["drin.serve.prepare", "drin.serve.forward",
                                      "drin.serve.result"]  # no store: no gather
    attention = [s for s in log if s.name == "drin.bert.attention"]
    # two BERT passes (the mention sentences, the zipped entity sentences)
    assert len(attention) == 2 * bert_cfg.num_hidden_layers
    assert _inside(log, kids[1], ("drin.bert.attention",)) == attention


def test_traced_trainer_epoch_spans(tmp_path):
    from drin_tpu_torch.data.dataset import create_datasets
    from drin_tpu_torch.data.synthetic import make_synthetic_store, tiny_config
    from drin_tpu_torch.models import get_model
    from drin_tpu_torch.train.trainer import Trainer

    cfg = tiny_config("wikimel", "drin", preprocess_dir=str(tmp_path)).replace(
        transformer_dropout=0.0)
    make_synthetic_store(cfg, n_mentions=10, n_entities=30, seed=3)
    train = create_datasets(cfg)[0]
    model, kind = get_model(cfg, torch.Generator().manual_seed(cfg.seed))
    trainer = Trainer(cfg, model, device="cpu", log=lambda *a: None)
    n = -(-len(train) // cfg.batch_size)
    _, log, ranges = _profiled(lambda: trainer._run_epoch(train, "train", True, kind))
    steps = [s for s in log if s.name == "drin.train.step"]
    assert len(steps) == n
    for step in steps:
        inside = _inside(log, step)
        assert [s.name for s in inside if s.name != "drin.gcn_layer"] == ["drin.train.optimizer"]
        assert sum(s.name == "drin.gcn_layer" for s in inside) == cfg.num_gcn_layers
    waits = [s for s in log if s.name == "drin.prefetch.wait"]
    assert len(waits) == n + 1  # one more get: the end of the epoch
    assert not any(_inside(log, w) for w in waits)
    assert {"drin.train.step", "drin.train.optimizer", "drin.prefetch.wait"} <= ranges


def test_chip_smoke_leaves_host_ranges_off_the_device_rows():
    """Under a CUDA profiler a host range also shows on the device's row,
    under its own name and covering what it launched: chip_smoke's device
    times and idle shares count kernels, copies and memsets only."""
    ev = lambda key, kind, ms, **kw: types.SimpleNamespace(
        key=key, device_type=kind, self_device_time_total=ms * 1e3, count=1, **kw)
    events = [ev("drin.serve.rank", DeviceType.CPU, 0.0), ev("aten::mm", DeviceType.CPU, 0.0),
              ev("drin.serve.rank", DeviceType.CUDA, 9.0),
              ev("drin.gcn_layer", DeviceType.CUDA, 2.0, is_user_annotation=True),
              ev("gcn_rows_f32", DeviceType.CUDA, 1.5), ev("Memcpy HtoD", DeviceType.CUDA, 4.0)]
    prof = types.SimpleNamespace(key_averages=lambda: events)
    assert [e.key for e in chip_smoke.device_events(prof)] == ["gcn_rows_f32", "Memcpy HtoD"]
