"""The readers of the port's spans (``portbench/spans.py`` and the three
metrics on it) on a synthetic trace and span log: the alignment of the two
clocks, the exact split of the window's idle time, and the refusals."""

import json
import os
import subprocess
import sys
import types

import pytest

from drin_tpu_torch.common.spans import Span
from portbench import harness
from portbench import spans as PS
from portbench import trace as tr

ROOT = os.path.dirname(harness.PKG)
METRICS = ("prepare_idle_ms.rank", "forward_idle_ms.rank", "result_idle_ms.rank")
T0 = 50.0  # the timed loop's perf_counter seconds at the window's start
WINDOW = (1000.0, 11000.0)  # the profiler's microseconds


def _ns(us: float) -> int:
    """A profiler time (us) as the span log's perf_counter nanoseconds."""
    return round((us - WINDOW[0] + T0 * 1e6) * 1e3)


def _log():
    """Two calls of 3,900 us, 5,000 us apart, and a call before the window."""
    out = []

    def add(name, a, b):
        out.append(Span(name, _ns(a), _ns(b)))

    add("drin.serve.rank", 500.0, 900.0)  # before t0: not in the window
    for k in range(2):
        s = 1100.0 + 5000.0 * k
        add("drin.serve.prepare", s, s + 900)
        add("drin.serve.gather", s + 900, s + 1400)
        add("drin.gcn_layer", s + 1500, s + 2000)
        add("drin.serve.forward", s + 1400, s + 3400)
        add("drin.serve.result", s + 3400, s + 3800)
        add("drin.serve.rank", s, s + 3900)
    return out


def _trace():
    ops = []
    for k in range(2):
        d = 5000.0 * k
        ops += [("Memcpy HtoD (Pageable -> Device)", 1200 + d, 1500 + d),
                ("Memcpy HtoD (Pageable -> Device)", 1600 + d, 1900 + d),
                ("gather_dequant", 2100 + d, 2400 + d),
                ("gcn_rows_f32", 2500 + d, 3000 + d),
                ("gcn_rows_f32", 3200 + d, 4600 + d),  # runs on into the result's span
                ("Memcpy DtoH (Device -> Pageable)", 4700 + d, 4800 + d)]
    ops.append(("Memcpy HtoD (Pageable -> Device)", 5200.0, 5300.0))  # between the calls
    return tr.Trace(ops, [], WINDOW)


def _reading(t1=T0 + 0.01, calls=2):
    return types.SimpleNamespace(rec={"t0": T0, "t1": t1, "calls": calls}, trace=_trace())


def test_the_spans_land_on_the_profilers_clock():
    spans = PS.window_spans(_reading(), _log())
    assert sum(1 for s in spans if s[0] == PS.ROOT) == 2  # the call before t0 is left out
    prepare = [s for s in spans if s[0] == "drin.serve.prepare"]
    assert [(a, b) for _, a, b in prepare] == [(pytest.approx(1100.0), pytest.approx(2000.0)),
                                                  (pytest.approx(6100.0), pytest.approx(7000.0))]


def test_the_idle_time_splits_exactly():
    m = _reading()
    split = PS.idle_split(m, _log())
    assert split["drin.serve.prepare"] == pytest.approx(600.0)  # 100 before, between, after
    assert split["drin.serve.gather"] == pytest.approx(400.0)
    assert split["drin.serve.forward"] == pytest.approx(400.0)
    assert split["drin.serve.result"] == pytest.approx(400.0)
    # before the first call, each root's own tail, between the calls (less the stray
    # copy), after the last call
    assert split[PS.OUTSIDE] == pytest.approx(100 + 100 + 1000 + 100 + 1000)
    idle_us = (m.trace.window_s() - m.trace.busy_s()) * 1e6
    assert sum(split.values()) == pytest.approx(idle_us, abs=1e-6)
    assert PS.idle_ms(m, ("drin.serve.prepare",), _log()) == pytest.approx(0.3)
    assert PS.idle_ms(m, ("drin.serve.gather", "drin.serve.forward"), _log()) == \
        pytest.approx(0.4)
    assert PS.idle_ms(m, ("drin.serve.result",), _log()) == pytest.approx(0.2)


def test_the_overlap_of_two_interval_lists():
    assert PS.merged([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]
    xs = [[0, 4], [5, 6], [8, 12]]
    assert PS.overlap(xs, [[1, 2], [3, 9], [11, 20]]) == 1 + 1 + 1 + 1 + 1
    assert PS.overlap(xs, [[4, 5], [6, 8]]) == 0  # touching is no overlap
    assert PS.overlap(xs, [[-5, 30]]) == 4 + 1 + 4
    assert PS.overlap([], xs) == PS.overlap(xs, []) == 0


@pytest.mark.parametrize("name", METRICS)
def test_each_reader(monkeypatch, name):
    reader = harness.load_file_module("metrics", name)
    monkeypatch.setattr(PS, "port_log", lambda: None)  # a program that keeps no spans
    assert reader.read(_reading()) is None
    monkeypatch.setattr(PS, "port_log", _log)
    want = {"prepare_idle_ms.rank": 0.3, "forward_idle_ms.rank": 0.4,
            "result_idle_ms.rank": 0.2}[name]
    assert reader.read(_reading()) == pytest.approx(want)
    with pytest.raises(RuntimeError, match="disagree"):  # the clocks 1.5 ms apart
        reader.read(_reading(t1=T0 + 0.0115))
    assert reader.read(_reading(t1=T0 + 0.0105)) is not None  # 0.5 ms apart
    with pytest.raises(RuntimeError, match="2 drin.serve.rank spans in the window for 3 calls"):
        reader.read(_reading(calls=3))


def test_validate_lists_the_span_metrics():
    proc = subprocess.run([sys.executable, os.path.join(harness.PKG, "run.py"), "--validate"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stderr == "", proc.stderr
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    entries = {m["name"]: m for m in spec["per_layer"]}
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines())
    for name in METRICS:
        assert entries[name]["moves"] == "rank_pairs_per_s"
        for cell in entries[name]["workloads"]:
            assert repr(name) in lines[cell]
