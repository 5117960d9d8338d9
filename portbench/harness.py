"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run loads the cell (``cells/<cell>.json``), its configuration
(``configs/<config>.json``) and its driver (``drivers/<driver>.py``), which
builds the port through the configuration's system (``systems/<system>.py``),
warms up every shape the cell's traffic uses and then drives the port for
``--seconds``.  With ``--trace 0`` the result carries the cell's end-to-end
metrics; with ``--trace 1`` the window runs under ``torch.profiler`` (kept in
memory) and the result carries the cell's per-layer metrics, each read by
``metrics/<metric>.py``, with the device's busy time and a breakdown.  After
the window the port is freed and the plain reference judges what the timed
path produced (``correct``); every number compared is printed beside its
limit, last on standard error and last in the result line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks``.  A run exits non-zero and prints no result
when CUDA is missing or has fewer devices than the cell asks for, and when
``jax``, ``jaxlib``, ``flax`` or ``drin_tpu`` is loaded once the window has
closed.

``--rehearse`` runs the cell end to end on the CPU at the tiny sizes of
``rehearsal/`` through the port's plain versions and prints no device metric.
``--validate`` lists the cells and metrics and checks that every name in
``BENCHMARK.json`` has its files.  A parked cell (a cell file with a
``parked`` reason, not in ``BENCHMARK.json``) runs by hand and reports only
``setup_s``, its driver's own numbers on standard error.  ``--control 1``
judges the control (the reference in a lower precision) in the program's
place; the benchmark's own runs never use it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
import sys
import time
import zlib

FORBIDDEN = ("jax", "jaxlib", "flax", "drin_tpu")  # whole top-level names
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
PKG = os.path.dirname(os.path.abspath(__file__))


def forbidden_modules(names=None) -> list:
    """Top-level names among ``names`` (default ``sys.modules``) that the
    benchmark's process must not hold, compared whole: ``drin_tpu_torch`` is
    not ``drin_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(kind: str, name: str, root: str = PKG):
    """``<root>/<kind>/<name>.py`` as a module of its own (names may hold
    dots and dashes, so they are loaded by path)."""
    path = os.path.join(root, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path}")
    mod_name = f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: str, pkg: str = PKG):
        self.root, self.pkg = root, pkg
        self.spec = _json(os.path.join(root, "BENCHMARK.json"))
        self.peaks = _json(os.path.join(pkg, "peaks.json"))  # the card's data-sheet rates

    def workload(self, name: str) -> dict:
        """The cell's entry in ``BENCHMARK.json``, or for a parked cell (a
        cell file with a ``parked`` reason, not in ``BENCHMARK.json``) one
        made from its file: it runs by hand and in the tests, and reports
        only ``setup_s``."""
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        if name in self.parked():
            cell = self.cell(name)
            return {"name": name, "config": cell["config"], "chips": cell.get("chips", 1)}
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def parked(self) -> list:
        """Cells whose files say why they are not in ``BENCHMARK.json``."""
        listed = {w["name"] for w in self.spec["workloads"]}
        names = sorted(f[:-5] for f in os.listdir(os.path.join(self.pkg, "cells"))
                       if f.endswith(".json"))
        return [n for n in names if n not in listed and "parked" in self.cell(n)]

    def cell(self, name: str) -> dict:
        return _json(os.path.join(self.pkg, "cells", f"{name}.json"))

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def rehearsal(self, name: str) -> dict:
        path = os.path.join(self.pkg, "rehearsal", f"{name}.json")
        return _json(path) if os.path.exists(path) else {}

    def module(self, kind: str, name: str):
        return load_file_module(kind, name, self.pkg)

    def metrics_for(self, workload: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
        that list it, and those without a list whose moved metric it
        reports."""
        e2e = [m for m in self.spec["end_to_end"] if workload in m.get("workloads", [workload])]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", []) or ("workloads" not in m and m["moves"] in names)]

    def validate(self) -> list:
        """Every name of ``BENCHMARK.json`` with its files, and the rules a
        later cell or metric has to keep; returns the problems found."""
        out, spec = [], self.spec
        configs = {c["name"] for c in spec["configs"]}
        e2e = {m["name"] for m in spec["end_to_end"]}
        for c in spec["configs"]:
            if not os.path.exists(os.path.join(self.root, c["file"])):
                out.append(f"config {c['name']}: no file {c['file']}")
        for w in spec["workloads"]:
            name = w["name"]
            if w["config"] not in configs:
                out.append(f"workload {name}: unknown config {w['config']}")
            try:
                cell = self.cell(name)
            except FileNotFoundError:
                out.append(f"workload {name}: no cells/{name}.json")
                continue
            if cell.get("config") != w["config"]:
                out.append(f"workload {name}: its cell file names config {cell.get('config')}")
            for kind, key in (("drivers", cell.get("driver")),
                              ("systems", (self.config(w["config"]) or {}).get("system"))):
                if not key or not os.path.exists(os.path.join(self.pkg, kind, f"{key}.py")):
                    out.append(f"workload {name}: no {kind}/{key}.py")
            reported = {m["name"] for m in self.metrics_for(name, "end_to_end")}
            if "setup_s" not in reported or len(reported) < 2:
                out.append(f"workload {name}: reports {sorted(reported)}")
            if not self.metrics_for(name, "per_layer"):
                out.append(f"workload {name}: no per-layer metric")
        for m in spec["per_layer"]:
            if not os.path.exists(os.path.join(self.pkg, "metrics", f"{m['name']}.py")):
                out.append(f"metric {m['name']}: no metrics/{m['name']}.py")
            if m["moves"] not in e2e:
                out.append(f"metric {m['name']}: moves unknown {m['moves']}")
            for w in m.get("workloads", []):
                if m["moves"] not in {x["name"] for x in self.metrics_for(w, "end_to_end")}:
                    out.append(f"metric {m['name']}: cell {w} does not report {m['moves']}")
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            for entry in spec[group]:
                if not NAME.match(entry["name"]):
                    out.append(f"{group}: bad name {entry['name']!r}")
        return out


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of a run, from ``--seed`` (any size)."""
    import numpy as np

    seed %= 2 ** 128
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, seed >> 64 & 0xFFFFFFFF,
             seed >> 96] + \
        [zlib.crc32(str(t).encode()) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


class Run:
    """What a driver and a system see of one run."""

    def __init__(self, bench: Bench, workload: str, seed: int, seconds: float, trace: bool,
                 rehearse: bool, control: bool, device):
        self.bench, self.workload, self.seed = bench, workload, seed
        self.seconds, self.trace, self.rehearse, self.control = seconds, trace, rehearse, control
        self.device = device
        self.entry = bench.workload(workload)
        self.cell = dict(bench.cell(workload))
        self.config = dict(bench.config(self.entry["config"]))
        if rehearse:  # tiny sizes for the CPU
            self.config.update(bench.rehearsal(self.entry["config"]))
            self.cell.update(bench.rehearsal(workload))
        self.peaks = bench.peaks
        self.system = bench.module("systems", self.config["system"])
        self.reference = bench.module("reference", self.config["reference"])

    def rng(self, *tags):
        import numpy as np

        return np.random.default_rng(derive_seed(self.seed, *tags))

    def generator(self, *tags):
        import torch

        return torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, *tags))

    def span(self, name: str):
        """A host range named ``portbench.<name>`` in a traced run."""
        import contextlib

        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"portbench.{name}")


def _device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def _check_lines(checks: dict) -> list:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}" for k, v in checks.items()]



def parse_args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="tiny sizes on the CPU through the plain versions; no device metric")
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="judge the control (the reference in a lower precision) in the "
                        "program's place")
    p.add_argument("--validate", action="store_true",
                   help="list the cells and metrics and check their files")
    return p.parse_args(argv)


def main(argv, t0: float, root: str) -> int:
    args = parse_args(argv)
    bench = Bench(root)
    if args.validate:
        for w in bench.spec["workloads"]:
            print(w["name"], [m["name"] for m in bench.metrics_for(w["name"], "end_to_end")],
                  [m["name"] for m in bench.metrics_for(w["name"], "per_layer")])
        for n in bench.parked():
            print(n, "parked:", bench.cell(n)["parked"])
        problems = bench.validate()
        for p in problems:
            print("problem:", p, file=sys.stderr)
        return 1 if problems else 0
    if not args.workload:
        print("portbench: --workload is required", file=sys.stderr)
        return 2
    chips = bench.workload(args.workload)["chips"]
    import torch

    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s); "
                  f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}. "
                  "A measuring run never falls back to the CPU (--rehearse runs the CPU rehearsal)",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    run = Run(bench, args.workload, args.seed, args.seconds, bool(args.trace), args.rehearse,
              bool(args.control), device)
    driver = bench.module("drivers", run.cell["driver"])
    result, checks = execute(run, driver, t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run's process holds {found} after the window: the benchmark "
              "and the port must not load JAX or the JAX package", file=sys.stderr)
        return 3
    for line in _check_lines(checks):
        print(line, file=sys.stderr)
    result["checks"] = {k: {n: (x if math.isfinite(x) else str(x)) for n, x in v.items()}
                        for k, v in checks.items()}  # last: the numbers beside their limits
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


def execute(run: Run, driver, t0: float):
    """Set-up, the window (traced or not), the metrics, then the check."""
    import torch

    from portbench import trace as tr

    cuda = run.device.type == "cuda"
    state = driver.setup(run)
    seconds = run.seconds
    if run.trace:
        seconds = min(seconds, float(run.cell.get("trace_seconds", seconds)))
    prof = tr.start() if run.trace and cuda else None
    try:
        rec = driver.window(run, state, seconds)
    finally:
        if prof is not None:
            prof.stop()
    setup_s = rec["t0"] - t0
    if cuda:
        torch.cuda.synchronize()
    device = _device_info(torch, run.entry["chips"]) if cuda else {"platform": "cpu"}
    metrics, breakdown = {}, None
    if run.rehearse:
        pass  # no device metric from a CPU run
    elif not run.trace:
        values = driver.end_to_end(run, state, rec)
        values["setup_s"] = setup_s
        if run.workload in run.bench.parked():
            print(f"portbench: parked cell {run.workload}: {values}", file=sys.stderr)
        for m in run.bench.metrics_for(run.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        t = tr.read(prof)
        device.update(busy_s=t.busy_s(), window_s=t.window_s())
        breakdown = t.breakdown()
        for m in run.bench.metrics_for(run.workload, "per_layer"):
            reader = run.bench.module("metrics", m["name"])
            value = reader.read(tr.Reading(run, rec, t))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    nvcc = _nvcc_seconds()
    if nvcc:
        print(f"portbench: this run built kernels: nvcc {nvcc} s (set-up {setup_s:.3f} s)",
              file=sys.stderr)
    driver.release(state)
    del state
    correct, checks = driver.check(run, rec)
    result = {"correct": bool(correct), "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    bad = [k for k, v in checks.items() if not (v["value"] <= v["limit"])]
    if correct and bad:  # a driver's verdict and its numbers must agree
        raise AssertionError(f"correct with numbers past their limits: {bad}")
    return result, checks


def _nvcc_seconds() -> dict:
    mod = sys.modules.get("drin_tpu_torch.ops.cuda._build")
    return {k: round(v, 3) for k, v in getattr(mod, "nvcc_seconds", {}).items()}


def judge(numbers: dict, limits: dict):
    """(correct, checks): each number the cell sets a limit for, beside it;
    correct when every one is finite and within its limit.  A number the
    cell sets no limit for is not compared (its control reads no upper
    end there)."""
    checks = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def now() -> float:
    return time.perf_counter()
