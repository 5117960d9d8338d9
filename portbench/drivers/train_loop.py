"""The port's training loop: ``Trainer._run_epoch`` (its ``Prefetcher``,
``Trainer._put``, ``build_step_fns``' ``train_step`` with Adam) over an
in-memory dataset whose mentions repeat a pool made from the seed.

Cell parameters: ``batch``, ``mention_pool`` (distinct mentions),
``epoch_steps`` (steps an epoch), ``warmup_steps``, ``store`` (the entity
store's form), ``trace_seconds``, ``limits``, and the system's own.

Set-up builds one ``Trainer`` and drives it through its first three steps,
one epoch of one step each on rows that all differ; the loss of each, the
first gradient (from Adam's first moment after step 1) and the parameters
after step 3 are kept for the check.  Then the same trainer warms up and
runs epochs for the window; a timer sets the trainer's own stop flag at the
window's end, the loop stops at the next step boundary and the epoch's
close synchronises.  ``train_pairs_per_s`` is B·C of every step finished in
the window over its seconds.

The check runs the reference's three steps from the same weights on the
same rows: ``loss_rel`` (the largest relative gap of a step's loss),
``grad_gap`` and ``step_gap`` (per leaf, the gap between the program's and
the reference's norms of the first gradient and of the change over the three
steps, over the larger of the reference's norm of that leaf and of the
median leaf; the worst leaf).  Leaves whose reference gradient is under a
thousandth of the median leaf's move under Adam by rounding alone and are
left out of ``step_gap``.
"""

from __future__ import annotations

import gc
import sys
import threading

import numpy as np
import torch

from portbench import harness

TINY_GRAD = 1e-3  # of the median leaf's first-gradient norm


class PoolDataset:
    """``length`` mentions that repeat ``pool`` from ``offset``; records
    the mention indices of every batch it assembles."""

    accepts_bucket_idx = False

    def __init__(self, pool: dict, fields, length: int, offset: int = 0):
        self.pool, self.fields, self.length, self.offset = pool, fields, length, offset
        self.n = len(next(iter(pool.values())))
        self.seen = []

    def __len__(self) -> int:
        return self.length

    def make_batch(self, idx, kind: str):
        from drin_tpu_torch.data.device_store import DrinRowsBatch

        rows = (np.asarray(idx) + self.offset) % self.n
        self.seen.append(rows)
        return DrinRowsBatch(*(self.pool[f][rows] for f in self.fields + ("answer",)))


def _log(*a, **k):
    print(*a, file=sys.stderr, **k)


def setup(run) -> dict:
    from drin_tpu_torch.data.device_store import DeviceEntityStore, include_for
    from drin_tpu_torch.models import get_model
    from drin_tpu_torch.train.trainer import Trainer

    sysm, cell, dev = run.system, run.cell, run.device
    B = cell["batch"]
    data = sysm.make_data(run)
    pool = sysm.mentions(run, "train", cell["mention_pool"])
    cfg = sysm.port_config(run.config).replace(
        batch_size=B, seed=harness.derive_seed(run.seed, "trainer") % 2 ** 31,
        shuffle_train_data=True)
    with torch.device("meta"):
        model, kind = get_model(cfg)
    model.load_state_dict({k: v.clone() for k, v in data["weights"].items()}, assign=True)
    store = DeviceEntityStore(cfg, data["tables"], device=dev, include=include_for(kind),
                              quantize=cell["store"] == "int8")
    trainer = Trainer(cfg, model, device=dev, feats_fn=store.drin_feats_fn(), log=_log)
    fields = sysm.FIELDS
    names = [n for n, _ in trainer.state.model.named_parameters()]
    params = dict(trainer.state.model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    losses, rows, grad_norms = [], [], None
    for step in range(3):  # the checked steps, one epoch of one step each
        ds = PoolDataset(pool, fields, B, offset=step * B)
        losses.append(trainer._run_epoch(ds, "train", True, "drin_rows")["loss"])
        rows.append(ds.seen[0])
        if step == 0:  # Adam's first moment after one step is (1 - beta1) g
            beta1 = trainer.state.optimizer.param_groups[0]["betas"][0]
            st = trainer.state.optimizer.state
            # a leaf that no gradient reaches (the last layer's edge weights)
            # has no state: its gradient is 0
            grad_norms = {k: float(st[params[k]]["exp_avg"].norm()) / (1 - beta1)
                          if "exp_avg" in st[params[k]] else 0.0 for k in names}
    change = {k: float((params[k].detach() - p0[k]).norm()) for k in names}
    warm = PoolDataset(pool, fields, cell["warmup_steps"] * B, offset=3 * B)
    trainer._run_epoch(warm, "train", True, "drin_rows")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    _log(f"portbench: {run.workload}: {sysm.describe(run, data)}; store "
         f"{store.nbytes / 1e6:.0f} MB on the device; pool of {cell['mention_pool']} mentions")
    return {"trainer": trainer, "store": store, "data": data, "pool": pool, "kind": kind,
            "checked": {"losses": losses, "rows": rows, "grad_norms": grad_norms,
                        "change": change, "p0": p0}}


def window(run, state: dict, seconds: float) -> dict:
    trainer, cell = state["trainer"], run.cell
    B = cell["batch"]
    ds = PoolDataset(state["pool"], run.system.FIELDS, cell["epoch_steps"] * B,
                     offset=(3 + cell["warmup_steps"]) * B)
    stop = lambda: trainer._interrupted.__setitem__("portbench_window", True)
    step0 = trainer.state.step
    with run.span("window"):
        t0 = harness.now()
        timer = threading.Timer(seconds, stop)
        timer.start()
        try:
            epochs = 0
            while not trainer._interrupted:
                trainer._run_epoch(ds, "train", True, state["kind"])
                epochs += 1
        finally:
            timer.cancel()
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = harness.now()
    trainer._interrupted.clear()
    steps = trainer.state.step - step0
    _log(f"portbench: {steps} steps in {epochs} epochs, {t1 - t0:.3f} s")
    C = run.system.num_candidates(run.config)
    flops = run.system.train_flops(run, B, C)
    return {"t0": t0, "t1": t1, "calls": steps, "attempted": steps * B, "failed": 0,
            "shapes": [{"B": B, "C": C}] * steps, "flops": [flops] * steps,
            "checked": state["checked"], "inputs": (state["data"], state["pool"])}


def end_to_end(run, state: dict, rec: dict) -> dict:
    C = run.system.num_candidates(run.config)
    return {"train_pairs_per_s": rec["calls"] * run.cell["batch"] * C / (rec["t1"] - rec["t0"])}


def release(state: dict) -> None:
    for k in ("trainer", "store"):
        state.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median(list(want.values())))
    keys = [k for k in want if keep is None or k in keep]
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def compare(got: dict, want: dict) -> dict:
    """loss_rel, grad_gap, step_gap of the program's (or the control's)
    three steps against the reference's."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    med = float(np.median(list(want["grad_norms"].values())))
    moved = {k for k, g in want["grad_norms"].items() if g >= TINY_GRAD * med}
    return {"loss_rel": loss_rel, "grad_gap": leaf_gap(got["grad_norms"], want["grad_norms"]),
            "step_gap": leaf_gap(got["change"], want["change"], moved)}


def reference_steps(run, data, pool, rows, p0, tf32: bool) -> dict:
    """The reference's three steps from ``p0`` on the checked rows."""
    sysm, cfg = run.system, run.config
    batches = [sysm.reference_batch(run, data, {f: pool[f][r] for f in sysm.FIELDS + ("answer",)})
               for r in rows]
    losses, first, params = run.reference.train_steps(p0, batches, cfg["triplet_margin"],
                                                      cfg["learning_rate"], tf32=tf32)
    return {"losses": losses, "grad_norms": {k: float(g.norm()) for k, g in first.items()},
            "change": {k: float((params[k] - p0[k].float()).norm()) for k in params}}


def check(run, rec: dict):
    data, pool = rec["inputs"]
    got = rec["checked"]
    want = reference_steps(run, data, pool, got["rows"], got["p0"], tf32=False)
    if run.control:
        got = reference_steps(run, data, pool, got["rows"], got["p0"], tf32=True)
    numbers = compare(got, want)
    _log("portbench: losses " + ", ".join(f"{a:.6g} / {b:.6g}" for a, b in
                                        zip(got["losses"], want["losses"])) + " (program / reference)")
    return harness.judge(numbers, run.cell["limits"])
