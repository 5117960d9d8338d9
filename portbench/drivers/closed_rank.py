"""One closed-loop caller of ``Ranker.rank``: a pool of requests made in
set-up from the seed, each sent as soon as the previous answer is back.

Cell parameters: ``batch`` (mentions a request), ``pool_batches``
(requests made and cycled), ``k`` (top-k), ``warmup_calls``, the system's
own (``sentence_tokens`` ...), ``limits`` of the check.

``rank_pairs_per_s``: B·C of every call completed in the window, C the
model's real candidates, over the window's seconds.  The check compares
every answer of the window against the reference's scores of its request:
``score_err`` is the largest gap between a served top-k score and the
reference's score of the same candidate, ``topk_gap`` the largest amount by
which the reference's j-th best score exceeds its score of the candidate
served j-th.
"""

from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from portbench import harness


def _sync(run):
    if run.device.type == "cuda":
        torch.cuda.synchronize()


def launch_counts() -> dict:
    """The port's own kernel launch counters (0 where a kernel never ran)."""
    out = {}
    for name in ("gather", "gcn_layer", "attention"):
        mod = sys.modules.get(f"drin_tpu_torch.ops.cuda.{name}")
        out[name] = int(getattr(mod, "launches", 0)) if mod is not None else 0
    return out


def setup(run) -> dict:
    sysm, cell = run.system, run.cell
    data = sysm.make_data(run)
    pool = sysm.request_pool(run, data, cell["pool_batches"], cell["batch"])
    ranker = sysm.build_ranker(run, data)
    seen = set()
    for feats in pool:  # every shape the traffic sends, once
        shape = tuple(sorted(sysm.shapes(run, feats).items()))
        if shape not in seen:
            seen.add(shape)
            ranker.rank(feats, cell["k"])
    for i in range(cell["warmup_calls"]):
        ranker.rank(pool[i % len(pool)], cell["k"])
    _sync(run)
    print(f"portbench: {run.workload}: {sysm.describe(run, data)}; pool of {len(pool)} requests "
          f"of {cell['batch']}", file=sys.stderr)
    return {"ranker": ranker, "data": data, "pool": pool}


def window(run, state: dict, seconds: float) -> dict:
    ranker, pool, k = state["ranker"], state["pool"], run.cell["k"]
    answers = []
    before = launch_counts()
    with run.span("window"):
        t0 = harness.now()
        t_end = t0 + seconds
        while True:
            j = len(answers) % len(pool)
            with run.span("rank"):
                vals, idx = ranker.rank(pool[j], k)
            answers.append((j, vals, idx))
            if harness.now() >= t_end:
                break
        t1 = harness.now()
    after = launch_counts()
    launches = {n: after[n] - before[n] for n in after}
    print(f"portbench: {len(answers)} calls in {t1 - t0:.3f} s; kernel launches {launches}",
          file=sys.stderr)
    B = run.cell["batch"]
    return {"t0": t0, "t1": t1, "calls": len(answers), "answers": answers,
            "attempted": len(answers) * B, "failed": 0, "launches": launches,
            "shapes": [run.system.shapes(run, pool[j]) for j, _, _ in answers],
            "flops": [run.system.rank_flops(run, pool[j]) for j, _, _ in answers],
            "inputs": (state["data"], pool)}


def end_to_end(run, state: dict, rec: dict) -> dict:
    C = run.system.num_candidates(run.config)
    pairs = rec["calls"] * run.cell["batch"] * C
    return {"rank_pairs_per_s": pairs / (rec["t1"] - rec["t0"])}


def release(state: dict) -> None:
    state.pop("ranker", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def compare(answers, want: dict, k: int) -> dict:
    """score_err and topk_gap of answers ``(request, scores, indices)``
    against the reference's [B, C] scores of each request."""
    score_err = topk_gap = 0.0
    for j, vals, idx in answers:
        ref = want[j]
        at = np.take_along_axis(ref, np.asarray(idx), -1)
        best = -np.sort(-ref, axis=-1)[:, :k]
        score_err = max(score_err, float(np.abs(np.asarray(vals, np.float64) - at).max()))
        topk_gap = max(topk_gap, float((best - at).max()))
    return {"score_err": score_err, "topk_gap": topk_gap}


def reference_answers(run, data, pool, used, k: int):
    """The reference's scores of each request used, and with ``--control 1``
    the control's answers (its top-k in one TF32 pass) to put in the
    program's place."""
    sysm = run.system
    want = {j: sysm.reference_scores(run, data, pool[j]) for j in used}
    control = None
    if run.control:
        control = {}
        for j in used:
            s = torch.from_numpy(sysm.reference_scores(run, data, pool[j], tf32=True))
            v, i = torch.topk(s, k, dim=-1)
            control[j] = (v.numpy(), i.numpy())
    return want, control


def check(run, rec: dict):
    data, pool = rec["inputs"]
    k = run.cell["k"]
    used = sorted({j for j, _, _ in rec["answers"]})
    want, control = reference_answers(run, data, pool, used, k)
    answers = rec["answers"] if control is None else \
        [(j,) + control[j] for j, _, _ in rec["answers"]]
    return harness.judge(compare(answers, want, k), run.cell["limits"])
