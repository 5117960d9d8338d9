# -*- coding: utf-8 -*-
"""The NMS kernel's walk (``csrc/nms.cu``), emulated step by step in torch
on the CPU, against ``nms_plain`` and ``drin_tpu.ops.detection.nms``.

The kernel cannot run here, so :func:`lazy_walk` follows its order of
operations: a stable descending sort, the walk's end at the first score not
above -inf, then per chunk of 64 sorted positions (a) the chunk's upper
triangle of IoU bits, every pair of it (the kernel computes it before the
chunk's rows are known live), (b) the picks in order, each applying its
diagonal row before the next position is read and skipping what earlier
chunks removed, the top_k stop folded in, (c) the chunk's kept rows against
every later column
still live (a column tested until its first hit), and the kept indices
written.  It counts the IoUs it computes.  Two planted faults must make it
differ from ``nms_plain``: the diagonal triangle left out, and the removed
words read before the previous chunk's column pass applied its picks (a
missing barrier)."""

import jax
import numpy as np
import pytest
import torch

from drin_tpu.ops import detection as jdet
from drin_tpu_torch.ops import detection as tdet
from test_torch_detection import _boxes, nms_edge_cases

CHUNK = 64


def lazy_walk(boxes, scores, thr, top_k, fault=None):
    """One problem (``boxes [n, 4]``, ``scores [n]``) -> (int64 kept indices
    ``[top_k]``, -1 padded; IoUs computed).  ``fault``: ``"no diagonal"`` or
    ``"stale removed"``."""
    n = scores.shape[0]
    out = torch.full((top_k,), -1, dtype=torch.int64)
    srt, order = torch.sort(scores, descending=True, stable=True)
    dead = ~(srt > float("-inf"))
    n_live = int(dead.nonzero()[0, 0]) if bool(dead.any()) else n
    sb = boxes[order[:n_live]]  # live boxes in sorted order
    removed = torch.zeros(n_live, dtype=torch.bool)
    before_pass = removed.clone()  # the removed set before the last column pass
    kept = evals = 0
    for c0 in range(0, n_live, CHUNK):
        if kept >= top_k:
            break
        length = min(CHUNK, n_live - c0)
        gone = (before_pass if fault == "stale removed" else removed)[c0:c0 + length].clone()
        cb = sb[c0:c0 + length]
        # (a) the upper triangle, every pair of it: the kernel computes it
        # under the previous chunk's column pass, before the rows are known
        pairs = torch.ones(length, length, dtype=torch.bool).triu(1)
        diag = torch.zeros(length, length, dtype=torch.bool)
        if fault != "no diagonal":
            evals += int(pairs.sum())
            diag = (tdet.box_iou(cb, cb) > thr) & pairs
        # (b) the picks, in order
        rem, keep = gone.clone(), []
        for r in range(length):
            if not rem[r]:
                keep.append(r)
                rem |= diag[r]
                if kept + len(keep) == top_k:
                    break
        keep = torch.tensor(keep, dtype=torch.int64)
        # (c) the kept rows against the later columns still live
        before_pass = removed.clone()
        if kept + len(keep) < top_k and c0 + CHUNK < n_live:
            cols = torch.arange(c0 + CHUNK, n_live)[~removed[c0 + CHUNK:]]
            hits = tdet.box_iou(cb[keep], sb[cols]) > thr  # [kept rows, columns]
            first = hits.int().argmax(0)
            evals += int(torch.where(hits.any(0), first + 1, len(keep)).sum())
            removed[cols[hits.any(0)]] = True
        out[kept:kept + len(keep)] = order[c0 + keep]
        kept += len(keep)
    return out, evals


def _rpn_like(rng, n=300):
    """Many overlapping boxes, a third of them padding at -inf (as P6's 507
    candidates padded to 1000)."""
    b = _boxes(rng, n, hi=60.0, wmin=8.0, wmax=40.0)
    s = rng.standard_normal(n).astype(np.float32)
    s[n - n // 3:] = -np.inf
    return b, s, 0.7, n


def _class_like(rng, n=1024):
    """Candidates of 20 classes, boxes offset by label; top_k 30."""
    b = _boxes(rng, n)
    b += rng.integers(1, 21, n).astype(np.float32)[:, None] * 202.0
    s = rng.uniform(0.05, 0.3, n).astype(np.float32)
    s[rng.uniform(size=n) < 1 / 7] = -np.inf
    return b, s, 0.5, 30


PROBLEMS = ([(name, b, s, thr, k) for name, b, s, thr, k in nms_edge_cases()]
            + [(f"rpn-like {i}", *_rpn_like(np.random.default_rng(10 + i))) for i in range(3)]
            + [(f"class-like {i}", *_class_like(np.random.default_rng(20 + i))) for i in range(2)])


@pytest.mark.parametrize("case", PROBLEMS, ids=lambda c: c[0])
def test_lazy_walk_equals_nms_plain_and_jax(case):
    _, boxes, scores, thr, top_k = case
    got, _ = lazy_walk(torch.from_numpy(boxes), torch.from_numpy(scores), thr, top_k)
    want = tdet.nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores), thr, top_k)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    nms_jit = jax.jit(jdet.nms, static_argnums=(2, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(nms_jit(boxes, scores, thr, top_k)))


def test_lazy_walk_counts_a_fraction_of_the_pairs_at_a_class_like_problem():
    """Only the kept rows' IoUs: at most a fifth of the n^2 / 2 pairs that a
    full suppression mask computes."""
    boxes, scores, thr, top_k = _class_like(np.random.default_rng(30))
    n = scores.shape[0]
    got, evals = lazy_walk(torch.from_numpy(boxes), torch.from_numpy(scores), thr, top_k)
    assert int((got >= 0).sum()) == top_k
    assert 0 < evals <= n * n / 2 / 5, evals


@pytest.mark.parametrize("fault", ["no diagonal", "stale removed"])
def test_planted_walk_faults_differ_from_nms_plain(fault):
    """Each fault changes the picks of some RPN-like problem."""
    differ = 0
    for i in range(3):
        boxes, scores, thr, top_k = _rpn_like(np.random.default_rng(10 + i))
        b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
        bad, _ = lazy_walk(b, s, thr, top_k, fault=fault)
        differ += int((bad != tdet.nms_plain(b, s, thr, top_k)).sum())
    assert differ, f"the emulation cannot see {fault!r}"
