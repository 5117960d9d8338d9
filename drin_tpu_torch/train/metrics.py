# -*- coding: utf-8 -*-
"""Top-k accuracy with correction (port of ``drin_tpu/train/metrics.py``).

The state is a dict of 0-d float32 tensors on the device, so a step adds to
it without a host read; the host reads it at log time only, after summing it
over the ranks of the data axis (:func:`psum_state`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from drin_tpu_torch.train.loss import _strip_answer_column

MetricState = Dict[str, torch.Tensor]  # {"correct_{k}": [], "total": [], ...}


def init_state(topk: Sequence[int], device="cpu") -> MetricState:
    zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
    state = {f"correct_{k}": zero() for k in topk}
    state["total"] = zero()
    # the running loss lives beside the counters
    state["loss_sum"] = zero()
    state["n_batches"] = zero()
    return state


def add_loss(state: MetricState, loss: torch.Tensor) -> MetricState:
    new = dict(state)
    new["loss_sum"] = state["loss_sum"] + loss.detach()
    new["n_batches"] = state["n_batches"] + 1.0
    return new


def mean_loss(state: MetricState) -> torch.Tensor:
    return state["loss_sum"] / torch.clamp_min(state["n_batches"], 1.0)


@torch.no_grad()
def update(state: MetricState, y_pred: torch.Tensor, y_true: torch.Tensor,
           topk: Sequence[int], valid: Optional[torch.Tensor] = None) -> MetricState:
    """Accumulate counters for one batch: the answer column is stripped, and
    the gold candidate counts as a top-k hit when fewer than k scores are
    strictly greater than its own (ties included).  An all-zero one-hot row
    ("answer not in candidates") never counts as a hit, and a row with a
    non-finite score counts as a miss.  ``valid`` masks padded rows."""
    y_pred = _strip_answer_column(y_true, y_pred)
    new = dict(state)
    s_gold = torch.sum(y_pred * y_true.to(y_pred.dtype), dim=-1)
    has_gold = (y_true.sum(dim=-1) > 0).float()
    n_greater = (y_pred > s_gold[:, None]).sum(dim=-1)
    # a NaN anywhere makes s_gold NaN and every comparison False: without
    # this a poisoned row would count as a hit for every k
    finite = torch.isfinite(y_pred).all(dim=-1).float()
    for k in topk:
        hit = (n_greater < k).float() * has_gold * finite
        if valid is not None:
            hit = hit * valid
        new[f"correct_{k}"] = state[f"correct_{k}"] + hit.sum()
    n = valid.sum() if valid is not None else float(y_pred.shape[0])
    new["total"] = state["total"] + n
    return new


def compute(state: MetricState, topk: Sequence[int], correction: float = 0.0) -> Dict[int, torch.Tensor]:
    """Final accuracies; ``correction`` folds first-stage retrieval misses
    into the reported number, acc / (1 - correction)."""
    total = torch.clamp_min(state["total"], 1.0)
    return {k: state[f"correct_{k}"] / total / (1.0 - correction) for k in topk}


def psum_state(state: MetricState, group) -> MetricState:
    """The counters summed over the ranks of ``group`` (the data axis), in
    one ``all_reduce``; the port of ``drin_tpu.train.metrics.psum_state``."""
    import torch.distributed as dist

    from drin_tpu_torch.parallel.collectives import group_size

    if group_size(group) == 1:
        return dict(state)
    keys = sorted(state)
    flat = torch.stack([state[k].reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    return {k: flat[i] for i, k in enumerate(keys)}
