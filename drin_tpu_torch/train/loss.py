# -*- coding: utf-8 -*-
"""Losses (port of ``drin_tpu/train/loss.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def _strip_answer_column(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """The model scores C = num_candidates_data + 1 candidates (the appended
    gold answer); losses and metrics drop that extra column when present."""
    if y_pred.shape[1] != y_true.shape[1]:
        y_pred = y_pred[:, :-1]
    return y_pred


def triplet_loss(y_true: torch.Tensor, y_pred: torch.Tensor, margin: float,
                 valid: Optional[torch.Tensor] = None, rows: Optional[tuple] = None) -> torch.Tensor:
    """Margin ranking loss with in-batch negatives: for every sample i,
    hinge(positive_i - score + margin) is averaged over the WHOLE batch's
    negated candidate matrix (all samples' candidates act as negatives),
    then averaged over i.

    y_true: one-hot [B, Cd] (all-zero row = answer absent -> positive_i = 0).
    y_pred: similarity scores [B, Cd] or [B, Cd + 1].
    valid:  optional [B] 0/1 mask for padded rows of a ragged batch; padded
            rows contribute neither positives nor negatives.
    rows:   optional [lo, hi): the part of the loss that samples lo..hi-1
            contribute, still against every row's negatives and divided by
            the whole batch's counts.  The parts of a partition of the batch
            sum to the loss: each rank of the data axis takes its own rows'
            part of the global batch's loss.
    """
    y_pred = _strip_answer_column(y_true, y_pred)
    neg = -y_pred
    positive = torch.sum(neg * y_true, dim=-1)  # [B]
    B, Cd = y_pred.shape
    lo, hi = rows if rows is not None else (0, B)
    # [hi - lo, B, Cd]: hinge of sample i's positive against every score
    hinge = torch.clamp_min(positive[lo:hi, None, None] - neg[None, :, :] + margin, 0.0)
    if valid is None:
        return hinge.mean(dim=(1, 2)).sum() / B
    w = valid[lo:hi, None, None] * valid[None, :, None]  # [hi - lo, B, 1]
    per_i = torch.sum(hinge * w, dim=(1, 2)) / torch.clamp_min(valid.sum() * Cd, 1.0)
    return per_i.sum() / torch.clamp_min(valid.sum(), 1.0)
