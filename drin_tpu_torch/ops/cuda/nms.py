# -*- coding: utf-8 -*-
"""Greedy NMS over many problems in one launch, on the card.

Kernel: ``csrc/nms.cu``, CUDA C++ for ``sm_90a``.  It is not the
counterpart of a Pallas kernel: ``drin_tpu/ops/detection.py:29`` ``nms`` is a
``lax.fori_loop`` inside one compiled program, which eager PyTorch does not
have, so the loop is a kernel here (``csrc/nms.cu`` says why and how).  The
wrapper sorts each problem's scores with a stable sort (ties: the lower
index first, as ``jnp.argmax`` picks), then one launch writes the
suppression bitmask and one walks it, a warp per problem.  Its picks equal
``ops.detection.nms_plain``'s index for index.

:func:`nms_cuda` takes CUDA tensors only; ``ops.detection.nms`` sends CPU
tensors to ``nms_plain``.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0  # kernel launches (the mask and the walk of one call count once)


def _problems(boxes: torch.Tensor, scores: torch.Tensor):
    """``boxes [..., N, 4]`` and ``scores [..., N]`` as float32 ``[P, N, 4]``
    (contiguous, 16-byte aligned) and ``[P, N]``, with the leading shape."""
    if not (boxes.is_cuda and scores.is_cuda and boxes.device == scores.device):
        raise ValueError("nms_cuda takes boxes and scores on one CUDA device")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError(f"nms_cuda takes float32 boxes and scores, got {boxes.dtype} / "
                         f"{scores.dtype}")
    if boxes.shape[-1:] != (4,) or boxes.shape[:-1] != scores.shape:
        raise ValueError(f"boxes must be [..., N, 4] over scores [..., N], got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    n = scores.shape[-1]
    b = boxes.reshape(-1, n, 4).contiguous()
    if b.data_ptr() % 16:
        b = b.clone()
    return b, scores.reshape(-1, n), scores.shape[:-1]


def _launch(fn, lib, boxes, sorted_scores, order, iou_threshold, top_k) -> torch.Tensor:
    """One call of the C entry ``fn`` on ``[P, N]`` problems whose scores
    come sorted (descending) with their ``order``; returns ``[P, top_k]``."""
    from drin_tpu_torch.ops.cuda import _build

    P, n = sorted_scores.shape
    if P > 65535:
        raise ValueError(f"nms_cuda takes at most 65535 problems a call, got {P}")
    out = torch.empty((P, top_k), dtype=torch.int64, device=boxes.device)
    if P == 0 or top_k == 0:
        return out
    if n == 0:
        return out.fill_(-1)
    words = -(-n // 64)
    mask = torch.empty((P, n, words), dtype=torch.int64, device=boxes.device)
    status = fn(boxes.data_ptr(), sorted_scores.contiguous().data_ptr(),
                order.contiguous().data_ptr(), mask.data_ptr(), out.data_ptr(), P, n, top_k,
                float(iou_threshold), _build.stream_of(boxes))
    _build.check(status, lib, "nms launch")
    return out


def entry(name: str = "nms"):
    """``(library, drin_nms)`` of ``csrc/<name>.cu``, built on first use."""
    from drin_tpu_torch.ops.cuda import _build

    P, I = ctypes.c_void_p, ctypes.c_int
    return _build.entry(name, "drin_nms", [P, P, P, P, P, I, I, I, ctypes.c_float, P])


def nms_cuda(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             top_k: int) -> torch.Tensor:
    """Greedy NMS of every problem in ``boxes [..., N, 4]`` / ``scores
    [..., N]`` (float32, on a CUDA device): int64 indices ``[..., top_k]``
    into each problem's N, -1 padded, equal to ``nms_plain``'s."""
    global launches
    b, s, lead = _problems(boxes, scores)
    srt, order = torch.sort(s, dim=-1, descending=True, stable=True)
    lib, fn = entry()
    out = _launch(fn, lib, b, srt, order, iou_threshold, int(top_k))
    if out.numel() and s.shape[-1]:
        launches += 1
    return out.reshape(*lead, int(top_k))
