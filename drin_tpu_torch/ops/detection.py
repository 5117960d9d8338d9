# -*- coding: utf-8 -*-
"""Detection primitives (port of ``drin_tpu/ops/detection.py``): IoU, NMS,
anchors, box coding, clipping and RoIAlign as torch functions.

The JAX module writes them in plain jnp; so does this one in torch, with the
same operation order (torchvision is not a dependency).  Each takes the JAX
function's arguments and also leading batch dimensions where a batch makes
sense (``box_iou``, ``nms``, the box coders), so the detector runs a chunk
of images in one call.

:func:`nms` dispatches on the tensor's device: a CPU tensor takes
:func:`nms_plain`, the JAX loop written out in torch; a CUDA tensor takes the
hand-written kernel (``ops/cuda/nms.py``, ``csrc/nms.cu``) or the call
raises.  Both return the JAX loop's picks index for index.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix ``[..., N, M]`` for boxes (x1, y1, x2, y2) ``[..., N, 4]``
    and ``[..., M, 4]``, in ``drin_tpu``'s operation order (so the matrix of
    a set with itself is symmetric bit for bit)."""
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              top_k: int) -> torch.Tensor:
    """Greedy NMS as ``drin_tpu.ops.detection.nms`` computes it: ``top_k``
    times, pick the live box of the highest score (the lowest index among
    equal scores), stop with -1 once that score is -inf, and remove the pick
    and every box whose IoU with it exceeds the threshold.  ``boxes``
    ``[..., N, 4]``, ``scores`` ``[..., N]`` -> int64 indices ``[..., top_k]``
    padded with -1; each leading index is a problem of its own."""
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n)
    P = scores.shape[0]
    out = torch.full((P, top_k), -1, dtype=torch.int64, device=scores.device)
    if n == 0 or P == 0:
        return out.reshape(*lead, top_k)
    iou = box_iou(boxes, boxes)
    alive = torch.ones((P, n), dtype=torch.bool, device=scores.device)
    rows = torch.arange(P, device=scores.device)
    cols = torch.arange(n, device=scores.device)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    for i in range(top_k):
        masked = torch.where(alive, scores, neg_inf)
        best = masked.argmax(dim=1)  # the first maximum, as jnp.argmax
        valid = masked[rows, best] > float("-inf")
        out[:, i] = torch.where(valid, best, -1)
        suppress = (iou[rows, best] > iou_threshold) | (cols[None, :] == best[:, None])
        alive &= ~(suppress & valid[:, None])
    return out.reshape(*lead, top_k)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        top_k: int) -> torch.Tensor:
    """:func:`nms_plain`'s picks: on a CUDA tensor through the NMS kernel
    (one launch for all the problems), on a CPU tensor through
    :func:`nms_plain`."""
    if not scores.is_cuda:
        return nms_plain(boxes, scores, iou_threshold, top_k)
    from drin_tpu_torch.ops.cuda.nms import nms_cuda

    return nms_cuda(boxes, scores, iou_threshold, top_k)


def generate_anchors(feature_size: tuple, stride: int, sizes=(32, 64, 128),
                     aspect_ratios=(0.5, 1.0, 2.0), device=None) -> torch.Tensor:
    """Anchors of one feature level, ``[H*W*A, 4]`` ordered (cell, anchor),
    the cells row-major over (h, w) and A = len(sizes) * len(aspect_ratios)
    ratio-major; the base anchors rounded half to even, as ``jnp.round``."""
    H, W = feature_size
    sizes = torch.tensor(sizes, dtype=torch.float32, device=device)
    ratios = torch.tensor(aspect_ratios, dtype=torch.float32, device=device)
    h_r = torch.sqrt(ratios)
    w_r = 1.0 / h_r
    ws = (w_r[:, None] * sizes[None, :]).reshape(-1)
    hs = (h_r[:, None] * sizes[None, :]).reshape(-1)
    base = torch.round(torch.stack([-ws, -hs, ws, hs], dim=1) / 2.0)  # [A, 4]
    shift_x = torch.arange(W, dtype=torch.float32, device=device) * stride
    shift_y = torch.arange(H, dtype=torch.float32, device=device) * stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx.reshape(-1), sy.reshape(-1)] * 2, dim=1)  # [H*W, 4]
    return (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0), clip: float = 4.135) -> torch.Tensor:
    """(dx, dy, dw, dh) deltas applied to anchors ``[..., 4]``
    (torchvision ``BoxCoder.decode``; ``clip`` = log(1000/16) bounds the
    exp)."""
    wx, wy, ww, wh = weights
    widths = anchors[..., 2] - anchors[..., 0]
    heights = anchors[..., 3] - anchors[..., 1]
    cx = anchors[..., 0] + 0.5 * widths
    cy = anchors[..., 1] + 0.5 * heights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=clip)
    dh = torch.clamp(deltas[..., 3] / wh, max=clip)
    pcx = dx * widths + cx
    pcy = dy * heights + cy
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """The inverse of :func:`decode_boxes` (``BoxCoder.encode``)."""
    wx, wy, ww, wh = weights
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    bcx = boxes[..., 0] + 0.5 * bw
    bcy = boxes[..., 1] + 0.5 * bh
    return torch.stack([wx * (bcx - acx) / aw, wy * (bcy - acy) / ah,
                        ww * torch.log(bw / aw), wh * torch.log(bh / ah)], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0, width), boxes[..., 1].clamp(0, height),
                        boxes[..., 2].clamp(0, width), boxes[..., 3].clamp(0, height)], dim=-1)


def roi_align_nchw(features: torch.Tensor, boxes: torch.Tensor, image: torch.Tensor,
                   output_size: tuple, spatial_scale: float = 1.0, sampling_ratio: int = 2,
                   aligned: bool = True) -> torch.Tensor:
    """RoIAlign over a batch: ``features`` [B, C, H, W], ``boxes`` [K, 4] in
    image coordinates, ``image`` [K] the batch index of each box ->
    ``[K, C, out_h, out_w]``.  Bilinear samples on a regular grid of
    ``sampling_ratio``^2 per bin, averaged; a sample outside [-1, H] x
    [-1, W] reads 0 (torchvision's ``bilinear_interpolate``), so a box past
    the border does not repeat the edge."""
    B, C, H, W = features.shape
    out_h, out_w = output_size
    K = boxes.shape[0]
    s = sampling_ratio
    offset = 0.5 if aligned else 0.0
    b = boxes * spatial_scale
    x1, y1 = b[:, 0] - offset, b[:, 1] - offset
    x2, y2 = b[:, 2] - offset, b[:, 3] - offset
    floor = 0.0 if aligned else 1.0
    bin_w = (x2 - x1).clamp_min(floor) / out_w
    bin_h = (y2 - y1).clamp_min(floor) / out_h
    dev = features.device
    grid_h = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    grid_w = torch.arange(out_w, dtype=torch.float32, device=dev)[:, None]
    sub = torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5
    iy = (grid_h[None] * bin_h[:, None, None] + sub[None] * bin_h[:, None, None] / s
          + y1[:, None, None]).reshape(K, -1)  # [K, out_h * s]
    ix = (grid_w[None] * bin_w[:, None, None] + sub[None] * bin_w[:, None, None] / s
          + x1[:, None, None]).reshape(K, -1)  # [K, out_w * s]
    in_y = (iy >= -1.0) & (iy <= H)
    in_x = (ix >= -1.0) & (ix <= W)
    y = iy.clamp(0.0, H - 1.0)
    x = ix.clamp(0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1_ = torch.clamp(y0 + 1, max=H - 1)
    x1_ = torch.clamp(x0 + 1, max=W - 1)
    wy = (y - y0)[:, :, None, None]  # [K, Sy, 1, 1]
    wx = (x - x0)[:, None, :, None]  # [K, 1, Sx, 1]
    nhwc = features.permute(0, 2, 3, 1).reshape(B * H * W, C)  # rows (b, h, w)
    base = (image.to(torch.int64) * (H * W))[:, None, None]

    def tap(yi, xi):  # [K, Sy, Sx, C]
        return nhwc[(base + yi[:, :, None] * W + xi[:, None, :]).reshape(-1)].reshape(
            K, yi.shape[1], xi.shape[1], C)

    val = tap(y0, x0) * (1 - wy) * (1 - wx)
    val = val + tap(y0, x1_) * (1 - wy) * wx
    val = val + tap(y1_, x0) * wy * (1 - wx)
    val = val + tap(y1_, x1_) * wy * wx
    val = torch.where((in_y[:, :, None] & in_x[:, None, :])[..., None], val, 0.0)
    val = val.reshape(K, out_h, s, out_w, s, C).mean(dim=(2, 4))
    return val.permute(0, 3, 1, 2)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: tuple,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """``drin_tpu``'s layout: ``features`` [H, W, C] (one NHWC image),
    ``boxes`` [K, 4] -> ``[K, out_h, out_w, C]``."""
    nchw = features.permute(2, 0, 1)[None]
    image = torch.zeros(boxes.shape[0], dtype=torch.int64, device=features.device)
    out = roi_align_nchw(nchw, boxes, image, output_size, spatial_scale, sampling_ratio, aligned)
    return out.permute(0, 2, 3, 1)


def resize_bilinear(images: torch.Tensor, size: tuple) -> torch.Tensor:
    """NCHW images resized with bilinear taps at half-pixel centres, edge
    taps renormalised: ``jax.image.resize(..., "bilinear")`` for an upsample
    (no antialias widening)."""
    return F.interpolate(images, size=size, mode="bilinear", align_corners=False,
                         antialias=False)
