# -*- coding: utf-8 -*-
"""Faster R-CNN (port of ``drin_tpu/encoders/frcnn.py``): a ResNet-50 body
with FrozenBN, an FPN, the RPN and the box head, as ``nn.Module``s over NCHW
tensors.

The parameters carry torchvision's >= 0.13 ``fasterrcnn_resnet50_fpn``
keys (``backbone.body.layer1.0.conv1.weight``,
``backbone.fpn.inner_blocks.0.0.weight``, ``rpn.head.conv.0.0.weight``,
``roi_heads.box_head.fc6.weight``, ...), so a torchvision state dict loads as
it is (``encoders/checkpoints.py::load_detector`` also takes the older
spelling).  fc6 reads the RoI features flattened channel first, as
torchvision's does; the JAX package permutes the weight instead.

The detection logic follows ``drin_tpu``, not torchvision: per-level top-k
and NMS of the proposals, then their joint top-k; every (proposal, class)
pair decoded and the candidates cut to the ``pre_class_nms_topk`` best
before one class-offset NMS; the 4.135 delta clip; anchors at strides
4..64.  Every stage runs over the whole batch of images given, and each NMS
is one launch for all of its problems: every (image, level) of the
proposals, every image of the class NMS.  The RoI stage aligns each box at
its own level only (the JAX package aligns it at all four and gathers one);
its gathers grow with the batch (~0.4 GB an image at 800 px), so the
detector (``preprocess/detector.py``) feeds 8 images a forward.
Top-k cuts are stable sorts: among equal scores (the -inf fills) the lower
index comes first, as ``lax.top_k`` gives it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from drin_tpu_torch.ops.detection import (clip_boxes, decode_boxes, generate_anchors, nms,
                                          roi_align_nchw)


class FRCNNConfig:
    def __init__(
        self,
        depths: Sequence[int] = (3, 4, 6, 3),  # resnet50
        stem_width: int = 64,
        fpn_channels: int = 256,
        anchor_sizes: Sequence[Sequence[int]] = ((32,), (64,), (128,), (256,), (512,)),
        aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
        pre_nms_topk: int = 1000,
        post_nms_topk: int = 1000,
        rpn_nms_thresh: float = 0.7,
        box_score_thresh: float = 0.05,
        box_nms_thresh: float = 0.5,
        box_min_size: float = 1e-2,
        detections_per_img: int = 100,
        pre_class_nms_topk: int = 4096,
        num_classes: int = 91,
        representation_size: int = 1024,
        min_size: int = 800,
        image_mean: Sequence[float] = (0.485, 0.456, 0.406),
        image_std: Sequence[float] = (0.229, 0.224, 0.225),
    ):
        self.depths = tuple(depths)
        self.stem_width = stem_width
        self.fpn_channels = fpn_channels
        self.anchor_sizes = tuple(tuple(s) for s in anchor_sizes)
        self.aspect_ratios = tuple(aspect_ratios)
        self.pre_nms_topk = pre_nms_topk
        self.post_nms_topk = post_nms_topk
        self.rpn_nms_thresh = rpn_nms_thresh
        self.box_score_thresh = box_score_thresh
        self.box_nms_thresh = box_nms_thresh
        self.box_min_size = box_min_size
        self.detections_per_img = detections_per_img
        self.pre_class_nms_topk = pre_class_nms_topk
        self.num_classes = num_classes
        self.representation_size = representation_size
        self.min_size = min_size
        self.image_mean = tuple(image_mean)
        self.image_std = tuple(image_std)


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest along the last axis, the lower index first among
    equal values (``lax.top_k``'s order), by a stable sort."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def take_along(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[b, index[b, ...]]`` for ``x`` [B, N, ...] and ``index`` [B, K]."""
    shape = index.shape + x.shape[2:]
    flat = index.reshape(index.shape[0], -1, *([1] * (x.dim() - 2))).expand(
        -1, -1, *x.shape[2:])
    return torch.gather(x, 1, flat).reshape(shape)


class FrozenBN(nn.Module):
    """torchvision ``FrozenBatchNorm2d``: x * w + (bias - mean * w) with
    w = weight / sqrt(var + eps), all four from the checkpoint."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, init in (("weight", torch.ones), ("bias", torch.zeros),
                           ("running_mean", torch.zeros), ("running_var", torch.ones)):
            self.register_buffer(name, init(features))

    def forward(self, x):
        w = self.weight * torch.rsqrt(self.running_var + self.eps)
        return x * w[:, None, None] + (self.bias - self.running_mean * w)[:, None, None]


class Bottleneck(nn.Module):
    """torchvision's ResNet bottleneck, the stride on the 3x3 convolution."""

    def __init__(self, in_ch: int, width: int, out: int, stride: int, shortcut: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = FrozenBN(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBN(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = FrozenBN(out)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, out, 1, stride=stride, bias=False),
                                         FrozenBN(out)) if shortcut else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return F.relu(self.bn3(self.conv3(h)) + residual)


class ResNet50Body(nn.Module):
    """The ResNet trunk (``backbone.body``): C2..C5 at strides 4..32."""

    def __init__(self, c: FRCNNConfig):
        super().__init__()
        w = c.stem_width
        self.conv1 = nn.Conv2d(3, w, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(w)
        in_ch = w
        for li, depth in enumerate(c.depths):
            out = w * 4 * 2**li
            blocks = [Bottleneck(in_ch if bi == 0 else out, w * 2**li, out,
                                 2 if (bi == 0 and li > 0) else 1, shortcut=bi == 0)
                      for bi in range(depth)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            in_ch = out
        self.n_layers = len(c.depths)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # the padding reads -inf
        outs = []
        for li in range(self.n_layers):
            x = getattr(self, f"layer{li + 1}")(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    """Lateral 1x1, top-down nearest 2x upsample, 3x3 smoothing, and P6 as a
    stride-2 max pool of P5 (``backbone.fpn``)."""

    def __init__(self, in_channels: Sequence[int], channels: int):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, channels, 1)) for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(channels, channels, 3, padding=1)) for _ in in_channels)

    def forward(self, feats):
        laterals = [blk(f) for blk, f in zip(self.inner_blocks, feats)]
        for i in range(len(laterals) - 2, -1, -1):
            # half-pixel nearest, jax.image.resize's (the same taps as
            # torchvision's "nearest" at the exact 2x of these maps)
            up = F.interpolate(laterals[i + 1], size=laterals[i].shape[-2:], mode="nearest-exact")
            laterals[i] = laterals[i] + up
        outs = [blk(lat) for blk, lat in zip(self.layer_blocks, laterals)]
        return outs + [F.max_pool2d(outs[-1], 1, stride=2)]


class Backbone(nn.Module):
    def __init__(self, c: FRCNNConfig):
        super().__init__()
        self.body = ResNet50Body(c)
        w = c.stem_width
        self.fpn = FPN([w * 4 * 2**li for li in range(len(c.depths))], c.fpn_channels)

    def forward(self, x):
        return self.fpn(self.body(x))


class RPNHead(nn.Module):
    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Sequential(nn.Conv2d(channels, channels, 3, padding=1),
                                                nn.ReLU()))
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats):
        logits, deltas = [], []
        for f in feats:
            h = self.conv(f)
            logits.append(self.cls_logits(h))
            deltas.append(self.bbox_pred(h))
        return logits, deltas


class RPN(nn.Module):
    def __init__(self, c: FRCNNConfig):
        super().__init__()
        self.head = RPNHead(c.fpn_channels, len(c.aspect_ratios) * len(c.anchor_sizes[0]))


class BoxHead(nn.Module):
    def __init__(self, in_features: int, representation_size: int):
        super().__init__()
        self.fc6 = nn.Linear(in_features, representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)

    def forward(self, x):  # [N, C * P * P], channel first
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class BoxPredictor(nn.Module):
    def __init__(self, representation_size: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(representation_size, num_classes)
        self.bbox_pred = nn.Linear(representation_size, num_classes * 4)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


class RoIHeads(nn.Module):
    def __init__(self, c: FRCNNConfig):
        super().__init__()
        self.box_head = BoxHead(c.fpn_channels * 7 * 7, c.representation_size)
        self.box_predictor = BoxPredictor(c.representation_size, c.num_classes)


def assign_levels(boxes: torch.Tensor, k_min: int = 2, k_max: int = 5) -> torch.Tensor:
    """FPN level per box (torchvision ``LevelMapper``), 0-indexed into
    P2..P5: floor(4 + log2(sqrt(area) / 224 + 1e-6)) clipped to [2, 5]."""
    area = ((boxes[..., 2] - boxes[..., 0]).clamp_min(0)
            * (boxes[..., 3] - boxes[..., 1]).clamp_min(0))
    k = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-6))
    return k.clamp(k_min, k_max).to(torch.int64) - k_min


class FasterRCNN(nn.Module):
    """Images [B, 3, H, W] in [0, 1] (H, W multiples of 32) -> boxes
    [B, D, 4], scores [B, D], labels [B, D] with D = detections_per_img,
    zero beyond the detections found."""

    def __init__(self, cfg: FRCNNConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.rpn = RPN(cfg)
        self.roi_heads = RoIHeads(cfg)

    def features(self, images: torch.Tensor):
        """The five FPN levels P2..P6 of the normalized images."""
        mean = torch.tensor(self.cfg.image_mean, dtype=images.dtype, device=images.device)
        std = torch.tensor(self.cfg.image_std, dtype=images.dtype, device=images.device)
        return self.backbone((images - mean[:, None, None]) / std[:, None, None])

    def proposals(self, feats, logits, deltas, H: int, W: int) -> torch.Tensor:
        """[B, post_nms_topk, 4]: per level the top ``pre_nms_topk`` anchors
        decoded, clipped, degenerate ones at -inf, NMS; then the joint top-k.
        One NMS launch takes every (image, level): the shorter levels padded
        with -inf scores, which no walk keeps."""
        c = self.cfg
        B = logits[0].shape[0]
        level_boxes, level_scores, level_k = [], [], []
        for lvl, (lg, dl, f) in enumerate(zip(logits, deltas, feats)):
            anchors = generate_anchors(tuple(f.shape[-2:]), 2 ** (lvl + 2), c.anchor_sizes[lvl],
                                       c.aspect_ratios, device=f.device)
            score = lg.permute(0, 2, 3, 1).reshape(B, -1)  # (h, w, a), NHWC's order
            delta = dl.permute(0, 2, 3, 1).reshape(B, -1, 4)
            k = min(c.pre_nms_topk, score.shape[1])
            top_s, top_i = top_k(score, k)
            boxes = clip_boxes(decode_boxes(take_along(delta, top_i), anchors[top_i]), H, W)
            valid = (((boxes[..., 2] - boxes[..., 0]) > 1e-3)
                     & ((boxes[..., 3] - boxes[..., 1]) > 1e-3))
            level_boxes.append(boxes)
            level_scores.append(torch.where(valid, top_s, float("-inf")))
            level_k.append(min(c.post_nms_topk, k))
        n = max(s.shape[1] for s in level_scores)
        keep = nms(torch.stack([F.pad(b, (0, 0, 0, n - b.shape[1])) for b in level_boxes], 1),
                   torch.stack([F.pad(s, (0, n - s.shape[1]), value=float("-inf"))
                                for s in level_scores], 1),
                   c.rpn_nms_thresh, max(level_k))  # [B, levels, max k]
        props, pscores = [], []
        for lvl, (boxes, scores, k) in enumerate(zip(level_boxes, level_scores, level_k)):
            kl = keep[:, lvl, :k]
            kv, safe = kl >= 0, kl.clamp_min(0)
            props.append(torch.where(kv[..., None], take_along(boxes, safe), 0.0))
            pscores.append(torch.where(kv, take_along(scores, safe), float("-inf")))
        props, pscores = torch.cat(props, 1), torch.cat(pscores, 1)
        _, top_i = top_k(pscores, min(c.post_nms_topk, props.shape[1]))
        return take_along(props, top_i)

    def class_outputs(self, feats, proposals: torch.Tensor):
        """Class probabilities without the background [b, K, classes - 1]
        and box deltas [b, K, classes - 1, 4] of ``proposals`` [b, K, 4],
        over the FPN levels ``feats`` of the same b images."""
        c = self.cfg
        b, K = proposals.shape[:2]
        flat = proposals.reshape(-1, 4)
        image = torch.arange(b, device=flat.device).repeat_interleave(K)
        levels = assign_levels(flat)
        pooled = flat.new_empty((b * K, c.fpn_channels, 7, 7))
        for lvl in range(4):
            idx = torch.nonzero(levels == lvl).squeeze(1)
            if idx.numel():
                pooled[idx] = roi_align_nchw(feats[lvl], flat[idx], image[idx], (7, 7),
                                             1.0 / 2 ** (lvl + 2))
        rep = self.roi_heads.box_head(pooled.flatten(1))
        cls_logits, box_deltas = self.roi_heads.box_predictor(rep)
        probs = torch.softmax(cls_logits, dim=-1)[:, 1:]
        deltas = box_deltas.reshape(-1, c.num_classes, 4)[:, 1:]
        return probs.reshape(b, K, -1), deltas.reshape(b, K, -1, 4)

    def postprocess(self, probs, deltas, proposals, H: int, W: int):
        """``drin_tpu``'s static-shape ``postprocess_detections``: every
        (proposal, class) pair decoded and clipped, the score and size
        filters as -inf, the ``pre_class_nms_topk`` best kept, then one
        greedy NMS over boxes offset by ``label * (max(H, W) + 2)`` so that
        classes never overlap; a launch for all b images."""
        c = self.cfg
        b, N, K = probs.shape
        boxes = decode_boxes(deltas.reshape(b, N * K, 4), proposals.repeat_interleave(K, dim=1),
                             weights=(10.0, 10.0, 5.0, 5.0))
        boxes = clip_boxes(boxes, H, W)
        scores = probs.reshape(b, N * K)
        labels = torch.arange(1, K + 1, device=probs.device).repeat(N)
        ok = ((scores >= c.box_score_thresh)
              & ((boxes[..., 2] - boxes[..., 0]) >= c.box_min_size)
              & ((boxes[..., 3] - boxes[..., 1]) >= c.box_min_size))
        scores = torch.where(ok, scores, float("-inf"))
        top_s, top_i = top_k(scores, min(c.pre_class_nms_topk, N * K))
        boxes, labels = take_along(boxes, top_i), labels[top_i]
        offset = labels.to(boxes.dtype) * (max(H, W) + 2.0)
        keep = nms(boxes + offset[..., None], top_s, c.box_nms_thresh, c.detections_per_img)
        kv, safe = keep >= 0, keep.clamp_min(0)
        return (torch.where(kv[..., None], take_along(boxes, safe), 0.0),
                torch.where(kv, take_along(top_s, safe), 0.0),
                torch.where(kv, take_along(labels, safe), 0))

    def forward(self, images: torch.Tensor):
        H, W = images.shape[-2:]
        feats = self.features(images)
        logits, deltas = self.rpn.head(feats)
        proposals = self.proposals(feats, logits, deltas, H, W)
        del logits, deltas
        probs, deltas = self.class_outputs(feats[:4], proposals)
        return self.postprocess(probs, deltas, proposals, H, W)
