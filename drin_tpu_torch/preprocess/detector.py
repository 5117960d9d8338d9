# -*- coding: utf-8 -*-
"""Object detectors for the ResNet stage (port of
``drin_tpu/preprocess/detector.py``).

A detector is a callable ``(images [B, H, W, 3] in [0, 1], topk) ->
(boxes [B, topk, 4], scores [B, topk])`` (numpy) with the reference's
padding convention: default_box / score 0 beyond the found objects.

  * :class:`FRCNNDetector`: the port's Faster R-CNN
    (``encoders/frcnn.py``) on one device, from a torchvision state dict
    (``detector_checkpoint``, either key layout).  Images are resized to
    the model's ``min_size`` square, boxes come back in the input's
    coordinates.
  * :class:`TorchDetector`: any proposal function's boxes and scores
    through the score threshold, NMS and the top-k padding.
  * :class:`WholeImageDetector`: the stub without a checkpoint, one
    "object" covering the whole image with score 1, emitted as the
    degenerate box [0, 0, 0, 0], which the crop step treats as "no crop"
    (the detector sees the resized array, so it cannot emit the original
    image's coordinates).
"""

from __future__ import annotations

import sys
import warnings
from typing import Callable, Tuple

import numpy as np
import torch

from drin_tpu_torch.common.config import Config


class WholeImageDetector:
    def __init__(self, cfg: Config):
        self.cfg = cfg

    def __call__(self, images: np.ndarray, topk: int) -> Tuple[np.ndarray, np.ndarray]:
        B = images.shape[0]
        boxes = np.tile(np.asarray(self.cfg.default_box, np.float32), (B, topk, 1))
        scores = np.zeros((B, topk), np.float32)
        boxes[:, 0] = [0, 0, 0, 0]  # degenerate = "whole ORIGINAL image, no crop"
        scores[:, 0] = 1.0
        return boxes, scores


def make_detector(cfg: Config, frcnn_cfg=None, device="cuda"):
    """The detector ``cfg`` selects.  With ``detector_checkpoint`` set, the
    torchvision state dict it names (``drin_object_detector``:
    ``faster_rcnn``, or ``mask_rcnn`` whose mask branch is dropped) loads
    into :class:`FRCNNDetector` on ``device``.  Without one it is
    :class:`WholeImageDetector`, LOUDLY: the reference always runs a real
    pretrained Faster R-CNN, so a store built with the stub has degraded
    object features and the miei edge degenerates to whole-image cosines."""
    if cfg.detector_checkpoint:
        from drin_tpu_torch.encoders.checkpoints import load_detector

        frcnn_cfg, state_dict = load_detector(cfg.detector_checkpoint, frcnn_cfg,
                                              cfg.drin_object_detector)
        return FRCNNDetector(cfg, state_dict, frcnn_cfg, device=device)
    msg = ("detector_checkpoint is unset: using WholeImageDetector — one "
           "degenerate whole-image 'object' per image instead of the "
           "reference's pretrained Faster R-CNN "
           f"({cfg.drin_object_detector}). Object features in the store will be "
           "whole-image features; set detector_checkpoint to a torchvision "
           "fasterrcnn_resnet50_fpn state_dict, or import_objects_from to a store "
           "preprocessed by a real detector, for production preprocessing.")
    warnings.warn(msg)
    print(f"WARNING: {msg}", file=sys.stderr, flush=True)
    return WholeImageDetector(cfg)


def _pad_topk(cfg: Config, boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              topk: int):
    """Boxes and scores where ``valid``, default_box / 0 elsewhere and in the
    slots past the found ones, as numpy ``[B, topk, 4]`` / ``[B, topk]``."""
    default = torch.tensor(cfg.default_box, dtype=torch.float32, device=boxes.device)
    b = torch.where(valid[..., None], boxes, default)
    s = torch.where(valid, scores, 0.0)
    B, k = s.shape
    if k < topk:
        b = torch.cat([b, default.expand(B, topk - k, 4)], 1)
        s = torch.cat([s, s.new_zeros((B, topk - k))], 1)
    return b.cpu().numpy(), s.cpu().numpy()


class FRCNNDetector:
    """The port's Faster R-CNN behind the detector interface, in float32 on
    ``device``.  ``images`` [B, H, W, 3] in [0, 1] are resized bilinearly to
    the model's ``min_size`` square (``jax.image.resize``'s taps), run
    ``batch`` images a forward (at 800 px a forward of 8 peaked at 4.9 GiB
    on an NVIDIA H100 80GB HBM3, most of it the RoI stage's gathers), and
    the ``topk`` best
    detections come back with their boxes scaled to the input's
    coordinates, padded with default_box / 0.  The caller holds the TF32
    flags (the ResNet stage runs it inside ``stages.full_float32()``)."""

    batch = 8

    def __init__(self, cfg: Config, state_dict, frcnn_cfg=None, device="cuda"):
        from drin_tpu_torch.encoders.frcnn import FasterRCNN, FRCNNConfig

        self.cfg = cfg
        self.frcnn_cfg = frcnn_cfg or FRCNNConfig()
        self.device = torch.device(device)
        with torch.device("meta"):
            model = FasterRCNN(self.frcnn_cfg)
        model.load_state_dict(state_dict, assign=True)
        self.model = model.to(device=self.device, dtype=torch.float32).eval()

    def detect(self, x: torch.Tensor):
        """[B, 3, H, W] on the device -> the model's (boxes, scores, labels)
        at ``min_size`` square, ``batch`` images a forward."""
        from drin_tpu_torch.ops.detection import resize_bilinear

        size = self.frcnn_cfg.min_size
        outs = [self.model(resize_bilinear(x[i:i + self.batch], (size, size)))
                for i in range(0, x.shape[0], self.batch)]
        return tuple(torch.cat(parts, 0) for parts in zip(*outs))

    def __call__(self, images, topk: int):
        from drin_tpu_torch.encoders.frcnn import take_along, top_k

        size = self.frcnn_cfg.min_size
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)
        H, W = x.shape[1:3]
        with torch.inference_mode():
            boxes, scores, _ = self.detect(x.permute(0, 3, 1, 2))
            top_s, top_i = top_k(scores, min(topk, scores.shape[1]))
            scale = torch.tensor([W / size, H / size, W / size, H / size], dtype=torch.float32,
                                 device=self.device)
            return _pad_topk(self.cfg, take_along(boxes, top_i) * scale, top_s, top_s > 0, topk)


class TorchDetector:
    """A proposal function's detections through NMS and the top-k padding
    (``drin_tpu``'s ``JaxDetector``).  ``propose_fn(images) -> (boxes [B, N,
    4], scores [B, N])`` as tensors; scores under ``score_threshold`` are
    dropped, the NMS of all B images is one call (the kernel on CUDA
    tensors), and the kept boxes are padded with default_box / 0."""

    def __init__(self, cfg: Config, propose_fn: Callable, iou_threshold: float = 0.5,
                 score_threshold: float = 0.05):
        self.cfg = cfg
        self.propose_fn = propose_fn
        self.iou_threshold = iou_threshold
        self.score_threshold = score_threshold

    def __call__(self, images, topk: int):
        from drin_tpu_torch.encoders.frcnn import take_along
        from drin_tpu_torch.ops.detection import nms

        with torch.inference_mode():
            boxes, scores = self.propose_fn(images)
            keep = nms(boxes, torch.where(scores >= self.score_threshold, scores, float("-inf")),
                       self.iou_threshold, topk)
            valid, safe = keep >= 0, keep.clamp_min(0)
            return _pad_topk(self.cfg, take_along(boxes, safe), take_along(scores, safe), valid, topk)
