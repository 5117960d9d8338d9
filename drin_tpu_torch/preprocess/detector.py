# -*- coding: utf-8 -*-
"""Object detectors for the ResNet stage (the port's copy of
``drin_tpu/preprocess/detector.py``, its stub half).

A detector is a callable ``(images [B, H, W, 3] in [0, 1], topk) ->
(boxes [B, topk, 4], scores [B, topk])`` with the reference's padding
convention (default_box / score 0 beyond the found objects).

:class:`WholeImageDetector` is the one ported: one "object" covering the
full image with score 1, emitted as the degenerate box [0, 0, 0, 0], which
the crop step treats as "no crop" (the detector sees the resized array, so
it cannot emit the original image's coordinates).  The Faster R-CNN that a
set ``detector_checkpoint`` selects in the JAX package is not ported yet and
is refused by name (ROADMAP item 8); ``import_objects_from`` adopts a real
detector's arrays from an existing store instead.
"""

from __future__ import annotations

import sys
import warnings
from typing import Tuple

import numpy as np

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


def make_detector(cfg: Config):
    """The detector ``cfg`` selects.  Without ``detector_checkpoint`` it is
    :class:`WholeImageDetector`, LOUDLY: the reference always runs a real
    pretrained Faster R-CNN, so a store built with the stub has degraded
    object features and the miei edge degenerates to whole-image cosines.
    With one set it raises: the Faster R-CNN detector is not ported."""
    if cfg.detector_checkpoint:
        raise NotImplementedError(
            f"detector_checkpoint={cfg.detector_checkpoint!r}: the Faster R-CNN detector "
            f"({cfg.drin_object_detector}) is not ported yet (ROADMAP: item 8, preprocessing "
            "and data tools); leave detector_checkpoint unset for the whole-image stub, or set "
            "import_objects_from to a store whose detector stage produced the object arrays")
    msg = ("detector_checkpoint is unset: using WholeImageDetector — one "
           "degenerate whole-image 'object' per image instead of the "
           "reference's pretrained Faster R-CNN "
           f"({cfg.drin_object_detector}). Object features in the store will be "
           "whole-image features; use import_objects_from with a store preprocessed "
           "by a real detector for production preprocessing.")
    warnings.warn(msg)
    print(f"WARNING: {msg}", file=sys.stderr, flush=True)
    return WholeImageDetector(cfg)
