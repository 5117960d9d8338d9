# -*- coding: utf-8 -*-
"""Image loading + preprocessing for the frozen-encoder stages (the port's
copy of ``drin_tpu/preprocess/images.py``).

Suffix probing, minimum-size rejection, and any failure -> the shared
default image.  Decoding is PIL's and runs in a thread pool (PIL releases
the interpreter lock while it decodes); resize and normalisation happen in
numpy and give NHWC float32 arrays, which the stages turn into NCHW tensors.
PIL is imported at the first decode, so the module imports without it; a
decode without it raises naming the package (Pillow)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

# probe order IS the reference's: with several candidate files the same one
# must resolve
SUFFIXES = ("", ".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG",
            ".tif", ".TIF", ".tiff", ".TIFF")

# torchvision/HF ImageNet normalization (resnet stages)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# CLIP normalization
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def pil_image():
    """``PIL.Image``, or an ImportError that names the package to install."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding images needs Pillow (import PIL failed); the ResNet and "
                          "CLIP stages and the WikiDiverse prepare stage read image files "
                          "through it") from e
    return Image


def load_image(path: str, default_image: str, min_size: Tuple[int, int] = (50, 50)):
    """Open ``path`` trying the known suffixes; reject images smaller than
    ``min_size``; fall back to ``default_image`` on any failure."""
    Image = pil_image()
    for suffix in SUFFIXES:
        try:
            image = Image.open(path + suffix)
            if image.size[0] < min_size[0] or image.size[1] < min_size[1]:
                raise ValueError("image is too small")
            return image.convert("RGB")
        except FileNotFoundError:
            continue
        except Exception:
            break
    return Image.open(default_image).convert("RGB")


def resnet_preprocess(image, size: Tuple[int, int] = (224, 224),
                      crop_pct: float = 0.875, resample: str = "bilinear") -> np.ndarray:
    """The ResNet stage's pipeline: a resize to ``size``, then the ConvNext
    processor's step, which for sizes under 384 resizes the shortest edge UP
    to ``size/crop_pct`` and center-crops back to ``size``, then rescale +
    ImageNet normalization.  ``crop_pct=0`` disables the ConvNext step.
    Returns [H, W, 3] f32 NHWC."""
    Image = pil_image()
    image = image.resize(size)
    s = min(size)
    if crop_pct and 0.0 < crop_pct < 1.0 and s < 384:
        rs = int(s / crop_pct)
        w, h = image.size
        nw, nh = (rs, int(h * rs / w)) if w < h else (int(w * rs / h), rs)
        rmode = Image.BICUBIC if resample == "bicubic" else Image.BILINEAR
        image = image.resize((nw, nh), rmode)
        left, top = (nw - size[0]) // 2, (nh - size[1]) // 2
        image = image.crop((left, top, left + size[0], top + size[1]))
    x = np.asarray(image, dtype=np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def clip_preprocess(image, size: int = 224) -> np.ndarray:
    """CLIPProcessor equivalent: resize shortest side to ``size`` (bicubic),
    center-crop, scale, CLIP-normalize.  Returns [size, size, 3] f32 NHWC.

    The long edge uses int() TRUNCATION, as HF's resize does: round() would
    make the canvas 1px larger whenever the aspect ratio's fraction is >= .5,
    shifting the center crop and every pixel after it."""
    Image = pil_image()
    w, h = image.size
    if w < h:
        nw, nh = size, int(h * size / w)
    else:
        nw, nh = int(w * size / h), size
    image = image.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    image = image.crop((left, top, left + size, top + size))
    x = np.asarray(image, dtype=np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


class ImageBatcher:
    """Threaded decode -> preprocess -> stacked batches."""

    def __init__(self, default_image: str, min_size=(50, 50), workers: int = 16):
        self.default_image = default_image
        self.min_size = min_size
        self.pool = ThreadPoolExecutor(max_workers=workers)

    def load_batch(self, paths: Sequence[str], preprocess, crops: Optional[Sequence] = None) -> np.ndarray:
        """Decode + preprocess ``paths`` in parallel; optional per-path crop
        boxes (for object regions).  Returns [B, H, W, 3] f32."""

        def one(i):
            img = load_image(str(paths[i]), self.default_image, self.min_size)
            if crops is not None:
                box = tuple(float(v) for v in crops[i])
                # degenerate box: "whole image" sentinel (WholeImageDetector)
                if box[2] > box[0] and box[3] > box[1]:
                    img = img.crop(box)
            return preprocess(img)

        return np.stack(list(self.pool.map(one, range(len(paths)))))

    def load_batch_chunked(self, paths: Sequence[str], preprocess,
                           crops: Optional[Sequence] = None,
                           chunk: int = 0) -> np.ndarray:
        """:meth:`load_batch` in sub-chunks of ``chunk`` paths written into ONE
        preallocated buffer, so that the decode working set (per-image
        results plus the stack copy) stays bounded by ``chunk``."""
        if not chunk or chunk >= len(paths):
            return self.load_batch(paths, preprocess, crops)
        out = None
        for j in range(0, len(paths), chunk):
            sub = self.load_batch(paths[j : j + chunk], preprocess,
                                  crops[j : j + chunk] if crops is not None else None)
            if out is None:
                out = np.empty((len(paths),) + sub.shape[1:], sub.dtype)
            out[j : j + len(sub)] = sub
        return out

    def close(self):
        self.pool.shutdown()
