# -*- coding: utf-8 -*-
"""Reading and writing the feature store's ``.npy`` arrays by name (the
port's copy of ``load_field`` / ``save_field`` of
``drin_tpu/common/npy_io.py``; the streaming writer belongs to preprocessing
and is not ported)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def load_field(preprocess_dir: str, field: str, split: Optional[str] = None,
               mmap: Optional[str] = None):
    """Load one feature-store array by the ``{field}_{split}.npy`` naming
    contract (underscores in the field name become dashes)."""
    name = field.replace("_", "-") + (f"_{split}" if split else "") + ".npy"
    return np.load(os.path.join(preprocess_dir, name), mmap_mode=mmap)


def save_field(preprocess_dir: str, field: str, value, split: Optional[str] = None) -> str:
    """Write one array under the same naming contract; returns its path."""
    os.makedirs(preprocess_dir, exist_ok=True)
    name = field.replace("_", "-") + (f"_{split}" if split else "") + ".npy"
    path = os.path.join(preprocess_dir, name)
    np.save(path, np.asarray(value))
    return path
