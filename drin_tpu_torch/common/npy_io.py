# -*- coding: utf-8 -*-
"""Reading the feature store's ``.npy`` arrays (the reading half of
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
