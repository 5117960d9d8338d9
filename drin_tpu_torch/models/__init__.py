# -*- coding: utf-8 -*-
"""Model registry (port of ``drin_tpu/models/__init__.py``), DRIN only."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from drin_tpu.common.config import Config


def get_model(cfg: Config, generator: Optional[torch.Generator] = None) -> Tuple[object, str]:
    """Return ``(nn.Module, batch kind)`` for the configured model."""
    if cfg.model_type == "drin":
        from drin_tpu_torch.models.drin import DRIN

        return DRIN(cfg, generator), "drin"
    raise NotImplementedError(
        f"model_type={cfg.model_type!r} is not ported yet (ROADMAP: GHMFC "
        "offline, MELHI, online BERT); the port runs DRIN")
