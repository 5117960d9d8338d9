# -*- coding: utf-8 -*-
"""Model registry (port of ``drin_tpu/models/__init__.py``): DRIN, GHMFC over
precomputed features, GHMFC with online BERT and MELHI."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from drin_tpu_torch.common.config import Config


def get_model(cfg: Config, generator: Optional[torch.Generator] = None,
              bert_cfg=None) -> Tuple[object, str]:
    """Return ``(nn.Module, batch kind)`` for the configured model.

    Batch kind names the request layout: 'drin' the 15-tensor DRIN batch,
    'baseline' the 9-tensor offline batch, 'online' the token-id
    ``OnlineBatch``.  The model may be moved to any device afterwards: the
    online model picks its attention path from where its input lies.
    BERT's dimensions are ``bert_cfg``'s, else ``cfg.bert_checkpoint``'s
    (its weights are loaded by the caller: ``encoders.checkpoints.load_bert``),
    else bert-base's."""
    if cfg.model_type == "drin":
        from drin_tpu_torch.models.drin import DRIN

        return DRIN(cfg, generator), "drin"
    if cfg.model_type == "ghmfc":
        if cfg.online_bert:
            from drin_tpu_torch.encoders.bert import BertConfig
            from drin_tpu_torch.models.ghmfc import GHMFCOnline

            if bert_cfg is None and cfg.bert_checkpoint:  # dims from the checkpoint
                from drin_tpu_torch.encoders.checkpoints import load_bert

                bert_cfg, _ = load_bert(cfg.bert_checkpoint)
            elif bert_cfg is None:
                bert_cfg = BertConfig(max_position_embeddings=cfg.max_bert_len)
            return GHMFCOnline(cfg, bert_cfg, generator), "online"
        from drin_tpu_torch.models.ghmfc import GHMFC

        return GHMFC(cfg, generator), "baseline"
    if cfg.model_type == "melhi":
        if cfg.dataset_name != "wikidiverse":  # the JAX package's guard
            raise NotImplementedError("melhi is only implemented for wikidiverse")
        from drin_tpu_torch.models.melhi import MELHI

        return MELHI(cfg, generator), "baseline"
    raise ValueError(f"unknown model_type: {cfg.model_type}")
