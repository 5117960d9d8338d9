# -*- coding: utf-8 -*-
"""GHMFC's mention and entity encoders, the branches DRIN uses (port of
``drin_tpu/models/ghmfc.py::MentionEncoder`` / ``EntityEncoder``).

DRIN's text vertices come out of these two encoders.  The ``transformer``
and ``multimodal`` mention layers belong to the GHMFC port (ROADMAP:
GHMFC offline) and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from drin_tpu.common.config import Config
from drin_tpu_torch.nn.layers import Avg, AvgLinear, Linear, MaxPool
from drin_tpu_torch.ops.core import token_span_max, token_span_mean


class MentionEncoder(nn.Module):
    """Mention-side encoder over precomputed BERT features: ``linear``
    (span-average + projection) or ``none`` (span-average or max-pool, per
    ``mention_final_representation``)."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        name = cfg.mention_final_layer_name
        if name == "linear":
            self.final_layer = AvgLinear(cfg.bert_embed_dim, cfg.mention_final_output_dim,
                                         generator)
        elif name == "none":
            self.final_repr = (MaxPool(dim=1)
                               if cfg.mention_final_representation == "max pool" else Avg())
        else:
            raise NotImplementedError(
                f"mention_final_layer_name={name!r} belongs to the GHMFC port "
                "(ROADMAP: GHMFC offline); the port supports 'linear' and 'none'")

    def forward(self, sentence_feature, attention_mask, begin, end):
        if self.cfg.mention_final_layer_name == "linear":
            return self.final_layer(sentence_feature, begin, end)
        return self.final_repr(sentence_feature, begin, end)


class EntityEncoder(nn.Module):
    """Entity-side encoder over the four entity-text layouts: projected
    ([B, C, 2, D], slot 0 already projected), pooled cache ([B, C, 2, D]
    pooled/CLS), token-level wikimel ([B, C, Le, D] + mask) and wikidiverse
    ([B, C, D])."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        # a projected store already applied this linear (project_drin_tables)
        if cfg.entity_final_layer_name == "linear" and not cfg.entity_projected:
            self.final_layer = Linear(cfg.bert_embed_dim, cfg.entity_final_output_dim,
                                      generator)

    def forward(self, entity_feature, entity_mask):
        cfg = self.cfg
        if cfg.entity_projected and entity_feature.ndim == 4:
            return entity_feature[:, :, 0]
        if cfg.entity_pooling_cached and entity_feature.ndim == 4:
            encoded = entity_feature[:, :, 1 if cfg.entity_final_pooling == "bert default" else 0]
        elif entity_feature.ndim == 4:  # wikimel token level [B, C, Le, D]
            if cfg.entity_final_pooling == "bert default":
                encoded = entity_feature[:, :, 0, :]
            else:
                num_tokens = entity_mask.sum(-1)
                pool = token_span_mean if cfg.entity_final_pooling == "avg" else token_span_max
                encoded = pool(entity_feature, num_tokens)
        else:  # wikidiverse [B, C, D] passes through
            encoded = entity_feature
        if cfg.entity_final_layer_name == "linear":
            encoded = self.final_layer(encoded)
        return encoded
