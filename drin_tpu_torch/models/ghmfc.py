# -*- coding: utf-8 -*-
"""GHMFC (port of ``drin_tpu/models/ghmfc.py``): gated hierarchical
multimodal fusion between the mention sentence and its image regions, scored
by cosine against pooled candidate entity text.

:class:`MentionEncoder` and :class:`EntityEncoder` also give DRIN its text
vertices.  :class:`GHMFC` runs over precomputed BERT features;
:class:`GHMFCOnline` runs BERT inside the forward pass.

Both forwards take a candidate ``split`` (``parallel/mesh.py``) with DRIN's
contract: the batch's entity tensors are the caller's block (of the
candidates, or in zipped mode of the entity sentences), the mention tower
runs whole on every rank of the model group, and every rank returns the
group's score blocks gathered in model-index order, cut to C after the
gather.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from drin_tpu_torch.common.config import Config
from drin_tpu_torch.nn.layers import (Avg, AvgLinear, CrossAttention, Linear, MaxPool,
                                      MultilayerTransformer, MultimodalFusion)
from drin_tpu_torch.ops.core import (cosine_similarity, token_span_max, token_span_mean,
                                     unzip_entities)
from drin_tpu_torch.parallel import collectives


class MentionEncoder(nn.Module):
    """Mention-side encoder over BERT features.  ``mention_final_layer_name``
    picks ``linear`` (span-average + projection), ``multimodal`` (gated
    text/image fusion when ``mention_multimodal_attention == "bi"``, else
    text-only cross attention followed by the final representation),
    ``transformer`` (the encoder stack followed by the final representation)
    or ``none`` (the final representation alone: max-pool or span-average)."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        name = cfg.mention_final_layer_name
        self.fusion = name == "multimodal" and cfg.mention_multimodal_attention == "bi"
        if name == "linear":
            self.final_layer = AvgLinear(cfg.bert_embed_dim, cfg.mention_final_output_dim,
                                         generator)
            return
        if self.fusion:
            self.intermediate_layer = MultimodalFusion(
                cfg.bert_embed_dim, cfg.resnet_embed_dim, cfg.mention_final_output_dim,
                cfg.transformer_num_heads, cfg.multimodal_subspace_activation, generator,
                cfg.transformer_dropout)
            return
        if name == "multimodal":
            self.intermediate_layer = CrossAttention(cfg.bert_embed_dim, cfg.resnet_embed_dim,
                                                     cfg.transformer_num_heads, generator,
                                                     cfg.transformer_dropout)
        elif name == "transformer":
            self.intermediate_layer = MultilayerTransformer(
                cfg.bert_embed_dim, cfg.transformer_num_layers, cfg.transformer_num_heads,
                cfg.transformer_ffn_hidden_size, cfg.transformer_dropout,
                cfg.transformer_ffn_activation, generator)
        self.final_repr = (MaxPool(dim=1)
                           if cfg.mention_final_representation == "max pool" else Avg())

    def forward(self, sentence_feature, attention_mask, begin, end, image_feature=None,
                deterministic: bool = True, rng: Optional[torch.Generator] = None):
        name = self.cfg.mention_final_layer_name
        if name == "linear":
            return self.final_layer(sentence_feature, begin, end)
        if self.fusion:
            return self.intermediate_layer(sentence_feature, attention_mask, image_feature,
                                           deterministic, rng)
        feature = sentence_feature
        if name == "multimodal":  # text-only cross attention
            feature = self.intermediate_layer(sentence_feature, attention_mask, image_feature,
                                              None, deterministic, rng)
        elif name == "transformer":
            feature = self.intermediate_layer(sentence_feature, attention_mask, deterministic, rng)
        return self.final_repr(feature, begin, end)


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


def _cosine_scores(mention, entity, num_candidates: int, split=None):
    """cos(mention [B, D], entity [B, C, D]) cut to the model's candidates
    (padded fake candidates sit past them).  With ``split``, ``entity`` is
    this rank's block: the group's blocks are gathered first, then cut."""
    scores = cosine_similarity(mention[:, None, :].expand_as(entity), entity)
    if split is not None:
        scores = collectives.gather_blocks(scores, split.group, split.order)
    return scores[:, :num_candidates]



class GHMFC(nn.Module):
    """GHMFC over precomputed features.  Batch (answer stripped): mention
    fields [0:5], entity fields [5:8].  Output: cosine scores [B, C]."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.mention_encoder = MentionEncoder(cfg, generator)
        self.entity_encoder = EntityEncoder(cfg, generator)

    def forward(self, batch, deterministic: bool = True,
                rng: Optional[torch.Generator] = None, split=None):
        """Scores [B, C]; with ``split`` the entity tensors are this rank's
        block of the padded candidates, and every rank of the model group
        returns the gathered scores."""
        (sentence_feature, attention_mask, begin, end, mention_image,
         entity_feature, entity_mask, _entity_image) = batch
        if split is not None:
            split.check_block(entity_feature.shape[1], self.cfg.num_candidates_model)
        mention = self.mention_encoder(sentence_feature, attention_mask, begin, end,
                                       mention_image, deterministic, rng)
        entity = self.entity_encoder(entity_feature, entity_mask)
        return _cosine_scores(mention, entity, self.cfg.num_candidates_model, split)


class GHMFCOnline(nn.Module):
    """GHMFC with BERT inside the forward pass.

    Batch (answer stripped), zipped mode (``cfg.num_entity_sentence > 0``):
      (mention_ids [B, Lm], mention_mask, begin, end, mention_image,
       entity_ids [B, S, Le], entity_mask [B, S, Le], sep_idx [B, S, E],
       entity_image)
    direct mode (``num_entity_sentence == 0``): entity_ids/mask are
    [B, C, Le] and sep_idx is an ignored placeholder.

    One shared text tower serves the mention and the entity side, and the
    entity sentences go through it as one batched [B*S, L] call.  The tower
    is BERT (``bert_cfg`` a ``BertConfig``, parameters under ``bert.``) or
    granite-4.0-h-micro's hybrid stack (``bert_cfg`` a
    ``GraniteHybridConfig``, parameters under ``model.``, the upstream
    checkpoint's prefix), whose width is ``cfg.bert_embed_dim`` either way;
    the hybrid tower is causal, reads no mask and runs forward only.
    With a candidate ``split`` BERT encodes only this rank's entity
    sequences: [B*Cb, Le] candidates in direct mode, [B*S/n, L] sentences in
    zipped mode, whose S/n sentences pool to this rank's (S/n)*E candidate
    slots.
    ``bert_fused_attention=None`` is settled at each call from where the
    tensors lie (the kernel on CUDA, the written-out product on the CPU), so
    the model may be built anywhere and moved.  BERT is frozen (it runs
    under ``torch.no_grad()``, so no gradient reaches its parameters) unless
    ``cfg.finetune_bert``; ``cfg.bert_remat`` then recomputes each BERT layer
    in the backward instead of keeping its activations.  ``deterministic=False``
    turns on the fusion's attention dropout, drawn from ``rng``; BERT itself
    has no dropout."""

    def __init__(self, cfg: Config, bert_cfg=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        from drin_tpu_torch.encoders.bert import BertConfig, BertModel
        from drin_tpu_torch.encoders.granite_hybrid import GraniteHybridConfig, GraniteHybridModel

        if cfg.num_entity_sentence and cfg.entity_final_pooling == "bert default":
            raise ValueError(
                "entity_final_pooling='bert default' has no per-candidate pooler output in "
                "zipped mode; use 'avg' or 'max', or set num_entity_sentence=0")
        self.cfg = cfg
        if isinstance(bert_cfg, GraniteHybridConfig):
            if cfg.finetune_bert:
                raise ValueError("the granite_hybrid text tower runs forward only (its scan "
                                 "kernel has no backward): finetune_bert must be False")
            if cfg.entity_final_pooling == "bert default" or \
                    cfg.bert_embed_dim != bert_cfg.hidden_size:
                raise ValueError("the granite_hybrid tower has no pooler output, and its "
                                 f"width {bert_cfg.hidden_size} must be bert_embed_dim "
                                 f"({cfg.bert_embed_dim})")
            self._tower = "model"
            self.model = GraniteHybridModel(bert_cfg, generator)
        else:
            self._tower = "bert"
            self.bert = BertModel(bert_cfg or BertConfig(), remat=cfg.bert_remat,
                                  fused_attention=cfg.bert_fused_attention, generator=generator)
        self.mention_encoder = MentionEncoder(cfg, generator)
        if cfg.entity_final_layer_name == "linear":
            self.entity_final_layer = Linear(cfg.bert_embed_dim, cfg.entity_final_output_dim,
                                             generator)

    def _encode(self, ids, mask):
        tower = getattr(self, self._tower)
        if self.cfg.finetune_bert:
            return tower(ids, mask)
        with torch.no_grad():
            return tower(ids, mask)

    def forward(self, batch, deterministic: bool = True,
                rng: Optional[torch.Generator] = None, split=None):
        cfg = self.cfg
        (mention_ids, mention_mask, begin, end, mention_image,
         entity_ids, entity_mask, sep_idx, _entity_image) = batch
        if split is not None and cfg.num_entity_sentence:  # the caller's block of sentences
            assert entity_ids.shape[1] * split.n == cfg.num_entity_sentence == \
                sep_idx.shape[1] * split.n, (
                    f"sentence blocks of {entity_ids.shape[1]} over {split.n} ranks are not a "
                    f"split of S={cfg.num_entity_sentence}")
        elif split is not None:
            split.check_block(entity_ids.shape[1], cfg.num_candidates_model)
        # mention tower: BERT, clipped to max_mention_sentence_len
        h, _ = self._encode(mention_ids, mention_mask)
        Lm = cfg.max_mention_sentence_len
        mention = self.mention_encoder(h[:, :Lm], mention_mask[:, :Lm], begin, end,
                                       mention_image, deterministic, rng)
        # entity tower
        B, C = entity_ids.shape[0], cfg.num_candidates_model
        flat_ids = entity_ids.reshape((-1,) + entity_ids.shape[2:])
        flat_mask = entity_mask.reshape(flat_ids.shape)
        eh, epooled = self._encode(flat_ids, flat_mask)
        if cfg.num_entity_sentence:  # zipped; a block's slots are cut after the gather
            zipped = eh.reshape(B, entity_ids.shape[1], *eh.shape[1:])
            encoded = unzip_entities(zipped, sep_idx, C if split is None else None,
                                     cfg.entity_final_pooling)
        else:  # per candidate; Ci may exceed C under candidate padding
            Ci = entity_ids.shape[1]
            if cfg.entity_final_pooling == "bert default":
                encoded = epooled.reshape(B, Ci, -1)
            else:
                pool = token_span_max if cfg.entity_final_pooling == "max" else token_span_mean
                encoded = pool(eh, flat_mask.sum(-1)).reshape(B, Ci, -1)
        if cfg.entity_final_layer_name == "linear":
            encoded = self.entity_final_layer(encoded)
        return _cosine_scores(mention, encoded, C, split)
