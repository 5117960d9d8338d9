# -*- coding: utf-8 -*-
"""MELHI (port of ``drin_tpu/models/melhi.py``), WikiDiverse only, as in the
JAX package.

Image gating and an LSTM over the mention's context: the mention image is
mapped into text space and gated by two cosine thresholds (text vs mention
image, mention image vs any candidate's image), each token gets
[token feature | mention-word average | gated image], one LSTM shared by
both sides encodes the left and the right context, and the score is the
cosine against the projected [entity text | gated entity image].

As in the JAX model: an empty context runs the LSTM over one all-zero
step, and the context encoding is the hidden state at each row's last
valid step (the JAX model's documented fix of the reference's
``lstm_extract_last`` indexing).  The left context (tokens ``1:start``) and
the right one (tokens ``end:len``, gathered left-aligned with the same clip)
run as 2B rows of one LSTM loop over L steps; the left rows' lengths are
clipped to the L - 1 steps they have, so the extra step never runs for them.

With a candidate ``split`` (``parallel/mesh.py``) the entity tensors are
this rank's block of the padded candidates: the mention side runs whole on
every rank of the model group, the gate's "any candidate" is this rank's
``any`` ORed over the group (``collectives.any_over``), so every rank uses
the same gate, and the score blocks are gathered, then cut to C.

Parameter names are the upstream state_dict's (``image_map_text``,
``entity_final_map``, ``mention_encoder.mention_lstm.weight_ih_l0``, ...), so
``drin_tpu.models.torch_import.melhi_params_from_torch`` reads a port
``state_dict()`` as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from drin_tpu_torch.common.config import Config
from drin_tpu_torch.nn.layers import LSTM, Linear
from drin_tpu_torch.ops.core import cosine_similarity, span_mean
from drin_tpu_torch.parallel import collectives


class MentionEncoder(nn.Module):
    """Left/right context encoder: one LSTM over both contexts, the two
    final states concatenated and projected to ``bert_embed_dim``."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        D3 = 3 * cfg.bert_embed_dim
        self.mention_lstm = LSTM(D3, D3, generator)
        self.mention_final_map = Linear(2 * D3, cfg.bert_embed_dim, generator)

    def forward(self, mention_feature, mention_mask, start, end):
        B, L = mention_feature.shape[:2]
        zero = torch.zeros((), dtype=mention_feature.dtype, device=mention_feature.device)
        # left context: tokens 1 .. start-1, left-aligned by construction;
        # one zero step appended so both sides share the loop's L steps
        left_len = start - 1
        left = torch.cat([mention_feature[:, 1:], torch.zeros_like(mention_feature[:, :1])], 1)
        left = torch.where((left_len <= 0)[:, None, None], zero, left)
        # right context: tokens end .. mention_len-1, gathered left-aligned
        right_len = mention_mask.sum(-1) - end
        idx = torch.clamp(end[:, None] + torch.arange(L, device=end.device)[None, :], 0, L - 1)
        right = torch.gather(mention_feature, 1,
                             idx[..., None].expand(-1, -1, mention_feature.shape[-1]))
        right = torch.where((right_len <= 0)[:, None, None], zero, right)
        lengths = torch.cat([torch.clamp(left_len, 1, L - 1), torch.clamp(right_len, min=1)])
        h = self.mention_lstm(torch.cat([left, right]), lengths)
        return self.mention_final_map(torch.cat([h[:B], h[B:]], dim=-1))


class MELHI(nn.Module):
    """MELHI over the offline baseline batch (answer stripped, 8 fields, the
    same contract as GHMFC).  Output: cosine scores [B, C]."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        D = cfg.bert_embed_dim
        self.image_map_text = Linear(cfg.resnet_embed_dim, D, generator)
        self.entity_final_map = Linear(2 * D, D, generator)
        self.mention_encoder = MentionEncoder(cfg, generator)

    def similarities(self, mention_feature, mention_image, entity_image, split=None):
        """The gate's two cosines and the mapped mention image: ``sim_tmim``
        [B] (first token vs the mapped mean image), ``sim_imie`` [B, Cb]
        (mean mention image vs each candidate's image of this block, padded
        candidates at -inf) and ``image_map_text(mean image)`` [B, D].  The
        padded candidates are those at global index C and past: with
        ``split`` this block's candidates are ``split.index * Cb`` on."""
        mention_image = mention_image.mean(-2)  # [B, Dr]
        mapped = self.image_map_text(mention_image)
        sim_tmim = cosine_similarity(mention_feature[:, 0], mapped)
        sim_imie = cosine_similarity(mention_image[:, None, :].expand_as(entity_image),
                                     entity_image)
        Cb, C = entity_image.shape[1], self.cfg.num_candidates_model
        lo = 0 if split is None else split.index * Cb
        if lo + Cb > C:  # padded fake candidates never open the gate
            real = torch.arange(lo, lo + Cb, device=sim_imie.device) < C
            sim_imie = sim_imie.masked_fill(~real[None, :], float("-inf"))
        return sim_tmim, sim_imie, mapped

    def _gate(self, sim_tmim, sim_imie, split=None):
        opened = torch.any(sim_imie > self.cfg.thres_imie, -1)
        if split is not None:  # any candidate of the model group's blocks
            opened = collectives.any_over(opened, split.group)
        return (sim_tmim > self.cfg.thres_tmim) & opened

    def gates(self, batch, split=None):
        """The image gate of each mention of a batch, [B] bool: ``sim_tmim >
        thres_tmim`` and any candidate's ``sim_imie > thres_imie`` (with
        ``split``, any candidate of the model group's blocks)."""
        return self._gate(*self.similarities(batch[0], batch[4], batch[7], split)[:2], split)

    def forward(self, batch, deterministic: bool = True,
                rng: Optional[torch.Generator] = None, split=None):
        """Scores [B, C]; with ``split`` the entity tensors are this rank's
        block of the padded candidates, and every rank of the model group
        returns the gathered scores."""
        (mention_feature, mention_mask, start, end, mention_image,
         entity_feature, _entity_mask, entity_image) = batch
        if split is not None:
            split.check_block(entity_image.shape[1], self.cfg.num_candidates_model)
        sim_tmim, sim_imie, mapped = self.similarities(mention_feature, mention_image,
                                                       entity_image, split)
        gate = self._gate(sim_tmim, sim_imie, split).to(mention_feature.dtype)
        mention_image_mapped = mapped * gate[:, None]
        entity_image_mapped = self.image_map_text(entity_image) * gate[:, None, None]
        mention_word = span_mean(mention_feature, start, end)  # [B, D]
        mention_cat = torch.cat([mention_feature,
                                 mention_word[:, None, :].expand_as(mention_feature),
                                 mention_image_mapped[:, None, :].expand_as(mention_feature)],
                                dim=-1)  # [B, L, 3D]
        mention = self.mention_encoder(mention_cat, mention_mask, start, end)
        entity = self.entity_final_map(torch.cat([entity_feature, entity_image_mapped], dim=-1))
        scores = cosine_similarity(mention[:, None, :].expand_as(entity), entity)
        if split is not None:  # the model group's blocks, in candidate order
            scores = collectives.gather_blocks(scores, split.group, split.order)
        return scores[:, :self.cfg.num_candidates_model]
