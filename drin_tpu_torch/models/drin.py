# -*- coding: utf-8 -*-
"""DRIN: Dynamic Relation Interactive Network (port of
``drin_tpu/models/drin.py``).

A 4-vertex / 4-edge-type relation graph per mention-candidate pair, refined
by ``num_gcn_layers`` GCN layers and scored by cosine matching of the text
vertices.  Vertex order: [mt, mi, et, ei]; edge order: [tt, ti, it, ii].

Parameter names follow the upstream torch state_dict
(``vertex_encoder.mention_image_linear.weight``, ``gcn_layers.{i}.w_h.weight``,
...), so ``drin_tpu.models.torch_import.drin_params_from_torch`` reads a
port ``state_dict()`` unchanged.

The scalar-edge GCN layer runs the fused layer kernel on CUDA tensors
(``ops/cuda/gcn_layer.py``) whatever ``use_pallas`` says; on CPU tensors the
same wrapper runs its plain version.

Candidate-parallel (``split``, a :class:`~drin_tpu_torch.parallel.mesh.CandidateSplit`
of the model axis): the entity tensors and the similarities of the batch
are this rank's block of the (padded) candidates, and the mention side is
computed alike on every rank of the model group.  The GCN layers sum the
mention means' messages over the group before dividing by the real C
(``collectives.all_sum``), and the forward gathers the score blocks
(``collectives.gather_blocks``) before it slices the scores to C.  This is
what GSPMD does for the JAX model on a mesh whose model axis shards the
candidates.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from drin_tpu_torch.common.config import Config
from drin_tpu_torch.common.spans import span
from drin_tpu_torch.models.ghmfc import EntityEncoder, MentionEncoder
from drin_tpu_torch.nn.layers import LayerNorm, Linear, get_activation
from drin_tpu_torch.ops.core import cosine_similarity, object_pair_similarity, span_mean
from drin_tpu_torch.ops.cuda.gcn_layer import fused_gcn_layer
from drin_tpu_torch.parallel import collectives


class VertexEncoder(nn.Module):
    """The four vertex sets: mt [B, D], mi [B, D], et [B, C, D], ei [B, C, D]."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.mention_text_encoder = MentionEncoder(cfg, generator)
        self.entity_text_encoder = EntityEncoder(cfg, generator)
        self.mention_image_linear = Linear(cfg.resnet_embed_dim, cfg.gcn_embed_dim, generator)
        if not cfg.entity_projected:  # a projected store already applied it
            self.entity_image_linear = Linear(cfg.resnet_embed_dim, cfg.gcn_embed_dim, generator)

    def forward(self, mention_text_feature, mention_text_mask, mention_start_pos,
                mention_end_pos, mention_image_feature, entity_text_feature,
                entity_text_mask, entity_image_feature, deterministic: bool = True,
                rng: Optional[torch.Generator] = None):
        mt = self.mention_text_encoder(mention_text_feature, mention_text_mask,
                                       mention_start_pos, mention_end_pos, None,
                                       deterministic, rng)
        et = self.entity_text_encoder(entity_text_feature, entity_text_mask)
        mi = self.mention_image_linear(mention_image_feature.mean(-2))
        if self.cfg.entity_projected:
            ei = entity_image_feature  # [B, C, Dg], projected at table build
        else:
            if entity_image_feature.ndim == 4:
                entity_image_feature = entity_image_feature.mean(-2)
            ei = self.entity_image_linear(entity_image_feature)
        return [mt, mi, et, ei]


class EdgeEncoder(nn.Module):
    """Same-modality edge weights: mtet from text cosine, miei from the
    score-weighted object-pair cosine.  No parameters."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg

    def forward(self, mention_text_feature, mention_start_pos, mention_end_pos,
                mention_object_feature, mention_object_score, entity_text_feature,
                entity_object_feature, entity_object_score):
        cfg = self.cfg
        if cfg.mention_final_representation == "max pool":
            m = torch.amax(mention_text_feature, dim=1)
        else:
            m = span_mean(mention_text_feature, mention_start_pos, mention_end_pos)
        if cfg.entity_pooling_cached:
            e = entity_text_feature[:, :, 1]  # the raw CLS slot (also when projected)
        elif entity_text_feature.ndim == 4:
            e = entity_text_feature[:, :, 0]
        else:
            e = entity_text_feature
        mtet = cosine_similarity(m[:, None, :].expand(e.shape), e)
        if mention_object_feature.ndim == 4:
            mention_object_feature = mention_object_feature.mean(-2)
        if entity_object_feature.ndim == 5:
            entity_object_feature = entity_object_feature.mean(-2)
        miei = object_pair_similarity(mention_object_feature, mention_object_score,
                                      entity_object_feature, entity_object_score)
        return mtet, miei


class GCNLayer(nn.Module):
    """One relation-interaction layer.

      vertex u <- [(edge, neighbor)]: mt<-[(tt,et),(ti,ei)] mi<-[(it,et),(ii,ei)]
                                      et<-[(tt,mt),(it,mi)] ei<-[(ti,mt),(ii,mi)]
      edge e  <- (u, v) endpoints:    tt=(mt,et) ti=(mt,ei) it=(mi,et) ii=(mi,ei)
    """

    vertex_graph = ((0, 2), (1, 3)), ((2, 2), (3, 3)), ((0, 0), (2, 1)), ((1, 0), (3, 1))
    edge_graph = ((0, 2), (0, 3), (1, 2), (1, 3))

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        D = cfg.gcn_embed_dim
        self.w_h = Linear(D, D, generator)
        self.layer_norm = LayerNorm(D)  # shared by all 4 vertex updates
        if cfg.gcn_edge_type == "dynamic":
            if cfg.gcn_edge_feature == "vector":
                self.w_u = Linear(D, D // 2, generator)
                self.w_v = Linear(D, D // 2, generator)
                self.w_m = Linear(D, D, generator)
            else:  # scalar: the folded edge update uses w_u, w_v as [D, D]
                self.w_u = Linear(D, D, generator)
                self.w_v = Linear(D, D, generator)

    def forward(self, vertexes, edges, split=None):
        """One layer; with ``split`` the entity vertices and the edges hold
        this rank's block of the candidates (the module docstring)."""
        with span("drin.gcn_layer"):
            return self._forward(vertexes, edges, split)

    def _forward(self, vertexes, edges, split):
        cfg = self.cfg
        C = cfg.num_candidates_model
        vector = cfg.gcn_edge_feature == "vector"
        edges = [e * m for e, m in zip(edges, cfg.gcn_edge_enabled)]  # ablation mask
        # candidate padding: fake candidates' edges are zeroed every layer so
        # they add nothing to the candidate means, which divide by the real C
        Cb = vertexes[2].shape[1]
        lo, Cp = (0, Cb) if split is None else (split.index * Cb, split.n * Cb)
        if Cp > C:
            cmask = ((torch.arange(Cb, device=edges[0].device) + lo) < C).to(edges[0].dtype)
            cm = cmask[None, :, None] if vector else cmask[None, :]
            edges = [e * cm for e in edges]
        total = None if split is None else (lambda x: collectives.all_sum(x, split.group))
        if vector:
            return self._vector(vertexes, edges, total)
        return self._scalar(vertexes, edges, total)

    def _scalar(self, vertexes, edges, total=None):
        """Scalar edges: the fused layer kernel on CUDA, which raises for
        activations it does not implement; its plain version on the CPU.
        Both average over the real C; ``total`` sums the message sums over
        the model group (candidate-parallel)."""
        cfg = self.cfg
        dt = vertexes[2].dtype
        dynamic = cfg.gcn_edge_type == "dynamic"
        w = lambda t: t.to(dt)
        dyn = ((w(self.w_u.weight), w(self.w_u.bias), w(self.w_v.weight), w(self.w_v.bias))
               if dynamic else (None, None, None, None))
        return fused_gcn_layer(
            [v.contiguous() for v in vertexes], [e.contiguous() for e in edges],
            w(self.w_h.weight), w(self.w_h.bias), w(self.layer_norm.weight),
            w(self.layer_norm.bias), *dyn, vact=cfg.gcn_vertex_activation,
            eact=cfg.gcn_edge_activation, eps=self.layer_norm.eps, dynamic=dynamic,
            num_candidates=cfg.num_candidates_model, sum_messages=total)

    def _vector(self, vertexes, edges, total=None):
        """Vector edges [B, C, D], plain torch as in JAX; ``total`` sums the
        mentions' candidate sums over the model group before the division
        (candidate-parallel)."""
        cfg = self.cfg
        C = cfg.num_candidates_model
        vact = get_activation(cfg.gcn_vertex_activation)
        eact = get_activation(cfg.gcn_edge_activation)

        # mention <- entity: the sums over this block's candidates, one
        # collective for all four, then the average over the real C
        sums = [[torch.sum(edges[ei_] * vertexes[vi], dim=1) for ei_, vi in neighbors]
                for neighbors in self.vertex_graph[:2]]
        if total is not None:
            summed = total(torch.stack([x for pair in sums for x in pair]))
            sums = [[summed[0], summed[1]], [summed[2], summed[3]]]

        def conv_vertex(e, v):
            return e * v[:, None, :]  # entity <- mention: broadcast

        aggs = []
        for ui, (u, neighbors) in enumerate(zip(vertexes, self.vertex_graph)):
            agg = u
            for j, (ei_, vi) in enumerate(neighbors):
                agg = agg + (sums[ui][j] / C if vertexes[vi].ndim == 3
                             else conv_vertex(edges[ei_], vertexes[vi]))
            aggs.append(agg)
        new_vertexes = [vact(self.layer_norm(self.w_h(a))) for a in aggs]
        if cfg.gcn_edge_type != "dynamic":
            return new_vertexes, edges
        new_edges = []
        for e, (ui, vi) in zip(edges, self.edge_graph):
            u, v = vertexes[ui], vertexes[vi]
            fu = self.w_u(u)[:, None, :]
            conv = torch.cat([fu.expand(*v.shape[:2], fu.shape[-1]), self.w_v(v)], dim=-1)
            new_edges.append(eact(self.w_m(conv + e)))
        return new_vertexes, new_edges


class DRIN(nn.Module):
    """Full DRIN forward.  Input: the 14-tensor batch (DrinBatch minus the
    answer).  Output: cosine scores [B, C].  ``deterministic=False`` is the
    train mode: attention dropout in the mention encoder, drawn from ``rng``."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.vertex_encoder = VertexEncoder(cfg, generator)
        self.edge_encoder = EdgeEncoder(cfg)
        self.gcn_layers = nn.ModuleList(GCNLayer(cfg, generator)
                                        for _ in range(cfg.num_gcn_layers))

    def forward(self, batch, deterministic: bool = True,
                rng: Optional[torch.Generator] = None, split=None):
        """Scores [B, C]; with ``split`` the batch's entity tensors and
        similarities are this rank's block of the padded candidates, and
        every rank of the model group returns the gathered scores."""
        cfg = self.cfg
        (mention_text_feature, mention_text_mask, mention_start_pos, mention_end_pos,
         mention_image_feature, mention_object_feature, mention_object_score,
         entity_text_feature, entity_text_mask, entity_image_feature,
         entity_object_feature, entity_object_score, miet_similarity,
         mtei_similarity) = batch
        if split is not None:  # the caller's blocks of C padded to the axis
            Cb = entity_image_feature.shape[1]
            split.check_block(Cb, cfg.num_candidates_model)
            assert miet_similarity.shape[1] == mtei_similarity.shape[1] == Cb, (
                f"similarities of {miet_similarity.shape[1]} / {mtei_similarity.shape[1]} "
                f"candidates for entity blocks of {Cb}")
        vertexes = self.vertex_encoder(
            mention_text_feature, mention_text_mask, mention_start_pos, mention_end_pos,
            mention_image_feature, entity_text_feature, entity_text_mask,
            entity_image_feature, deterministic, rng)
        mtet, miei = self.edge_encoder(
            mention_text_feature, mention_start_pos, mention_end_pos,
            mention_object_feature, mention_object_score, entity_text_feature,
            entity_object_feature, entity_object_score)
        # edge order (tt, ti, it, ii); CLIP logits scaled by 1/100
        edges = [mtet, mtei_similarity / 100.0, miet_similarity / 100.0, miei]
        if cfg.gcn_edge_feature == "vector":
            edges = [e[..., None].expand(*e.shape, cfg.gcn_embed_dim) for e in edges]
        for layer in self.gcn_layers:
            vertexes, edges = layer(vertexes, edges, split)
        mention, entity = vertexes[0], vertexes[2]
        mention = mention[:, None, :].expand(entity.shape)
        scores = cosine_similarity(mention, entity)
        if split is not None:  # the model group's blocks, in candidate order
            scores = collectives.gather_blocks(scores, split.group, split.order)
        # padded fake candidates are sliced away: scores are always [B, C]
        return scores[:, : cfg.num_candidates_model]
