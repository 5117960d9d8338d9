# -*- coding: utf-8 -*-
"""The port's DRIN against ``drin_tpu.models.drin.DRIN.apply`` with the same
weights (``drin_state_dict_from_jax``) and the same numpy inputs, across the
entity layouts and the GCN configuration space.  Float32 at rtol 2e-4 (the
same math in another association order)."""

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _random_drin_batch
from drin_tpu.data.synthetic import tiny_config
from drin_tpu.models.drin import DRIN as JaxDRIN
from drin_tpu.models.torch_import import drin_params_from_torch
from drin_tpu_torch.models import get_model
from drin_tpu_torch.models.convert import drin_state_dict_from_jax
from drin_tpu_torch.models.drin import DRIN

RTOL, ATOL = 2e-4, 1e-6


def _batch(cfg, B, seed):
    """Numpy DRIN features (answer stripped) in the layout ``cfg`` reads."""
    rng = np.random.default_rng(seed)
    C, D, Dr = cfg.num_candidates_model, cfg.bert_embed_dim, cfg.resnet_embed_dim
    if cfg.dataset_name == "wikimel":
        feats = list(_random_drin_batch(cfg, B, rng)[0])
        if cfg.entity_projected:  # slot 0 projected, images projected to Dg
            feats[9] = rng.standard_normal((B, C, cfg.gcn_embed_dim), dtype=np.float32)
        return tuple(feats)
    base = cfg.replace(dataset_name="wikimel", cache_entity_pooling=False)
    feats = list(_random_drin_batch(base, B, rng)[0])
    feats[7] = rng.standard_normal((B, C, D), dtype=np.float32)  # mention-aligned rows
    feats[8] = np.zeros((B,), np.int64)
    feats[9] = rng.standard_normal((B, C, Dr), dtype=np.float32)
    return tuple(feats)


CONFIGS = {
    "wikimel-pooled": ("wikimel", {}),
    "wikimel-pooled-cls": ("wikimel", {"entity_final_pooling": "bert default"}),
    "wikimel-token-avg": ("wikimel", {"cache_entity_pooling": False}),
    "wikimel-token-max": ("wikimel", {"entity_final_pooling": "max"}),
    "wikimel-projected": ("wikimel", {"entity_projected": True}),
    "wikidiverse": ("wikidiverse", {}),
    "static": ("wikimel", {"gcn_edge_type": "static"}),
    "vector": ("wikidiverse", {"gcn_edge_feature": "vector"}),
    "ablation": ("wikimel", {"gcn_edge_enabled": (1, 0, 0, 1)}),
    "maxpool-none": ("wikimel", {"mention_final_layer_name": "none",
                                 "mention_final_representation": "max pool"}),
    "avg-none": ("wikidiverse", {"mention_final_layer_name": "none"}),
    "relu-tanh-3layers": ("wikimel", {"gcn_vertex_activation": "relu",
                                      "gcn_edge_activation": "tanh", "num_gcn_layers": 3}),
    "transformer-avg": ("wikimel", {"mention_final_layer_name": "transformer",
                                    "mention_final_representation": "avg"}),
    "transformer-maxpool": ("wikidiverse", {"mention_final_layer_name": "transformer",
                                            "mention_final_representation": "max pool"}),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_drin_forward_matches_flax(name):
    ds, kw = CONFIGS[name]
    cfg = tiny_config(ds, "drin", preprocess_dir="/tmp/unused-torch-drin", **kw)
    feats = _batch(cfg, B=3, seed=len(name))
    jm = JaxDRIN(cfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), feats)["params"])
    want = np.asarray(jm.apply({"params": params}, feats))
    model, kind = get_model(cfg)
    assert kind == "drin"
    model.load_state_dict(drin_state_dict_from_jax(params, cfg))
    with torch.inference_mode():
        got = model(tuple(torch.from_numpy(np.asarray(x)) for x in feats))
    assert got.shape == want.shape == (3, cfg.num_candidates_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    # the upstream converter reads the port's names (it knows the dynamic,
    # unprojected layouts: upstream layers always carry w_u / w_v)
    if not cfg.entity_projected and cfg.gcn_edge_type == "dynamic":
        back = drin_params_from_torch({k: v.numpy() for k, v in model.state_dict().items()},
                                      cfg.num_gcn_layers,
                                      edge_vector=cfg.gcn_edge_feature == "vector",
                                      transformer_num_layers=cfg.transformer_num_layers)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)


def test_upstream_parameter_names_and_seeded_init():
    cfg = tiny_config("wikimel", "drin", preprocess_dir="/tmp/unused-torch-drin")
    a = DRIN(cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    b = DRIN(cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    for key in ("vertex_encoder.mention_text_encoder.final_layer.linear.weight",
                "vertex_encoder.entity_text_encoder.final_layer.weight",
                "vertex_encoder.mention_image_linear.weight",
                "vertex_encoder.entity_image_linear.weight",
                "gcn_layers.0.w_h.weight", "gcn_layers.1.layer_norm.weight",
                "gcn_layers.1.w_u.weight", "gcn_layers.0.w_v.bias"):
        assert key in a
    assert all(torch.equal(a[k], b[k]) for k in a)
    D = cfg.gcn_embed_dim
    assert a["gcn_layers.0.w_u.weight"].shape == (D, D)  # scalar mode: [D, D]


# the transformer mention layer, MELHI and pretrained BERT checkpoints are
# ported: what get_model still refuses is MELHI off WikiDiverse (as the JAX
# package does), a BERT checkpoint that is not there (it reads the dims from
# it, as the JAX package does) and an unknown model
@pytest.mark.parametrize("kw", [({"model_type": "melhi"}, NotImplementedError, "wikidiverse"),
                                ({"model_type": "ghmfc", "online_bert": True,
                                  "bert_checkpoint": "some/dir"}, FileNotFoundError, "some/dir"),
                                ({"model_type": "nope"}, ValueError, "unknown model_type")])
def test_unported_branches_raise(kw):
    overrides, error, match = kw
    cfg = tiny_config("wikimel", "drin", preprocess_dir="/tmp/unused-torch-drin").replace(
        **overrides)
    with pytest.raises(error, match=match):
        get_model(cfg)
