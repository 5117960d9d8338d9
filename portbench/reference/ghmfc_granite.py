"""Plain PyTorch reference of GHMFC with granite-4.0-h-micro as its online
text tower, at the configuration of
``configs/ghmfc-granite-h-micro-wikimel.json``: ``reference/ghmfc_online.py``
with its BERT replaced by ``reference/granite_hybrid.py``'s stack.

Float32 with TF32 off (:data:`precision`), no kernels; it imports nothing of
the program.  The gated fusion of the mention's token states with its image
regions, the unzip and average pooling of the candidates, the entity linear
and the cosine are ``ghmfc_online``'s own functions.

Departures from the published model beside the tower's (random seeded
weights, no LM head): the request keeps BERT's zipped layout and its
``[CLS]`` / ``[SEP]`` ids (101, 102) as plain token ids of granite's
vocabulary; a candidate in a zipped sentence sees the candidates before it,
causally, as BERT's zipped sentences let their candidates see each other.
"""

from __future__ import annotations

import torch

from portbench import harness

_online = harness.load_file_module("reference", "ghmfc_online")
granite = harness.load_file_module("reference", "granite_hybrid")
precision = _online.precision
TOWER = "model."  # the upstream checkpoint's prefix of the decoder stack
# the smallest BERT ghmfc_online's shapes can be asked for; its tensors are dropped
_NO_BERT = {"hidden_size": 1, "intermediate_size": 1, "vocab_size": 1,
            "max_position_embeddings": 1, "type_vocab_size": 1, "num_hidden_layers": 0}


def param_shapes(cfg: dict) -> dict:
    """The tower's tensors under ``model.``, then the fusion's and the entity
    linear's as ``ghmfc_online`` has them."""
    rest = _online.param_shapes(dict(cfg, bert=_NO_BERT))
    return {**granite.param_shapes(cfg, TOWER),
            **{k: v for k, v in rest.items() if not k.startswith("bert.")}}


def init_ssm(p: dict, cfg: dict) -> None:
    granite.init_ssm(p, cfg, TOWER)


def forward(p: dict, cfg: dict, batch: dict, control: bool = False) -> torch.Tensor:
    """Scores [B, C] of an online request (the zipped fields by name);
    ``control`` rounds the tower's linears to float8 e4m3."""
    Lm = cfg["max_mention_sentence_len"]
    h = granite.tower(p, cfg, batch["mention_ids"], control, TOWER)
    mention = _online.fusion(p, cfg, h[:, :Lm], batch["mention_mask"][:, :Lm],
                             batch["mention_image_feature"])
    ids = batch["entity_ids"]
    B, S, L = ids.shape
    C = cfg["num_candidates_data"] + 1
    states = granite.tower(p, cfg, ids.reshape(B * S, L), control, TOWER).reshape(B, S, L, -1)
    entity = _online._lin(p, "entity_final_layer",
                          _online.unzip_mean(states, batch["entity_sep_idx"])[:, :C])
    return _online.cosine(mention[:, None], entity)
