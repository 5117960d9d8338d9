# -*- coding: utf-8 -*-
"""Encoder checkpoint loading (port of ``drin_tpu/encoders/checkpoints.py``,
its BERT half): a torch state_dict file or an HF-style directory
(``config.json`` + ``pytorch_model.bin`` / ``model.pt`` / ``state_dict.pt``)
-> the port's ``BertConfig`` and a state_dict for its ``BertModel``.

The port's BERT carries HF ``BertModel``'s keys (``models/convert.py``), so a
checkpoint's tensors load under their own names: the keys read are the ones
``drin_tpu.encoders.bert.bert_params_from_torch`` reads, without a prefix.
Without ``config.json`` the dimensions are inferred from the weights' shapes
as the JAX package infers them (64 dimensions per head).  Offline files
replace the reference's hub downloads; nothing is fetched."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch


def load_torch_state_dict(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """Returns (state_dict on the CPU, the HF config dict or None)."""
    cfg_dict = None
    if os.path.isdir(path):
        cfg_file = os.path.join(path, "config.json")
        if os.path.exists(cfg_file):
            with open(cfg_file) as f:
                cfg_dict = json.load(f)
        for candidate in ("pytorch_model.bin", "model.pt", "state_dict.pt"):
            p = os.path.join(path, candidate)
            if os.path.exists(p):
                path = p
                break
        else:
            raise FileNotFoundError(f"no torch weights file found in {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return dict(sd), cfg_dict


def load_bert(path: str, bert_cfg=None):
    """Returns (BertConfig, state_dict of the port's ``BertModel``).  The
    config comes from ``config.json`` when there is one, else from the
    weights' shapes; a key the model needs and the file lacks raises
    ``KeyError``."""
    from drin_tpu_torch.encoders.bert import BertConfig, BertModel

    sd, hf = load_torch_state_dict(path)
    if bert_cfg is None:
        if hf is not None:
            bert_cfg = BertConfig(
                vocab_size=hf["vocab_size"],
                hidden_size=hf["hidden_size"],
                num_hidden_layers=hf["num_hidden_layers"],
                num_attention_heads=hf["num_attention_heads"],
                intermediate_size=hf["intermediate_size"],
                max_position_embeddings=hf["max_position_embeddings"],
                type_vocab_size=hf.get("type_vocab_size", 2),
                layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
            )
        else:
            n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layer."))
            V, D = sd["embeddings.word_embeddings.weight"].shape
            bert_cfg = BertConfig(
                vocab_size=V, hidden_size=D, num_hidden_layers=n_layers,
                num_attention_heads=max(D // 64, 2),
                intermediate_size=sd["encoder.layer.0.intermediate.dense.weight"].shape[0],
                max_position_embeddings=sd["embeddings.position_embeddings.weight"].shape[0],
                type_vocab_size=sd["embeddings.token_type_embeddings.weight"].shape[0],
            )
    with torch.device("meta"):  # the key set only: no weights are made
        keys = list(BertModel(bert_cfg).state_dict())
    return bert_cfg, {k: sd[k] for k in keys}
