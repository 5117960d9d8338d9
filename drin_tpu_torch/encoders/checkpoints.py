# -*- coding: utf-8 -*-
"""Encoder checkpoint loading (port of ``drin_tpu/encoders/checkpoints.py``):
a torch state_dict file or an HF-style directory (``config.json`` +
``pytorch_model.bin`` / ``model.pt`` / ``state_dict.pt``) -> the port's
config and a state_dict for its ``BertModel``, ``ResNetModel`` or
``CLIPModel``; a torchvision detection state dict -> the port's
``FasterRCNN`` (:func:`load_detector`).

The port's encoders carry the HF models' keys (``models/convert.py``), so a
checkpoint's tensors load under their own names: the keys read are the ones
``drin_tpu.encoders.{bert,resnet,clip}.*_params_from_torch`` read, without a
prefix; a key the model needs and the file lacks raises ``KeyError``, and
the file's other keys (``num_batches_tracked``, ``position_ids``) are left.
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
    return bert_cfg, _keys_of(BertModel, bert_cfg, sd)


def _keys_of(model_cls, cfg, sd) -> Dict[str, torch.Tensor]:
    """The entries of ``sd`` that ``model_cls(cfg)`` has."""
    with torch.device("meta"):  # the key set only: no weights are made
        keys = list(model_cls(cfg).state_dict())
    return {k: sd[k] for k in keys}


def load_resnet(path: str, resnet_cfg=None):
    """Returns (ResNetConfig, state_dict of the port's ``ResNetModel``)."""
    from drin_tpu_torch.encoders.resnet import ResNetConfig, ResNetModel

    sd, hf = load_torch_state_dict(path)
    if resnet_cfg is None:
        if hf is not None:
            resnet_cfg = ResNetConfig(
                embedding_size=hf["embedding_size"],
                hidden_sizes=hf["hidden_sizes"],
                depths=hf["depths"],
                downsample_in_first_stage=hf.get("downsample_in_first_stage", False),
                downsample_in_bottleneck=hf.get("downsample_in_bottleneck", False),
            )
        else:
            depths, hidden = [], []
            si = 0
            while f"encoder.stages.{si}.layers.0.layer.0.convolution.weight" in sd:
                li = 0
                while f"encoder.stages.{si}.layers.{li}.layer.0.convolution.weight" in sd:
                    li += 1
                depths.append(li)
                hidden.append(sd[f"encoder.stages.{si}.layers.0.layer.2.convolution.weight"].shape[0])
                si += 1
            resnet_cfg = ResNetConfig(
                embedding_size=sd["embedder.embedder.convolution.weight"].shape[0],
                hidden_sizes=hidden, depths=depths,
            )
    return resnet_cfg, _keys_of(ResNetModel, resnet_cfg, sd)


def load_clip(path: str, clip_cfg=None):
    """Returns (CLIPConfig, state_dict of the port's ``CLIPModel``)."""
    from drin_tpu_torch.encoders.clip import (CLIPConfig, CLIPModel, CLIPTextConfig,
                                              CLIPVisionConfig)

    sd, hf = load_torch_state_dict(path)
    if clip_cfg is None:
        if hf is not None:
            t, v = hf["text_config"], hf["vision_config"]
            clip_cfg = CLIPConfig(
                text=CLIPTextConfig(
                    t["vocab_size"], t["hidden_size"], t["num_hidden_layers"],
                    t["num_attention_heads"], t["intermediate_size"],
                    t["max_position_embeddings"], t.get("layer_norm_eps", 1e-5)),
                vision=CLIPVisionConfig(
                    v["hidden_size"], v["num_hidden_layers"], v["num_attention_heads"],
                    v["intermediate_size"], v["image_size"], v["patch_size"],
                    v.get("layer_norm_eps", 1e-5)),
                projection_dim=hf["projection_dim"],
            )
        else:
            tV, tD = sd["text_model.embeddings.token_embedding.weight"].shape
            tN = 1 + max(int(k.split(".")[3]) for k in sd if k.startswith("text_model.encoder.layers."))
            vN = 1 + max(int(k.split(".")[3]) for k in sd if k.startswith("vision_model.encoder.layers."))
            pw = sd["vision_model.embeddings.patch_embedding.weight"]  # [D, 3, p, p]
            vD, p = pw.shape[0], pw.shape[-1]
            n_pos = sd["vision_model.embeddings.position_embedding.weight"].shape[0]
            img = int(round((n_pos - 1) ** 0.5)) * p
            clip_cfg = CLIPConfig(
                text=CLIPTextConfig(
                    tV, tD, tN, max(tD // 64, 2),
                    sd["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
                    sd["text_model.embeddings.position_embedding.weight"].shape[0]),
                vision=CLIPVisionConfig(
                    vD, vN, max(vD // 64, 2),
                    sd["vision_model.encoder.layers.0.mlp.fc1.weight"].shape[0], img, p),
                projection_dim=sd["text_projection.weight"].shape[0],
            )
    return clip_cfg, _keys_of(CLIPModel, clip_cfg, sd)


DETECTOR_ARCHS = ("faster_rcnn", "mask_rcnn")


def _pre_013_spelling(key: str) -> str:
    """torchvision's key before 0.13, where the FPN blocks and the RPN
    head's convolution were bare ``Conv2d``s, not ``Conv2dNormActivation``s:
    ``backbone.fpn.inner_blocks.{i}.0.weight`` -> ``...inner_blocks.{i}.weight``,
    ``rpn.head.conv.0.0.weight`` -> ``rpn.head.conv.weight``."""
    for blocks in ("backbone.fpn.inner_blocks.", "backbone.fpn.layer_blocks."):
        if key.startswith(blocks):
            i, rest = key[len(blocks):].split(".", 1)
            return blocks + i + "." + rest[2:] if rest.startswith("0.") else key
    return key.replace("rpn.head.conv.0.0.", "rpn.head.conv.", 1)


def load_detector(path: str, frcnn_cfg=None, arch: str = "faster_rcnn"):
    """Returns (FRCNNConfig, state_dict of the port's ``FasterRCNN``) from a
    torchvision ``fasterrcnn_resnet50_fpn`` / ``maskrcnn_resnet50_fpn`` state
    dict file, in either key layout (torchvision before 0.13 or after; where
    a file has both spellings of a key, the older is read, as the JAX
    package's converter reads it).  ``arch`` is ``drin_object_detector``,
    validated as ``drin_tpu``'s ``detector_params_from_torch`` validates it:
    ``mask_rcnn`` requires the ``roi_heads.mask_*`` keys (then dropped: the
    pipeline reads boxes and scores only) and ``faster_rcnn`` refuses them.
    A key the model needs and the file lacks raises ``KeyError``.  Without
    ``frcnn_cfg`` the detector is ``FRCNNConfig()``, torchvision's own
    model, as in ``drin_tpu``'s ``make_detector``; a file of other widths
    is refused by ``load_state_dict``."""
    from drin_tpu_torch.encoders.frcnn import FasterRCNN, FRCNNConfig

    if arch not in DETECTOR_ARCHS:
        raise ValueError(f"unknown drin_object_detector {arch!r} (expected one of {DETECTOR_ARCHS})")
    sd, _ = load_torch_state_dict(path)
    has_mask = any(k.startswith("roi_heads.mask_") for k in sd)
    if arch == "mask_rcnn" and not has_mask:
        raise ValueError(f"drin_object_detector='mask_rcnn' but {path} has no roi_heads.mask_* "
                         "keys (a Faster R-CNN state_dict?)")
    if arch == "faster_rcnn" and has_mask:
        raise ValueError(f"drin_object_detector='faster_rcnn' but {path} has roi_heads.mask_* "
                         "keys (a Mask R-CNN state_dict?)")
    frcnn_cfg = frcnn_cfg or FRCNNConfig()
    with torch.device("meta"):
        keys = list(FasterRCNN(frcnn_cfg).state_dict())
    out = {}
    for k in keys:
        old = _pre_013_spelling(k)
        if old in sd:
            out[k] = sd[old]
        elif k in sd:
            out[k] = sd[k]
        else:
            raise KeyError(f"{path}: no {k!r} (nor its pre-0.13 spelling {old!r})")
    return frcnn_cfg, out
