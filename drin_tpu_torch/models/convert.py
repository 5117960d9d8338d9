# -*- coding: utf-8 -*-
"""Weight bridge between the JAX package and the port.

The port's parameters carry the upstream torch state_dict names, so
``drin_tpu.models.torch_import.drin_params_from_torch`` turns a port
``state_dict()`` into flax params.  :func:`drin_state_dict_from_jax` is the
other direction: flax params (numpy leaves) into a state_dict the port's
``DRIN`` loads.  Flax kernels are [in, out]; torch weights are [out, in].
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from drin_tpu_torch.common.config import Config


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))  # a writable copy


def _dense(sd: Dict, prefix: str, p: Mapping) -> None:
    """A flax Dense ``{kernel [in, out], bias}`` -> ``prefix.weight/bias``."""
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    sd[prefix + ".bias"] = _t(p["bias"])


def drin_state_dict_from_jax(params: Mapping, cfg: Config) -> Dict[str, torch.Tensor]:
    """Flax DRIN params (``DRIN.init(...)["params"]``, any array leaves) ->
    a float32 state_dict for ``drin_tpu_torch.models.drin.DRIN(cfg)``."""
    sd: Dict[str, torch.Tensor] = {}
    ve = params["vertex_encoder"]
    pre = "vertex_encoder."
    if "mention_text_encoder" in ve:  # no parameters under "none"
        _mention_encoder(sd, pre + "mention_text_encoder", ve["mention_text_encoder"], cfg)
    if "entity_text_encoder" in ve:
        _dense(sd, pre + "entity_text_encoder.final_layer",
               ve["entity_text_encoder"]["final_layer"]["Dense_0"])
    for name in ("mention_image_linear", "entity_image_linear"):
        if name in ve:
            _dense(sd, pre + name, ve[name]["Dense_0"])
    for i in range(cfg.num_gcn_layers):
        layer, p = params[f"gcn_{i}"], f"gcn_layers.{i}."
        _dense(sd, p + "w_h", layer["w_h"]["Dense_0"])
        sd[p + "layer_norm.weight"] = _t(layer["layer_norm"]["scale"])
        sd[p + "layer_norm.bias"] = _t(layer["layer_norm"]["bias"])
        if cfg.gcn_edge_type != "dynamic":
            continue
        if cfg.gcn_edge_feature == "vector":
            for name in ("w_u", "w_v", "w_m"):
                _dense(sd, p + name, layer[name]["Dense_0"])
        else:  # scalar mode stores flat [in, out] kernels (the folded update)
            for name in ("w_u", "w_v"):
                sd[p + name + ".weight"] = _t(np.asarray(layer[name + "_kernel"]).T)
                sd[p + name + ".bias"] = _t(layer[name + "_bias"])
    return sd


def _layernorm(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def bert_state_dict_from_jax(params: Mapping, bert_cfg, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax ``BertModel`` params -> a float32 state_dict with the HF
    ``BertModel`` keys (the inverse of
    ``drin_tpu.encoders.bert.bert_params_from_torch``)."""
    sd: Dict[str, torch.Tensor] = {}
    emb = params["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{prefix}embeddings.{name}.weight"] = _t(emb[name])
    _layernorm(sd, prefix + "embeddings.LayerNorm", emb["LayerNorm"])
    _dense(sd, prefix + "pooler.dense", params["pooler"])
    for i in range(bert_cfg.num_hidden_layers):
        layer, p = params[f"layer_{i}"], f"{prefix}encoder.layer.{i}."
        for name in ("query", "key", "value"):
            _dense(sd, p + "attention.self." + name, layer["self"][name])
        _dense(sd, p + "attention.output.dense", layer["attention_output_dense"])
        _layernorm(sd, p + "attention.output.LayerNorm", layer["attention_output_norm"])
        _dense(sd, p + "intermediate.dense", layer["intermediate_dense"])
        _dense(sd, p + "output.dense", layer["output_dense"])
        _layernorm(sd, p + "output.LayerNorm", layer["output_norm"])
    return sd


def _mha(sd: Dict, prefix: str, p: Mapping) -> None:
    """Flax MultiheadAttention -> the upstream ``nn.MultiheadAttention`` keys:
    one packed ``in_proj_weight`` when q, k and v read the same width."""
    w = {n: np.asarray(p[f"{n}_proj"]["kernel"]).T for n in "qkv"}
    if w["q"].shape == w["k"].shape == w["v"].shape:
        sd[prefix + ".in_proj_weight"] = _t(np.concatenate([w["q"], w["k"], w["v"]]))
    else:
        for n in "qkv":
            sd[f"{prefix}.{n}_proj_weight"] = _t(w[n])
    sd[prefix + ".in_proj_bias"] = _t(np.concatenate(
        [np.asarray(p[f"{n}_proj"]["bias"]) for n in "qkv"]))
    _dense(sd, prefix + ".out_proj", p["out_proj"])


def _cross_attention(sd: Dict, prefix: str, p: Mapping) -> None:
    for name in ("a2b_attention", "b2a_attention"):
        _mha(sd, f"{prefix}.{name}", p[name])
    for name in ("a2b_ffn", "b2a_ffn"):
        _dense(sd, f"{prefix}.{name}", p[name]["Dense_0"])
    for i in range(4):
        _layernorm(sd, f"{prefix}.layernorms.{i}", p[f"ln{i}"])


def _transformer(sd: Dict, prefix: str, p: Mapping, num_layers: int) -> None:
    """Flax MultilayerTransformer -> the upstream ``nn.TransformerEncoder``
    keys under ``prefix.transformer.layers.{i}``."""
    for i in range(num_layers):
        layer, pre = p[f"layer_{i}"], f"{prefix}.transformer.layers.{i}"
        _mha(sd, pre + ".self_attn", layer["self_attn"])
        for name in ("linear1", "linear2"):
            _dense(sd, f"{pre}.{name}", layer[name])
        for name in ("norm1", "norm2"):
            _layernorm(sd, f"{pre}.{name}", layer[name])


def _mention_encoder(sd: Dict, prefix: str, p: Mapping, cfg: Config) -> None:
    name = cfg.mention_final_layer_name
    if name == "linear":
        _dense(sd, prefix + ".final_layer.linear", p["final_layer"]["linear"]["Dense_0"])
    elif name == "multimodal" and cfg.mention_multimodal_attention == "bi":
        inter, pre = p["intermediate_layer"], prefix + ".intermediate_layer"
        for ca in ("t2v_attention", "v2t_attention"):
            _cross_attention(sd, f"{pre}.{ca}", inter[ca])
        for lin in ("text_linear", "image_linear", "score_linear"):
            _dense(sd, f"{pre}.{lin}", inter[lin]["Dense_0"])
    elif name == "multimodal":
        _cross_attention(sd, prefix + ".intermediate_layer", p["intermediate_layer"])
    elif name == "transformer":
        _transformer(sd, prefix + ".intermediate_layer", p["intermediate_layer"],
                     cfg.transformer_num_layers)


def ghmfc_state_dict_from_jax(params: Mapping, cfg: Config) -> Dict[str, torch.Tensor]:
    """Flax GHMFC params -> a float32 state_dict for
    ``drin_tpu_torch.models.ghmfc.GHMFC(cfg)``."""
    sd: Dict[str, torch.Tensor] = {}
    _mention_encoder(sd, "mention_encoder", params.get("mention_encoder", {}), cfg)
    if cfg.entity_final_layer_name == "linear":
        _dense(sd, "entity_encoder.final_layer",
               params["entity_encoder"]["final_layer"]["Dense_0"])
    return sd


def ghmfc_online_state_dict_from_jax(params: Mapping, cfg: Config,
                                     bert_cfg) -> Dict[str, torch.Tensor]:
    """Flax GHMFCOnline params -> a float32 state_dict for
    ``drin_tpu_torch.models.ghmfc.GHMFCOnline(cfg, bert_cfg)``."""
    sd = bert_state_dict_from_jax(params["bert"], bert_cfg, prefix="bert.")
    _mention_encoder(sd, "mention_encoder", params.get("mention_encoder", {}), cfg)
    if cfg.entity_final_layer_name == "linear":
        _dense(sd, "entity_final_layer", params["entity_final_layer"]["Dense_0"])
    return sd


def melhi_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax MELHI params -> a float32 state_dict for
    ``drin_tpu_torch.models.melhi.MELHI(cfg)`` (the upstream names, which
    ``drin_tpu.models.torch_import.melhi_params_from_torch`` reads back)."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("image_map_text", "entity_final_map"):
        _dense(sd, name, params[name]["Dense_0"])
    me = params["mention_encoder"]
    _dense(sd, "mention_encoder.mention_final_map", me["mention_final_map"]["Dense_0"])
    lstm = me["mention_lstm"]
    for flax_name, torch_name in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0")):
        sd[f"mention_encoder.mention_lstm.{torch_name}"] = _t(np.asarray(lstm[flax_name]).T)
    for flax_name, torch_name in (("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
        sd[f"mention_encoder.mention_lstm.{torch_name}"] = _t(lstm[flax_name])
    return sd


def _conv(sd: Dict, key: str, kernel) -> None:
    """A flax conv kernel [kh, kw, in, out] (HWIO) -> a torch OIHW weight."""
    sd[key] = _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _batchnorm(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])
    sd[prefix + ".running_mean"] = _t(p["mean"])
    sd[prefix + ".running_var"] = _t(p["var"])


def resnet_state_dict_from_jax(params: Mapping, resnet_cfg) -> Dict[str, torch.Tensor]:
    """Flax ``ResNetModel`` params -> a float32 state_dict with the HF
    ``ResNetModel`` keys (the inverse of
    ``drin_tpu.encoders.resnet.resnet_params_from_torch``)."""
    sd: Dict[str, torch.Tensor] = {}
    emb = params["embedder"]
    _conv(sd, "embedder.embedder.convolution.weight", emb["conv"]["kernel"])
    _batchnorm(sd, "embedder.embedder.normalization", emb["bn"])
    for si, depth in enumerate(resnet_cfg.depths):
        for li in range(depth):
            layer, p = params[f"stage{si}_layer{li}"], f"encoder.stages.{si}.layers.{li}"
            if "shortcut_conv" in layer:
                _conv(sd, p + ".shortcut.convolution.weight", layer["shortcut_conv"]["kernel"])
                _batchnorm(sd, p + ".shortcut.normalization", layer["shortcut_bn"])
            for ci in range(3):
                conv = layer[f"conv{ci}"]
                _conv(sd, f"{p}.layer.{ci}.convolution.weight", conv["conv"]["kernel"])
                _batchnorm(sd, f"{p}.layer.{ci}.normalization", conv["bn"])
    return sd


def _clip_layers(sd: Dict, prefix: str, p: Mapping, n: int) -> None:
    for i in range(n):
        layer, pre = p[f"layer_{i}"], f"{prefix}.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{pre}.self_attn.{name}", layer["self_attn"][name])
        _layernorm(sd, pre + ".layer_norm1", layer["layer_norm1"])
        _layernorm(sd, pre + ".layer_norm2", layer["layer_norm2"])
        _dense(sd, pre + ".mlp.fc1", layer["fc1"])
        _dense(sd, pre + ".mlp.fc2", layer["fc2"])


def clip_state_dict_from_jax(params: Mapping, clip_cfg) -> Dict[str, torch.Tensor]:
    """Flax ``CLIPModel`` params -> a float32 state_dict with the HF
    ``CLIPModel`` keys (the inverse of
    ``drin_tpu.encoders.clip.clip_params_from_torch``)."""
    sd: Dict[str, torch.Tensor] = {}
    text, vision = params["text_model"], params["vision_model"]
    sd["text_model.embeddings.token_embedding.weight"] = _t(text["token_embedding"])
    sd["text_model.embeddings.position_embedding.weight"] = _t(text["position_embedding"])
    _clip_layers(sd, "text_model.encoder", text, clip_cfg.text.num_layers)
    _layernorm(sd, "text_model.final_layer_norm", text["final_layer_norm"])
    sd["vision_model.embeddings.class_embedding"] = _t(vision["class_embedding"])
    _conv(sd, "vision_model.embeddings.patch_embedding.weight",
          vision["patch_embedding"]["kernel"])
    sd["vision_model.embeddings.position_embedding.weight"] = _t(vision["position_embedding"])
    _layernorm(sd, "vision_model.pre_layrnorm", vision["pre_layrnorm"])
    _clip_layers(sd, "vision_model.encoder", vision, clip_cfg.vision.num_layers)
    _layernorm(sd, "vision_model.post_layernorm", vision["post_layernorm"])
    for name in ("visual_projection", "text_projection"):
        sd[name + ".weight"] = _t(np.asarray(params[name]["kernel"]).T)
    sd["logit_scale"] = _t(params["logit_scale"])
    return sd


def frcnn_state_dict_from_jax(params: Mapping, frcnn_cfg) -> Dict[str, torch.Tensor]:
    """Flax ``FasterRCNN`` params -> a float32 state_dict with torchvision's
    >= 0.13 ``fasterrcnn_resnet50_fpn`` keys (the inverse of
    ``drin_tpu.encoders.frcnn.frcnn_params_from_torch``): convolutions HWIO
    -> OIHW, Dense kernels transposed, and fc6's input axis permuted back
    from the flax model's (P, P, C) flatten to torchvision's (C, P, P)."""
    sd: Dict[str, torch.Tensor] = {}
    body = params["body"]
    _conv(sd, "backbone.body.conv1.weight", body["conv1"]["kernel"])
    _batchnorm(sd, "backbone.body.bn1", body["bn1"])
    for li, depth in enumerate(frcnn_cfg.depths):
        for bi in range(depth):
            blk, p = body[f"layer{li + 1}_{bi}"], f"backbone.body.layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                _conv(sd, f"{p}.conv{ci}.weight", blk[f"conv{ci}"]["kernel"])
                _batchnorm(sd, f"{p}.bn{ci}", blk[f"bn{ci}"])
            if "downsample_conv" in blk:
                _conv(sd, p + ".downsample.0.weight", blk["downsample_conv"]["kernel"])
                _batchnorm(sd, p + ".downsample.1", blk["downsample_bn"])
    fpn = params["fpn"]
    for i in range(len(frcnn_cfg.depths)):
        for flax_name, torch_name in ((f"inner_{i}", "inner_blocks"), (f"layer_{i}", "layer_blocks")):
            _conv(sd, f"backbone.fpn.{torch_name}.{i}.0.weight", fpn[flax_name]["kernel"])
            sd[f"backbone.fpn.{torch_name}.{i}.0.bias"] = _t(fpn[flax_name]["bias"])
    rpn = params["rpn_head"]
    for flax_name, torch_name in (("conv", "conv.0.0"), ("cls_logits", "cls_logits"),
                                  ("bbox_pred", "bbox_pred")):
        _conv(sd, f"rpn.head.{torch_name}.weight", rpn[flax_name]["kernel"])
        sd[f"rpn.head.{torch_name}.bias"] = _t(rpn[flax_name]["bias"])
    fc6 = dict(params["box_head"]["fc6"])
    kernel = np.asarray(fc6["kernel"])  # [P * P * C, R], rows in (P, P, C) order
    cin = frcnn_cfg.fpn_channels
    p = int(round((kernel.shape[0] // cin) ** 0.5))
    fc6["kernel"] = kernel.reshape(p, p, cin, -1).transpose(2, 0, 1, 3).reshape(cin * p * p, -1)
    _dense(sd, "roi_heads.box_head.fc6", fc6)
    _dense(sd, "roi_heads.box_head.fc7", params["box_head"]["fc7"])
    for name in ("cls_score", "bbox_pred"):
        _dense(sd, f"roi_heads.box_predictor.{name}", params["box_predictor"][name])
    return sd
