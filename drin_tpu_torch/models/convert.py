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

from drin_tpu.common.config import Config


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
    if "mention_text_encoder" in ve and "final_layer" in ve["mention_text_encoder"]:
        _dense(sd, pre + "mention_text_encoder.final_layer.linear",
               ve["mention_text_encoder"]["final_layer"]["linear"]["Dense_0"])
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
