"""GHMFC with granite-4.0-h-micro as its online text tower, through the
port (``drin_tpu_torch``): its ``Ranker`` on the nine token-id fields of an
online request, judged by ``reference/ghmfc_granite.py``.

The requests are ``systems/ghmfc_online.py``'s, made by its own request
maker and zip with granite's vocabulary (token ids uniform over [1000,
vocab_size)): B mention sentences, and each mention's C candidate texts
zipped into S sentences and trimmed to the batch's longest rounded up to
``online_length_buckets``, at most ``max_bert_len`` tokens.  The tower's
settings are the configuration's top-level ``granitemoehybrid`` keys.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts_granite, harness
from portbench import inputs as I

_online = harness.load_file_module("systems", "ghmfc_online")
FIELDS = _online.FIELDS
num_candidates = _online.num_candidates
shapes = _online.shapes


class _Vocabulary:
    """A run as ``ghmfc_online``'s request maker reads it, with the tower's
    vocabulary where it reads BERT's."""

    def __init__(self, run):
        self._run = run
        self.config = dict(run.config, bert={"vocab_size": run.config["vocab_size"]})

    def __getattr__(self, name):
        return getattr(self._run, name)


def port_config(config: dict):
    """The port's ``Config``: GHMFC's (the file's ``model_type`` is the tower's
    published one, ``granitemoehybrid``)."""
    return _online.port_config(dict(config, model_type="ghmfc"))


def make_data(run) -> dict:
    """The seeded float32 weights on the device.  The tower's settings are
    read first: a program without the tower fails here, before the weights
    take the card."""
    tower_config(run.config)
    ref = run.reference
    weights = I.make_weights(ref.param_shapes(run.config), run.generator("weights"), run.device)
    ref.init_ssm(weights, run.config)
    return {"weights": weights}


def request_pool(run, data: dict, n_batches: int, B: int) -> list:
    return _online.request_pool(_Vocabulary(run), data, n_batches, B)


def tower_config(config: dict):
    from drin_tpu_torch.encoders.granite_hybrid import GraniteHybridConfig

    return GraniteHybridConfig.from_dict(config)


def build_ranker(run, data: dict):
    """The port casts the weights to the compute dtype on the card: the
    seeded float32 weights stay as the reference's."""
    from drin_tpu_torch.serve import Ranker

    return Ranker(port_config(run.config), data["weights"], device=run.device,
                  bert_cfg=tower_config(run.config))


def reference_scores(run, data: dict, feats: tuple, tf32: bool = False) -> np.ndarray:
    """The reference's scores of a request; ``tf32`` (the harness's flag of
    the control) asks for the control, the tower's linears in float8."""
    ref, dev = run.reference, run.device
    batch = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in zip(FIELDS, feats)}
    batch["mention_image_feature"] = batch["mention_image_feature"].float()
    with ref.precision(False), torch.no_grad():
        return ref.forward(data["weights"], run.config, batch, control=tf32).cpu().numpy()


def rank_flops(run, feats: tuple) -> float:
    s = shapes(run, feats)
    return counts_granite.ghmfc_granite_flops(run.config, s["B"], s["Lm"], s["S"], s["L"])


def describe(run, data: dict) -> str:
    n = sum(v.numel() for v in data["weights"].values())
    return f"{n / 1e6:.1f} M parameters, {counts_granite.mamba_layers(run.config)} Mamba-2 layers"
