# -*- coding: utf-8 -*-
"""Train/valid/test entry point on one device (port of the root ``train.py``):
print the full config, seed, build datasets + model, then run
``num_epoch // test_epoch_interval`` rounds of fit + test (or test only).

    python -m drin_tpu_torch.train model_type=drin dataset_name=wikimel \\
        preprocess_dir=... batch_size=64 device=cuda

Every config field is overridable as ``key=value``.  ``device`` (default
``cuda``) is explicit: ``device=cuda`` without CUDA raises, nothing falls
back to the CPU.  On WikiMEL with the pooled entity cache DRIN and offline
GHMFC train over the device-resident entity tables (``device_entity_tables``,
the default): each batch carries [B, C] row indices and the step gathers the
rows on the device.  Not ported yet, and refused by name: device meshes
(``mesh_data`` / ``mesh_model``), several processes, the raw-text online
dataset and loading a pretrained BERT.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from drin_tpu_torch.common.cli import parse_overrides


def _not_ported(what: str, roadmap: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP: {roadmap})")


def main(argv=None) -> None:
    from drin_tpu_torch.common.config import config_summary, make_config
    from drin_tpu_torch.data.dataset import create_datasets
    from drin_tpu_torch.models import get_model
    from drin_tpu_torch.train.trainer import Trainer

    overrides = parse_overrides(argv if argv is not None else sys.argv[1:])
    device = torch.device(overrides.pop("device", "cuda"))
    model_type = overrides.pop("model_type", "drin")
    dataset_name = overrides.pop("dataset_name", "wikidiverse")
    cfg = make_config(model_type, dataset_name, **overrides)

    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda was asked for and CUDA is not available "
                           "(pass device=cpu to train on the CPU)")
    if cfg.num_processes > 1:
        _not_ported(f"num_processes={cfg.num_processes}", "multi-device on torch.distributed")
    if cfg.mesh_data != 1 or cfg.mesh_model != 1:
        _not_ported(f"mesh_data={cfg.mesh_data} mesh_model={cfg.mesh_model}",
                    "multi-device on torch.distributed")
    if cfg.profiling:
        _not_ported("profiling=true", "the trainer's profiler windows")
    print(config_summary(cfg))

    # seed discipline: numpy for the data order, a generator for the weights
    np.random.seed(cfg.seed)
    generator = torch.Generator().manual_seed(cfg.seed)

    if cfg.model_type == "ghmfc" and cfg.online_bert:
        # refused before a bert-base sized model is built
        _not_ported("kind='online' with the raw-text dataset (OnlineMELDataset)",
                    "raw-text serving")
    model, kind = get_model(cfg, generator)
    train_ds, valid_ds, test_ds = create_datasets(cfg)
    feats_fn = None
    # device-resident entity tables: ship [B, C] row indices per batch and
    # gather on the device (data/device_store.py)
    if (cfg.device_entity_tables and cfg.dataset_name == "wikimel"
            and cfg.entity_pooling_cached):
        from drin_tpu_torch.data.device_store import DeviceEntityStore, include_for

        # GHMFC reads the text table alone: the other tables are not uploaded
        store = DeviceEntityStore(cfg, train_ds.tables, device=device, include=include_for(kind))
        feats_fn = store.drin_feats_fn() if kind == "drin" else store.baseline_feats_fn()
        kind = kind + "_rows"
        print(f"device entity tables resident: {store.nbytes / 1e6:.0f} MB")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.model_type} ({n_params:,} params), device: {device}")

    # training runs with dropout active (transformer_dropout applies to the
    # multimodal mention configs); eval stays deterministic
    trainer = Trainer(cfg, model, device=device, feats_fn=feats_fn)
    if cfg.test_only:
        trainer.test(test_ds, kind=kind)
        return
    rounds = max(cfg.num_epoch // cfg.test_epoch_interval, 1)
    for _ in range(rounds):  # fit/test chunks
        trainer.fit(train_ds, valid_ds, cfg.test_epoch_interval, kind=kind)
        trainer.test(test_ds, kind=kind)
