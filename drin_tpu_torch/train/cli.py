# -*- coding: utf-8 -*-
"""Train/valid/test entry point (port of the root ``train.py``): print the
full config, seed, build datasets + model, then run
``num_epoch // test_epoch_interval`` rounds of fit + test (or test only).

    python -m drin_tpu_torch.train model_type=drin dataset_name=wikimel \\
        preprocess_dir=... batch_size=64 device=cuda

    python -m drin_tpu_torch.train model_type=ghmfc dataset_name=wikimel \\
        online_bert=true finetune_bert=true bert_remat=true \\
        bert_checkpoint=<dir or file> bert_vocab=<vocab.txt> \\
        enable_checkpointing=true profiling=true preprocess_dir=... device=cuda

Every config field is overridable as ``key=value``.  ``device`` (default
``cuda``) is explicit: ``device=cuda`` without CUDA raises, nothing falls
back to the CPU.  On WikiMEL with the pooled entity cache DRIN and offline
GHMFC train over the device-resident entity tables (``device_entity_tables``,
the default): each batch carries [B, C] row indices and the step gathers the
rows on the device.  GHMFC with online BERT trains from the intermediate
store's raw strings (``OnlineMELDataset``, its tokenizer pool of
``dataloader_workers`` spawn processes), from a pretrained BERT when
``bert_checkpoint`` names one (an HF-style directory or a state_dict file).

Several processes, one rank each (``parallel/``): ``num_processes``,
``process_id`` and ``coordinator_address`` join the process group, and
``mesh_data`` x ``mesh_model`` lay the ranks out (``mesh_data=-1``: all
remaining ranks; over several hosts the model axis stays within a host).
``mesh_data`` splits every global batch of ``batch_size`` rows over its
ranks.  ``mesh_model`` splits every model's candidates over its ranks (C
padded to a multiple of it: WikiMEL's 101 -> 102 on 2 ranks; DRIN, offline
GHMFC, MELHI, the online GHMFC in direct mode) or, for the online GHMFC in
zipped mode, its entity sentences (12 -> 6 a rank on 2; a model axis that
does not divide them replicates the model), and row-shards the token-level
entity tables (``cache_entity_pooling=false``) over them: DRIN's and
GHMFC's gathers then keep each rank's block of the candidates.
``dist_backend`` (default:
NCCL on CUDA, gloo on the CPU) is the process group's backend; two ranks on
one card need ``dist_backend=gloo``::

    python -m drin_tpu_torch.train ... mesh_data=2 num_processes=2 process_id=0 \
        coordinator_address=127.0.0.1:29500 dist_backend=gloo device=cuda   # and process_id=1
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from drin_tpu_torch.common.cli import parse_overrides


def main(argv=None):
    """Run the entry point; returns the ``Trainer`` (None on a rank outside
    the mesh)."""
    from drin_tpu_torch.common.config import make_config
    from drin_tpu_torch.parallel import distributed

    overrides = parse_overrides(argv if argv is not None else sys.argv[1:])
    device = torch.device(overrides.pop("device", "cuda"))
    backend = overrides.pop("dist_backend", None)
    model_type = overrides.pop("model_type", "drin")
    dataset_name = overrides.pop("dataset_name", "wikidiverse")
    cfg = make_config(model_type, dataset_name, **overrides)

    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda was asked for and CUDA is not available "
                           "(pass device=cpu to train on the CPU)")
    # join the process group before anything touches the device; a group the
    # caller joined stays joined
    import torch.distributed as dist

    owned = not dist.is_initialized()
    joined = distributed.initialize(cfg, backend=backend, device=device)
    try:
        return _run(cfg, device, joined)
    finally:
        if joined and owned:
            distributed.shutdown()


def _mesh(cfg, joined: bool):
    """The mesh of the joined ranks (hybrid over several hosts), or None for
    one rank; ``cfg`` with ``mesh_data`` resolved."""
    from drin_tpu_torch.parallel.mesh import group_by_host, make_hybrid_mesh, make_mesh

    if not joined:
        make_mesh(cfg)  # refuses a mesh that needs more ranks than one
        return None, cfg.replace(mesh_data=1)
    hosts = group_by_host()
    if len(hosts) > 1:
        mesh = make_hybrid_mesh(hosts, model=cfg.mesh_model,
                                data=None if cfg.mesh_data == -1 else cfg.mesh_data)
    else:
        mesh = make_mesh(cfg)
    return mesh, cfg.replace(mesh_data=mesh.shape["data"])


def _run(cfg, device, joined: bool):
    from drin_tpu_torch.common.config import config_summary
    from drin_tpu_torch.data.dataset import create_datasets
    from drin_tpu_torch.models import get_model
    from drin_tpu_torch.parallel.distributed import local_device
    from drin_tpu_torch.train.trainer import Trainer

    mesh, cfg = _mesh(cfg, joined)
    if joined:
        device = local_device(device, cfg.process_id)
        if not mesh.active:
            print(f"rank {cfg.process_id} is outside the mesh {mesh}: idle", file=sys.stderr)
            return None
        if mesh.size == 1:
            mesh = None  # a mesh of one rank is one device
    main = mesh is None or mesh.main
    say = print if main else (lambda *a, **k: None)
    say(config_summary(cfg))

    # seed discipline: numpy for the data order, a generator for the weights
    np.random.seed(cfg.seed)
    generator = torch.Generator().manual_seed(cfg.seed)

    model, kind = get_model(cfg, generator)
    feats_fn = None
    train_ds = valid_ds = test_ds = None
    if kind == "online":
        from drin_tpu_torch.data.online import OnlineMELDataset

        train_ds, valid_ds, test_ds = (OnlineMELDataset(cfg, s) for s in ("train", "valid", "test"))
        if cfg.bert_checkpoint:
            # the pretrained BERT tower (the reference downloads
            # bert-base-cased at model build)
            from drin_tpu_torch.encoders.checkpoints import load_bert

            _, bert_sd = load_bert(cfg.bert_checkpoint, model.bert.cfg)
            model.bert.load_state_dict(bert_sd)
            say(f"BERT loaded from {cfg.bert_checkpoint}")
    else:
        train_ds, valid_ds, test_ds = create_datasets(cfg)
        # device-resident entity tables: ship [B, C] row indices per batch and
        # gather on the device (data/device_store.py).  The pooled tables are
        # whole on every rank; the token-level ones row-shard over the model
        # axis
        shard_rows = (not cfg.entity_pooling_cached and mesh is not None
                      and mesh.shape["model"] > 1)
        if (cfg.device_entity_tables and cfg.dataset_name == "wikimel"
                and (cfg.entity_pooling_cached or shard_rows)):
            from drin_tpu_torch.data.device_store import DeviceEntityStore, include_for

            # GHMFC reads the text table alone: the other tables are not uploaded
            store = DeviceEntityStore(cfg, train_ds.tables, device=device,
                                      include=include_for(kind), shard_rows=shard_rows,
                                      mesh=mesh)
            feats_fn = store.drin_feats_fn() if kind == "drin" else store.baseline_feats_fn()
            kind = kind + "_rows"
            say(f"device entity tables resident: {store.nbytes / 1e6:.0f} MB"
                + (" a rank (row-sharded over the model axis)" if shard_rows else ""))
    n_params = sum(p.numel() for p in model.parameters())
    say(f"model: {cfg.model_type} ({n_params:,} params), device: {device}"
        + (f", {mesh.size} ranks ({mesh})" if mesh is not None else ""))

    # training runs with dropout active (transformer_dropout applies to the
    # multimodal mention configs); eval stays deterministic
    try:
        trainer = Trainer(cfg, model, device=device, feats_fn=feats_fn, mesh=mesh)
        if cfg.test_only:
            trainer.test(test_ds, kind=kind)
            return trainer
        rounds = max(cfg.num_epoch // cfg.test_epoch_interval, 1)
        for _ in range(rounds):  # fit/test chunks
            trainer.fit(train_ds, valid_ds, cfg.test_epoch_interval, kind=kind)
            trainer.test(test_ds, kind=kind)
        return trainer
    finally:
        for ds in (train_ds, valid_ds, test_ds):
            close = getattr(ds, "close", None)  # the online datasets' tokenizer pools
            if close is not None:
                close()
