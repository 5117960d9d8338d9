# -*- coding: utf-8 -*-
"""Preprocessing CLI: ``python -m drin_tpu_torch.preprocess <stage> [key=value ...]``.

Stages: prepare, bert, resnet, clip, all.  Config overrides work like the
training CLI (e.g. ``dataset_name=wikimel bert_checkpoint=/path/dir``), and
``device`` (default ``cuda``) is explicit: ``device=cuda`` without CUDA
raises, nothing falls back to the CPU.

Object boxes: ``detector_checkpoint=/path/frcnn.pt`` runs the Faster R-CNN
of a torchvision ``fasterrcnn_resnet50_fpn`` state dict (either key layout;
``drin_object_detector=mask_rcnn`` for a Mask R-CNN one) on the stage's
device; unset, a whole-image stub stands in, with a warning.  Migrating a
store the reference already preprocessed (with its pretrained torchvision
detector): ``resnet import_objects_from=/path/to/ref/store`` adopts the
detector-derived object arrays verbatim, while whole-image features are
recomputed here.

With ``preprocess_data_parallel`` (the default) and several CUDA devices
visible, every stage spreads each encoder batch over all of them
(``stages.RowShardedDispatch``)."""

from __future__ import annotations

import sys

STAGES = ("prepare", "bert", "resnet", "clip", "all")


def main(argv=None):
    """Run the stage; returns ``{name: stage object}`` of the encoder stages
    it ran (their ``clock`` holds host and encoder seconds)."""
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        raise SystemExit(__doc__)
    stage, rest = argv[0], argv[1:]
    if stage not in STAGES:
        # validate BEFORE building the config: a stage typo must not be
        # masked by (or wait behind) override/config errors
        raise SystemExit(f"unknown stage: {stage} (expected one of {STAGES})")

    from drin_tpu_torch.common.cli import parse_overrides
    from drin_tpu_torch.common.config import make_config

    overrides = parse_overrides(rest)
    device = overrides.pop("device", "cuda")
    model_type = overrides.pop("model_type", "drin")
    dataset_name = overrides.pop("dataset_name", "wikidiverse")
    cfg = make_config(model_type, dataset_name, **overrides)
    if stage != "prepare":  # the encoder stages' device, checked before any work
        import torch

        from drin_tpu_torch.preprocess import stages

        device = stages.stage_device(device)

    if stage in ("prepare", "all"):
        from drin_tpu_torch.preprocess.prepare import run_prepare

        run_prepare(cfg)
    ran = {}
    if stage == "prepare":
        return ran
    devices = None
    if device.type == "cuda" and cfg.preprocess_data_parallel and torch.cuda.device_count() > 1:
        # every visible card takes a share of each encoder batch
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        print(f"the stages' encoders run data-parallel over {len(devices)} CUDA devices",
              flush=True)
    if stage in ("bert", "all"):
        ran["bert"] = stages.BertStage(cfg, device=device, devices=devices)
        ran["bert"].run()
    if stage in ("resnet", "all"):
        ran["resnet"] = stages.ResnetStage(cfg, device=device, devices=devices)
        ran["resnet"].run()
    if stage in ("clip", "all"):
        ran["clip"] = stages.ClipStage(cfg, device=device, devices=devices)
        ran["clip"].run()
    return ran


if __name__ == "__main__":
    main()
