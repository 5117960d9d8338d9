# -*- coding: utf-8 -*-
"""Structured configuration (the port's own copy of ``drin_tpu/common/config.py``).

A frozen dataclass whose field names match the reference implementation's
``common/args.py`` globals, with the per-model / per-dataset conditional
defaults of that module.  The copy is field for field the JAX package's
(``tests/test_torch_package.py`` holds ``dataclasses.asdict`` of both equal),
so a ``Config`` built by either package serves the port: its functions read
attributes only.  Fields that steer JAX- or TPU-only machinery (``use_pallas``,
mesh sizes, ...) are kept for that equality and are not read by the port.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Optional

# BERT special-token ids (bert-base-cased vocabulary; reference args.py:46-47).
CLS_TOKEN_ID = 101
SEP_TOKEN_ID = 102


@dataclass(frozen=True)
class Config:
    """Immutable run configuration.

    Field names intentionally match the reference's ``common/args.py`` globals
    so config-surface compatibility holds (a user can look up any reference
    knob by the same name).  TPU-specific additions live at the bottom.
    """

    # ---- model selection ------------------------------------------------
    model_type: str = "drin"  # ghmfc, melhi or drin
    dataset_name: str = "wikidiverse"  # wikimel or wikidiverse

    # ---- ghmfc options (reference args.py:8-19) -------------------------
    pre_extract_mention: bool = False
    mention_final_layer_name: str = "linear"
    mention_final_representation: str = "avg extract"
    mention_final_output_dim: int = 768
    entity_final_layer_name: str = "linear"
    entity_final_pooling: str = "avg"
    entity_final_output_dim: int = 768
    multimodal_subspace_activation: str = "gelu"
    mention_multimodal_attention: str = "bi"

    # ---- melhi options (reference args.py:20-23) ------------------------
    thres_tmim: float = 0.3
    thres_imie: float = 0.3

    # ---- drin options (reference args.py:24-40) -------------------------
    gcn_embed_dim: int = 768
    num_gcn_layers: int = 2
    drin_object_detector: str = "faster_rcnn"  # faster_rcnn or mask_rcnn
    gcn_edge_type: str = "dynamic"  # static or dynamic
    gcn_edge_feature: str = "scaler"  # scaler or vector
    gcn_edge_enabled: tuple = (1, 1, 1, 1)  # per-edge ablation mask (tt, ti, it, ii)
    gcn_vertex_activation: str = "gelu"
    gcn_edge_activation: str = "sigmoid"

    # ---- encoders: bert (reference args.py:43-49) -----------------------
    max_bert_len: int = 512
    bert_embed_dim: int = 768
    CLS: int = CLS_TOKEN_ID
    SEP: int = SEP_TOKEN_ID
    finetune_bert: bool = False
    online_bert: bool = False

    # ---- encoders: resnet (reference args.py:51-57) ---------------------
    resnet_embed_dim: int = 2048
    resnet_num_region: int = 49
    image_input_size: tuple = (224, 224)
    min_image_size: tuple = (50, 50)
    default_box: tuple = (0, 0, 50, 50)
    mention_object_topk: int = 3
    entity_object_topk: int = 1

    # ---- encoders: transformer block (reference args.py:59-64) ----------
    transformer_num_layers: int = 8
    transformer_num_heads: int = 8
    transformer_ffn_hidden_size: int = 512
    transformer_ffn_activation: str = "gelu"
    transformer_dropout: float = 0.1

    # ---- data (reference args.py:67-74) ---------------------------------
    entity_text_type: str = "attr"
    num_entity_sentence: int = 12
    max_mention_name_len: int = 32
    max_mention_sentence_len: int = 128
    mention_mmap: Optional[str] = None
    entity_mmap: Optional[str] = None

    # ---- dataset paths (reference args.py:76-101) -----------------------
    dataset_root: str = ""
    preprocess_dir: str = ""
    default_image: str = ""
    num_candidates_data: int = 10
    max_entity_attr_char_len: int = 512
    max_entity_attr_token_len: int = 128
    qid2entity_path: str = ""
    qid2attr_path: str = ""
    mention_text_path: str = ""
    candidate_path: str = ""
    entity2image_path: str = ""
    entity2brief_path: str = ""
    image_dir: str = ""
    mention_image_dir: str = ""
    entity_image_dir: str = ""

    # ---- train (reference args.py:104-126) ------------------------------
    dataloader_workers: int = 8
    use_device: str = "tpu"
    shuffle_train_data: bool = True
    seed: int = 0
    num_epoch: int = 30
    test_epoch_interval: int = 10
    test_only: bool = False
    metrics_topk: tuple = (1, 3, 5)
    acc_correction: tuple = (0.0, 0.0, 0.0)
    learning_rate: float = 1e-3
    triplet_margin: float = 0.25
    batch_size: int = 64

    # ---- debug (reference args.py:129-137) ------------------------------
    output_test_result: bool = False
    profiling: bool = False
    debug: bool = False

    # ---- TPU-native additions (no reference equivalent) -----------------
    # Mesh axis sizes; data parallel over 'data', candidate/tensor parallel
    # over 'model'.  (1, 1) means single chip.
    mesh_data: int = 1
    mesh_model: int = 1
    # Multi-process (multi-host) cluster: one process per host, same program
    # on every host (parallel/distributed.py).  All three must be set (or a
    # TPU-pod runtime must provide them) for num_processes > 1.
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0
    # Reference-harness fidelity: the reference builds a FRESH Lightning
    # Trainer for every fit/test chunk (train.py:141-144) and each
    # trainer.fit re-runs configure_optimizers (train.py:55-56), so Adam's
    # moments and step count restart at every test_epoch_interval boundary.
    # True reproduces that observable schedule (pinned by
    # tests/test_training_parity.py::test_full_harness_trajectory); set
    # False to carry optimizer state across chunks (e.g. resumed long runs).
    reset_optimizer_per_fit: bool = True
    # Checkpointing is NEW capability (reference disables it, train.py:115).
    enable_checkpointing: bool = False
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    # Checkpoint STEP number to resume from (checkpoints are keyed by
    # global step under checkpoint_dir); None resumes from the latest.
    resume_from: Optional[str] = None
    # Compute dtype for the model body; params stay f32.
    compute_dtype: str = "float32"
    # Online path: trim each batch's token tensors to the batch max content
    # length rounded up to this multiple (0 disables).  EXACT numerics: the
    # removed columns are all-padding, which BERT's additive mask already
    # zeroes out of every kept position (softmax terms are exact zeros) —
    # the reference always runs the full 512 columns.  A few buckets means
    # a few XLA programs.  Single-process only (multi-host SPMD needs one
    # global batch shape; the dataset disables it there).
    online_length_buckets: int = 128
    # Online path: route BERT self-attention through the flash-style fused
    # Pallas kernel (ops/pallas/attention.py) — the [L, L] logits stay in
    # VMEM instead of round-tripping HBM, which is what out-of-memories a
    # chip at batch 64 x 13 towers x 512 tokens.  None = auto: on for a
    # single-device TPU backend, off elsewhere (CPU tests; meshes, where
    # pallas_call partitioning isn't wired).  Measured 24x faster than the
    # XLA attention at [32, 12, 512, 64] bf16 (BASELINE.md).
    bert_fused_attention: Optional[bool] = None
    # Online path: rematerialize each BERT layer in the backward pass
    # (jax.checkpoint) so ``finetune_bert=True`` fits at real batch sizes —
    # saved activations drop from O(layers) to O(1) per tower at the cost of
    # one extra forward.  No effect when BERT is frozen (no backward).
    bert_remat: bool = False
    # Use the fused Pallas GCN vertex kernel on TPU.  Measured on v5e the
    # XLA-fused path is slightly faster for the default shapes (1.29 vs
    # 1.38 ms/iter full-model bf16), so this defaults off; the kernel is kept
    # maintained + tested for larger-C workloads where per-sample blocking
    # wins.
    use_pallas: bool = False
    # batch-tile rows per fused-GCN-layer kernel program (ops/pallas/gcn_layer;
    # 8 measured best — BASELINE.md; 16 exceeds the 16MB scoped-VMEM limit)
    pallas_block_b: int = 8
    # WikiMEL: pool the frozen global entity-text table ONCE at load instead
    # of streaming [B, C, Le, D] token features through every batch (32x less
    # entity-side HBM traffic; numerically identical — the per-batch pooling
    # is deterministic over frozen features).  The batch then carries
    # [B, C, 2, D] stacked (pooled, CLS) entity text.
    cache_entity_pooling: bool = True
    # WikiMEL: keep the (pooled) global entity tables resident in device HBM
    # and gather candidate rows INSIDE the jitted step — batches then carry a
    # [B, C] int32 row-index matrix instead of ~90MB of gathered entity
    # features (the pooled text+image+object tables are ~350MB in bf16 for
    # the full 109k-entity store).  Requires cache_entity_pooling.
    device_entity_tables: bool = True
    # Eval/serving: the batch's entity text slot 0 and entity image features
    # arrive ALREADY projected through the trained entity-side linears (the
    # frozen global tables are projected once per eval epoch/deployment —
    # data/device_store.project_drin_tables).  Exact math: linear(gather(T))
    # == gather(linear(T)); drops ~28 GFLOP from every eval forward.
    entity_projected: bool = False
    # Host-side input pipeline.
    prefetch_depth: int = 2
    # Steps between status-line refreshes.  Each refresh fetches the on-device
    # metric state to the host (the reference prints every step, train.py:31-39;
    # we keep the same \r protocol but only sync at this cadence so the device
    # queue never drains on a blocking per-step transfer).
    log_interval_steps: int = 50
    # Frozen-encoder assets for the preprocessing stages (torch state_dicts
    # converted on load; tokenizer vocab/merges files).  The reference
    # downloads these from the HF hub at run time (bert.py:87, resnet.py:130,
    # clip.py:159); here they are explicit local paths.
    bert_checkpoint: str = ""
    bert_vocab: str = ""
    resnet_checkpoint: str = ""
    clip_checkpoint: str = ""
    clip_vocab: str = ""
    clip_merges: str = ""
    # torch state_dict of the detection model named by drin_object_detector
    # (fasterrcnn_resnet50_fpn or maskrcnn_resnet50_fpn; both convert through
    # encoders.frcnn — the pipeline consumes only boxes+scores, so the mask
    # branch of a mask_rcnn checkpoint is ignored, reference resnet.py:117-120)
    detector_checkpoint: str = ""
    # Adopt the detector-derived arrays ({mention,entity}-object-feature/-score,
    # reference resnet.py:152-162) VERBATIM from an existing store directory —
    # e.g. one the reference preprocessed with its pretrained torchvision
    # Faster R-CNN — instead of running a detector here.  Zero object-feature
    # drift for users migrating a reference-preprocessed dataset; the resnet
    # stage still computes the whole-image features itself.
    import_objects_from: str = ""
    # The reference's ResNet stage runs images through HF's ConvNext
    # processor, which upsizes the shortest edge to size/crop_pct and
    # center-crops back (preprocess/images.resnet_preprocess); 0 disables.
    resnet_crop_pct: float = 0.875
    resnet_resample: str = "bilinear"
    # preprocessing batch size (the reference pins resnet/clip to 1,
    # resnet.py:19, clip.py:18; TPU stages use real batches)
    preprocess_batch_size: int = 64
    image_decode_workers: int = 16
    # shard each preprocessing stage's batch over all local devices
    # (stages.RowShardedJit); per-device batch stays preprocess_batch_size
    preprocess_data_parallel: bool = True
    # Profiler trace output dir (jax.profiler; reference used torch.profiler,
    # train.py:64-70).
    profile_dir: str = "log/profiler"
    # Windowed profiler schedule, stepped per train batch — the reference's
    # torch.profiler schedule(wait=1, warmup=1, active=3, repeat=2)
    # (train.py:64-70).  Each cycle skips ``wait + warmup`` steps then traces
    # ``active`` steps; ``repeat`` cycles total (0 = trace the entire fit,
    # which is unusable at num_epoch=30 scale).
    profile_wait: int = 1
    profile_warmup: int = 1
    profile_active: int = 3
    profile_repeat: int = 2

    # ------------------------------------------------------------------
    @property
    def num_candidates_model(self) -> int:
        # "the last is reserved for answer" (reference args.py:101)
        return self.num_candidates_data + 1

    @property
    def entity_pooling_cached(self) -> bool:
        """True when the global entity-text table is replaced by its
        (pooled, CLS) cache: wikimel only, and only for pooling modes the
        cache can represent (max pooling needs the raw tokens)."""
        return (
            self.cache_entity_pooling
            and self.dataset_name == "wikimel"
            and self.entity_final_pooling in ("avg", "bert default")
        )

    @property
    def object_topk(self) -> dict:
        return {"mention": self.mention_object_topk, "entity": self.entity_object_topk}

    @property
    def num_devices(self) -> int:
        """Total mesh size.  ``mesh_data == -1`` ("all remaining devices",
        mesh.make_mesh semantics) must be resolved by the entry point AFTER
        any jax.distributed initialization (train.py:resolve_mesh_data) —
        querying the backend from a config property would initialize JAX as
        a side effect of merely reading config."""
        assert self.mesh_data != -1, (
            "resolve mesh_data=-1 against jax.devices() first "
            "(train.py resolves it after cluster init)")
        return self.mesh_data * self.mesh_model

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _dataset_defaults(dataset_name: str, dataset_root: str) -> dict:
    """Per-dataset conditional defaults (reference args.py:77-101)."""
    root = dataset_root.rstrip("/") + "/"
    if dataset_name == "wikimel":
        return dict(
            num_candidates_data=100,
            max_entity_attr_char_len=128,
            max_entity_attr_token_len=64,
            qid2entity_path=root + "candidates/qid2ne.json",
            qid2attr_path=root + "entities/qid2abs.json",
            mention_text_path=root + "mentions/WIKIMEL_%s.json",
            candidate_path=root + "candidates/top100/candidates-answer.tsv",
            mention_image_dir=root + "mentions/KVQAimgs",
            entity_image_dir=root + "entities/cleaned-images",
            metrics_topk=(1, 5, 10, 20, 50),
            acc_correction=(0.0, 0.0, 0.0),
        )
    elif dataset_name == "wikidiverse":
        return dict(
            num_candidates_data=10,
            max_entity_attr_char_len=512,
            max_entity_attr_token_len=128,
            mention_text_path=root + "candidates/%s_w_10cands.json",
            entity2image_path=root + "entities/wikipedia_entity2imgs.tsv",
            entity2brief_path=root + "entities/entity2brief_%s.json",
            image_dir=root + "images",
            mention_image_dir=root + "images",
            entity_image_dir=root + "images",
            metrics_topk=(1, 3, 5),
            # first-stage retrieval miss rates folded into reported accuracy
            # (reference args.py:121-123)
            acc_correction=(2292 / 13205, 250 / 1552, 282 / 1570),
        )
    raise ValueError(f"unknown dataset_name: {dataset_name}")


def _model_defaults(model_type: str) -> dict:
    """Per-model conditional defaults (reference args.py:7-40)."""
    if model_type == "ghmfc":
        return dict(
            pre_extract_mention=False,
            mention_final_layer_name="multimodal",
            mention_final_representation="max pool",
            mention_final_output_dim=768,
            entity_final_layer_name="linear",
            entity_final_pooling="avg",
            entity_final_output_dim=768,
            multimodal_subspace_activation="gelu",
            mention_multimodal_attention="bi",
        )
    elif model_type == "melhi":
        return dict(
            thres_tmim=0.3,
            thres_imie=0.3,
            mention_final_layer_name="multimodal",
            entity_final_layer_name="multimodal",
        )
    elif model_type == "drin":
        return dict(
            gcn_embed_dim=768,
            num_gcn_layers=2,
            mention_final_layer_name="linear",
            mention_final_representation="avg extract",
            entity_final_layer_name="linear",
            drin_object_detector="faster_rcnn",
            gcn_edge_type="dynamic",
            gcn_edge_feature="scaler",
            gcn_edge_enabled=(1, 1, 1, 1),
            gcn_vertex_activation="gelu",
            gcn_edge_activation="sigmoid",
            mention_final_output_dim=768,
            entity_final_output_dim=768,
            entity_final_pooling="avg",
        )
    raise ValueError(f"unknown model_type: {model_type}")


def make_config(
    model_type: str = "drin",
    dataset_name: str = "wikidiverse",
    dataset_root: Optional[str] = None,
    preprocess_dir: Optional[str] = None,
    **overrides: Any,
) -> Config:
    """Build a Config with the reference's conditional defaults applied.

    Override precedence: explicit ``overrides`` > dataset defaults > model
    defaults > dataclass field defaults.  Debug mode applies the reference's
    debug overrides (args.py:133-137) last unless explicitly overridden.
    """
    # catch typo'd knobs with a suggestion instead of a bare TypeError (the
    # config surface is ~80 fields; CLI overrides make typos easy)
    valid = {f.name for f in dataclasses.fields(Config)}
    unknown = [k for k in overrides if k not in valid]
    if unknown:
        import difflib

        hints = []
        for k in unknown:
            close = difflib.get_close_matches(k, valid, n=1)
            hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)" if close else ""))
        raise ValueError("unknown config field(s): " + ", ".join(hints))
    if dataset_root is None:
        dataset_root = os.environ.get(
            "DRIN_DATA_ROOT", os.path.expanduser(f"~/mel-dataset/{dataset_name}")
        )
    if preprocess_dir is None:
        preprocess_dir = os.environ.get(
            "DRIN_PREPROCESS_DIR",
            os.path.join(os.path.dirname(dataset_root.rstrip("/")), "processed", dataset_name),
        )
    kw: dict = {}
    kw.update(_model_defaults(model_type))
    kw.update(_dataset_defaults(dataset_name, dataset_root))
    kw["model_type"] = model_type
    kw["dataset_name"] = dataset_name
    kw["dataset_root"] = dataset_root
    kw["preprocess_dir"] = preprocess_dir
    kw["default_image"] = os.environ.get(
        "DRIN_DEFAULT_IMAGE",
        os.path.join(os.path.dirname(dataset_root.rstrip("/")), "default.jpg"),
    )
    kw.update(overrides)
    cfg = Config(**kw)
    if cfg.debug:
        # reference debug overrides (args.py:133-137), each yielding to an
        # explicit user override of that same field
        debug_defaults = dict(
            shuffle_train_data=False,
            num_epoch=1,
            test_epoch_interval=1,
            dataloader_workers=0,
            mention_mmap="r",
            entity_mmap="r",
        )
        cfg = cfg.replace(**{k: v for k, v in debug_defaults.items()
                             if k not in overrides})
    return cfg


def config_summary(cfg: Config) -> str:
    """Render every config key/value, mirroring the reference's startup dump
    (train.py:126-133)."""
    lines = ["=============== parameters ==============="]
    d = dataclasses.asdict(cfg)
    d["num_candidates_model"] = cfg.num_candidates_model
    for k in sorted(d):
        v = d[k]
        if isinstance(v, str):
            v = "'" + v + "'"
        lines.append(f"{k} = {v}")
    return "\n".join(lines)
