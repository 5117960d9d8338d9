"""DRIN through the port (``drin_tpu_torch``): its ``Ranker`` over the served
store and its ``Trainer`` over the float store, fed with data made from the
seed, and judged by ``reference/drin.py``.

The entity tables are WikiMEL's pooled cache at its widths: per row the
pooled and the CLS text vectors [2, D], the image vector [1, Dr], the
object vectors [Te, 1, Dr] and their detector scores [Te].  A mention holds
its sentence's BERT features [L, D] padded to L, its span, its R regions
[R, Dr], its Tm objects and scores, C candidate rows drawn over the whole
table (the last one the gold answer, appended as the dataset does) and the
two CLIP logits per candidate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import counts
from portbench import inputs as I

TABLES = ("entity_text_feature", "entity_image_feature", "entity_object_feature",
          "entity_object_score")


def port_config(config: dict):
    """The port's ``Config`` for a configuration file: ``make_config``'s
    defaults for the model and dataset, with every key of the file that
    names a ``Config`` field; paths point nowhere (nothing is read)."""
    from drin_tpu_torch.common.config import Config, make_config

    fields = {f.name for f in dataclasses.fields(Config)} - {"model_type", "dataset_name"}
    over = {k: tuple(v) if isinstance(v, list) else v for k, v in config.items() if k in fields}
    cfg = make_config(config["model_type"], config["dataset_name"],
                      dataset_root="/nonexistent/dataset", preprocess_dir="/nonexistent/processed",
                      **over)
    for k, v in over.items():
        assert getattr(cfg, k) == v, (k, getattr(cfg, k), v)
    return cfg


def num_candidates(config: dict) -> int:
    return config["num_candidates_data"] + 1


def make_data(run) -> dict:
    """The weights (on the device) and the entity tables (host arrays, as
    the program's store builder takes them)."""
    cfg, dev = run.config, run.device
    weights = I.make_weights(run.reference.param_shapes(cfg), run.generator("weights"), dev)
    N, D, Dr, Te = (cfg["entity_rows"], cfg["bert_embed_dim"], cfg["resnet_embed_dim"],
                    cfg["entity_object_topk"])
    g = run.generator("tables")
    tables = {"entity_text_feature": I.host(I.normal(g, dev, N, 2, D)),
              "entity_image_feature": I.host(I.normal(g, dev, N, 1, Dr)),
              "entity_object_feature": I.host(I.normal(g, dev, N, Te, 1, Dr)),
              "entity_object_score": I.host(I.uniform(g, dev, 0, 1, N, Te))}
    return {"weights": weights, "tables": tables}


def mentions(run, tag: str, n: int) -> dict:
    """``n`` mentions as host arrays under the rows batch's field names (the
    answer one-hot over the C - 1 data candidates, its row appended last)."""
    cfg, cell, dev = run.config, run.cell, run.device
    g = run.generator("mentions", tag)
    C, L, D = num_candidates(cfg), cfg["max_mention_sentence_len"], cfg["bert_embed_dim"]
    R, Dr, Tm = cfg["resnet_num_region"], cfg["resnet_embed_dim"], cfg["mention_object_topk"]
    lo, hi = cell["sentence_tokens"]
    lens = I.integers(g, dev, lo, hi + 1, n)
    start = 1 + (I.uniform(g, dev, 0, 1, n) * (lens - 3)).long()  # after CLS
    end = torch.minimum(start + I.integers(g, dev, 1, 4, n), lens - 1)  # before SEP
    rows = I.integers(g, dev, 0, cfg["entity_rows"], n, C).int()
    gold = I.integers(g, dev, 0, C - 1, n)
    rows[:, -1] = rows[torch.arange(n, device=dev), gold]
    answer = torch.zeros((n, C - 1), device=dev)
    answer[torch.arange(n, device=dev), gold] = 1.0
    out = {"mention_text_feature": I.normal(g, dev, n, L, D),
           "mention_text_mask": (torch.arange(L, device=dev)[None] < lens[:, None]).long(),
           "mention_start_pos": start, "mention_end_pos": end,
           "mention_image_feature": I.normal(g, dev, n, R, Dr),
           "mention_object_feature": I.normal(g, dev, n, Tm, Dr),
           "mention_object_score": I.uniform(g, dev, 0, 1, n, Tm),
           "entity_rows": rows,
           "miet_similarity": I.uniform(g, dev, 0, 40, n, C),
           "mtei_similarity": I.uniform(g, dev, 0, 40, n, C),
           "answer": answer}
    return {k: I.host(v) for k, v in out.items()}


FIELDS = ("mention_text_feature", "mention_text_mask", "mention_start_pos", "mention_end_pos",
          "mention_image_feature", "mention_object_feature", "mention_object_score",
          "entity_rows", "miet_similarity", "mtei_similarity")


def request_pool(run, data: dict, n_batches: int, B: int) -> list:
    """``n_batches`` rank requests of B mentions: tuples of the rows
    batch's fields in order (the answer left out)."""
    m = mentions(run, "pool", n_batches * B)
    return [tuple(m[f][i * B:(i + 1) * B] for f in FIELDS) for i in range(n_batches)]


def build_ranker(run, data: dict):
    """The served deployment: ``Ranker`` over the store the cell names
    (the serve CLI's int8 fused store), on a copy of the weights."""
    from drin_tpu_torch.serve import Ranker

    cell = run.cell
    return Ranker(port_config(run.config), {k: v.clone() for k, v in data["weights"].items()},
                  data["tables"], device=run.device, quantize_store=cell["quantize_store"],
                  fused_gather=cell["fused_gather"])


def reference_batch(run, data: dict, fields: dict) -> dict:
    """The reference's batch for mentions given by field name: the mention
    fields on the device and the served rows worked out again from the raw
    tables."""
    dev = run.device
    t = lambda x: torch.as_tensor(np.asarray(x)).to(dev)
    rows = np.asarray(fields["entity_rows"])
    raw = {k: t(data["tables"][k][rows]) for k in TABLES}
    batch = run.reference.served_rows(raw, run.cell.get("quantize_store", False))
    for k in FIELDS[:7] + FIELDS[8:]:
        batch[k] = t(fields[k])
        if batch[k].is_floating_point():
            batch[k] = batch[k].float()
    if "answer" in fields:
        batch["answer"] = t(fields["answer"]).float()
    return batch


def reference_scores(run, data: dict, feats: tuple, tf32: bool = False) -> np.ndarray:
    """[B, C] scores of a rank request (the rows batch's fields in order)
    by the plain reference, float32, or in one TF32 pass for the control."""
    ref = run.reference
    batch = reference_batch(run, data, dict(zip(FIELDS, feats)))
    weights = {k: v.float() for k, v in data["weights"].items()}
    with ref.precision(tf32), torch.no_grad():
        return ref.forward(weights, batch).cpu().numpy()


def rank_flops(run, feats: tuple) -> float:
    B, C = np.asarray(feats[7]).shape
    return counts.drin_flops(run.config, B, C)


def describe(run, data: dict) -> str:
    n = run.config["entity_rows"]
    mb = sum(v.nbytes for v in data["tables"].values()) / 1e6
    return f"{n} entity rows, {mb:.0f} MB of host tables"


def shapes(run, feats: tuple) -> dict:
    B, C = np.asarray(feats[7]).shape
    return {"B": B, "C": C}


def train_flops(run, B: int, C: int) -> float:
    return counts.drin_flops(run.config, B, C, train=True)
