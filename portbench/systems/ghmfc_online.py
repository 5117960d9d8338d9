"""GHMFC with online BERT through the port (``drin_tpu_torch``): its
``Ranker`` on the nine token-id fields of an online request, fed with
requests made from the seed and judged by ``reference/ghmfc_online.py``.

A request holds B mention sentences ``[CLS] ... [SEP]`` of the cell's
``sentence_tokens`` lengths, padded to ``max_mention_sentence_len``, each
with a mention span and R region features, and its C candidate texts of
``candidate_tokens`` wordpieces each (``[CLS]`` and ``[SEP]`` included),
zipped into S sentences as the port's online data path lays them out
(``data/online.py:zip_entities``: ceil(C / S) candidates a sentence, each
candidate's tokens after the sentence's one [CLS], each ended by its
[SEP]) and trimmed, as that path does, to the batch's longest sentence
rounded up to ``online_length_buckets``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts
from portbench import inputs as I

CLS, SEP = 101, 102
FIRST_ID = 1000  # token ids are drawn past the vocabulary's special and unused ids
FIELDS = ("mention_ids", "mention_mask", "mention_start_pos", "mention_end_pos",
          "mention_image_feature", "entity_ids", "entity_mask", "entity_sep_idx",
          "entity_image_feature")


def port_config(config: dict):
    from portbench import harness

    return harness.load_file_module("systems", "drin").port_config(config)


def num_candidates(config: dict) -> int:
    return config["num_candidates_data"] + 1


def make_data(run) -> dict:
    shapes = run.reference.param_shapes(run.config)
    return {"weights": I.make_weights(shapes, run.generator("weights"), run.device)}


def _bucket(used: int, bucket: int, cap: int) -> int:
    return min(cap, -(-max(used, 1) // bucket) * bucket)


def zip_candidates(lengths, ids, S: int, max_len: int):
    """One mention's candidates (token lists of ``lengths``, each [CLS] body
    [SEP]) zipped into S sentences: (ids [S, max_len], mask, sep_idx [S, E])."""
    C = len(lengths)
    per = -(-C // S)
    out = np.zeros((S, max_len), np.int64)
    out[:, 0] = CLS
    mask = np.zeros((S, max_len), np.int64)
    sep = np.zeros((S, per), np.int64)
    for s in range(S):
        cur = 0
        for j, c in enumerate(range(s * per, min((s + 1) * per, C))):
            body = np.append(ids[c, :lengths[c] - 2], SEP)  # without CLS, with SEP
            out[s, cur + 1:cur + 1 + len(body)] = body
            cur += len(body)
            sep[s, j] = cur
        mask[s, :cur + 1] = 1
    return out, mask, sep


def request_pool(run, data: dict, n_batches: int, B: int) -> list:
    cfg, cell = run.config, run.cell
    rng = run.rng("requests")
    V, C, S = cfg["bert"]["vocab_size"], num_candidates(cfg), cfg["num_entity_sentence"]
    Lm, R, Dr = cfg["max_mention_sentence_len"], cfg["resnet_num_region"], cfg["resnet_embed_dim"]
    bucket, cap = cfg["online_length_buckets"], cfg["max_bert_len"]
    g = run.generator("regions")
    images = I.host(I.normal(g, run.device, n_batches * B, R, Dr))
    pool = []
    for n in range(n_batches):
        lo, hi = cell["sentence_tokens"]
        lens = rng.integers(lo, hi + 1, B)
        m_ids = np.zeros((B, Lm), np.int64)
        m_mask = np.zeros((B, Lm), np.int64)
        start = np.zeros(B, np.int64)
        end = np.zeros(B, np.int64)
        for b, n_tok in enumerate(lens):
            m_ids[b, 0], m_ids[b, n_tok - 1] = CLS, SEP
            m_ids[b, 1:n_tok - 1] = rng.integers(FIRST_ID, V, n_tok - 2)
            m_mask[b, :n_tok] = 1
            start[b] = rng.integers(1, n_tok - 2)
            end[b] = min(start[b] + rng.integers(1, 4), n_tok - 1)
        m_ids, m_mask = m_ids[:, :_bucket(int(lens.max()), bucket, Lm)], \
            m_mask[:, :_bucket(int(lens.max()), bucket, Lm)]
        zipped = []
        c_lo, c_hi = cell["candidate_tokens"]
        for b in range(B):
            lengths = rng.integers(c_lo, c_hi + 1, C)
            tok = rng.integers(FIRST_ID, V, (C, c_hi))
            zipped.append(zip_candidates(lengths, tok, S, cap))
        e_ids = np.stack([z[0] for z in zipped])
        e_mask = np.stack([z[1] for z in zipped])
        sep = np.stack([z[2] for z in zipped])
        L = _bucket(int(e_mask.sum(-1).max()), bucket, cap)
        pool.append((m_ids, m_mask, start, end, images[n * B:(n + 1) * B],
                     e_ids[..., :L].copy(), e_mask[..., :L].copy(), sep,
                     np.zeros(B, np.float32)))
    return pool


def build_ranker(run, data: dict):
    from drin_tpu_torch.encoders.bert import BertConfig
    from drin_tpu_torch.serve import Ranker

    return Ranker(port_config(run.config), {k: v.clone() for k, v in data["weights"].items()},
                  device=run.device, bert_cfg=BertConfig(**run.config["bert"]))


def reference_scores(run, data: dict, feats: tuple, tf32: bool = False) -> np.ndarray:
    ref, dev = run.reference, run.device
    batch = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in zip(FIELDS, feats)}
    batch["mention_image_feature"] = batch["mention_image_feature"].float()
    weights = {k: v.float() for k, v in data["weights"].items()}
    with ref.precision(tf32), torch.no_grad():
        return ref.forward(weights, run.config, batch).cpu().numpy()


def shapes(run, feats: tuple) -> dict:
    B, S, L = np.asarray(feats[5]).shape
    return {"B": B, "S": S, "L": L, "Lm": np.asarray(feats[0]).shape[1],
            "C": num_candidates(run.config)}


def rank_flops(run, feats: tuple) -> float:
    s = shapes(run, feats)
    return counts.ghmfc_online_flops(run.config, s["B"], s["Lm"], s["S"], s["L"])


def describe(run, data: dict) -> str:
    n = sum(v.numel() for v in data["weights"].values())
    return f"{n / 1e6:.1f} M parameters"
