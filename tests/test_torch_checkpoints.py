# -*- coding: utf-8 -*-
"""``drin_tpu_torch.encoders.checkpoints.load_bert`` against
``drin_tpu.encoders.checkpoints.load_bert``: checkpoints the test writes
itself (an HF-style directory with ``config.json``, directories with only a
weights file, a bare state_dict file), the dims each package reads from
them, BERT's forward from the loaded weights at rtol 2e-4 in float32, and
``get_model`` taking BERT's dims from ``cfg.bert_checkpoint``."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from drin_tpu.encoders import bert as jbert
from drin_tpu.encoders import checkpoints as jckpt
from drin_tpu.models import get_model as jax_get_model
from drin_tpu_torch.encoders import bert as tbert
from drin_tpu_torch.encoders import checkpoints as tckpt
from drin_tpu_torch.models import get_model
from test_torch_ghmfc import online_cfg

F32 = dict(rtol=2e-4, atol=1e-5)
# 4 heads of 16 in config.json; without it both packages infer max(D // 64, 2)
HF = dict(vocab_size=61, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
          intermediate_size=96, max_position_embeddings=40, type_vocab_size=2,
          layer_norm_eps=1e-12)


def _weights(seed=0):
    """A seeded state_dict under HF ``BertModel``'s keys, with the position-id
    buffer HF checkpoints carry (read by neither package)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        keys = tbert.BertModel(tbert.BertConfig(**HF)).state_dict()
    sd = {}
    for k, v in keys.items():
        scale = 0.2 if v.ndim == 2 else 0.1
        base = 1.0 if "LayerNorm.weight" in k else 0.0
        sd[k] = torch.from_numpy(base + scale * rng.standard_normal(tuple(v.shape),
                                                                     dtype=np.float32))
    sd["embeddings.position_ids"] = torch.arange(HF["max_position_embeddings"])[None]
    return sd


def _write(tmp_path, layout):
    sd = _weights()
    if layout == "hf-dir":
        d = tmp_path / "hf"
        d.mkdir()
        torch.save(sd, d / "pytorch_model.bin")
        (d / "config.json").write_text(json.dumps(dict(HF, model_type="bert")))
        return str(d)
    if layout in ("model.pt", "state_dict.pt"):
        d = tmp_path / layout.split(".")[0]
        d.mkdir()
        torch.save(sd, d / layout)
        return str(d)
    path = tmp_path / "bert.bin"  # a bare state_dict file
    torch.save(sd, path)
    return str(path)


@pytest.mark.parametrize("layout", ["hf-dir", "model.pt", "state_dict.pt", "file"])
def test_load_bert_equals_jax(tmp_path, layout):
    path = _write(tmp_path, layout)
    tcfg, sd = tckpt.load_bert(path)
    jcfg, params = jckpt.load_bert(path)
    assert vars(tcfg) == vars(jcfg)
    assert tcfg.num_attention_heads == (4 if layout == "hf-dir" else 2)
    model = tbert.BertModel(tcfg).eval()
    assert set(sd) == set(model.state_dict())  # the buffer is not read
    model.load_state_dict(sd)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, HF["vocab_size"], (3, 20)).astype(np.int64)
    mask = (np.arange(20)[None] < np.array([[20], [13], [5]])).astype(np.int64)
    types = (np.arange(20)[None] >= 10).astype(np.int64).repeat(3, 0)
    want_h, want_p = jax.jit(jbert.BertModel(jcfg).apply)({"params": params}, ids, mask, types)
    with torch.inference_mode():
        got_h, got_p = model(torch.from_numpy(ids), torch.from_numpy(mask),
                             torch.from_numpy(types))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **F32)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **F32)
    # an explicit config is taken as given
    given = tbert.BertConfig(**dict(HF, num_attention_heads=8))
    assert tckpt.load_bert(path, given)[0] is given


def test_key_layout_is_the_jax_packages(tmp_path):
    """A checkpoint under another prefix (``bert.`` of a task model) is refused
    by both, and a missing weights file is named."""
    sd = {"bert." + k: v for k, v in _weights().items()}
    torch.save(sd, tmp_path / "prefixed.bin")
    for load in (tckpt.load_bert, jckpt.load_bert):
        with pytest.raises((KeyError, ValueError)):
            load(str(tmp_path / "prefixed.bin"))
    (tmp_path / "empty").mkdir()
    for load in (tckpt.load_bert, jckpt.load_bert):
        with pytest.raises(FileNotFoundError, match="no torch weights file"):
            load(str(tmp_path / "empty"))
    got, hf = tckpt.load_torch_state_dict(_write(tmp_path, "hf-dir"))
    assert hf["num_attention_heads"] == 4 and "embeddings.position_ids" in got


@pytest.mark.parametrize("layout", ["hf-dir", "file"])
def test_get_model_reads_bert_dims_from_the_checkpoint(tmp_path, layout):
    path = _write(tmp_path, layout)
    cfg = online_cfg(bert_checkpoint=path)
    model, kind = get_model(cfg)
    jmodel, jkind = jax_get_model(_jax_cfg(cfg))
    assert kind == jkind == "online"
    assert vars(model.bert.cfg) == vars(jmodel.bert_cfg)
    assert model.bert.cfg.hidden_size == 64
    # the weights are the caller's to load (the training entry point does)
    model.bert.load_state_dict(tckpt.load_bert(path, model.bert.cfg)[1])
    assert torch.equal(model.bert.embeddings.word_embeddings.weight,
                       _weights()["embeddings.word_embeddings.weight"])


def _jax_cfg(cfg):
    from drin_tpu.common.config import make_config

    d = dataclasses.asdict(cfg)
    return make_config(d.pop("model_type"), d.pop("dataset_name"), **d)
