# -*- coding: utf-8 -*-
"""The port's BERT against ``drin_tpu.encoders.bert.BertModel`` through
``bert_state_dict_from_jax``, at a tiny width in float32 (rtol 2e-4: the same
math in another association order)."""

import functools

import jax
import numpy as np
import pytest
import torch

from drin_tpu.encoders import bert as jbert
from drin_tpu_torch.encoders import bert as tbert
from drin_tpu_torch.models.convert import bert_state_dict_from_jax
from drin_tpu_torch.ops.cuda import attention as tattn

F32 = dict(rtol=2e-4, atol=1e-5)
DIMS = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=48, max_position_embeddings=40)


@functools.lru_cache(maxsize=None)  # flax init compiles: once per set of dims
def _jax_bert(fused=False, **dims):
    cfg = jbert.BertConfig(**{**DIMS, **dims})
    model = jbert.BertModel(cfg, fused_attention=fused)
    ids = np.zeros((1, 8), np.int32)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(0), ids)["params"])
    return cfg, model, params


def _port_bert(params, fused=False, **dims):
    cfg = tbert.BertConfig(**{**DIMS, **dims})
    model = tbert.BertModel(cfg, fused_attention=fused).eval()
    model.load_state_dict(bert_state_dict_from_jax(params, cfg))
    return model


def _tokens(B, L, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, L)).astype(np.int64)
    lens = rng.integers(2, L + 1, B)
    lens[0] = L
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    return ids * mask, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masked"])
def test_bert_matches_jax(masked):
    _, jmodel, params = _jax_bert()
    model = _port_bert(params)
    ids, mask = _tokens(3, 24, DIMS["vocab_size"], 0)
    types = (np.arange(24)[None] >= 12).astype(np.int64).repeat(3, 0)
    m = mask if masked else None
    want_h, want_p = jax.jit(jmodel.apply)({"params": params}, ids, m, types)
    with torch.inference_mode():
        got_h, got_p = model(torch.from_numpy(ids), None if m is None else torch.from_numpy(m),
                             torch.from_numpy(types))
    assert got_h.shape == (3, 24, 32) and got_p.shape == (3, 32)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **F32)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **F32)


def test_state_dict_round_trip_leaf_by_leaf():
    cfg, _, params = _jax_bert()
    sd = bert_state_dict_from_jax(params, cfg)
    assert set(sd) == set(tbert.BertModel(tbert.BertConfig(**DIMS)).state_dict())
    back = jbert.bert_params_from_torch({k: v.numpy() for k, v in sd.items()}, cfg)
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(params), flat(back)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # a prefix nests the keys, as GHMFCOnline holds them under "bert."
    nested = bert_state_dict_from_jax(params, cfg, prefix="bert.")
    assert set(nested) == {"bert." + k for k in sd}


@pytest.mark.parametrize("L,through_wrapper", [(24, False), (255, False), (260, False),
                                               (256, True), (264, True)])
def test_gate_picks_the_jax_path_and_keeps_the_numbers(L, through_wrapper, monkeypatch):
    """fused requested: L < 256 or L % 8 != 0 takes the written-out product,
    else the wrapper (the plain version for a CPU tensor), with the same
    numbers as the unfused model and the JAX model on either side."""
    _, jmodel, params = _jax_bert(max_position_embeddings=264, num_hidden_layers=1)
    fused = _port_bert(params, fused=True, max_position_embeddings=264, num_hidden_layers=1)
    plain = _port_bert(params, fused=False, max_position_embeddings=264, num_hidden_layers=1)
    calls = []
    real = tattn.fused_attention
    monkeypatch.setattr(tbert, "fused_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    ids, mask = _tokens(2, L, DIMS["vocab_size"], L)
    with torch.inference_mode():
        tattn.launches = 0
        got, _ = fused(torch.from_numpy(ids), torch.from_numpy(mask))
        want, _ = plain(torch.from_numpy(ids), torch.from_numpy(mask))
    assert calls == ([(2, 2, L, 16)] if through_wrapper else [])
    assert tattn.launches == 0  # a CPU tensor never launches
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    jwant, _ = jax.jit(jmodel.apply)({"params": params}, ids, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **F32)


@pytest.mark.parametrize("flag,device,L,want", [
    (None, "cuda", 512, True), (None, "cuda:1", 256, True), (None, "cuda", 264, True),
    (None, "cuda", 128, False), (None, "cuda", 260, False), (None, "cpu", 512, False),
    (True, "cpu", 512, True), (True, "cuda", 248, False), (False, "cuda", 512, False)])
def test_attention_path_follows_the_tensor_not_the_build(flag, device, L, want):
    """The module keeps the tri-state and settles it per call from the
    tensor's device: a model built on the CPU (or on ``meta``) and moved to
    the card takes the kernel there, never the written-out product."""
    layer = tbert.BertSelfAttention(tbert.BertConfig(**DIMS), fused=flag)
    assert layer.takes_kernel(torch.device(device), L) is want


def test_auto_model_on_the_cpu_takes_the_written_out_product(monkeypatch):
    _, _, params = _jax_bert(max_position_embeddings=264, num_hidden_layers=1)
    auto = _port_bert(params, fused=None, max_position_embeddings=264, num_hidden_layers=1)
    plain = _port_bert(params, fused=False, max_position_embeddings=264, num_hidden_layers=1)
    calls = []
    monkeypatch.setattr(tbert, "fused_attention", lambda *a: calls.append(a) or 1 / 0)
    ids, mask = _tokens(2, 256, DIMS["vocab_size"], 3)
    with torch.inference_mode():
        got, _ = auto(torch.from_numpy(ids), torch.from_numpy(mask))
        want, _ = plain(torch.from_numpy(ids), torch.from_numpy(mask))
    assert calls == [] and torch.equal(got, want)


def test_resolve_fused_attention_reads_only_its_arguments():
    assert tbert.resolve_fused_attention(None, "cuda") is True
    assert tbert.resolve_fused_attention(None, torch.device("cuda:1")) is True
    assert tbert.resolve_fused_attention(None, "cpu") is False
    assert tbert.resolve_fused_attention(True, "cpu") is True
    assert tbert.resolve_fused_attention(False, "cuda") is False
    assert tbert.FUSED_ATTENTION_MIN_LEN == jbert.FUSED_ATTENTION_MIN_LEN == 256


def test_seeded_init_is_reproducible_and_remat_is_accepted():
    cfg = tbert.BertConfig(**DIMS)
    a = tbert.BertModel(cfg, remat=True, generator=torch.Generator().manual_seed(5)).state_dict()
    b = tbert.BertModel(cfg, generator=torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert abs(float(a["embeddings.word_embeddings.weight"].std()) - 0.02) < 5e-3
