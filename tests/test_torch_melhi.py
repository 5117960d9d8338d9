# -*- coding: utf-8 -*-
"""The port's MELHI and its LSTM against ``drin_tpu.models.melhi`` and
``drin_tpu.nn.layers.LSTM``, same weights (``melhi_state_dict_from_jax``)
and the same numpy inputs, float32 at rtol 2e-4 (the same math in another
association order).  The cases cover the image gate open, closed and
mixed, padded candidates, and empty left or right contexts.  The LSTM is
also held against ``torch.nn.LSTM`` over packed sequences."""

import jax
import numpy as np
import pytest
import torch

from drin_tpu.data.synthetic import tiny_config
from drin_tpu.models.melhi import MELHI as JaxMELHI
from drin_tpu.models.torch_import import melhi_params_from_torch
from drin_tpu.nn.layers import LSTM as JaxLSTM
from drin_tpu_torch.models import get_model
from drin_tpu_torch.models.convert import melhi_state_dict_from_jax
from drin_tpu_torch.models.melhi import MELHI
from drin_tpu_torch.nn.layers import LSTM

F32 = dict(rtol=2e-4, atol=1e-5)


def _lstm_sd(p):
    return {"weight_ih_l0": torch.from_numpy(np.asarray(p["w_ih"]).T.copy()),
            "weight_hh_l0": torch.from_numpy(np.asarray(p["w_hh"]).T.copy()),
            "bias_ih_l0": torch.from_numpy(np.asarray(p["b_ih"]).copy()),
            "bias_hh_l0": torch.from_numpy(np.asarray(p["b_hh"]).copy())}


def _lstm_case(seed=0, B=5, L=9, In=5, H=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, In)).astype(np.float32)
    lengths = np.array([L, 1, 4, 7, 2][:B], np.int64)
    jm = JaxLSTM(H)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed), x, lengths)["params"])
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x, lengths))
    tm = LSTM(In, H)
    tm.load_state_dict(_lstm_sd(params))
    return x, lengths, tm, want


def test_lstm_matches_flax_and_sees_its_planted_faults():
    x, lengths, tm, want = _lstm_case()
    tx, tlen = torch.from_numpy(x), torch.from_numpy(lengths)
    with torch.inference_mode():
        got = tm(tx, tlen).numpy()
        off_by_one = tm(tx, tlen - 1).numpy()  # the state one step before the last valid one
        sd = tm.state_dict()
        H = tm.hidden
        swap = lambda w: torch.cat([w[H:2 * H], w[:H], w[2 * H:]])  # i and f gates swapped
        tm.load_state_dict({k: swap(v) for k, v in sd.items()})
        swapped = tm(tx, tlen).numpy()
    assert got.shape == want.shape == (5, 6)
    np.testing.assert_allclose(got, want, **F32)
    for fault in (off_by_one, swapped):
        assert np.abs(fault - want).max() > 100 * (F32["atol"] + F32["rtol"] * np.abs(want).max())


def test_lstm_equals_torch_nn_lstm_over_packed_sequences():
    """The parameter names and the numerics are ``torch.nn.LSTM``'s: the same
    state_dict gives the final state of each packed sequence."""
    x, lengths, tm, _ = _lstm_case(seed=1)
    ref = torch.nn.LSTM(5, 6, batch_first=True)
    ref.load_state_dict(tm.state_dict())
    packed = torch.nn.utils.rnn.pack_padded_sequence(torch.from_numpy(x), torch.from_numpy(lengths),
                                                     batch_first=True, enforce_sorted=False)
    with torch.inference_mode():
        _, (h_n, _) = ref(packed)
        got = tm(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), h_n[0].numpy(), rtol=1e-5, atol=1e-6)


def test_lstm_keeps_the_input_dtype_and_a_seed_fixes_its_init():
    a = LSTM(4, 3, torch.Generator().manual_seed(5))
    b = LSTM(4, 3, torch.Generator().manual_seed(5))
    ref = torch.nn.LSTM(4, 3)
    assert {k: v.shape for k, v in a.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())
    assert float(a.weight_hh_l0.detach().abs().max()) <= 3 ** -0.5
    out = a.to(torch.bfloat16)(torch.ones(2, 3, 4, dtype=torch.bfloat16), torch.tensor([3, 1]))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3)


# ------------------------------------------------------------------- MELHI


def _cfg(**kw):
    return tiny_config("wikidiverse", "melhi", preprocess_dir="unused-melhi", **kw).replace(
        compute_dtype="float32")


def melhi_batch(cfg, B, seed, pad_candidates=0):
    """Numpy baseline-batch features (answer stripped) with the mention
    span's context empty on the left for row 0 (start = 1) and on the right
    for row 1 (end = the sentence's length)."""
    rng = np.random.default_rng(seed)
    C, D, L = cfg.num_candidates_model + pad_candidates, cfg.bert_embed_dim, \
        cfg.max_mention_sentence_len
    lens = rng.integers(5, L + 1, B)
    start = rng.integers(1, 3, B)
    end = np.minimum(start + rng.integers(1, 3, B), lens)
    start[0], end[1] = 1, lens[1]
    entity = rng.standard_normal((B, C, D)).astype(np.float32)
    entity_image = rng.standard_normal((B, C, cfg.resnet_embed_dim)).astype(np.float32)
    if pad_candidates:  # candidate padding: zero rows past the model's candidates
        entity[:, -pad_candidates:] = entity_image[:, -pad_candidates:] = 0
    return (rng.standard_normal((B, L, D)).astype(np.float32),
            (np.arange(L)[None] < lens[:, None]).astype(np.int64),
            start.astype(np.int64), end.astype(np.int64),
            rng.standard_normal((B, cfg.resnet_num_region, cfg.resnet_embed_dim)).astype(np.float32),
            entity, np.zeros((B,), np.int64), entity_image)


def _tensors(batch):
    return tuple(torch.from_numpy(np.asarray(x)) for x in batch)


def _pair(cfg, batch, seed=0):
    jmodel = JaxMELHI(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed), batch)["params"])
    model, kind = get_model(cfg)
    assert isinstance(model, MELHI) and kind == "baseline"
    sd = melhi_state_dict_from_jax(params)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    return jmodel, params, model.eval()


GATES = {"open": (-2.0, -2.0), "closed": (2.0, 2.0), "tmim-closed": (2.0, -2.0),
         "imie-closed": (-2.0, 2.0), "mixed": None}


@pytest.mark.parametrize("name", list(GATES))
def test_melhi_matches_flax(name):
    cfg = _cfg()
    batch = melhi_batch(cfg, 6, 3)
    if GATES[name] is None:  # thresholds at the batch's own medians: both gate states
        probe = _pair(cfg, batch)[2]
        with torch.inference_mode():
            sim_tmim, sim_imie, _ = probe.similarities(*(_tensors(batch)[i] for i in (0, 4, 7)))
        cfg = cfg.replace(thres_tmim=float(sim_tmim.median()) - 1e-4,
                          thres_imie=float(sim_imie.amax(-1).median()) - 1e-4)
    else:
        cfg = cfg.replace(thres_tmim=GATES[name][0], thres_imie=GATES[name][1])
    jmodel, params, model = _pair(cfg, batch)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, batch))
    with torch.inference_mode():
        got = model(_tensors(batch)).numpy()
        gate = model.gates(_tensors(batch)).numpy()
    expect = {"open": [True], "closed": [False], "tmim-closed": [False], "imie-closed": [False],
              "mixed": [False, True]}[name]
    assert sorted(set(gate.tolist())) == expect, gate
    assert got.shape == want.shape == (6, cfg.num_candidates_model)
    np.testing.assert_allclose(got, want, **F32)


def test_melhi_empty_contexts_run_one_zero_step():
    """Row 0 has no left context, row 1 no right one, row 2 neither: each
    empty side is the LSTM's state after one all-zero step, as in JAX."""
    cfg = _cfg(thres_tmim=-2.0, thres_imie=-2.0)
    batch = list(melhi_batch(cfg, 3, 4))
    batch[2][2], batch[3][2] = 1, batch[1][2].sum()  # row 2: the span covers tokens 1 .. len
    batch = tuple(batch)
    jmodel, params, model = _pair(cfg, batch, seed=2)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, batch))
    feats = _tensors(batch)
    enc = model.mention_encoder
    D3 = 3 * cfg.bert_embed_dim
    with torch.inference_mode():
        got = model(feats).numpy()
        zero_step = enc.mention_lstm(torch.zeros(1, 1, D3), torch.ones(1, dtype=torch.int64))
        both_empty = enc.mention_final_map(torch.cat([zero_step, zero_step], -1))[0]
        # any token features: row 2 reads none of them
        mention = enc(torch.randn(3, cfg.max_mention_sentence_len, D3), *feats[1:4])
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(mention[2].numpy(), both_empty.numpy(), rtol=1e-6, atol=1e-7)


def test_padded_candidates_never_open_the_gate():
    """Zero-padded fake candidates (cosine 0) sit above a negative
    ``thres_imie``; masked to -inf, they leave the gate closed when every
    real candidate's image points away from the mention's."""
    cfg = _cfg(thres_tmim=-2.0, thres_imie=-0.05)
    batch = list(melhi_batch(cfg, 4, 5, pad_candidates=2))
    C = cfg.num_candidates_model
    batch[7][:, :C] = -batch[4].mean(1)[:, None, :]  # real candidates: cosine -1
    batch = tuple(batch)
    jmodel, params, model = _pair(cfg, batch)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, batch))
    with torch.inference_mode():
        got = model(_tensors(batch)).numpy()
        gate = model.gates(_tensors(batch))
    assert not gate.any()
    assert got.shape == want.shape == (4, C)
    np.testing.assert_allclose(got, want, **F32)


def test_port_state_dict_round_trips_into_jax():
    """port ``state_dict()`` -> ``melhi_params_from_torch`` -> JAX apply gives
    the port's scores: the port's names are the upstream torch names."""
    cfg = _cfg()
    batch = melhi_batch(cfg, 4, 6)
    model, _ = get_model(cfg, torch.Generator().manual_seed(3))
    params = melhi_params_from_torch({k: v.numpy() for k, v in model.state_dict().items()})
    want = np.asarray(jax.jit(JaxMELHI(cfg).apply)({"params": params}, batch))
    with torch.inference_mode():
        got = model.eval()(_tensors(batch)).numpy()
    np.testing.assert_allclose(got, want, **F32)


def test_melhi_is_wikidiverse_only():
    with pytest.raises(NotImplementedError, match="wikidiverse"):
        get_model(tiny_config("wikimel", "melhi", preprocess_dir="unused-melhi"))
