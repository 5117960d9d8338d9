# -*- coding: utf-8 -*-
"""The port's attention layers against the flax modules of
``drin_tpu/nn/layers.py``, same weights (through the converters), float32 at
rtol 2e-4 (the same math in another association order)."""

import jax
import numpy as np
import pytest
import torch

from drin_tpu.nn import layers as jl
from drin_tpu_torch.models import convert
from drin_tpu_torch.nn import layers as tl

F32 = dict(rtol=2e-4, atol=1e-5)


def _seq(rng, B, L, D):
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    lens = rng.integers(1, L + 1, B)
    lens[0] = L
    return x, (np.arange(L)[None] < lens[:, None]).astype(np.int64)


def _init(module, *args):
    # jitted: one compile instead of op-by-op dispatch
    return jax.tree.map(np.asarray, jax.jit(module.init)(jax.random.key(0), *args)["params"])


def _perturb_biases(params, seed):
    """Flax zero-inits the attention biases; random ones exercise them."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
                        if x.ndim == 1 else x, params)


@pytest.mark.parametrize("kdim,vdim", [(None, None), (24, 24), (24, 40)],
                         ids=["packed", "kdim=vdim", "kdim!=vdim"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masked"])
def test_multihead_attention_matches_flax(kdim, vdim, masked):
    rng = np.random.default_rng(0)
    E, H = 32, 2
    q, _ = _seq(rng, 3, 5, E)
    k, kmask = _seq(rng, 3, 7, kdim or E)
    v, _ = _seq(rng, 3, 7, vdim or E)
    kpm = (kmask == 0) if masked else None
    jm = jl.MultiheadAttention(E, H, kdim=kdim, vdim=vdim)
    params = _perturb_biases(_init(jm, q, k, v), 1)
    want = jax.jit(jm.apply)({"params": params}, q, k, v, kpm)
    tm = tl.MultiheadAttention(E, H, kdim=kdim, vdim=vdim).eval()
    sd = {}
    convert._mha(sd, "m", params)
    assert ("m.in_proj_weight" in sd) == (kdim is None)
    tm.load_state_dict({key[2:]: val for key, val in sd.items()})
    with torch.inference_mode():
        got = tm(*map(torch.from_numpy, (q, k, v)), None if kpm is None else torch.from_numpy(kpm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("mask_b", [False, True], ids=["b-unmasked", "b-masked"])
def test_cross_attention_matches_flax(mask_b):
    rng = np.random.default_rng(2)
    a, ma = _seq(rng, 3, 6, 32)
    b, mb = _seq(rng, 3, 4, 24)
    mb = mb if mask_b else None
    jm = jl.CrossAttention(32, 24, 2, 0.0)
    params = _perturb_biases(_init(jm, a, ma, b, mb), 3)
    want = jax.jit(jm.apply)({"params": params}, a, ma, b, mb)
    tm = tl.CrossAttention(32, 24, 2).eval()
    sd = {}
    convert._cross_attention(sd, "c", params)
    tm.load_state_dict({key[2:]: val for key, val in sd.items()})
    with torch.inference_mode():
        got = tm(torch.from_numpy(a), torch.from_numpy(ma), torch.from_numpy(b),
                 None if mb is None else torch.from_numpy(mb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("act", ["gelu", "tanh"])
def test_multimodal_fusion_matches_flax(act):
    from drin_tpu.data.synthetic import tiny_config

    rng = np.random.default_rng(4)
    text, tmask = _seq(rng, 3, 6, 16)
    image = rng.standard_normal((3, 4, 24)).astype(np.float32)
    jm = jl.MultimodalFusion(16, 24, 20, 2, 0.0, act)
    params = _perturb_biases(_init(jm, text, tmask, image), 5)
    want = jax.jit(jm.apply)({"params": params}, text, tmask, image)
    tm = tl.MultimodalFusion(16, 24, 20, 2, act).eval()
    cfg = tiny_config("wikimel", "ghmfc", preprocess_dir="unused").replace(
        mention_final_layer_name="multimodal", mention_multimodal_attention="bi")
    sd = {}
    convert._mention_encoder(sd, "m", {"intermediate_layer": params}, cfg)
    tm.load_state_dict({key[len("m.intermediate_layer."):]: val for key, val in sd.items()})
    with torch.inference_mode():
        got = tm(torch.from_numpy(text), torch.from_numpy(tmask), torch.from_numpy(image))
    assert got.shape == (3, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_attention_init_follows_torch_and_a_seed_fixes_it():
    """Packed in-proj: xavier over [3E, E]; every attention bias zero; the
    same generator seed gives the same weights."""
    E = 32
    a = tl.MultiheadAttention(E, 2, generator=torch.Generator().manual_seed(7))
    b = tl.MultiheadAttention(E, 2, generator=torch.Generator().manual_seed(7))
    ref = torch.nn.MultiheadAttention(E, 2, batch_first=True)
    assert set(a.state_dict()) == set(ref.state_dict())
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert float(a.in_proj_weight.detach().abs().max()) <= (6 / (E + 3 * E)) ** 0.5
    assert not a.in_proj_bias.any() and not a.out_proj.bias.any()
    sep = tl.MultiheadAttention(E, 2, kdim=24, vdim=24)
    ref = torch.nn.MultiheadAttention(E, 2, kdim=24, vdim=24, batch_first=True)
    assert {k: v.shape for k, v in sep.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}


def _transformer_sd(params, num_layers):
    sd = {}
    convert._transformer(sd, "t", params, num_layers)
    return {key[len("t."):]: val for key, val in sd.items()}


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masked"])
def test_transformer_encoder_layer_matches_flax(act, masked):
    rng = np.random.default_rng(6)
    x, mask = _seq(rng, 3, 7, 32)
    kpm = (mask == 0) if masked else None
    jm = jl.TransformerEncoderLayer(32, 4, 48, 0.0, act)
    params = _perturb_biases(_init(jm, x, kpm), 7)
    want = jax.jit(jm.apply)({"params": params}, x, kpm)
    tm = tl.TransformerEncoderLayer(32, 4, 48, 0.0, act).eval()
    sd = _transformer_sd({"layer_0": params}, 1)
    tm.load_state_dict({key[len("transformer.layers.0."):]: val for key, val in sd.items()})
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), None if kpm is None else torch.from_numpy(kpm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_multilayer_transformer_matches_flax_and_a_fully_masked_row_stays_finite():
    """Three layers over a batch with one row whose every key is masked:
    ``finfo.min`` fills its logits, so its attention is uniform, not NaN."""
    rng = np.random.default_rng(8)
    x, mask = _seq(rng, 4, 6, 32)
    mask[3] = 0
    jm = jl.MultilayerTransformer(32, 3, 2, 40, 0.0, "gelu")
    params = _perturb_biases(_init(jm, x, mask), 9)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x, mask))
    tm = tl.MultilayerTransformer(32, 3, 2, 40, 0.0, "gelu").eval()
    sd = _transformer_sd(params, 3)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    for dt in (torch.float32, torch.bfloat16):
        with torch.inference_mode():
            got = tm.to(dt)(torch.from_numpy(x).to(dt), torch.from_numpy(mask)).float().numpy()
        assert np.isfinite(got).all()
        if dt == torch.float32:
            np.testing.assert_allclose(got, want, **F32)


def test_transformer_init_follows_torch_and_dropout_draws_from_the_generator():
    ref = torch.nn.TransformerEncoderLayer(32, 4, 48, batch_first=True)
    tm = tl.TransformerEncoderLayer(32, 4, 48, 0.5, generator=torch.Generator().manual_seed(1))
    assert {k: v.shape for k, v in tm.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    assert not tm.self_attn.out_proj.bias.any()
    x = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(2))
    run = lambda seed: tm(x, None, deterministic=False, rng=torch.Generator().manual_seed(seed))
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    assert not torch.equal(tm(x), run(3))  # eval (deterministic) keeps every unit
