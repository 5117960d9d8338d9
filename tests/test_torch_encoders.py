# -*- coding: utf-8 -*-
"""The preprocessing encoders of the port against ``drin_tpu.encoders``:
ResNet (tiny bottleneck stacks, two stages) and CLIP (text and vision
towers, projections, the logit scale) on the same numpy inputs, through both
weight routes: the JAX package's flax params through
``*_state_dict_from_jax``, and a tiny HF checkpoint (``transformers``'
own ``ResNetModel`` / ``CLIPModel``, written as an HF-style directory and
as a bare state dict) through both packages' ``load_*``.  Also the CLIP BPE
tokenizer's ids against ``drin_tpu.text.clip_bpe``, over-length texts
included.  Float32, rtol 2e-4."""

import json

import jax
import numpy as np
import pytest
import torch

from drin_tpu.encoders import checkpoints as jckpt
from drin_tpu.encoders import clip as jclip
from drin_tpu.encoders import resnet as jresnet
from drin_tpu.text import clip_bpe as jbpe
from drin_tpu_torch.encoders import checkpoints as tckpt
from drin_tpu_torch.encoders import clip as tclip
from drin_tpu_torch.encoders import resnet as tresnet
from drin_tpu_torch.models.convert import clip_state_dict_from_jax, resnet_state_dict_from_jax
from drin_tpu_torch.text import clip_bpe as tbpe

F32 = dict(rtol=2e-4, atol=1e-5)
RESNETS = {"plain": {},
           "downsample in first stage": dict(downsample_in_first_stage=True),
           "downsample in bottleneck": dict(downsample_in_bottleneck=True)}


def _randomized(params, seed):
    """Every leaf of a flax param tree redrawn from a seed (LayerNorm and
    BatchNorm scales near 1, variances positive), so that no weight sits at
    an initializer's constant."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        shape = np.shape(x)
        if name in ("scale", "var"):
            return (1.0 + 0.2 * rng.uniform(-1, 1, shape)).astype(np.float32)
        if name == "logit_scale":
            return np.asarray(np.log(1 / 0.07), np.float32)
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _resnet_cfg(**kw):
    return jresnet.ResNetConfig(embedding_size=8, hidden_sizes=(12, 16), depths=(2, 1), **kw)


def _torch_resnet_cfg(jc):
    return tresnet.ResNetConfig(jc.embedding_size, jc.hidden_sizes, jc.depths,
                                jc.downsample_in_first_stage, jc.downsample_in_bottleneck)


def _port(model, sd):
    model.load_state_dict(sd)
    return model.eval()


@pytest.mark.parametrize("variant", list(RESNETS))
def test_resnet_matches_jax_through_the_converter(variant):
    """Regions come out row-major over (h, w) of the NHWC map, as the JAX
    stage reshapes them, on a non-square input."""
    jc = _resnet_cfg(**RESNETS[variant])
    x = np.random.default_rng(1).standard_normal((2, 40, 56, 3)).astype(np.float32)
    model = jresnet.ResNetModel(jc)
    params = _randomized(jax.jit(model.init)(jax.random.key(0), x)["params"], seed=2)
    h, pooled = (np.asarray(a) for a in jax.jit(model.apply)({"params": params}, x))
    tc = _torch_resnet_cfg(jc)
    port = _port(tresnet.ResNetModel(tc), resnet_state_dict_from_jax(params, tc))
    with torch.no_grad():
        got_h, got_pooled = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_h.numpy(), h.reshape(h.shape[0], -1, h.shape[-1]), **F32)
    np.testing.assert_allclose(got_pooled.numpy(), pooled, **F32)


def _hf_resnet(seed=3):
    from transformers import ResNetConfig, ResNetModel

    hf_cfg = ResNetConfig(embedding_size=8, hidden_sizes=[12, 16], depths=[2, 1],
                          layer_type="bottleneck", hidden_act="relu")
    torch.manual_seed(seed)
    model = ResNetModel(hf_cfg).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():  # running statistics away from 0 / 1
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(1 + 0.2 * torch.rand(buf.shape, generator=g))
    return hf_cfg, model


def _write_hf(tmp_path, hf_cfg, model, layout):
    if layout == "hf-dir":
        d = tmp_path / "hf"
        d.mkdir()
        torch.save(model.state_dict(), d / "pytorch_model.bin")
        (d / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
        return str(d)
    path = tmp_path / "state_dict.pt"
    torch.save(model.state_dict(), path)
    return str(path)


@pytest.mark.parametrize("layout", ["hf-dir", "bare state dict"])
def test_load_resnet_matches_jax_and_transformers(tmp_path, layout):
    hf_cfg, hf_model = _hf_resnet()
    path = _write_hf(tmp_path, hf_cfg, hf_model, layout)
    jc, jparams = jckpt.load_resnet(path)
    tc, sd = tckpt.load_resnet(path)
    assert (tc.embedding_size, tc.hidden_sizes, tc.depths) == (jc.embedding_size, jc.hidden_sizes,
                                                              jc.depths)
    assert not any("num_batches_tracked" in k for k in sd)
    x = np.random.default_rng(4).standard_normal((2, 64, 48, 3)).astype(np.float32)
    h, pooled = (np.asarray(a) for a in jax.jit(jresnet.ResNetModel(jc).apply)(
        {"params": jparams}, x))
    port = _port(tresnet.ResNetModel(tc), sd)
    with torch.no_grad():
        got_h, got_pooled = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        hf = hf_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_h.numpy(), h.reshape(2, -1, h.shape[-1]), **F32)
    np.testing.assert_allclose(got_pooled.numpy(), pooled, **F32)
    # the NCHW map of transformers' own model, in the same region order
    np.testing.assert_allclose(got_h.numpy(), hf.last_hidden_state.flatten(2).transpose(1, 2),
                               **F32)


def _clip_cfgs(vocab_size=64):
    jc = jclip.CLIPConfig(
        text=jclip.CLIPTextConfig(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                                  num_heads=4, intermediate_size=48, max_position_embeddings=20),
        vision=jclip.CLIPVisionConfig(hidden_size=24, num_layers=2, num_heads=2,
                                      intermediate_size=40, image_size=32, patch_size=8),
        projection_dim=16)
    t, v = jc.text, jc.vision
    tc = tclip.CLIPConfig(
        tclip.CLIPTextConfig(t.vocab_size, t.hidden_size, t.num_layers, t.num_heads,
                             t.intermediate_size, t.max_position_embeddings),
        tclip.CLIPVisionConfig(v.hidden_size, v.num_layers, v.num_heads, v.intermediate_size,
                               v.image_size, v.patch_size), jc.projection_dim)
    return jc, tc


def _clip_inputs(vocab_size, L=20):
    """Token ids whose end token holds the vocabulary's largest id, padded
    with it (so argmax takes the first), of several lengths, and images."""
    rng = np.random.default_rng(5)
    eot = vocab_size - 1
    ids = np.full((4, L), eot, np.int64)
    for i, n in enumerate((3, 9, 17, L - 1)):
        ids[i, 0] = vocab_size - 2  # the start token
        ids[i, 1:n] = rng.integers(0, vocab_size - 2, n - 1)
    pix = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    return ids, pix


def _clip_outputs_jax(jc, params, ids, pix):
    m = jclip.CLIPModel(jc)

    @jax.jit
    def run(v, ids, pix):
        return (m.apply(v, ids, method=m.get_text_features),
                m.apply(v, pix, method=m.get_image_features), m.apply(v, ids, pix)[0])

    return [np.asarray(a) for a in run({"params": params}, ids, pix)]


def _clip_outputs_port(model, ids, pix):
    """Text and image features, and the logits per image as the stage forms
    them: normalized features, products scaled by exp(logit_scale)."""
    with torch.no_grad():
        t = model.get_text_features(torch.from_numpy(ids))
        v = model.get_image_features(torch.from_numpy(pix).permute(0, 3, 1, 2))
        norm = lambda x: x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        per_image = model.logit_scale.exp() * norm(v) @ norm(t).T
        return [a.numpy() for a in (t, v, per_image)]


def test_clip_matches_jax_through_the_converter():
    jc, tc = _clip_cfgs()
    ids, pix = _clip_inputs(jc.text.vocab_size)
    params = jax.jit(jclip.CLIPModel(jc).init)(jax.random.key(0), ids, pix)["params"]
    params = _randomized(params, seed=6)
    want = _clip_outputs_jax(jc, params, ids, pix)
    port = _port(tclip.CLIPModel(tc), clip_state_dict_from_jax(params, tc))
    got = _clip_outputs_port(port, ids, pix)
    for name, g, w in zip(("text", "image", "logits_per_image"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **F32)
    # the text tower pools at argmax(input_ids): the last position would differ
    with torch.no_grad():
        last = port.text_projection(port.text_model.hidden_states(torch.from_numpy(ids))[:, -1])
    assert not np.allclose(last.numpy()[:3], want[0][:3], rtol=1e-2, atol=1e-3)


def _hf_clip(jc, seed=7):
    from transformers import CLIPConfig, CLIPModel

    t, v = jc.text, jc.vision
    hf_cfg = CLIPConfig(
        text_config=dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                         num_hidden_layers=t.num_layers, num_attention_heads=t.num_heads,
                         intermediate_size=t.intermediate_size,
                         max_position_embeddings=t.max_position_embeddings,
                         eos_token_id=2, hidden_act="quick_gelu"),
        vision_config=dict(hidden_size=v.hidden_size, num_hidden_layers=v.num_layers,
                           num_attention_heads=v.num_heads, intermediate_size=v.intermediate_size,
                           image_size=v.image_size, patch_size=v.patch_size,
                           hidden_act="quick_gelu"),
        projection_dim=jc.projection_dim)
    torch.manual_seed(seed)
    model = CLIPModel(hf_cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return hf_cfg, model


@pytest.mark.parametrize("layout", ["hf-dir", "bare state dict"])
def test_load_clip_matches_jax_and_transformers(tmp_path, layout):
    """Without config.json both packages infer 64 dims per head (at least 2
    heads); the tiny towers here have 2 heads of 16 and 12."""
    jc, _ = _clip_cfgs()
    jc.text.num_heads = 2
    hf_cfg, hf_model = _hf_clip(jc)
    path = _write_hf(tmp_path, hf_cfg, hf_model, layout)
    jcfg, jparams = jckpt.load_clip(path)
    tcfg, sd = tckpt.load_clip(path)
    assert vars(tcfg.text) == vars(jcfg.text) and vars(tcfg.vision) == vars(jcfg.vision)
    assert tcfg.projection_dim == jcfg.projection_dim
    ids, pix = _clip_inputs(jc.text.vocab_size)
    want = _clip_outputs_jax(jcfg, jparams, ids, pix)
    got = _clip_outputs_port(_port(tclip.CLIPModel(tcfg), sd), ids, pix)
    for name, g, w in zip(("text", "image", "logits_per_image"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **F32)
    with torch.no_grad():
        hf_text = hf_model.get_text_features(input_ids=torch.from_numpy(ids))
    hf_text = getattr(hf_text, "pooler_output", hf_text)  # newer transformers wrap the tensor
    np.testing.assert_allclose(got[0], hf_text.numpy(), **F32)


def _bpe_assets():
    """A byte-level vocabulary (256 symbols and their word-end forms), merges
    built from the words of the texts, and the two special tokens last."""
    b2u = jbpe.bytes_to_unicode()
    alphabet = sorted(set(b2u.values()))
    vocab = {ch: i for i, ch in enumerate(alphabet)}
    vocab.update({ch + "</w>": len(alphabet) + i for i, ch in enumerate(alphabet)})
    merges = []
    for word in ("the", "thing", "called", "photograph", "bridge", "über", "naïve"):
        parts = ["".join(b2u[b] for b in ch.encode()) for ch in word]
        parts[-1] += "</w>"
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            merges.append(pair)
            vocab.setdefault(pair[0] + pair[1], len(vocab))
            parts = [pair[0] + pair[1]] + parts[2:]
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


BPE_TEXTS = [
    "The thing called a photograph of the Golden Gate Bridge",
    "Über naïve café's 2024 prices: 3.5€ (isn't it?) they'll see",
    "CJK 東京 and 1st-2nd #tags @user <|endoftext|> mixed\tTabs\nnewlines",
    "  ",
    " ".join(["the bridge photograph"] * 40),  # far over 77 tokens
]


@pytest.mark.parametrize("kw", [dict(padding="max_length", truncation=True, max_length=77),
                                dict(padding=True, truncation=True),
                                dict(padding=True, truncation=False),
                                dict(padding="max_length", truncation=True, max_length=20)],
                         ids=["stage", "longest", "no truncation", "cap 20"])
def test_clip_bpe_ids_match_jax(tmp_path, kw):
    vocab, merges = _bpe_assets()
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))
    files = dict(vocab_file=str(tmp_path / "vocab.json"), merges_file=str(tmp_path / "merges.txt"))
    ours, theirs = tbpe.CLIPTokenizer(**files), jbpe.CLIPTokenizer(**files)
    assert ours.bpe_ranks == theirs.bpe_ranks and ours.bpe_ranks
    for text in BPE_TEXTS:
        assert ours.tokenize(text) == theirs.tokenize(text), text
    got, want = ours(BPE_TEXTS, **kw), theirs(BPE_TEXTS, **kw)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    if kw.get("truncation") and kw.get("max_length"):  # the end token survives truncation
        cap = kw["max_length"]
        assert got["input_ids"].shape[1] == cap
        assert got["input_ids"][4, cap - 1] == ours.eos_id == got["input_ids"].max()
