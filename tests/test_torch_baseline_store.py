# -*- coding: utf-8 -*-
"""The port's device store for the offline baselines against
``drin_tpu.data.device_store``: ``include`` narrows the uploaded tables the
same way, and ``baseline_feats_fn`` rebuilds the same 8-field batch from a
rows batch in the float, int8 and fused layouts, text-only and text+image.
Float32 throughout, so every layout is bit-equal: the fused CPU path runs
``gather_dequant_plain`` against the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.data import device_store as jstore
from drin_tpu.data.synthetic import tiny_config
from drin_tpu.ops.pallas import gather as jgather
from drin_tpu_torch.data import device_store as tstore
from drin_tpu_torch.ops.cuda import gather as tgather

N, B, C = 37, 3, 8


def _cfg():
    return tiny_config("wikimel", "ghmfc", preprocess_dir="unused-baseline-store",
                       bert_embed_dim=128, resnet_embed_dim=128).replace(compute_dtype="float32")


def _tables(cfg, seed=0):
    rng = np.random.default_rng(seed)
    D, Dr, Te = cfg.bert_embed_dim, cfg.resnet_embed_dim, cfg.entity_object_topk
    text = rng.standard_normal((N, 2, D)).astype(np.float32)
    text[:, 1] *= 20  # the CLS slot at another scale: per-slot text scales
    return {"entity_text_feature": text,
            "entity_image_feature": rng.standard_normal((N, 1, Dr)).astype(np.float32),
            "entity_object_feature": rng.standard_normal((N, Te, 1, Dr)).astype(np.float32),
            "entity_object_score": rng.uniform(0, 1, (N, Te)).astype(np.float32)}


def _rows_feats(cfg, seed=1):
    """The five mention fields and [B, C] rows, some out of range (negatives
    wrap once, the rest clamp)."""
    rng = np.random.default_rng(seed)
    L, D = cfg.max_mention_sentence_len, cfg.bert_embed_dim
    rows = rng.integers(0, N, (B, C)).astype(np.int32)
    rows[0, :4] = [-1, -N, N, N + 5]
    return (rng.standard_normal((B, L, D)).astype(np.float32), np.ones((B, L), np.int64),
            np.array([1, 2, 1], np.int64), np.array([3, 4, 2], np.int64),
            rng.standard_normal((B, cfg.resnet_num_region, cfg.resnet_embed_dim)).astype(np.float32),
            rows)


LAYOUTS = {"float": dict(), "int8": dict(quantize=True),
           "fused": dict(quantize=True, fused_gather=True)}
INCLUDES = {"text": ("text",), "text+image": ("text", "image")}


@pytest.mark.parametrize("include", list(INCLUDES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_baseline_feats_fn_matches_jax(layout, include):
    cfg, tables = _cfg(), _tables(_cfg())
    kw, inc = LAYOUTS[layout], INCLUDES[include]
    js = jstore.DeviceEntityStore(cfg, tables, dtype=jnp.float32, include=inc, **kw)
    ts = tstore.DeviceEntityStore(cfg, tables, device="cpu", dtype=torch.float32, include=inc,
                                  **kw)
    assert ts.include == js.include == inc and ts.n_rows == js.n_rows == N
    assert ts.nbytes == js.nbytes
    if layout == "fused":
        assert ts._chunks == js._chunks and ts.packed.numpy().tobytes() == \
            np.asarray(js.packed).tobytes()
    feats = _rows_feats(cfg)
    want = js.baseline_feats_fn()(tuple(jnp.asarray(x) for x in feats))
    tgather.launches = 0
    got = ts.baseline_feats_fn()(tuple(torch.from_numpy(x) for x in feats))
    assert tgather.launches == 0  # CPU tensors: the plain version, no launch
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, (i, tuple(g.shape), w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"field {i}")
    # the text-only store's image slot is a [B, C, 1] placeholder the model never reads
    assert got[7].shape == ((B, C, 1) if include == "text" else (B, C, cfg.resnet_embed_dim))


def test_fused_text_only_rows_equal_the_interpret_kernel():
    """The text-only fused layout (one chunk of two slots) read through the
    port's wrapper is bit-equal to the JAX kernel in interpret mode."""
    cfg, tables = _cfg(), _tables(_cfg(), seed=3)
    ts = tstore.DeviceEntityStore(cfg, tables, device="cpu", quantize=True, fused_gather=True,
                                  include=("text",))
    assert ts._chunks == ((256, 2),) and tuple(ts.packed.shape) == (N, 8, 128)
    rows = _rows_feats(cfg)[5]
    want = jgather.gather_dequant(jnp.asarray(ts.packed.numpy()),
                                  jnp.asarray(ts.packed_scales.numpy()), jnp.asarray(rows),
                                  ts._chunks, jnp.float32, interpret=True)
    got = tgather.gather_dequant(ts.packed, ts.packed_scales, torch.from_numpy(rows),
                                 ts._chunks, torch.float32)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("include,chunks,m", [
    (("text",), ((1536, 2),), 16),
    (("text", "image"), ((1536, 2), (2048, 1)), 32),
    (("text", "image", "obj"), ((1536, 2), (2048, 1), (2048, 1)), 48)])
def test_fused_layouts_at_the_full_widths(include, chunks, m):
    """GHMFC's layouts at the WikiMEL widths (D=768, Dr=2048): a 12-of-16
    sub-row slab text-only, 28 of 32 with the image; DRIN's 44 of 48."""
    cfg = tiny_config("wikimel", "ghmfc", preprocess_dir="unused-baseline-store",
                      bert_embed_dim=768, resnet_embed_dim=2048)
    tables = {k: v[:3] for k, v in _tables(cfg).items()}
    ts = tstore.DeviceEntityStore(cfg, tables, device="cpu", quantize=True, fused_gather=True,
                                  include=include)
    assert ts._chunks == chunks and tuple(ts.packed.shape) == (3, m, 128)
    assert tgather._slot_subrows(chunks) == jgather._slot_subrows(chunks)
    assert tgather._slot_subrows(chunks)[2] == m


def test_include_narrows_the_upload_like_jax():
    cfg, tables = _cfg(), _tables(_cfg())
    for inc in (("image", "text"), ("obj", "text"), ("text", "obj", "image")):
        ts = tstore.DeviceEntityStore(cfg, tables, device="cpu", include=inc)
        js = jstore.DeviceEntityStore(cfg, tables, dtype=jnp.float32, include=inc)
        assert ts.include == js.include  # canonical order
        assert (ts.obj_score is None) == (js.obj_score is None) == ("obj" not in inc)
        assert (ts.image is None) == ("image" not in inc) and ts.nbytes == js.nbytes
        assert len(ts._tables()) == len(js._tables())
    with pytest.raises(AssertionError, match="text"):
        tstore.DeviceEntityStore(cfg, tables, device="cpu", include=("image",))


def test_layouts_each_feats_fn_refuses():
    cfg, tables = _cfg(), _tables(_cfg())
    text_only = tstore.DeviceEntityStore(cfg, tables, device="cpu", include=("text",))
    with pytest.raises(AssertionError, match="baseline layout"):
        text_only.drin_feats_fn()
    full_fused = tstore.DeviceEntityStore(cfg, tables, device="cpu", quantize=True,
                                          fused_gather=True)
    with pytest.raises(AssertionError, match="object chunk"):
        full_fused.baseline_feats_fn()
    # a full float store serves both kinds
    full = tstore.DeviceEntityStore(cfg, tables, device="cpu")
    full.drin_feats_fn()
    got = full.baseline_feats_fn()(tuple(torch.from_numpy(x) for x in _rows_feats(cfg)))
    assert got[7].shape == (B, C, cfg.resnet_embed_dim)


def test_baseline_rows_batch_fields_equal_jax():
    assert tstore.BaselineRowsBatch._fields == jstore.BaselineRowsBatch._fields
    assert tstore.include_for("ghmfc") == jstore.include_for("ghmfc") == ("text",)
    assert tstore.include_for("drin") == jstore.include_for("drin")
