# -*- coding: utf-8 -*-
"""The port's gather+dequant layout and plain version against the JAX
package: the packed bytes are equal, and ``gather_dequant_plain`` is
bit-equal to ``gather_dequant(interpret=True)`` (same f32 multiply, same
rounding).  The CUDA kernel itself is compared on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.data import device_store as jstore
from drin_tpu.ops.pallas import gather as jgather
from drin_tpu_torch.data import device_store as tstore
from drin_tpu_torch.ops.cuda import gather as tgather

N = 300
CHUNKS = ((256, 2), (128, 1), (256, 1))


@pytest.fixture(scope="module")
def packed():
    rng = np.random.default_rng(7)
    qt = [rng.integers(-127, 128, (N, w)).astype(np.int8) for w, _ in CHUNKS]
    sc = [rng.uniform(0.01, 2.0, (N, s)).astype(np.float32) for _, s in CHUNKS]
    return qt, sc


def test_layout_helpers_match_jax(packed):
    qt, sc = packed
    tp, tsc = tgather.pack_quantized_tables(qt, sc)
    jp, jsc = jgather.pack_quantized_tables(qt, sc)
    assert tp.dtype == jp.dtype == np.int8 and tp.shape == jp.shape == (N, 8, 128)
    assert tp.tobytes() == jp.tobytes() and tsc.tobytes() == jsc.tobytes()
    assert tgather._slot_subrows(CHUNKS) == jgather._slot_subrows(CHUNKS)
    for d, ch in ((640, CHUNKS), (704, CHUNKS), (640, ((256, 3), (128, 1), (256, 1))),
                  (5632, ((1536, 2), (2048, 1), (2048, 1)))):
        assert tgather.fused_gather_supported(d, ch) == jgather.fused_gather_supported(d, ch)
    with pytest.raises(AssertionError, match="128-lane"):
        tgather.pack_quantized_tables([qt[0][:, :200]], [np.ones((N, 1), np.float32)])


@pytest.mark.parametrize("rows", [
    np.random.default_rng(1).integers(0, N, (5, 7)).astype(np.int32),
    np.array([[-1, 0, N - 1, N, N + 7, -2 * N, 3, 5]], np.int32),  # wrap once, clamp
    np.array([[2, -3], [N * 4, 1]], np.int64),
    np.array([[2**40, -2**40, -N - 1, 2**31], [-2**31 - 1, -2**63, N - 1, 7]], np.int64),
], ids=["random", "out_of_range", "int64", "int64_beyond_int32"])
def test_plain_bit_equal_to_interpret_kernel(packed, rows):
    """The plain version against the JAX kernel in interpret mode.  Rows
    beyond int32 (the CUDA kernel takes them as they come) do not survive
    JAX's int32 indices: there the JAX kernel reads the rows as
    ``sanitize_rows`` gives them, wrapped once and clamped in numpy."""
    qt, sc = packed
    table, scales = jgather.pack_quantized_tables(qt, sc)
    jrows = rows
    if np.abs(rows.astype(np.float64)).max() >= 2**31:
        jrows = np.clip(np.where(rows < 0, rows + N, rows), 0, N - 1).astype(np.int32)
        np.testing.assert_array_equal(tgather.sanitize_rows(torch.from_numpy(rows), N).numpy(),
                                      jrows.reshape(-1))
    want = jgather.gather_dequant(jnp.asarray(table), jnp.asarray(scales), jnp.asarray(jrows),
                                  CHUNKS, jnp.float32, interpret=True)
    got = tgather.gather_dequant(torch.from_numpy(table), torch.from_numpy(scales),
                                 torch.from_numpy(rows), CHUNKS, torch.float32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # bf16: the same single rounding of the f32 product
    got16 = tgather.gather_dequant_plain(torch.from_numpy(table), torch.from_numpy(scales),
                                         torch.from_numpy(rows), CHUNKS, torch.bfloat16)
    want16 = jgather.gather_dequant(jnp.asarray(table), jnp.asarray(scales), jnp.asarray(jrows),
                                    CHUNKS, jnp.bfloat16, interpret=True)
    for g, w in zip(got16, want16):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("chunks", [CHUNKS, ((1536, 2), (2048, 1), (2048, 1)), ((1536, 2),)],
                         ids=["tiny", "drin", "ghmfc_text"])
def test_output_plan_is_one_buffer_of_aligned_chunk_views(chunks, dtype):
    """The CUDA path's single output buffer: chunk k's view is contiguous,
    ``rows.shape + (width,)``, starts R * 128 * lo_k elements in (where the
    kernel writes it) at a 256-byte-aligned offset, and the views tile the
    buffer; the kernel's layout arguments list m, the chunk count and the
    sub-row spans."""
    shape = (3, 7)
    R = 21
    numel, views = tgather.out_plan(R, chunks)
    spans, m_data, m = tgather._slot_subrows(chunks)
    assert numel == R * m_data * 128
    buf = torch.empty(numel, dtype=dtype)
    outs = tgather.out_views(buf, shape, chunks)
    assert len(outs) == len(views) == len(chunks)
    for o, (w, _), (lo, _hi), (offset, width) in zip(outs, chunks, spans, views):
        assert o.is_contiguous() and tuple(o.shape) == shape + (w,) and width == w
        assert o.storage_offset() == offset == R * 128 * lo
        assert (o.data_ptr() - buf.data_ptr()) % 256 == 0
    assert sum(o.numel() for o in outs) == numel
    pad = ((0, 0),) * (tgather.MAX_CHUNKS - len(spans))
    assert tgather._layout_args(chunks) == (m, len(chunks)) + sum(tuple(spans) + pad, ())


def test_empty_rows_and_non_integer_rows(packed):
    qt, sc = packed
    table, scales = (torch.from_numpy(a) for a in tgather.pack_quantized_tables(qt, sc))
    empty = tgather.gather_dequant(table, scales, torch.zeros((2, 0), dtype=torch.int32),
                                   CHUNKS, torch.float32)
    assert [tuple(e.shape) for e in empty] == [(2, 0, w) for w, _ in CHUNKS]
    for bad in (torch.zeros((2, 3)), torch.zeros((2, 3), dtype=torch.bool)):
        with pytest.raises(TypeError, match="integer"):
            tgather.gather_dequant(table, scales, bad, CHUNKS, torch.float32)
    with pytest.raises(ValueError, match="int8"):  # layout mismatch is refused
        tgather.gather_dequant(table[:, :4], scales, torch.zeros(3, dtype=torch.int32),
                               CHUNKS, torch.float32)


@pytest.mark.parametrize("per_slot", [False, True])
def test_quantize_entity_rows_equal_to_jax(per_slot):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, 2, 12)).astype(np.float32) * rng.uniform(0.1, 10, (9, 2, 1))
    x[3] = 0.0  # zero rows: scale 1
    tq, ts = tstore.quantize_entity_rows(x, per_slot=per_slot)
    jq, js = jstore.quantize_entity_rows(x, per_slot=per_slot)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    deq = tstore._dequantize(torch.from_numpy(tq), torch.from_numpy(ts), torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jstore._dequantize(jnp.asarray(jq), jnp.asarray(js), jnp.float32)))


def test_store_views_match_jax_store(tmp_path):
    """The port's float, int8 and fused stores give the JAX stores' float
    views and feature tuples bit for bit (same quantization, same dequant)."""
    from drin_tpu.data.dataset import MELFeatureDataset, load_wikimel_entity_tables
    from drin_tpu.data.synthetic import make_synthetic_store, tiny_config

    cfg = tiny_config("wikimel", "drin", preprocess_dir=str(tmp_path), bert_embed_dim=128,
                      resnet_embed_dim=128, gcn_embed_dim=128, entity_final_output_dim=128,
                      mention_final_output_dim=128)
    make_synthetic_store(cfg, n_mentions=6, n_entities=40, seed=13)
    tables = load_wikimel_entity_tables(cfg)
    rows_batch = MELFeatureDataset(cfg, "train", tables).drin_rows_batch(np.arange(4))
    feats_np = rows_batch[:-1]
    for quantize, fused in ((False, False), (True, False), (True, True)):
        js = jstore.DeviceEntityStore(cfg, tables, dtype=jnp.float32, quantize=quantize,
                                      fused_gather=fused)
        ts = tstore.DeviceEntityStore(cfg, tables, device="cpu", dtype=torch.float32,
                                      quantize=quantize, fused_gather=fused)
        assert ts.nbytes == js.nbytes
        for name in ("text", "image", "obj"):
            np.testing.assert_array_equal(ts.float_table(name, chunk=16).numpy(),
                                          np.asarray(js.float_table(name, chunk=16)))
        np.testing.assert_array_equal(ts.float_rows("text", 3, 9, slot=1).numpy(),
                                      np.asarray(js.float_rows("text", 3, 9, slot=1)))
        want = js.drin_feats_fn()(tuple(jnp.asarray(x) for x in feats_np))
        got = ts.drin_feats_fn()(tuple(torch.as_tensor(np.asarray(x)) for x in feats_np))
        assert len(got) == len(want) == 14
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(AssertionError, match="quantize"):
        tstore.DeviceEntityStore(cfg, tables, device="cpu", fused_gather=True)
