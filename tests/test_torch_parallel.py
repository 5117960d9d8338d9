# -*- coding: utf-8 -*-
"""The port's mesh layer (``drin_tpu_torch/parallel``) without a process
group, against ``drin_tpu.parallel``: the numpy helpers bit for bit, the
mesh sizes with ``-1`` and the idle-rank line, each rank's rows of the
global batch against the JAX sharding's on a (4, 2) mesh of the 8 virtual
CPU devices, and the hybrid layout against ``make_hybrid_mesh``'s device
order on host lists of uneven sizes."""

import warnings

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from drin_tpu.data.device_store import DrinRowsBatch as JaxRowsBatch
from drin_tpu.parallel import mesh as jmesh
from drin_tpu_torch.common.config import make_config
from drin_tpu_torch.parallel import mesh as tmesh
from drin_tpu_torch.parallel.distributed import process_row_range


def _rows_batch(rng, B, C):
    shapes = {"mention_text_feature": (B, 5, 4), "mention_text_mask": (B, 5),
              "mention_start_pos": (B,), "mention_end_pos": (B,),
              "mention_image_feature": (B, 3, 4), "mention_object_feature": (B, 2, 4),
              "mention_object_score": (B, 2), "entity_rows": (B, C),
              "miet_similarity": (B, C), "mtei_similarity": (B, C), "answer": (B, C - 1)}
    return JaxRowsBatch(**{k: (rng.integers(0, 50, s) if k == "entity_rows"
                               else rng.standard_normal(s).astype(np.float32))
                           for k, s in shapes.items()})


@pytest.mark.parametrize("C,nm", [(101, 2), (101, 4), (7, 1), (8, 4)])
def test_candidate_padding_equals_jax(C, nm):
    rng = np.random.default_rng(C * 10 + nm)
    batch = _rows_batch(rng, 6, C)
    cp = tmesh.padded_candidate_count(C, nm)
    assert cp == jmesh.padded_candidate_count(C, nm) and cp % nm == 0 and cp >= C
    got = tmesh.pad_candidates_to(batch, batch._fields, C, cp)
    want = jmesh.pad_candidates_to(batch, batch._fields, C, cp)
    assert type(got) is type(want)
    for name, g, w in zip(batch._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    plain = tuple(batch)  # a plain tuple stays a tuple
    assert type(tmesh.pad_candidates_to(plain, batch._fields, C, cp)) is tuple


@pytest.mark.parametrize("b,n", [(3, 8), (8, 8), (1, 4)])
def test_batch_padding_equals_jax(b, n):
    batch = _rows_batch(np.random.default_rng(b + n), b, 5)
    got, gv = tmesh.pad_batch_to(batch, n)
    want, wv = jmesh.pad_batch_to(batch, n)
    np.testing.assert_array_equal(gv, wv)
    for name, g, w in zip(batch._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_make_mesh_sizes_and_idle_line(capsys):
    cfg = make_config("drin", "wikimel", mesh_data=-1, mesh_model=2)
    m = tmesh.make_mesh(cfg, world_size=8, rank=5)
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert (m.data_index, m.model_index) == (2, 1) and m.active and not m.main
    assert m.ranks.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert m.data_order == [0, 1, 2, 3]
    assert capsys.readouterr().err == ""
    # a mesh that does not cover the world says so, and its other ranks idle
    m = tmesh.make_mesh(data=-1, model=3, world_size=8, rank=7)
    assert m.shape == {"data": 2, "model": 3} and not m.active
    assert "using 6 of 8 ranks (2 idle" in capsys.readouterr().err
    assert tmesh.make_mesh(world_size=1).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="data=2 x model=2 needs 4 ranks"):
        tmesh.make_mesh(data=2, model=2, world_size=2)
    # the same sizes as the JAX mesh over as many devices
    j = jmesh.make_mesh(devices=jax.devices()[:8], data=-1, model=2)
    assert dict(j.shape) == tmesh.make_mesh(data=-1, model=2, world_size=8).shape


def test_process_row_range_matches_jax_rank_for_rank():
    B = 16
    jm = jmesh.make_mesh(devices=jax.devices()[:8], data=4, model=2)
    rows = NamedSharding(jm, P("data")).devices_indices_map((B,))
    for rank in range(8):
        m = tmesh.make_mesh(data=4, model=2, world_size=8, rank=rank)
        device = jm.devices[m.data_index, m.model_index]
        s = rows[device][0]
        assert process_row_range(m, B) == (s.start or 0, B if s.stop is None else s.stop), rank
    assert process_row_range(None, B) == (0, B)
    with pytest.raises(ValueError, match="does not split evenly"):
        process_row_range(tmesh.make_mesh(data=3, model=1, world_size=3), 16)


@pytest.mark.parametrize("sizes,model,data", [([4, 4], 2, None), ([3, 3, 2], 1, None),
                                              ([4, 4], 2, 2), ([2, 3], 1, None),
                                              ([4, 3], 1, 4)])
def test_hybrid_layout_matches_jax_device_order(sizes, model, data):
    """Fake host lists of the 8 virtual devices: the port's grid holds the
    ranks where JAX's holds the devices of the same ids."""
    devices = jax.devices()[:sum(sizes)]
    starts = np.cumsum([0] + sizes)
    slices = [devices[a:b] for a, b in zip(starts[:-1], starts[1:])]
    ranks = [[d.id for d in s] for s in slices]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jmesh.make_hybrid_mesh(slices, model=model, data=data)
        got = tmesh.hybrid_layout(ranks, model=model, data=data, main=False)
    assert got.tolist() == [[d.id for d in row] for row in want.devices]
    assert got.shape == (want.shape["data"], want.shape["model"])


def test_hybrid_layout_refuses_a_half_idle_layout_and_warns():
    # a host of 6 and one of 2 at model=2: 4 of 8 used, refused by both
    with pytest.raises(ValueError, match="over half the ranks would sit idle"):
        tmesh.hybrid_layout([[0, 1, 2, 3, 4, 5], [6, 7]], model=2)
    with pytest.raises(ValueError, match="idle"):
        jmesh.make_hybrid_mesh([jax.devices()[:6], jax.devices()[6:8]], model=2)
    with pytest.warns(UserWarning, match="1/7 rank"):
        grid = tmesh.hybrid_layout([[0, 1, 2, 3], [4, 5, 6]], model=1, main=False)
    assert grid.tolist() == [[0], [1], [2], [4], [5], [6]]
    with pytest.raises(ValueError, match="must divide over 2 hosts"):
        tmesh.hybrid_layout([[0, 1], [2, 3]], model=1, data=3)


def test_group_by_host():
    assert tmesh.group_by_host(["a", "b", "a", "b"]) == [[0, 2], [1, 3]]
    assert tmesh.group_by_host(local_world_size=2, world_size=5) == [[0, 1], [2, 3], [4]]
    assert tmesh.group_by_host(world_size=1) == [[0]]
    # ranks grouped by host name lie in a column in data order, whatever
    # their global ranks: the gathers follow data_order
    m = tmesh.Mesh(tmesh.hybrid_layout([[0, 2], [1, 3]], model=1, main=False), rank=2)
    assert m.ranks[:, 0].tolist() == [0, 2, 1, 3] and m.data_index == 1
    assert m.data_order == [0, 2, 1, 3]


def _layout_batch(rng, layout, B=3, C=12, S=4, E=3):
    """A host batch of one baseline layout, its entity placeholders included."""
    from drin_tpu_torch.data.dataset import BaselineBatch
    from drin_tpu_torch.data.device_store import BaselineRowsBatch
    from drin_tpu_torch.data.online import OnlineBatch

    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    i = lambda *s: rng.integers(0, 9, s)
    mention = (f(B, 5, 4), i(B, 5), i(B), i(B), f(B, 3, 6))
    answer = f(B, C - 1)
    if layout == "rows":
        return BaselineRowsBatch(*mention, i(B, C), answer)
    if layout.startswith("online"):
        if layout == "online-zipped":  # dim 1 is S, the zipped sentences
            entity = (i(B, S, 16), i(B, S, 16), i(B, S, E), np.zeros((B,), np.float32))
        else:  # direct: [B] placeholders for the separators and the image
            entity = (i(B, C, 7), i(B, C, 7), np.zeros((B,), np.int64), np.zeros((B,), np.float32))
        return OnlineBatch(*((i(B, 9), i(B, 9), i(B), i(B), f(B, 3, 6)) + entity + (answer,)))
    text, mask = {"pooled": (f(B, C, 2, 4), i(B)), "tokens": (f(B, C, 7, 4), i(B, C, 7)),
                  "wikidiverse": (f(B, C, 4), i(B))}[layout.split("+")[0]]
    image = f(B, C, 1) if layout.endswith("+placeholder") else f(B, C, 6)
    return BaselineBatch(*mention, text, mask, image, answer)


@pytest.mark.parametrize("layout", ["pooled", "tokens", "wikidiverse", "pooled+placeholder",
                                    "rows", "online-direct", "online-zipped"])
@pytest.mark.parametrize("nm", [2, 4])
def test_slice_candidates_on_baseline_layouts_equals_jax_specs(layout, nm):
    """``slice_candidates`` on every baseline layout keeps each rank's block
    of dim 1 of exactly the fields that ``drin_tpu``'s ``batch_specs``
    shards over the model axis: C of GHMFC's and MELHI's entity tensors (a
    [B, C, 1] image placeholder too) and of the online direct mode, S of the
    zipped mode; a [B] placeholder (a pooled store's mask, direct mode's
    separators, the online image) passes whole, and so does a rows batch,
    whose store gathers the block."""
    batch = _layout_batch(np.random.default_rng(nm), layout)
    fields = type(batch)._fields
    mesh = jmesh.make_mesh(devices=jax.devices()[:nm], data=1, model=nm)
    specs = jmesh.batch_specs(mesh, fields, batch)
    for index in range(nm):
        got = tmesh.slice_candidates(batch, fields, tmesh.CandidateSplit(None, index, nm, None))
        assert type(got) is type(batch)
        for name, x, g, spec in zip(fields, batch, got, specs):
            if layout != "rows" and spec == P("data", "model"):
                lo, hi = index * x.shape[1] // nm, (index + 1) * x.shape[1] // nm
                np.testing.assert_array_equal(g, x[:, lo:hi], err_msg=name)
            else:
                np.testing.assert_array_equal(g, x, err_msg=name)
    sliced = {name for name, spec in zip(fields, specs) if spec == P("data", "model")}
    want = {"pooled": {"entity_text_feature", "entity_image_feature"},
            "tokens": {"entity_text_feature", "entity_text_mask", "entity_image_feature"},
            "online-direct": {"entity_ids", "entity_mask"},
            "online-zipped": {"entity_ids", "entity_mask", "entity_sep_idx"}, "rows": set()}
    want["wikidiverse"] = want["pooled+placeholder"] = want["pooled"]
    assert sliced == want[layout]
