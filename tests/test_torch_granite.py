# -*- coding: utf-8 -*-
"""granite-4.0-h-micro as GHMFC's online text tower
(``encoders/granite_hybrid.py``): its settings as published, the tower
against the benchmark's plain reference (``portbench/reference/
granite_hybrid.py``) at a tiny size with both kinds of layer, GQA grouping
and the published multipliers, GHMFC with the tower served through
``Ranker`` against ``reference/ghmfc_granite.py``, and the check of the
benchmark's cell seeing each planted fault.

Tolerance: float32 at 1e-5 relative to the largest hidden state (the same
mathematics: the scan chunked against its quadratic form, another order of
sums)."""

import json
import os

import pytest
import torch

from drin_tpu_torch.encoders import granite_hybrid as gh
from portbench import harness, inputs
from portbench.tests.test_portbench_granite import FAULTS, plant

ROOT = os.path.dirname(harness.PKG)
CELL = "ghmfc-granite-rank-b8"
REF = harness.load_file_module("reference", "granite_hybrid")


def _tiny(**over):
    """A tiny tower with the published multipliers and both kinds of layer."""
    d = dict(vocab_size=300, hidden_size=64, num_hidden_layers=4,
             layer_types=["mamba", "attention", "mamba", "attention"],
             shared_intermediate_size=96, num_attention_heads=8, num_key_value_heads=2,
             mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=8,
             attention_multiplier=0.015625, embedding_multiplier=12, residual_multiplier=0.22,
             rms_norm_eps=1e-5, mamba_d_conv=4, mamba_expand=2)
    d.update(over)
    return d


def _weights(d, seed=0):
    w = inputs.make_weights(REF.param_shapes(d, ""), torch.Generator().manual_seed(seed), "cpu")
    REF.init_ssm(w, d, "")
    return w


def test_the_defaults_are_the_published_config():
    """``GraniteHybridConfig()`` is granite-4.0-h-micro as the benchmark's
    configuration file holds it (the catalog's config.json keys)."""
    path = os.path.join(ROOT, "portbench", "configs", "ghmfc-granite-h-micro-wikimel.json")
    with open(path) as f:
        published = json.load(f)
    cfg, from_file = gh.GraniteHybridConfig(), gh.GraniteHybridConfig.from_dict(published)
    assert vars(cfg) == vars(from_file)
    assert cfg.num_hidden_layers == 40 and cfg.hidden_size == 2048 and cfg.vocab_size == 100352
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] == [5, 15, 25, 35]
    assert (cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state, cfg.mamba_chunk_size) == \
        (64, 64, 128, 256)
    assert (cfg.num_attention_heads, cfg.num_key_value_heads) == (32, 8)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier, cfg.attention_multiplier) == \
        (12, 0.22, 0.015625)


@pytest.mark.parametrize("over,match", [
    (dict(num_local_experts=4), "num_local_experts"), (dict(mamba_n_groups=2), "one group"),
    (dict(position_embedding_type="rope"), "no positions"), (dict(attention_bias=True), "bias"),
    (dict(layer_types=["mamba"] * 3), "layer_types"), (dict(mamba_expand=1), "mamba_expand")])
def test_settings_the_tower_does_not_take_are_refused(over, match):
    with pytest.raises(ValueError, match=match):
        gh.GraniteHybridConfig(**_tiny(**over))


@pytest.mark.parametrize("heads", [(8, 2), (4, 4), (8, 1)], ids=["gqa4", "mha", "mqa"])
@pytest.mark.parametrize("L", [5, 8, 29])
def test_the_tower_matches_the_reference(heads, L):
    """Token states of right-padded sequences of L tokens (the scan's chunk of
    8 crossed at 29), the key heads shared by 4, 1 and 8 query heads."""
    d = _tiny(num_attention_heads=heads[0], num_key_value_heads=heads[1])
    w = _weights(d, seed=L)
    model = gh.GraniteHybridModel(gh.GraniteHybridConfig(**d))
    model.load_state_dict(w)
    ids = torch.randint(1, d["vocab_size"], (3, L), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, pooled = model(ids, torch.ones_like(ids))
        want = REF.tower(w, d, ids, prefix="")
    assert pooled is None and got.shape == (3, L, 64)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


def test_causal_attention_in_blocks_of_sequences():
    g = torch.Generator().manual_seed(2)
    q, k, v = torch.randn(5, 2, 3 * 7, 4, generator=g), torch.randn(5, 2, 7, 4, generator=g), \
        torch.randn(5, 2, 7, 4, generator=g)
    whole = gh.causal_attention(q, k, v)
    torch.testing.assert_close(gh.causal_attention(q, k, v, block_elems=2 * 21 * 7 * 2), whole,
                               rtol=0, atol=0)
    # a query at position t reads keys 0..t only: a later key changed moves nothing before it
    k2 = k.clone()
    k2[:, :, 4] += 1.0
    moved = (gh.causal_attention(q, k2, v) - whole).abs().view(5, 2, 3, 7, 4).amax((0, 1, 2, 4))
    assert torch.all(moved[:4] == 0) and torch.all(moved[4:] > 0)


def _run(seed=3_000_000_017):
    return harness.Run(harness.Bench(ROOT), CELL, seed, 0.3, False, True, False,
                       torch.device("cpu"))


def test_ghmfc_with_the_tower_matches_the_reference():
    """The served scores of ``Ranker.score`` (the rank path's entry point) on
    the cell's rehearsal requests against the reference's, float32; the port
    model's parameters are the reference's, under the upstream keys."""
    from drin_tpu_torch.models import get_model
    from drin_tpu_torch.serve import Ranker

    run = _run()
    sysm = run.system
    with torch.device("meta"):
        model, kind = get_model(sysm.port_config(run.config),
                                bert_cfg=sysm.tower_config(run.config))
    shapes = {k: tuple(s) for k, (s, _) in run.reference.param_shapes(run.config).items()}
    assert kind == "online" and {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    assert any(k.startswith("model.layers.1.self_attn.") for k in shapes)
    data = sysm.make_data(run)
    pool = sysm.request_pool(run, data, 2, run.cell["batch"])
    ranker = sysm.build_ranker(run, data)
    assert isinstance(ranker, Ranker) and ranker.model._tower == "model"
    for feats in pool:
        got = ranker.score(feats)
        want = sysm.reference_scores(run, data, feats)
        assert got.shape == want.shape == (run.cell["batch"], 7)
        assert abs(got - want).max() <= 1e-5


def test_finetune_bert_is_refused_with_the_tower():
    from drin_tpu_torch.models import get_model

    run = _run()
    cfg = run.system.port_config(run.config).replace(finetune_bert=True)
    with pytest.raises(ValueError, match="forward only"):
        get_model(cfg, bert_cfg=run.system.tower_config(run.config))


# -- the check sees each planted fault ----------------------------------------
@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_the_check_sees_each_planted_fault(monkeypatch, fault):
    """The cell's check at the rehearsal's sizes: ``correct`` with the port as
    it is, not with the scan's state left in its chunk, ``D * x`` left out or
    the attention reading later keys (``portbench/tests/test_portbench_granite.py``
    plants the same faults at the cell's own sizes on the card)."""
    if fault is not None:
        plant(monkeypatch, fault)
    run = _run(3_000_000_029)
    result, checks = harness.execute(run, run.bench.module("drivers", "closed_rank"),
                                     harness.now())
    assert result["correct"] is (fault is None), checks
