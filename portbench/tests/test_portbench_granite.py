"""The granite cell (``ghmfc-granite-rank-b8``): its plain reference against
the port at the rehearsal's tiny sizes, the scan's operation and byte counts
at a shape worked by hand, the benchmark's validation, and the check seeing
each planted fault at the cell's own sizes, with a CUDA device (``python -m
pytest portbench/tests/test_portbench_granite.py`` on the card)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import counts_granite, harness

ROOT = os.path.dirname(harness.PKG)
CELL = "ghmfc-granite-rank-b8"


def _run(seed=3_000_000_019, rehearse=True, device="cpu", seconds=0.3):
    return harness.Run(harness.Bench(ROOT), CELL, seed, seconds, False, rehearse, False,
                       torch.device(device))


def test_reference_weights_and_scores_are_the_ports():
    """The reference's tensors are the port model's, under the same names,
    and its scores of the rehearsal's requests the served ones, float32."""
    from drin_tpu_torch.models import get_model

    run = _run()
    sysm = run.system
    with torch.device("meta"):
        model, _ = get_model(sysm.port_config(run.config), bert_cfg=sysm.tower_config(run.config))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(s) for k, (s, _) in run.reference.param_shapes(run.config).items()} == want
    data = sysm.make_data(run)
    ranker = sysm.build_ranker(run, data)
    for feats in sysm.request_pool(run, data, 2, run.cell["batch"]):
        np.testing.assert_allclose(ranker.score(feats), sysm.reference_scores(run, data, feats),
                                   rtol=0, atol=1e-5)


def test_the_scan_counts_at_a_shape_worked_by_hand():
    """H = 2 heads of P = 4, a state of 8, chunks of 4, one sequence of 6
    tokens: chunks of 4 and 2.  Inside: 4·5/2 + 2·3/2 = 13 causal pairs, the
    scores 2·13·8 = 208 and their sums over x 2·(2·13·4) = 208; the carried
    state's term in the second chunk 2·(2·2·8·4) = 256; the update after the
    first 2·(2·4·4·8) = 512: 1,184 operations.  Bytes: 6 tokens of x (16 B),
    B and C (32 B) and dt (8 B), A and D (16 B), y (16 B a token): 448."""
    cfg = {"mamba_n_heads": 2, "mamba_d_head": 4, "mamba_d_state": 8, "mamba_chunk_size": 4}
    assert counts_granite.ssd_flops(cfg, 1, 6) == 1184
    assert counts_granite.ssd_bytes(cfg, 1, 6) == 448
    # the cell's entity pass [32, 896] at the published widths
    big = {"mamba_n_heads": 64, "mamba_d_head": 64, "mamba_d_state": 128, "mamba_chunk_size": 256}
    assert counts_granite.ssd_flops(big, 32, 896) / 1e9 == pytest.approx(76.2, abs=0.05)
    assert counts_granite.ssd_bytes(big, 32, 896) / 1e6 == pytest.approx(491.8, abs=0.05)
    with open(os.path.join(harness.PKG, "peaks.json")) as f:
        bound = counts_granite.ssd_bound_s(big, 32, 896, json.load(f))
    assert bound * 1e3 == pytest.approx(0.1468, abs=5e-5)  # the bytes bound it


def test_the_model_flops_of_a_call():
    """A call of 8 mentions at 128 tokens and 32 zipped sentences at 896: ~182
    TFLOP, nearly all of it the tower's linears (5.97 GFLOP a token: 36 x
    (34.9 M in_proj + 16.8 M out_proj + 100.7 M MLP) + 4 x (21.0 M
    projections + 100.7 M MLP))."""
    cfg = _run(rehearse=False).config
    total = counts_granite.ghmfc_granite_flops(cfg, 8, 128, 4, 896)
    assert total / 1e12 == pytest.approx(182, rel=0.02)
    assert counts_granite.tower_flops(cfg, 1, 1) / 1e9 == pytest.approx(5.97, abs=0.005)


def test_validate_exits_0():
    proc = subprocess.run([sys.executable, os.path.join(harness.PKG, "run.py"), "--validate"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert any(line.startswith(CELL) and "ssd_roofline.rank" in line
               for line in proc.stdout.splitlines())


def _no_carry(scan):
    """The scan's state not carried between chunks: each chunk scanned alone."""
    def scan_alone(x, dt, A, B, C, D, chunk=256):
        pieces = [slice(i, i + chunk) for i in range(0, x.shape[1], chunk)]
        return torch.cat([scan(x[:, p], dt[:, p], A, B[:, p], C[:, p], D, chunk)
                          for p in pieces], 1)
    return scan_alone


def _no_skip(scan):
    """``D * x`` left out."""
    return lambda x, dt, A, B, C, D, chunk=256: scan(x, dt, A, B, C, 0 * D, chunk)


def _non_causal(attention):
    """Attention over every key, the later ones included."""
    def every_key(q, k, v, block_elems=1 << 28):
        return torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v
    return every_key


# planted faults: (module, function, what replaces it); tests/test_torch_granite.py plants
# them on the CPU at the rehearsal's sizes
FAULTS = {"state not carried": ("drin_tpu_torch.ops.cuda.ssd", "ssd_scan", _no_carry),
          "D x left out": ("drin_tpu_torch.ops.cuda.ssd", "ssd_scan", _no_skip),
          "attention not causal": ("drin_tpu_torch.encoders.granite_hybrid", "causal_attention",
                                   _non_causal)}


def plant(monkeypatch, fault):
    import importlib

    mod_name, name, plant = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, name, plant(getattr(mod, name)))


def _execute(run):
    result, checks = harness.execute(run, run.bench.module("drivers", "closed_rank"),
                                     harness.now())
    print(json.dumps({k: v["value"] for k, v in checks.items()}))
    return result


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the cell's own sizes need a CUDA device")
    return "cuda"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_the_check_on_the_card(monkeypatch, cuda_device, fault):
    """At the cell's own sizes, a short window (its answers judged as the
    benchmark judges them)."""
    plant(monkeypatch, fault)
    run = _run(seed=3_000_000_037, rehearse=False, device=cuda_device, seconds=2)
    assert _execute(run)["correct"] is False
