"""The plain references held against the port on the CPU at tiny sizes (the
rehearsal sizes of ``portbench/rehearsal/``): the same weights, the same
requests, float32.  The port's CUDA kernels are not on this path; on the
CPU it runs their plain versions."""

import numpy as np
import pytest
import torch

from portbench import harness


def _run(workload, seed=3_000_000_017):
    bench = harness.Bench(harness.PKG.rsplit("/", 1)[0])
    return harness.Run(bench, workload, seed, 1.0, False, True, False, torch.device("cpu"))


def _port_state_dict(run):
    from drin_tpu_torch.encoders.bert import BertConfig
    from drin_tpu_torch.models import get_model

    cfg = run.system.port_config(run.config)
    bert = BertConfig(**run.config["bert"]) if "bert" in run.config else None
    with torch.device("meta"):
        model, _ = get_model(cfg, bert_cfg=bert) if bert else get_model(cfg)
    return model.state_dict()


@pytest.mark.parametrize("workload", ["drin-rank-b64", "ghmfc-online-rank-b8"])
def test_reference_weights_are_the_port_model(workload):
    run = _run(workload)
    want = {k: tuple(v.shape) for k, v in _port_state_dict(run).items()}
    got = {k: tuple(s) for k, (s, _) in run.reference.param_shapes(run.config).items()}
    assert got == want


@pytest.mark.parametrize("workload,store", [("drin-rank-b64", "float"),
                                            ("drin-rank-b64", "int8 fused"),
                                            ("ghmfc-online-rank-b8", None)])
def test_reference_scores_match_the_port(workload, store):
    run = _run(workload)
    if store is not None:
        run.cell["quantize_store"] = run.cell["fused_gather"] = store != "float"
    data = run.system.make_data(run)
    pool = run.system.request_pool(run, data, 2, run.cell["batch"])
    ranker = run.system.build_ranker(run, data)
    for feats in pool:
        got = ranker.score(feats)
        want = run.system.reference_scores(run, data, feats)
        assert got.shape == want.shape == (run.cell["batch"], run.system.num_candidates(run.config))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_drin_quantized_rows_are_the_store_rows():
    """The reference's int8 rows, worked out again from the raw table, equal
    the port's store quantization bit for bit."""
    from drin_tpu_torch.data.device_store import quantize_entity_rows

    x = np.random.default_rng(0).standard_normal((7, 2, 128)).astype(np.float32)
    x[3] = 0.0
    ref = _run("drin-rank-b64").reference
    for lead, per_slot in ((1, False), (2, True)):
        q, s = quantize_entity_rows(x, per_slot=per_slot)
        rq, rs = ref.quantize_rows(torch.from_numpy(x), lead)
        assert np.array_equal(q.astype(np.float32), rq.numpy())
        assert np.array_equal(s, rs.numpy())


def test_drin_train_steps_match_the_port():
    """Three Trainer steps against the reference's three: losses, the first
    gradient by leaf and the parameters after the third step."""
    run = _run("drin-train-b64")
    driver = run.bench.module("drivers", "train_loop")
    state = driver.setup(run)
    checked = state["checked"]
    data, pool = state["data"], state["pool"]
    params = dict(state["trainer"].state.model.named_parameters())
    assert checked["losses"][0] > 0
    want = driver.reference_steps(run, data, pool, checked["rows"], checked["p0"], tf32=False)
    np.testing.assert_allclose(checked["losses"], want["losses"], rtol=1e-5)
    for k, g in want["grad_norms"].items():
        assert checked["grad_norms"][k] == pytest.approx(g, rel=1e-4, abs=1e-7), k
    numbers = driver.compare(checked, want)
    assert numbers["step_gap"] < 1e-4 and numbers["grad_gap"] < 1e-4, numbers
    # the window's steps moved the parameters further: the check's are kept
    assert any(not torch.equal(params[k].detach(), checked["p0"][k]) for k in params)
    driver.release(state)
