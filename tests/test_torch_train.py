# -*- coding: utf-8 -*-
"""The port's training path against ``drin_tpu.train``: the triplet loss and
the metric counters on the same arrays, and five-step trajectories of DRIN,
offline GHMFC and GHMFC with online BERT (fine-tuned and frozen) from the
same weights (through the converters) and the same numpy batches.  Float32 on
the CPU, loss per step at rtol 2e-4 (the same math in another association
order); first-step gradients are compared leaf by leaf through Adam's first
``mu`` (post-Adam parameters are not: the first update is ~g/|g|, which
amplifies last-bit differences of gradients near zero)."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.data import dataset as jdataset
from drin_tpu.data.synthetic import make_synthetic_store, tiny_config
from drin_tpu.encoders.bert import BertConfig as JaxBertConfig
from drin_tpu.models.drin import DRIN as JaxDRIN
from drin_tpu.models.ghmfc import GHMFC as JaxGHMFC, GHMFCOnline as JaxGHMFCOnline
from drin_tpu.models.melhi import MELHI as JaxMELHI
from drin_tpu.train import metrics as JM
from drin_tpu.train.loss import triplet_loss as jax_triplet_loss
from drin_tpu.train.trainer import build_step_fns as jax_build_step_fns
from drin_tpu.train.trainer import create_train_state as jax_create_train_state
from drin_tpu_torch.common.config import make_config
from drin_tpu_torch.data import dataset as tdataset
from drin_tpu_torch.data.device_store import DeviceEntityStore, include_for
from drin_tpu_torch.encoders.bert import BertConfig
from drin_tpu_torch.models import get_model
from drin_tpu_torch.models.convert import (bert_state_dict_from_jax, drin_state_dict_from_jax,
                                           ghmfc_online_state_dict_from_jax,
                                           ghmfc_state_dict_from_jax, melhi_state_dict_from_jax)
from drin_tpu_torch.train import metrics as TM
from drin_tpu_torch.train.cli import main as train_main
from drin_tpu_torch.train.loss import triplet_loss
from drin_tpu_torch.train.trainer import (Trainer, build_step_fns, create_train_state,
                                          step_generator)
from test_torch_ghmfc import BERT_DIMS, online_batch, online_cfg

F32 = dict(rtol=2e-4, atol=1e-6)
STEPS = 5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


# --------------------------------------------------------------- loss, metrics


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("answer_column", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_triplet_loss_matches_jax(seed, answer_column, with_valid):
    rng = np.random.default_rng(seed)
    B, Cd = 5, 7
    idx = rng.integers(0, Cd + 1, B)  # Cd = answer absent: an all-zero row
    y_true = np.concatenate([np.eye(Cd, dtype=np.float32), np.zeros((1, Cd), np.float32)])[idx]
    y_pred = rng.uniform(-1, 1, (B, Cd + int(answer_column))).astype(np.float32)
    valid = (rng.uniform(size=B) < 0.7).astype(np.float32) if with_valid else None
    if seed == 3 and with_valid:
        valid[:] = 0  # no valid row at all: the guards keep the loss at 0
    want = float(jax_triplet_loss(y_true, y_pred, 0.25, valid))
    got = float(triplet_loss(_t(y_true), _t(y_pred), 0.25, None if valid is None else _t(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["random", "ties", "no-gold", "nan-row", "valid", "answer-column"])
def test_metrics_update_matches_jax(case):
    rng = np.random.default_rng(len(case))
    B, Cd, topk = 6, 7, (1, 3, 5)
    idx = rng.integers(0, Cd, B)
    y_true = np.eye(Cd, dtype=np.float32)[idx]
    y_pred = rng.uniform(-1, 1, (B, Cd)).astype(np.float32)
    valid = None
    if case == "ties":  # the gold score equals two others: ties count as hits
        y_pred = np.round(y_pred * 2) / 2
        y_pred[0, :] = 0.5
    elif case == "no-gold":
        y_true[[0, 3]] = 0
    elif case == "nan-row":
        y_pred[1, 2] = np.nan
        y_pred[4, idx[4]] = np.inf
    elif case == "valid":
        valid = np.array([1, 1, 0, 1, 0, 1], np.float32)
    elif case == "answer-column":
        y_pred = np.concatenate([y_pred, np.full((B, 1), 9.0, np.float32)], axis=1)
    jstate = JM.update(JM.init_state(topk), jnp.asarray(y_pred), jnp.asarray(y_true), topk,
                       None if valid is None else jnp.asarray(valid))
    jstate = JM.add_loss(jstate, jnp.float32(0.5))
    tstate = TM.update(TM.init_state(topk), _t(y_pred), _t(y_true), topk,
                       None if valid is None else _t(valid))
    tstate = TM.add_loss(tstate, torch.tensor(0.5))
    assert set(tstate) == set(jstate)
    for k in jstate:
        assert tstate[k].shape == () and tstate[k].dtype == torch.float32
        assert float(tstate[k]) == float(jstate[k]), (case, k)
    for k, v in JM.compute(jstate, topk, 0.1).items():
        np.testing.assert_allclose(float(TM.compute(tstate, topk, 0.1)[k]), float(v), rtol=1e-6)
    assert float(TM.mean_loss(tstate)) == float(JM.mean_loss(jstate)) == 0.5


# ------------------------------------------------------------------ trajectories


def _jax_steps(model, params, cfg, batches, valids, steps=STEPS, jit=True):
    """Losses of ``steps`` JAX train steps (dropout off) and Adam's ``mu``
    after the first, as numpy.  ``jit=False`` runs the same step op by op."""
    if not jit:
        with jax.disable_jit():
            return _jax_steps(model, params, cfg, batches, valids, steps)
    apply_fn = lambda p, f: model.apply({"params": p}, f)
    state, tx = jax_create_train_state(jax.tree.map(jnp.asarray, params), cfg)
    fns = jax_build_step_fns(apply_fn, cfg, tx)
    losses, mu = [], None
    mstate = JM.init_state(cfg.metrics_topk)
    for i in range(steps):
        state, loss, mstate = fns.train_step(state, batches[i % len(batches)],
                                             valids[i % len(valids)], mstate)
        losses.append(float(loss))
        if i == 0:
            adam = state.opt_state.inner_state[0] if hasattr(state.opt_state, "inner_state") \
                else state.opt_state[0]
            mu = jax.device_get(adam.mu)
    return losses, mu, jax.device_get(state.params), jax.device_get(mstate)


def _torch_steps(model, cfg, batches, valids, feats_fn=None, steps=STEPS):
    state = create_train_state(model, cfg)
    fns = build_step_fns(model, cfg, feats_fn)
    losses, mu = [], None
    mstate = TM.init_state(cfg.metrics_topk)
    for i in range(steps):
        batch = tuple(_t(x) for x in batches[i % len(batches)])
        state, loss, mstate = fns.train_step(state, batch, _t(valids[i % len(valids)]), mstate)
        losses.append(float(loss))
        if i == 0:
            names = {id(p): n for n, p in model.named_parameters()}
            mu = {names[id(p)]: s["exp_avg"].clone() for p, s in state.optimizer.state.items()}
    return losses, mu, state, mstate


def _assert_mu(mu_torch, mu_as_state_dict, skip=()):
    """Adam's first mu ( = 0.1 * gradient), leaf by leaf in the port's names."""
    wanted = {k for k in mu_as_state_dict if not k.startswith(tuple(skip))}
    assert set(mu_torch) <= wanted
    for k in wanted - set(mu_torch):
        # a parameter no output depends on (the last layer's edge update) gets
        # no gradient and no Adam state in torch; in JAX its gradient is zero
        assert not mu_as_state_dict[k].numpy().any(), k
    for k, got in mu_torch.items():
        want = mu_as_state_dict[k].numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                   atol=1e-7 + 2e-4 * np.abs(want).max(), err_msg=k)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Tiny synthetic feature stores, written once by the JAX package."""
    out = {}
    for ds in ("wikidiverse", "wikimel"):
        d = str(tmp_path_factory.mktemp(ds))
        cfg = tiny_config(ds, "drin", preprocess_dir=d)
        make_synthetic_store(cfg, n_mentions=10, n_entities=30, seed=3)
        out[ds] = d
    return out


def _port_cfg(cfg):
    """The same configuration as the port's own Config object."""
    import dataclasses

    d = dataclasses.asdict(cfg)
    return make_config(d.pop("model_type"), d.pop("dataset_name"), **d)


@pytest.mark.parametrize("ds", ["wikidiverse", "wikimel"])
def test_drin_trajectory_matches_jax(stores, ds):
    cfg = tiny_config(ds, "drin", preprocess_dir=stores[ds]).replace(transformer_dropout=0.0)
    train = jdataset.create_datasets(cfg)[0]
    idx = [np.arange(4), np.arange(4, 8), np.array([8, 9, 8, 8])]
    valids = [np.ones(4, np.float32), np.ones(4, np.float32), np.array([1, 1, 0, 0], np.float32)]
    jbatches = [train.make_batch(i, "drin") for i in idx]
    jmodel = JaxDRIN(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), jbatches[0][:-1])["params"])
    jl, jmu, _, jms = _jax_steps(jmodel, params, cfg, jbatches, valids)

    pcfg = _port_cfg(cfg)
    ptrain = tdataset.create_datasets(pcfg)[0]
    model, kind = get_model(pcfg)
    model.load_state_dict(drin_state_dict_from_jax(params, pcfg))
    feats_fn = None
    if ds == "wikimel":  # the port gathers from the device-resident tables inside the step
        feats_fn = DeviceEntityStore(pcfg, ptrain.tables, device="cpu").drin_feats_fn()
        kind = "drin_rows"
    tl, tmu, _, tms = _torch_steps(model, pcfg, [ptrain.make_batch(i, kind) for i in idx], valids,
                                   feats_fn)
    np.testing.assert_allclose(tl, jl, **F32)
    _assert_mu(tmu, drin_state_dict_from_jax(jmu, pcfg))
    for k in jms:
        np.testing.assert_allclose(float(tms[k]), float(jms[k]), rtol=2e-4)


def test_ghmfc_offline_trajectory_matches_jax(stores):
    cfg = tiny_config("wikimel", "ghmfc", preprocess_dir=stores["wikimel"]).replace(
        transformer_dropout=0.0)
    train = jdataset.create_datasets(cfg)[0]
    idx = [np.arange(4), np.arange(4, 8)]
    valids = [np.ones(4, np.float32)]
    batches = [train.make_batch(i, "baseline") for i in idx]
    jmodel = JaxGHMFC(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), batches[0][:-1])["params"])
    jl, jmu, _, _ = _jax_steps(jmodel, params, cfg, batches, valids)
    pcfg = _port_cfg(cfg)
    model, kind = get_model(pcfg)
    assert kind == "baseline"
    model.load_state_dict(ghmfc_state_dict_from_jax(params, pcfg))
    tl, tmu, _, _ = _torch_steps(model, pcfg, batches, valids)
    np.testing.assert_allclose(tl, jl, **F32)
    _assert_mu(tmu, ghmfc_state_dict_from_jax(jmu, pcfg))


@pytest.mark.parametrize("mention_layer", ["multimodal", "transformer"])
def test_ghmfc_store_trajectory_matches_jax(stores, mention_layer):
    """Offline GHMFC trained over the device store (a text-only store,
    ``baseline_rows`` batches, rows gathered inside the step) follows the
    JAX steps on the dense baseline batches."""
    cfg = tiny_config("wikimel", "ghmfc", preprocess_dir=stores["wikimel"],
                      mention_final_layer_name=mention_layer).replace(transformer_dropout=0.0)
    train = jdataset.create_datasets(cfg)[0]
    idx = [np.arange(4), np.arange(4, 8), np.array([8, 9, 8, 8])]
    valids = [np.ones(4, np.float32), np.ones(4, np.float32), np.array([1, 1, 0, 0], np.float32)]
    jbatches = [train.make_batch(i, "baseline") for i in idx]
    jmodel = JaxGHMFC(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), jbatches[0][:-1])["params"])
    jl, jmu, _, jms = _jax_steps(jmodel, params, cfg, jbatches, valids)
    pcfg = _port_cfg(cfg)
    ptrain = tdataset.create_datasets(pcfg)[0]
    model, kind = get_model(pcfg)
    model.load_state_dict(ghmfc_state_dict_from_jax(params, pcfg))
    store = DeviceEntityStore(pcfg, ptrain.tables, device="cpu", include=include_for(kind))
    assert store.include == ("text",) and store.image is None and store.obj_score is None
    tl, tmu, _, tms = _torch_steps(model, pcfg, [ptrain.make_batch(i, "baseline_rows") for i in idx],
                                   valids, store.baseline_feats_fn())
    np.testing.assert_allclose(tl, jl, **F32)
    _assert_mu(tmu, ghmfc_state_dict_from_jax(jmu, pcfg))
    for k in jms:
        np.testing.assert_allclose(float(tms[k]), float(jms[k]), rtol=2e-4)


def test_melhi_trajectory_matches_jax(stores):
    """MELHI on the WikiDiverse baseline batch, gates open (thresholds
    under every cosine), so the image mapping takes gradients too."""
    cfg = tiny_config("wikidiverse", "melhi", preprocess_dir=stores["wikidiverse"],
                      thres_tmim=-2.0, thres_imie=-2.0)
    train = jdataset.create_datasets(cfg)[0]
    idx = [np.arange(4), np.arange(4, 8)]
    valids = [np.ones(4, np.float32), np.array([1, 1, 1, 0], np.float32)]
    batches = [train.make_batch(i, "baseline") for i in idx]
    jmodel = JaxMELHI(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(2), batches[0][:-1])["params"])
    jl, jmu, _, _ = _jax_steps(jmodel, params, cfg, batches, valids)
    pcfg = _port_cfg(cfg)
    model, kind = get_model(pcfg)
    assert kind == "baseline"
    model.load_state_dict(melhi_state_dict_from_jax(params))
    tl, tmu, _, _ = _torch_steps(model, pcfg, [tdataset.create_datasets(pcfg)[0].make_batch(
        i, "baseline") for i in idx], valids)
    np.testing.assert_allclose(tl, jl, **F32)
    _assert_mu(tmu, melhi_state_dict_from_jax(jmu))
    assert tmu["image_map_text.weight"].abs().max() > 0  # the open gate passes gradient


def _online_case(zipped, finetune, remat=False, B=3):
    cfg = online_cfg(zipped, finetune_bert=finetune, bert_remat=remat, batch_size=B,
                     transformer_dropout=0.0, metrics_topk=(1, 5))
    feats = [online_batch(cfg, B, seed) for seed in (5, 6)]
    rng = np.random.default_rng(9)
    Cd = cfg.num_candidates_data
    batches = [f + (np.eye(Cd + 1, dtype=np.float32)[rng.integers(0, Cd + 1, B)][:, :Cd],)
               for f in feats]
    return cfg, batches, [np.ones(B, np.float32)]


@pytest.fixture(scope="module")
def online_jax():
    """JAX trajectories of the tiny online model, one per (zipped, finetune).
    The step runs op by op: XLA's jitted CPU program of this step returns
    other gradients than the same function run op by op for a few elements
    of the fusion's last LayerNorm (13% off, in float64 too, so it is no
    rounding), and the port agrees with the op-by-op run."""
    out = {}
    for zipped in (True, False):
        for finetune in (True, False):
            cfg, batches, valids = _online_case(zipped, finetune)
            jmodel = JaxGHMFCOnline(cfg, JaxBertConfig(**BERT_DIMS))
            params = jax.tree.map(np.asarray,
                                  jmodel.init(jax.random.key(1), batches[0][:-1])["params"])
            out[zipped, finetune] = (params,) + _jax_steps(jmodel, params, cfg, batches, valids,
                                                           jit=False)
    return out


def _port_online(cfg, params):
    pcfg = _port_cfg(cfg)
    bert_cfg = BertConfig(**BERT_DIMS)
    model, kind = get_model(pcfg, bert_cfg=bert_cfg)
    assert kind == "online"
    model.load_state_dict(ghmfc_online_state_dict_from_jax(params, pcfg, bert_cfg))
    return pcfg, bert_cfg, model


@pytest.mark.parametrize("finetune", [True, False], ids=["finetune", "frozen"])
@pytest.mark.parametrize("zipped", [True, False], ids=["zipped", "direct"])
def test_online_trajectory_matches_jax(online_jax, zipped, finetune):
    params, jl, jmu, jparams, _ = online_jax[zipped, finetune]
    cfg, batches, valids = _online_case(zipped, finetune)
    pcfg, bert_cfg, model = _port_online(cfg, params)
    before = copy.deepcopy(model.state_dict())
    tl, tmu, state, _ = _torch_steps(model, pcfg, batches, valids)
    np.testing.assert_allclose(tl, jl, **F32)
    assert tl[-1] < tl[0]
    bert_keys = [k for k in before if k.startswith("bert.")]
    if finetune:
        mu = dict(jmu)
        want = ghmfc_online_state_dict_from_jax(mu, pcfg, bert_cfg)
        _assert_mu(tmu, want)
        assert any(not torch.equal(model.state_dict()[k], before[k]) for k in bert_keys)
    else:
        # frozen BERT: no Adam state is held for it, it gets no gradient and
        # stays bit-equal; the heads move
        assert not any(k.startswith("bert.") for k in tmu)
        held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
        assert not any(id(p) in held for n, p in model.named_parameters() if n.startswith("bert."))
        assert all(p.grad is None for n, p in model.named_parameters() if n.startswith("bert."))
        for k in bert_keys:
            assert torch.equal(model.state_dict()[k], before[k]), k
        assert any(not torch.equal(model.state_dict()[k], before[k])
                   for k in before if not k.startswith("bert."))
        heads = {k: v for k, v in jmu.items() if k != "bert"}
        zero_bert = jax.tree.map(np.zeros_like, params["bert"])
        want = ghmfc_online_state_dict_from_jax(dict(heads, bert=zero_bert), pcfg, bert_cfg)
        _assert_mu(tmu, want, skip=("bert.",))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_remat_equals_no_remat(online_jax, dtype):
    """Recomputing each BERT layer in the backward changes memory, not
    numbers; under a bf16 body the recompute runs on the bf16 copies too."""
    params = online_jax[True, True][0]
    runs = []
    for remat in (False, True):
        cfg, batches, valids = _online_case(True, True, remat=remat)
        pcfg, _, model = _port_online(cfg.replace(compute_dtype=dtype), params)
        assert model.bert.remat is remat
        runs.append(_torch_steps(model, pcfg, batches, valids, steps=2))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    for k, v in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=1e-7 + 2e-4 * float(v.abs().max()), err_msg=k)


def test_ragged_padded_batch_equals_unpadded(stores):
    cfg = _port_cfg(tiny_config("wikidiverse", "drin", preprocess_dir=stores["wikidiverse"]))
    train = tdataset.create_datasets(cfg)[0]
    model, _ = get_model(cfg, torch.Generator().manual_seed(0))
    fns = build_step_fns(model, cfg)
    short = tuple(_t(x) for x in train.make_batch(np.arange(3), "drin"))
    padded = tuple(_t(x) for x in train.make_batch(np.array([0, 1, 2, 0, 0]), "drin"))
    valid = torch.tensor([1, 1, 1, 0, 0], dtype=torch.float32)
    la, ma, _ = fns.eval_step(short, torch.ones(3), TM.init_state(cfg.metrics_topk))
    lb, mb, _ = fns.eval_step(padded, valid, TM.init_state(cfg.metrics_topk))
    np.testing.assert_allclose(float(lb), float(la), rtol=1e-6)
    for k in ma:
        assert float(ma[k]) == pytest.approx(float(mb[k]), rel=1e-6), k


def test_bf16_body_keeps_f32_masters(stores):
    cfg = _port_cfg(tiny_config("wikidiverse", "drin", preprocess_dir=stores["wikidiverse"])
                    ).replace(compute_dtype="bfloat16")
    train = tdataset.create_datasets(cfg)[0]
    model, _ = get_model(cfg, torch.Generator().manual_seed(0))
    f32_model = copy.deepcopy(model)
    batches = [train.make_batch(np.arange(4), "drin")]
    valids = [np.ones(4, np.float32)]
    losses, mu, state, _ = _torch_steps(model, cfg, batches, valids, steps=3)
    assert all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
               for p in model.parameters())
    assert sum(p.grad is not None for p in model.parameters()) >= 10
    assert all(v.dtype == torch.float32 for v in mu.values())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    f32_losses = _torch_steps(f32_model, cfg.replace(compute_dtype="float32"), batches, valids,
                              steps=1)[0]
    # the bf16 body rounds every activation to 8 bits: 2e-2 on a loss of ~0.3
    np.testing.assert_allclose(losses[0], f32_losses[0], rtol=2e-2)


def test_dropout_active_in_train_steps_only(stores):
    cfg = _port_cfg(tiny_config("wikimel", "ghmfc", preprocess_dir=stores["wikimel"])
                    ).replace(transformer_dropout=0.5)
    train = tdataset.create_datasets(cfg)[0]
    batch = tuple(_t(x) for x in train.make_batch(np.arange(4), "baseline"))
    valid = torch.ones(4)

    def first_loss(dropout, step=0):
        # the rate is the model's: the same seed builds the same weights at either rate
        run = cfg if dropout else cfg.replace(transformer_dropout=0.0)
        model, _ = get_model(run, torch.Generator().manual_seed(0))
        state = create_train_state(model, run)
        state.step = step
        fns = build_step_fns(model, run)
        ev = float(fns.eval_step(batch, valid, TM.init_state(cfg.metrics_topk))[0])
        return float(fns.train_step(state, batch, valid, TM.init_state(cfg.metrics_topk))[1]), ev

    (on, ev_on), (on_again, _), (off, ev_off) = first_loss(True), first_loss(True), first_loss(False)
    assert on == on_again          # the same seed and step: the same masks
    assert ev_on == ev_off == off  # eval is deterministic; so is a step at rate 0
    assert on != off
    assert first_loss(True, step=1)[0] != on  # another step, other masks
    g0, g1 = step_generator(cfg, 7, "cpu"), step_generator(cfg.replace(seed=1), 7, "cpu")
    assert g0.initial_seed() != g1.initial_seed()


# ----------------------------------------------------------------- the Trainer


def _trainer(cfg, **kw):
    model, kind = get_model(cfg, torch.Generator().manual_seed(cfg.seed))
    return Trainer(cfg, model, device="cpu", log=lambda *a: None, **kw), kind


def test_checkpoint_resume_continues_the_trajectory(stores, tmp_path):
    base = _port_cfg(tiny_config("wikidiverse", "drin", preprocess_dir=stores["wikidiverse"])
                     ).replace(enable_checkpointing=True, reset_optimizer_per_fit=False,
                               keep_checkpoints=2)
    train, valid, _ = tdataset.create_datasets(base)
    straight, kind = _trainer(base.replace(checkpoint_dir=str(tmp_path / "a")))
    straight.fit(train, valid, 3, kind=kind)
    first, _ = _trainer(base.replace(checkpoint_dir=str(tmp_path / "b")))
    first.fit(train, valid, 2, kind=kind)
    resumed, _ = _trainer(base.replace(checkpoint_dir=str(tmp_path / "b")))  # picks up the latest
    assert (resumed.epoch, resumed.state.step) == (2, first.state.step) and first.state.step > 0
    resumed.fit(train, valid, 1, kind=kind)
    assert resumed.state.step == straight.state.step
    for (k, a), b in zip(straight.state.model.state_dict().items(),
                         resumed.state.model.state_dict().values()):
        assert torch.equal(a, b), k
    # keyed by step, the newest two kept; resume_from names a step
    kept = sorted(os.listdir(tmp_path / "b"))
    assert kept == sorted(f"step_{s}.pt" for s in (first.state.step, resumed.state.step))
    again, _ = _trainer(base.replace(checkpoint_dir=str(tmp_path / "b"),
                                     resume_from=str(first.state.step)))
    assert again.state.step == first.state.step and again.epoch == 2


def test_restore_errors_are_named(tmp_path):
    cfg = _port_cfg(tiny_config("wikidiverse", "drin", preprocess_dir="unused"))
    with pytest.raises(ValueError, match="resume_from takes the checkpoint STEP number"):
        _trainer(cfg.replace(enable_checkpointing=True, checkpoint_dir=str(tmp_path / "c"),
                             resume_from="checkpoints/step_20"))
    trainer, _ = _trainer(cfg)
    trainer.save()  # a no-op without checkpointing
    with pytest.raises(RuntimeError, match="restore\\(\\) needs checkpointing"):
        trainer.restore()


def test_test_result_dump_lines(stores, tmp_path):
    cfg = _port_cfg(tiny_config("wikidiverse", "drin", preprocess_dir=stores["wikidiverse"])
                    ).replace(output_test_result=True)
    test = tdataset.create_datasets(cfg)[2]
    path = tmp_path / "test-result.txt"
    trainer, kind = _trainer(cfg, output_test_result_path=str(path))
    dumped = trainer.test(test, kind=kind)
    plain = trainer._run_epoch(test, "test", False, kind)
    assert dumped["accs"] == plain["accs"] and dumped["loss"] == pytest.approx(plain["loss"])
    lines = path.read_text().splitlines()
    assert len(lines) == len(test) == 3  # the ragged tail's padding rows are not written
    batch = tuple(_t(x) for x in test.make_batch(np.arange(3), kind))
    with torch.no_grad():
        scores = trainer.state.model(batch[:-1]).numpy()
    for line, row, label in zip(lines, scores, test.labels(np.arange(3))):
        left, right = line.split(" | ")
        assert int(right) == label
        np.testing.assert_allclose([float(v) for v in left.split()], row, atol=1e-6)
    assert scores.shape[1] == cfg.num_candidates_model


def _entry_args(cfg, d, **extra):
    args = {"model_type": cfg.model_type, "dataset_name": cfg.dataset_name, "preprocess_dir": d,
            "dataset_root": "unused", "num_candidates_data": cfg.num_candidates_data,
            "metrics_topk": tuple(cfg.metrics_topk), "bert_embed_dim": 16, "resnet_embed_dim": 24,
            "gcn_embed_dim": 16, "mention_final_output_dim": 16, "entity_final_output_dim": 16,
            "max_mention_sentence_len": 12, "max_entity_attr_token_len": 8,
            "resnet_num_region": 4, "batch_size": 4, "transformer_num_layers": 2,
            "transformer_num_heads": 2, "transformer_ffn_hidden_size": 16, "num_epoch": 2,
            "test_epoch_interval": 1, "device": "cpu"}
    args.update(extra)
    return [f"{k}={v}" for k, v in args.items()]


@pytest.mark.parametrize("model_type,ds", [("drin", "wikimel"), ("drin", "wikidiverse"),
                                           ("ghmfc", "wikidiverse"), ("ghmfc", "wikimel"),
                                           ("melhi", "wikidiverse")])
def test_train_entry_runs_fit_and_test_rounds(stores, capsys, model_type, ds):
    cfg = tiny_config(ds, model_type, preprocess_dir=stores[ds])
    train_main(_entry_args(cfg, stores[ds]))
    out = capsys.readouterr().out
    assert out.count("train epoch") == 4 and out.count("valid epoch") == 4  # start + done, twice
    assert out.count("test epoch") == 4 and "pairs/s" in out
    assert ("device entity tables resident" in out) == (ds == "wikimel")
    assert f"model: {model_type}" in out and "device: cpu" in out


def test_train_entry_refuses_by_name(stores):
    cfg = tiny_config("wikimel", "drin", preprocess_dir=stores["wikimel"])
    args = lambda **kw: _entry_args(cfg, stores["wikimel"], **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_main(args(device="cuda"))
    for kw, what in ((dict(mesh_data=2), "mesh_data=2"), (dict(num_processes=2), "num_processes=2")):
        with pytest.raises(NotImplementedError, match="not ported yet") as err:
            train_main(args(**kw))
        assert what in str(err.value)
