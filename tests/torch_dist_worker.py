# -*- coding: utf-8 -*-
"""Scenarios of the port over several ranks (not a test module).

Each scenario takes the run's spec (store directories, weight files, a
scratch directory) and a mesh, or None for the one-process run that it is
held against, and returns a JSON-able result.  ``tests/test_torch_distributed.py``
runs the one-process side in its own process and the ranks as processes of
this script, which imports nothing of the JAX package:

    python tests/torch_dist_worker.py <rank> <world> <rendezvous file> <spec.json> \\
        <out dir> <scenario>@<mesh data>x<mesh model>[,...]

Every rank writes ``<out dir>/rank<rank>.json``: {"<scenario>@<shape>": result}.
"""

import json
import os
import sys

import numpy as np
import torch

FIT_EPOCHS = 2


def digest(state_dict) -> float:
    """Order-sensitive digest of a state dict (keys sorted): every element is
    weighted by a position- and tensor-dependent factor, so rows permuted
    across ranks change it, as a plain sum would not."""
    tot = 0.0
    for i, k in enumerate(sorted(state_dict)):
        x = state_dict[k].detach().double().cpu().numpy().ravel()
        tot += float(np.dot(x, np.cos(0.03 * np.arange(x.size) + i)))
    return tot


def _record_epochs(trainer, out: list):
    """Record every epoch's result dict (train, valid and test) as it ends."""
    run = trainer._run_epoch

    def recording(dataset, split, train, kind):
        r = run(dataset, split, train, kind)
        out.append({"split": split, "loss": r["loss"], "accs": {str(k): v for k, v in r["accs"].items()}})
        return r

    trainer._run_epoch = recording


def _fit_and_test(cfg, model, kind, datasets, mesh, feats_fn=None, dump=None):
    from drin_tpu_torch.train.trainer import Trainer

    train, valid, test = datasets
    tr = Trainer(cfg, model, device="cpu", log=lambda *a: None, mesh=mesh, feats_fn=feats_fn,
                 output_test_result_path=dump or "unused")
    epochs = []
    _record_epochs(tr, epochs)
    tr.fit(train, valid, FIT_EPOCHS, kind=kind)
    test_out = tr.test(test, kind=kind)
    out = {"epochs": epochs, "test_loss": test_out["loss"],
           "test_accs": {str(k): v for k, v in test_out["accs"].items()},
           "digest": digest(tr.state.model.state_dict()), "step": tr.state.step}
    if dump and (mesh is None or mesh.main):
        with open(dump) as f:
            out["dump"] = f.read()
    return out


def drin_cfg(store: str):
    from drin_tpu_torch.data.synthetic import tiny_config

    return tiny_config("wikidiverse", "drin", preprocess_dir=store).replace(
        batch_size=8, learning_rate=3e-3, transformer_dropout=0.0, output_test_result=True)


def _drin(spec, mesh, fault=None):
    from drin_tpu_torch.data.dataset import create_datasets
    from drin_tpu_torch.models import get_model

    from drin_tpu_torch.train import trainer as T

    cfg = drin_cfg(spec["wd"])
    model, kind = get_model(cfg)
    model.load_state_dict(torch.load(spec["drin_weights"], weights_only=True))
    dump = os.path.join(spec["scratch"], f"dump-{mesh}-{fault}.txt")
    planted = T.triplet_loss
    if fault == "local_loss":
        T.triplet_loss = local_loss(mesh)
    try:
        return _fit_and_test(cfg, model, kind, create_datasets(cfg), mesh, dump=dump)
    finally:
        T.triplet_loss = planted


def local_loss(mesh):
    """A planted fault: each rank's loss is the triplet loss of its own rows
    against its own rows' negatives, DDP's way (the summed gradients divided
    by the data width): the in-batch negatives of the global batch are
    lost."""
    from drin_tpu_torch.train import loss as L

    nd = mesh.shape["data"]

    def local(y_true, y_pred, margin, valid=None, rows=None):
        if rows is None:
            return L.triplet_loss(y_true, y_pred, margin, valid)
        lo, hi = rows
        return L.triplet_loss(y_true[lo:hi], y_pred[lo:hi], margin, valid[lo:hi]) / nd

    return local


def scenario_drin(spec, mesh):
    return _drin(spec, mesh)


def scenario_drin_local_loss(spec, mesh):
    return _drin(spec, mesh, fault="local_loss")


def scenario_psum(spec, mesh):
    """Counters made from the rank (the data index) summed over the data
    group."""
    from drin_tpu_torch.train import metrics as M

    d = mesh.data_index
    state = {"correct_1": torch.tensor(float(d + 1)), "total": torch.tensor(8.0 + d),
             "loss_sum": torch.tensor(0.25 * d), "n_batches": torch.tensor(1.0)}
    return {k: float(v) for k, v in M.psum_state(state, mesh.data_group).items()}


def wm_cfg(store: str):
    from drin_tpu_torch.data.synthetic import tiny_config

    return tiny_config("wikimel", "drin", preprocess_dir=store).replace(
        batch_size=8, learning_rate=3e-3, transformer_dropout=0.0, cache_entity_pooling=False)


def scenario_wm_rows(spec, mesh):
    """Token-level WikiMEL tables: row-sharded over the model axis on a
    mesh, gathered on the host in one process."""
    from drin_tpu_torch.data.dataset import create_datasets
    from drin_tpu_torch.data.device_store import DeviceEntityStore
    from drin_tpu_torch.models import get_model

    cfg = wm_cfg(spec["wm"])
    assert not cfg.entity_pooling_cached
    datasets = create_datasets(cfg)
    model, kind = get_model(cfg)
    model.load_state_dict(torch.load(spec["wm_weights"], weights_only=True))
    out = {}
    feats_fn = None
    if mesh is not None:
        tables = datasets[0].tables
        store = DeviceEntityStore(cfg, tables, device="cpu", shard_rows=True, mesh=mesh)
        assert store.block < store.n_rows and store.sharded
        rng = np.random.default_rng(mesh.data_index)
        rows = torch.from_numpy(rng.integers(-3, store.n_rows + 3, (8, cfg.num_candidates_model)))
        names = ["text", "text_mask", "image", "obj", "obj_score"]
        keys = ["entity_text_feature", "entity_text_mask", "entity_image_feature",
                "entity_object_feature", "entity_object_score"]
        want_rows = np.clip(np.where(rows.numpy() < 0, rows.numpy() + store.n_rows, rows.numpy()),
                            0, store.n_rows - 1)
        got = store.gather(names, rows)
        out["gather_bit_equal"] = all(
            np.array_equal(g.numpy(), np.asarray(tables[k])[want_rows].astype(g.numpy().dtype))
            for g, k in zip(got, keys))
        out["nbytes"] = store.nbytes
        feats_fn, kind = store.drin_feats_fn(), "drin_rows"
    out.update(_fit_and_test(cfg, model, kind, datasets, mesh, feats_fn=feats_fn))
    return out


def scenario_ckpt(spec, mesh):
    """Save each epoch; a fresh trainer on every rank restores the newest."""
    from drin_tpu_torch.data.dataset import create_datasets
    from drin_tpu_torch.models import get_model
    from drin_tpu_torch.train.trainer import Trainer

    cfg = drin_cfg(spec["wd"]).replace(enable_checkpointing=True,
                                       checkpoint_dir=os.path.join(spec["scratch"], "ckpt"),
                                       output_test_result=False)
    train, valid, _ = create_datasets(cfg)
    model, kind = get_model(cfg, torch.Generator().manual_seed(0))
    tr = Trainer(cfg, model, device="cpu", log=lambda *a: None, mesh=mesh)
    tr.fit(train, valid, FIT_EPOCHS, kind=kind)
    fresh, _ = get_model(cfg, torch.Generator().manual_seed(1))
    again = Trainer(cfg, fresh, device="cpu", log=lambda *a: None, mesh=mesh)
    return {"digest": digest(tr.state.model.state_dict()),
            "restored_digest": digest(again.state.model.state_dict()),
            "restored_epoch": again.epoch, "restored_step": again.state.step,
            "step": tr.state.step, "files": sorted(os.listdir(cfg.checkpoint_dir))}


ONLINE_BERT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                   intermediate_size=32)


def scenario_online(spec, mesh):
    """GHMFC with online BERT and length bucketing: every rank trims its rows
    to the global batch's bucket."""
    from drin_tpu_torch.data.online import OnlineMELDataset
    from drin_tpu_torch.data.synthetic import make_synthetic_online_store
    from drin_tpu_torch.encoders.bert import BertConfig
    from drin_tpu_torch.models import get_model

    cfg, tok = make_synthetic_online_store(spec["online"], write=False)
    cfg = cfg.replace(batch_size=8, learning_rate=3e-3, metrics_topk=(1,), transformer_dropout=0.0,
                      num_processes=1 if mesh is None else mesh.size)
    datasets = [OnlineMELDataset(cfg, s, tokenizer=tok) for s in ("train", "valid", "test")]
    if mesh is not None:
        assert datasets[0]._men_len is not None, "bucketing must stay on over several ranks"
    bert_cfg = BertConfig(max_position_embeddings=cfg.max_bert_len, **ONLINE_BERT)
    model, kind = get_model(cfg, torch.Generator().manual_seed(0), bert_cfg=bert_cfg)
    try:
        return _fit_and_test(cfg, model, kind, datasets, mesh)
    finally:
        for ds in datasets:
            ds.close()


def main():
    rank, world, rendezvous, spec_path, out_dir, runs = sys.argv[1:7]
    torch.set_num_threads(1)
    from drin_tpu_torch.parallel import distributed
    from drin_tpu_torch.parallel.mesh import make_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    distributed.TIMEOUT_S = 120
    distributed.initialize(coordinator_address=f"file://{rendezvous}", num_processes=int(world),
                           process_id=int(rank), device="cpu")
    try:
        out = {}
        for run in runs.split(","):
            name, shape = run.split("@")
            nd, nm = (int(x) for x in shape.split("x"))
            # every rank builds every mesh's groups in the same order
            out[run] = globals()[f"scenario_{name}"](spec, make_mesh(data=nd, model=nm))
    finally:
        distributed.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
