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


def drin_cand_cfg(store: str):
    """Tiny WikiDiverse with a prime C = 11: padded to 12 over a model axis
    of 2."""
    return drin_cfg(store).replace(num_candidates_data=10)


def first_step_grads(cfg, model, kind, dataset, mesh, feats_fn=None) -> dict:
    """The gradient that the first train step of the epoch's first global
    batch gives Adam (summed over the mesh), per parameter, as lists."""
    from drin_tpu_torch.train import metrics as M
    from drin_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, model, device="cpu", log=lambda *a: None, mesh=mesh, feats_fn=feats_fn)
    idx, valid = next(tr._index_batches(len(dataset), False, 0))
    batch, valid = tr._assemble(dataset, kind, idx, valid)
    tr.fns.train_step(tr.state, batch, valid, M.init_state(cfg.metrics_topk, "cpu"))
    return {name: p.grad.reshape(-1).tolist() for name, p in tr.state.model.named_parameters()
            if p.grad is not None}


def planted_model_axis_fault(fault):
    """A context with one planted fault of candidate-parallel training:
    ``nosum``, the mention means' message sum without its collective in the
    backward; ``avg``, the model axis's gradient shares averaged where the
    rule sums them (the rule of a replicated model axis: the sum over the
    mesh over the model width)."""
    import contextlib

    from drin_tpu_torch.parallel import collectives as coll

    @contextlib.contextmanager
    def ctx():
        saved = coll._AllSum.backward, coll.sum_grads_
        if fault == "nosum":
            coll._AllSum.backward = staticmethod(lambda c, g: (g, None))
        elif fault == "avg":
            def averaged(params, group, extra):
                out = saved[1](params, group, extra)
                width = 2  # the scenarios' model axis
                for p in params:
                    if p.grad is not None:
                        p.grad /= width
                return out

            coll.sum_grads_ = averaged
        try:
            yield
        finally:
            coll._AllSum.backward, coll.sum_grads_ = saved

    return ctx()


def _drin_cand(spec, mesh, fault=None):
    from drin_tpu_torch.data.dataset import create_datasets
    from drin_tpu_torch.models import get_model

    cfg = drin_cand_cfg(spec["wd11"])
    datasets = create_datasets(cfg)
    with planted_model_axis_fault(fault):
        model, kind = get_model(cfg)
        model.load_state_dict(torch.load(spec["drin_weights"], weights_only=True))
        grads = first_step_grads(cfg, model, kind, datasets[0], mesh)
        model.load_state_dict(torch.load(spec["drin_weights"], weights_only=True))
        out = _fit_and_test(cfg, model, kind, datasets, mesh,
                            dump=os.path.join(spec["scratch"], f"dump-cand-{mesh}-{fault}.txt"))
    out["grads"] = grads
    return out


def scenario_drin_cand(spec, mesh):
    """DRIN candidate-parallel over the model axis, C = 11 padded to 12."""
    return _drin_cand(spec, mesh)


def scenario_drin_cand_nosum(spec, mesh):
    return _drin_cand(spec, mesh, fault="nosum")


def scenario_drin_cand_avg(spec, mesh):
    return _drin_cand(spec, mesh, fault="avg")


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
    """Tiny WikiMEL with token-level tables and a prime C = 11."""
    from drin_tpu_torch.data.synthetic import tiny_config

    return tiny_config("wikimel", "drin", preprocess_dir=store, num_candidates_data=10).replace(
        batch_size=8, learning_rate=3e-3, transformer_dropout=0.0, cache_entity_pooling=False)


def scenario_wm_rows(spec, mesh):
    """Token-level WikiMEL tables: row-sharded over the model axis on a
    mesh (DRIN candidate-parallel, C = 11 padded to 12: each rank's gather
    is a reduce-scatter over the candidates), gathered on the host in one
    process."""
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
        # the candidate-parallel gather: this rank's block of 12 padded candidates
        padded = torch.cat([rows, rows[:, :1]], 1)
        split = mesh.candidate_split()
        lo, hi = split.bounds(padded.shape[1])
        want_block = np.concatenate([want_rows, want_rows[:, :1]], 1)[:, lo:hi]
        got = store.gather(names, padded, split)
        out["block_gather_bit_equal"] = all(
            np.array_equal(g.numpy(), np.asarray(tables[k])[want_block].astype(g.numpy().dtype))
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


def serve_cfg(store: str):
    """``tests/test_serve.py``'s served store: tiny WikiMEL DRIN in f32,
    C = 8 (a model axis of 2 divides it), 25 entities."""
    from drin_tpu_torch.data.synthetic import tiny_config

    return tiny_config("wikimel", "drin", preprocess_dir=store).replace(compute_dtype="float32")


def _served(spec):
    from drin_tpu_torch.data.dataset import MELFeatureDataset, load_wikimel_entity_tables

    cfg = serve_cfg(spec["serve"])
    tables = load_wikimel_entity_tables(cfg)
    ds = MELFeatureDataset(cfg, "train", tables)
    batch = ds.drin_rows_batch(np.arange(4))
    b3 = ds.drin_rows_batch(np.arange(3))
    params = torch.load(spec["serve_weights"], weights_only=True)
    return cfg, tables, batch, b3, params


def scenario_serve_rows(spec, mesh):
    """A Ranker over the served store row-sharded on the model axis:
    ``tests/test_serve.py::test_ranker_over_row_sharded_store`` and
    ``::test_save_load_bundle_roundtrip``'s checks, every rank in lockstep."""
    from drin_tpu_torch.data.device_store import DeviceEntityStore
    from drin_tpu_torch.parallel import collectives
    from drin_tpu_torch.serve import Ranker

    cfg, tables, batch, b3, params = _served(spec)
    r = Ranker(cfg, params, tables, device="cpu")
    base4, base3 = r.score(batch[:-1]), r.score(b3[:-1])
    store = DeviceEntityStore(cfg, tables, device="cpu", dtype=torch.float32, mesh=mesh,
                              shard_rows=True)
    r.set_store(store, tables)
    n = int(tables["entity_text_feature"].shape[0])
    scattered = []  # the gather's reduce-scatters over the candidates in one score
    plain_scatter = collectives.reduce_scatter_exact_
    collectives.reduce_scatter_exact_ = lambda *a, **k: scattered.append(1) or plain_scatter(*a, **k)
    try:
        score4 = r.score(batch[:-1]).tolist()
    finally:
        collectives.reduce_scatter_exact_ = plain_scatter
    out = {"n_rows": store.n_rows, "block": store.block, "text_rows": int(store.text.shape[0]),
           "split": bool(scattered), "base4": base4.tolist(), "base3": base3.tolist(),
           "score4": score4, "score3": r.score(b3[:-1]).tolist()}
    s, i = r.rank(b3[:-1], k=3)
    out["rank3"] = [s.tolist(), i.tolist()]
    rt = r._ensure_retrieval_table()
    out["retrieval_rows"] = int(rt.shape[0])
    out["retrieval_finite"] = bool(torch.isfinite(rt).all())
    q = np.asarray(tables["entity_text_feature"][[3, 17], 0])
    out["retrieve"] = {}
    for mode in ("exact", "approx", "int8"):
        rs, ri = r.retrieve(q, k=5, mode=mode)
        out["retrieve"][mode] = [rs.tolist(), ri.tolist()]
    path = os.path.join(spec["scratch"], "bundle-sharded")
    r.save_bundle(path)
    r4 = Ranker.from_bundle(path, device="cpu")
    out["bundle"] = {"n_rows": r4.store.n_rows, "text_rows": int(r4.store.text.shape[0]),
                     "obj_score_rows": int(r4.store.obj_score.shape[0]),
                     "score4": r4.score(batch[:-1]).tolist(),
                     "obj_score_equal": bool(np.array_equal(
                         r4.store.obj_score.numpy(),
                         np.asarray(tables["entity_object_score"], np.float32)))}
    assert n == out["n_rows"]
    return out


def _http(url, path, obj=None, timeout=60):
    """(status, JSON body) of a GET (obj None) or a POST."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _refused(address, wait_s: float = 30.0) -> bool:
    """Whether a connection to ``address`` is refused within ``wait_s``
    (the front closes its socket just after its serving loop ends)."""
    import socket
    import time

    end = time.monotonic() + wait_s
    while time.monotonic() < end:
        try:
            socket.create_connection(address, timeout=5).close()
        except ConnectionRefusedError:
            return True
        time.sleep(0.1)
    return False


def scenario_http_front(spec, mesh):
    """The HTTP front over the row-sharded served store: the first rank
    serves /rank (B=1), /retrieve and /stats and leads, the other follows,
    and ``server.stop()`` ends both.  Then a follower that fails: the front
    answers 500 and stops with ``server.fault`` set; the follower leaves
    the process group (as its process would by exiting).  Run it last: the
    group is gone after it."""
    import torch.distributed as dist

    from drin_tpu_torch.serve import Ranker, _encode_arrays, rank_feat_fields, serve_http

    cfg, tables, batch, b3, params = _served(spec)
    want = Ranker(cfg, params, tables, device="cpu").rank(tuple(x[:1] for x in batch[:-1]), k=3)
    out = {}
    for mode in ("clean", "fault"):
        r = Ranker(cfg, params, tables, device="cpu", store_mesh=mesh)
        fields = rank_feat_fields(r)
        if mesh.model_index != 0:
            if mode == "fault":
                def planted(*a, **kw):
                    raise RuntimeError("planted follower fault")

                r._rank = planted
                try:
                    serve_http(r, port=0, feat_fields=fields)
                except RuntimeError as e:
                    out[mode] = {"raised": str(e)}
                    dist.destroy_process_group()  # what the follower's exit does
                continue
            out[mode] = {"returned": serve_http(r, port=0, feat_fields=fields)}
            continue
        server = serve_http(r, port=0, feat_fields=fields)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        feats = _encode_arrays({name: np.asarray(v)[:1] for name, v in zip(fields, batch[:-1])})
        res = {"rank": _http(url, "/rank", {"features": feats, "k": 3})}
        if mode == "clean":
            q = np.asarray(tables["entity_text_feature"][[3, 17], 0], np.float32)
            res["retrieve"] = _http(url, "/retrieve", {"query": _encode_arrays({"q": q}), "k": 5})
            res["stats"] = _http(url, "/stats")
            res["bad"] = _http(url, "/rank", {"features": feats, "k": 99})
            server.stop()
        res["stopped"] = server.stopped.wait(60)
        res["fault"] = None if server.fault is None else str(server.fault)
        if mode == "fault":
            res["refused"] = _refused(server.server_address)
            server.stop()
        out[mode] = res
    out["want"] = [want[0].tolist(), want[1].tolist()]
    return out


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
        distributed.shutdown()  # a no-op where a scenario left the group
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
