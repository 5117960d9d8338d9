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


def _fit_and_test(cfg, model, kind, datasets, mesh, feats_fn=None, dump=None, logs=None):
    from drin_tpu_torch.train.trainer import Trainer

    train, valid, test = datasets
    tr = Trainer(cfg, model, device="cpu", log=(lambda *a: None) if logs is None else logs.append,
                 mesh=mesh, feats_fn=feats_fn, output_test_result_path=dump or "unused")
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
    if logs is not None:
        out.update(cand_pad=tr._cand_pad, split=tr._split is not None,
                   logs=[" ".join(str(a) for a in x) if isinstance(x, tuple) else str(x)
                         for x in logs])
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
        except ConnectionResetError:
            pass  # accepted into the backlog as the socket closed: ask again
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


# ---------------------------------------------------------------------------
# the baselines over the model axis: offline GHMFC and MELHI on WikiDiverse
# with C = 10 padded to 12 over 4 ranks (3 candidates a rank, rank 3 holding
# candidate 9 and two fakes), the JAX package's
# test_baseline_padding_on_mesh_matches_single setup


def baseline_cfg(store: str, model_type: str):
    """Tiny WikiDiverse GHMFC or MELHI, C = 10.  MELHI's thresholds make
    the image gate turn on the candidates' images alone (``melhi_gate_store``
    lays them out): every text-image cosine clears ``thres_tmim``, and a
    candidate opens the gate at a mention-image cosine above -0.5."""
    from drin_tpu_torch.data.synthetic import tiny_config

    return tiny_config("wikidiverse", model_type, preprocess_dir=store).replace(
        num_candidates_data=9, metrics_topk=(1, 5), batch_size=4, transformer_dropout=0.0,
        thres_tmim=-2.0, thres_imie=-0.5)


def melhi_gate_store(store: str, C: int):
    """Rewrite a WikiDiverse store's candidate images so that MELHI's gate
    depends on where its open candidate lies: for mention i, i % 3 == 0,
    every candidate's image is the negated mean mention image (cosine -1,
    closed) but candidate C - 1's, which is the mean image itself (cosine 1,
    open): on a model axis of 4 it lies in the last rank's block alone;
    i % 3 == 1, every candidate closed (an unmasked padded candidate, whose
    zero image gives cosine 0, would open it); i % 3 == 2, random images."""
    for split in ("train", "valid", "test"):
        mention = np.load(os.path.join(store, f"mention-image-feature_{split}.npy")).mean(1)
        path = os.path.join(store, f"entity-image-feature_{split}.npy")
        ent = np.load(path)
        ent = ent.reshape(len(mention), C, *ent.shape[1:])
        for i, m in enumerate(mention):
            if i % 3 == 2:
                continue
            ent[i] = -m.reshape(ent.shape[2:])
            if i % 3 == 0:
                ent[i, C - 1] = m.reshape(ent.shape[2:])
        np.save(path, ent.reshape(-1, *ent.shape[2:]))


def planted_baseline_fault(fault, width: int = 1):
    """A context with one planted fault of the baselines' candidate-parallel
    compute: ``noor``, MELHI's gate without its OR over the model group;
    ``localmask``, MELHI's padded candidates masked at the block's local
    indices; ``gsum``, the score gather's backward summing the gradient over
    the group in place of keeping its block; ``replicated``, the loss
    backpropagated by the replicated rule (over the model width) while the
    entity side is split (``width``: the model axis's)."""
    import contextlib

    from drin_tpu_torch.models.melhi import MELHI
    from drin_tpu_torch.parallel import collectives as coll

    @contextlib.contextmanager
    def ctx():
        saved = coll.any_over, MELHI.similarities, coll.gather_blocks, torch.Tensor.backward
        if fault == "noor":
            coll.any_over = lambda flag, group: flag
        elif fault == "localmask":
            MELHI.similarities = lambda self, mf, mi, ei, split=None: saved[1](self, mf, mi, ei)
        elif fault == "gsum":
            def summed(x, group, order=None, dim=1):
                return coll.gather_rows(x.transpose(0, dim).contiguous(), group,
                                        order).transpose(0, dim)

            coll.gather_blocks = summed
        elif fault == "replicated":
            def over_width(loss, *a, **kw):
                return saved[3](loss / width, *a, **kw)

            torch.Tensor.backward = over_width
        try:
            yield
        finally:
            coll.any_over, MELHI.similarities, coll.gather_blocks, torch.Tensor.backward = saved

    return ctx()


def _baseline_cand(spec, mesh, model_type, fault=None):
    from drin_tpu_torch.data.dataset import create_datasets
    from drin_tpu_torch.models import get_model

    cfg = baseline_cfg(spec["base_cand"], model_type)
    datasets = create_datasets(cfg)
    weights = torch.load(spec[f"{model_type}_weights"], weights_only=True)
    with planted_baseline_fault(fault):
        model, kind = get_model(cfg)
        model.load_state_dict(weights)
        grads = first_step_grads(cfg, model, kind, datasets[0], mesh)
        if fault is not None:  # the first step's gradients are the check it must fail
            return {"grads": grads}
        model.load_state_dict(weights)
        out = _fit_and_test(cfg, model, kind, datasets, mesh, logs=[])
    out["grads"] = grads
    return out


def scenario_ghmfc_cand(spec, mesh):
    """Offline GHMFC candidate-parallel, C = 10 padded to 12."""
    return _baseline_cand(spec, mesh, "ghmfc")


def scenario_melhi_cand(spec, mesh):
    """MELHI candidate-parallel, C = 10 padded to 12, its gate ORed over the
    model group."""
    return _baseline_cand(spec, mesh, "melhi")


def scenario_ghmfc_cand_gsum(spec, mesh):
    return _baseline_cand(spec, mesh, "ghmfc", fault="gsum")


def scenario_melhi_cand_noor(spec, mesh):
    return _baseline_cand(spec, mesh, "melhi", fault="noor")


def scenario_melhi_cand_localmask(spec, mesh):
    return _baseline_cand(spec, mesh, "melhi", fault="localmask")


def ghmfc_rows_args(store: str, mesh) -> list:
    """The training entry point's arguments for tiny WikiMEL GHMFC over
    token-level tables (C = 11): row-sharded over a model axis of 2 on a
    mesh (candidate-parallel, C padded to 12), gathered on the host in one
    process."""
    args = dict(model_type="ghmfc", dataset_name="wikimel", preprocess_dir=store,
                dataset_root="unused", num_candidates_data=10, metrics_topk=(1, 5),
                bert_embed_dim=16, resnet_embed_dim=24, gcn_embed_dim=16,
                mention_final_output_dim=16, entity_final_output_dim=16,
                max_mention_sentence_len=12, max_entity_attr_token_len=8, resnet_num_region=4,
                batch_size=8, transformer_num_layers=2, transformer_num_heads=2,
                transformer_ffn_hidden_size=16, num_epoch=FIT_EPOCHS, test_epoch_interval=FIT_EPOCHS,
                transformer_dropout=0.0, cache_entity_pooling="false",
                device="cpu")
    if mesh is not None:
        import torch.distributed as dist

        args.update(num_processes=mesh.size, process_id=dist.get_rank(),
                    coordinator_address="unused:0", mesh_data=1, mesh_model=mesh.size)
    return [f"{k}={v}" for k, v in args.items()]


def scenario_ghmfc_rows_cand(spec, mesh):
    """Offline GHMFC through ``cli.main`` over WikiMEL's token-level tables:
    row-sharded over the model axis on a mesh (each gather a reduce-scatter
    that keeps this rank's block of the 12 padded candidates)."""
    from drin_tpu_torch.parallel import collectives
    from drin_tpu_torch.train import cli
    from drin_tpu_torch.train.trainer import Trainer

    epochs, scattered = [], []
    plain_epoch, plain_scatter = Trainer._run_epoch, collectives.reduce_scatter_exact_

    def recording(self, dataset, split, train, kind):
        r = plain_epoch(self, dataset, split, train, kind)
        epochs.append({"split": split, "loss": r["loss"],
                       "accs": {str(k): v for k, v in r["accs"].items()}})
        return r

    Trainer._run_epoch = recording
    collectives.reduce_scatter_exact_ = lambda *a, **k: scattered.append(1) or plain_scatter(*a, **k)
    try:
        tr = cli.main(ghmfc_rows_args(spec["wm"], mesh))
    finally:
        Trainer._run_epoch, collectives.reduce_scatter_exact_ = plain_epoch, plain_scatter
    tests = [e for e in epochs if e["split"] == "test"]
    return {"epochs": epochs, "test_loss": tests[-1]["loss"], "test_accs": tests[-1]["accs"],
            "digest": digest(tr.state.model.state_dict()), "step": tr.state.step,
            "cand_pad": tr._cand_pad, "split": tr._split is not None, "scattered": len(scattered)}


# the online GHMFC over the model axis: BERT and the batch of
# tests/test_multichip.py::test_online_ghmfc_on_mesh_matches_single_device
ONLINE_MESH_BERT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                        intermediate_size=32, max_position_embeddings=64)


def online_mesh_cfg(zipped_sentences: int = 0, C: int = 7):
    """Tiny online GHMFC, fine-tuned: direct mode (C = 7, padded to 8 over a
    model axis of 2, as the JAX test's one padded candidate) or zipped into
    ``zipped_sentences`` sentences of 32 tokens (C = 8)."""
    from drin_tpu_torch.data.synthetic import tiny_config

    return tiny_config("wikimel", "ghmfc", preprocess_dir="unused-online-mesh").replace(
        num_candidates_data=C - 1, batch_size=8, metrics_topk=(1, 5), online_bert=True,
        num_entity_sentence=zipped_sentences, finetune_bert=True,
        mention_final_layer_name="linear", max_mention_sentence_len=16, max_bert_len=32,
        max_entity_attr_token_len=12, transformer_dropout=0.0, learning_rate=3e-3)


def online_mesh_batch(cfg, seed: int = 31):
    """A seeded ``OnlineBatch`` of B = 8 (answer included): 24 mention
    tokens, candidates of 4-11 tokens per candidate (direct) or of 4-7
    zipped."""
    from drin_tpu_torch.data.online import OnlineBatch, zip_entities

    rng = np.random.default_rng(seed)
    B, C, V, Lm, Le = cfg.batch_size, cfg.num_candidates_model, 64, 24, cfg.max_entity_attr_token_len
    mids, mmask = np.zeros((B, Lm), np.int64), np.zeros((B, Lm), np.int64)
    for b in range(B):
        n = rng.integers(8, Lm)
        mids[b, 0], mids[b, 1:n - 1], mids[b, n - 1] = 1, rng.integers(5, V, n - 2), 2
        mmask[b, :n] = 1
    longest = 6 if cfg.num_entity_sentence else Le - 1  # three texts fill a zipped sentence
    texts = [[[1] + list(rng.integers(5, V, rng.integers(2, longest))) + [2] for _ in range(C)]
             for _ in range(B)]
    if cfg.num_entity_sentence:
        packed = [zip_entities(t, cfg.num_entity_sentence, cfg.max_bert_len, 1) for t in texts]
        eids, emask, sep = (np.stack(x) for x in zip(*packed))
    else:
        eids, emask = np.zeros((B, C, Le), np.int64), np.zeros((B, C, Le), np.int64)
        for b in range(B):
            for c, t in enumerate(texts[b]):
                eids[b, c, :len(t)], emask[b, c, :len(t)] = t, 1
        sep = np.zeros((B,), np.int64)
    answer = np.eye(C, dtype=np.float32)[rng.integers(0, C - 1, B)][:, :-1]
    return OnlineBatch(mids, mmask, np.full((B,), 2, np.int64), np.full((B,), 4, np.int64),
                       rng.standard_normal((B, 4, cfg.resnet_embed_dim)).astype(np.float32),
                       eids, emask, sep, np.zeros((B,), np.float32), answer)


class _Fixed:
    """A dataset of one fixed batch, for ``Trainer._assemble``."""

    def __init__(self, batch):
        self.batch = batch

    def make_batch(self, idx, kind):
        return type(self.batch)(*(np.asarray(x)[idx] for x in self.batch))


def online_step(cfg, model, batch, mesh, fault=None) -> dict:
    """One train step of the online model on ``batch`` through the
    Trainer's assembly (padding and slicing): the global loss, the counters
    summed over the data group, the gradient Adam took, and the scores of
    this rank's rows after the step."""
    from drin_tpu_torch.train import metrics as M
    from drin_tpu_torch.train.trainer import Trainer

    B = cfg.batch_size
    tr = Trainer(cfg, model, device="cpu", log=lambda *a: None, mesh=mesh)
    b, v = tr._assemble(_Fixed(batch), "online", np.arange(B), np.ones((B,), np.float32))
    with planted_baseline_fault(fault, mesh.shape["model"] if mesh is not None else 1):
        tr.state, loss, mstate = tr.fns.train_step(tr.state, b, v, M.init_state(cfg.metrics_topk, "cpu"))
    grads = {name: p.grad.reshape(-1).tolist() for name, p in tr.state.model.named_parameters()
             if p.grad is not None}
    _, _, scores = tr.fns.eval_step(b, v, M.init_state(cfg.metrics_topk, "cpu"))
    return {"loss": float(loss), "counters": {k: float(x) for k, x in tr._reduced(mstate).items()},
            "grads": grads, "scores": scores.tolist(), "rows": list(tr._rows),
            "cand_pad": tr._cand_pad, "split": tr._split is not None}


def _online_mesh_model(cfg, weights=None):
    from drin_tpu_torch.encoders.bert import BertConfig
    from drin_tpu_torch.models import get_model

    model, kind = get_model(cfg, torch.Generator().manual_seed(0),
                            bert_cfg=BertConfig(**ONLINE_MESH_BERT))
    assert kind == "online"
    if weights is not None:
        model.load_state_dict(torch.load(weights, weights_only=True))
    return model


def scenario_online_cand(spec, mesh):
    """Direct mode, C = 7 padded to 8: each rank's BERT encodes its 4
    candidates of its rows (rank 1 of a model group one all-masked fake)."""
    cfg = online_mesh_cfg()
    return online_step(cfg, _online_mesh_model(cfg, spec["online_weights"]), online_mesh_batch(cfg),
                       mesh)


def _online_zip(mesh, S, fault=None):
    cfg = online_mesh_cfg(zipped_sentences=S, C=8)
    return online_step(cfg, _online_mesh_model(cfg), online_mesh_batch(cfg), mesh, fault)


def scenario_online_zip(spec, mesh):
    """Zipped mode, S = 4 sentences: 2 a rank on a model axis of 2."""
    return _online_zip(mesh, 4)


def scenario_online_zip3(spec, mesh):
    """Zipped mode, S = 3 sentences, which a model axis of 2 does not
    divide: the model replicates its compute along the axis."""
    return _online_zip(mesh, 3)


def scenario_online_zip_replicated(spec, mesh):
    return _online_zip(mesh, 4, fault="replicated")


def ghmfc_serve_cfg(store: str):
    """``serve_cfg``'s store served by offline GHMFC in f32 (pooled text
    table, C = 8)."""
    from drin_tpu_torch.data.synthetic import tiny_config

    return tiny_config("wikimel", "ghmfc", preprocess_dir=store).replace(compute_dtype="float32")


def scenario_serve_ghmfc_rows(spec, mesh):
    """A GHMFC Ranker over the served store row-sharded on the model axis,
    candidate-parallel, behind the HTTP front: the first rank scores B = 4
    and B = 3 and ranks B = 3 in lockstep and answers /rank B = 1; the other
    follows until the front stops."""
    from drin_tpu_torch.data.dataset import MELFeatureDataset, load_wikimel_entity_tables
    from drin_tpu_torch.parallel import collectives
    from drin_tpu_torch.serve import Ranker, _encode_arrays, rank_feat_fields, serve_http

    cfg = ghmfc_serve_cfg(spec["serve"])
    tables = load_wikimel_entity_tables(cfg)
    ds = MELFeatureDataset(cfg, "train", tables)
    b4, b3 = ds.baseline_rows_batch(np.arange(4)), ds.baseline_rows_batch(np.arange(3))
    params = torch.load(spec["ghmfc_serve_weights"], weights_only=True)
    r = Ranker(cfg, params, tables, device="cpu", store_mesh=mesh)
    fields = rank_feat_fields(r)
    scattered = []
    plain_scatter = collectives.reduce_scatter_exact_
    collectives.reduce_scatter_exact_ = lambda *a, **k: scattered.append(1) or plain_scatter(*a, **k)
    try:
        if mesh.model_index != 0:
            return {"returned": serve_http(r, port=0, feat_fields=fields),
                    "scattered": len(scattered)}
        server = serve_http(r, port=0, feat_fields=fields)
        try:
            out = {"score4": r.score(b4[:-1]).tolist(), "score3": r.score(b3[:-1]).tolist()}
            s, i = r.rank(b3[:-1], k=3)
            out["rank3"] = [s.tolist(), i.tolist()]
            url = f"http://127.0.0.1:{server.server_address[1]}"
            feats = _encode_arrays({name: np.asarray(v)[:1] for name, v in zip(fields, b4[:-1])})
            out["http_rank"] = _http(url, "/rank", {"features": feats, "k": 3})
        finally:
            server.stop()
        out["stopped"] = server.stopped.wait(60)
        out["scattered"] = len(scattered)
        return out
    finally:
        collectives.reduce_scatter_exact_ = plain_scatter


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
