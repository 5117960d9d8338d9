# -*- coding: utf-8 -*-
"""Training GHMFC with online BERT from raw text, against ``drin_tpu``:
``WindowedProfiler``'s start/stop sequence and cycle directories against the
JAX profiler's over the same steps and chunks (``jax.profiler`` recorded, not
run), a real trace on the CPU, SIGTERM in a train epoch and during
validation, ``save(wait=False)`` holding the parameters of the step it was
taken at, the training entry point's online path end to end, and a
two-chunk ``fit`` trajectory against the JAX ``Trainer`` over the JAX
``OnlineMELDataset`` from the same converted weights."""

import copy
import dataclasses
import glob
import json
import multiprocessing
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.data import online as jonline
from drin_tpu.data import synthetic as jsyn
from drin_tpu.encoders.bert import BertConfig as JaxBertConfig
from drin_tpu.models.ghmfc import GHMFCOnline as JaxGHMFCOnline
from drin_tpu.train import trainer as jtrainer
from drin_tpu_torch.common.config import make_config
from drin_tpu_torch.data import online as tonline
from drin_tpu_torch.data import synthetic as tsyn
from drin_tpu_torch.encoders.bert import BertConfig, BertModel
from drin_tpu_torch.models import get_model
from drin_tpu_torch.models.convert import ghmfc_online_state_dict_from_jax
from drin_tpu_torch.train import metrics as TM
from drin_tpu_torch.train import trainer as ttrainer
from drin_tpu_torch.train.cli import main as train_main


def _port_cfg(cfg):
    d = dataclasses.asdict(cfg)
    return make_config(d.pop("model_type"), d.pop("dataset_name"), **d)


def _bert_dims(vocab):
    return dict(vocab_size=len(vocab), hidden_size=16, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=32, max_position_embeddings=32)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The tiny raw-text store (8 train, 2 valid, 2 test mentions; C=3),
    written by the port, with its config and vocab."""
    d = str(tmp_path_factory.mktemp("online-store"))
    cfg, tok = tsyn.make_synthetic_online_store(d, n=8, C=3, max_len=32)
    cfg = cfg.replace(batch_size=4, metrics_topk=(1, 2), transformer_dropout=0.0,
                      mention_final_output_dim=16, entity_final_output_dim=16)
    return d, cfg, tok.vocab


def _trainer(cfg, vocab, **kw):
    model, kind = get_model(cfg, torch.Generator().manual_seed(0),
                            bert_cfg=BertConfig(**_bert_dims(vocab)))
    return ttrainer.Trainer(cfg, model, device="cpu", log=lambda *a: None, **kw), kind


def _datasets(cfg, vocab):
    from drin_tpu_torch.text.wordpiece import BertTokenizer

    tok = BertTokenizer(vocab=vocab, model_max_length=cfg.max_bert_len)
    return [tonline.OnlineMELDataset(cfg, s, tokenizer=tok) for s in ("train", "valid", "test")]


# ------------------------------------------------------------- the profiler


def _drive(make, chunks):
    """What ``fit`` does with the profiler: one instance for the run,
    ``begin_fit`` at later chunks, before/after each train step, ``stop``
    at the end of a chunk."""
    prof = None
    for steps in chunks:
        if prof is None:
            prof = make()
        else:
            prof.begin_fit()
        for _ in range(steps):
            prof.before_step()
            prof.after_step()
        prof.stop()


SCHEDULES = [((1, 1, 3, 2), (4, 4, 4)), ((0, 0, 2, 3), (5, 1, 3)), ((2, 0, 1, 1), (2, 3, 3)),
             ((1, 1, 3, 2), (2, 2, 9)), ((1, 1, 0, 2), (3, 2)), ((1, 1, 3, 0), (2, 1))]


@pytest.mark.parametrize("schedule,chunks", SCHEDULES,
                         ids=[f"{'-'.join(map(str, s))}@{'-'.join(map(str, c))}"
                              for s, c in SCHEDULES])
def test_windowed_profiler_matches_jax(tmp_path, monkeypatch, schedule, chunks):
    wait, warmup, active, repeat = schedule
    kw = dict(profile_wait=wait, profile_warmup=warmup, profile_active=active,
              profile_repeat=repeat)
    calls = {"jax": [], "port": []}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda path: calls["jax"].append(("start", os.path.relpath(path, jdir))))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: calls["jax"].append(("stop",)))
    monkeypatch.setattr(ttrainer.WindowedProfiler, "_start_trace",
                        lambda self, path: calls["port"].append(
                            ("start", os.path.relpath(path, tdir))))
    monkeypatch.setattr(ttrainer.WindowedProfiler, "_stop_trace",
                        lambda self: calls["port"].append(("stop",)))
    jcfg = jsyn.tiny_config("wikimel", "ghmfc", preprocess_dir="unused", profile_dir=jdir, **kw)
    _drive(lambda: jtrainer.WindowedProfiler(jcfg), chunks)
    _drive(lambda: ttrainer.WindowedProfiler(_port_cfg(jcfg).replace(profile_dir=tdir), "cpu"),
           chunks)
    assert calls["port"] == calls["jax"]
    assert calls["port"], "the schedule traced nothing"
    starts = [c[1] for c in calls["port"] if c[0] == "start"]
    if active and repeat:
        assert starts == [f"cycle{i}" for i in range(len(starts))] and len(starts) <= repeat
    else:
        assert set(starts) == {"."}  # the whole fit, into the directory itself


def test_profiler_writes_a_trace_on_the_cpu(store, tmp_path):
    d, cfg, vocab = store
    cfg = _port_cfg(cfg).replace(profiling=True, profile_dir=str(tmp_path / "prof"),
                                 profile_wait=0, profile_warmup=1, profile_active=1,
                                 profile_repeat=2)
    tr, kind = _trainer(cfg, vocab)
    train, valid, _ = _datasets(cfg, vocab)
    tr.fit(train, valid, 2, kind=kind)  # 2 train steps an epoch: one traced per epoch
    assert sorted(os.listdir(tmp_path / "prof")) == ["cycle0", "cycle1"]
    for cycle in ("cycle0", "cycle1"):
        (trace,) = glob.glob(str(tmp_path / "prof" / cycle / "*.pt.trace.json"))
        with open(trace) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        assert "aten::mm" in names or "aten::addmm" in names, sorted(names)[:20]
    assert not tr._profiler.tracing and tr._profiler.cycles == 2


# --------------------------------------------------------------- preemption


class _Signaling:
    """A dataset that sends SIGTERM to this process as its ``at``-th batch is
    assembled (in the prefetcher's thread, as a real signal arrives)."""

    def __init__(self, ds, at=0, repeat=1):
        self.ds, self.at, self.repeat, self.calls = ds, at, repeat, 0

    def make_batch(self, idx, kind):
        if self.calls == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        self.calls += 1
        return self.ds.make_batch(np.asarray(idx) % len(self.ds), kind)

    def __len__(self):
        return self.repeat * len(self.ds)


@pytest.mark.parametrize("during", ["train", "valid"])
def test_sigterm_saves_at_the_step_and_stops(store, tmp_path, during):
    d, cfg, vocab = store
    cfg = _port_cfg(cfg).replace(enable_checkpointing=True, checkpoint_dir=str(tmp_path / "ck"))
    tr, kind = _trainer(cfg, vocab)
    train, valid, _ = _datasets(cfg, vocab)
    before = signal.getsignal(signal.SIGTERM)
    if during == "train":
        train = _Signaling(train)
    else:
        valid = _Signaling(valid, repeat=32)  # long enough that draining it would show
    with pytest.raises(KeyboardInterrupt):
        tr.fit(train, valid, 5, kind=kind)
    assert signal.getsignal(signal.SIGTERM) is before  # the handlers are put back
    assert tr.epoch == 0  # stopped inside the first epoch
    step = tr.state.step
    if during == "train":
        assert 1 <= step < 2  # the signalled step ran, the epoch's second did not
    else:
        assert step == 2  # the train epoch was whole
        # the valid pass broke at a step boundary (the prefetcher may have
        # assembled a few batches past the signalled one)
        assert valid.calls <= 2 + cfg.prefetch_depth < len(valid) // cfg.batch_size
    assert os.listdir(tmp_path / "ck") == [f"step_{step}.pt"]
    resumed, _ = _trainer(cfg, vocab)  # picks up the checkpoint of that step
    assert resumed.epoch == 0 and resumed.state.step == step
    for (k, a), b in zip(tr.state.model.state_dict().items(),
                         resumed.state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_async_save_holds_the_step_it_was_taken_at(store, tmp_path, monkeypatch):
    d, cfg, vocab = store
    cfg = _port_cfg(cfg).replace(enable_checkpointing=True, checkpoint_dir=str(tmp_path / "ck"),
                                 finetune_bert=True)
    tr, kind = _trainer(cfg, vocab)
    train = _datasets(cfg, vocab)[0]
    valid = np.ones(4, np.float32)
    batches = [tr._assemble(train, kind, idx, valid) for idx in (np.arange(4), np.arange(4, 8))]
    mstate = TM.init_state(cfg.metrics_topk)
    tr.state, _, mstate = tr.fns.train_step(tr.state, *batches[0], mstate)
    want = copy.deepcopy(tr.state.model.state_dict())
    want_adam = copy.deepcopy(tr.state.optimizer.state_dict())
    # hold the write until the next step has updated the parameters in place
    held, release, real_save = threading.Event(), threading.Event(), torch.save

    def slow_save(obj, f, *a, **k):
        held.set()
        assert release.wait(60)
        return real_save(obj, f, *a, **k)

    monkeypatch.setattr(torch, "save", slow_save)
    tr.save(wait=False)
    assert held.wait(60) and tr._writer.is_alive()
    tr.state, _, mstate = tr.fns.train_step(tr.state, *batches[1], mstate)
    moved = [k for k, v in tr.state.model.state_dict().items() if not torch.equal(v, want[k])]
    assert len(moved) > 10 and any(k.startswith("bert.") for k in moved)
    release.set()
    tr.wait_until_finished()
    payload = torch.load(tmp_path / "ck" / "step_1.pt", weights_only=True)
    assert payload["step"] == 1 and payload["epoch"] == 0
    for k, v in want.items():
        assert torch.equal(payload["params"][k], v), k
    for i, s in want_adam["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(payload["opt_state"]["state"][i][name], s[name]), (i, name)
    # a failed background write is raised where it is waited for
    monkeypatch.setattr(torch, "save", lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    tr.save(wait=False)
    with pytest.raises(RuntimeError, match="writing the checkpoint failed") as err:
        tr.wait_until_finished()
    assert isinstance(err.value.__cause__, OSError)
    tr.wait_until_finished()  # raised once


# ---------------------------------------------------------- the entry point


def test_train_entry_online_path(store, tmp_path, capsys, monkeypatch):
    """``python -m drin_tpu_torch.train`` on a raw-text store: a pretrained
    BERT from an HF-style directory (frozen here, so it must come out of
    training as it went in), the tokenizer pools, checkpoints and profiler
    cycles, two fit/test rounds; the pools are gone afterwards."""
    d, cfg, vocab = store
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    bert_dir = tmp_path / "bert"
    bert_dir.mkdir()
    dims = _bert_dims(vocab)
    bert = BertModel(BertConfig(**dims), generator=torch.Generator().manual_seed(5))
    torch.save(bert.state_dict(), bert_dir / "pytorch_model.bin")
    (bert_dir / "config.json").write_text(json.dumps(dims))
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    args = {"model_type": "ghmfc", "dataset_name": "wikimel", "preprocess_dir": d,
            "dataset_root": "unused", "online_bert": True, "finetune_bert": False,
            "bert_remat": True, "bert_checkpoint": str(bert_dir), "bert_vocab": str(vocab_file),
            "num_candidates_data": cfg.num_candidates_data, "max_bert_len": cfg.max_bert_len,
            "num_entity_sentence": 2, "online_length_buckets": 4,
            "mention_final_layer_name": "linear", "entity_final_layer_name": "linear",
            "qid2entity_path": cfg.qid2entity_path, "qid2attr_path": cfg.qid2attr_path,
            "bert_embed_dim": 16, "mention_final_output_dim": 16, "entity_final_output_dim": 16,
            "max_mention_sentence_len": 12, "batch_size": 4, "metrics_topk": (1, 2),
            "num_epoch": 2, "test_epoch_interval": 1, "dataloader_workers": 2,
            "enable_checkpointing": True, "checkpoint_dir": str(tmp_path / "ck"),
            "profiling": True, "profile_dir": str(tmp_path / "prof"), "profile_wait": 0,
            "profile_warmup": 1, "profile_active": 1, "device": "cpu"}
    tr = train_main([f"{k}={v}" for k, v in args.items()])
    out = capsys.readouterr().out
    assert out.count("train epoch") == 4 and out.count("valid epoch") == 4
    assert out.count("test epoch") == 4 and "pairs/s" in out
    assert f"BERT loaded from {bert_dir}" in out and "device: cpu" in out
    assert out.count("tokenizer pool: 2 spawn workers") == 3
    assert not multiprocessing.active_children()  # every pool closed
    for k, v in bert.state_dict().items():
        assert torch.equal(tr.state.model.bert.state_dict()[k], v), k
    assert tr.state.step == 4 and sorted(os.listdir(tmp_path / "ck")) == ["step_2.pt", "step_4.pt"]
    assert sorted(os.listdir(tmp_path / "prof")) == ["cycle0", "cycle1"]
    assert glob.glob(str(tmp_path / "prof" / "cycle1" / "*.pt.trace.json"))


# ------------------------------------------------------ the two-chunk fit


def test_two_chunk_fit_matches_jax(store):
    """Two fit/test chunks of one epoch each, fine-tuning BERT, from the same
    weights (flax params, converted) over each package's own dataset of the
    same store: epoch losses and accuracies, and the weights after, in
    float32 at rtol 2e-4.  The JAX steps run jitted."""
    d, cfg, vocab = store
    jcfg = _jax_cfg(cfg).replace(finetune_bert=True, shuffle_train_data=True)
    pcfg = _port_cfg(jcfg)
    dims = _bert_dims(vocab)
    jtok = jsyn.make_synthetic_online_store(d, n=8, C=3, max_len=32, write=False)[1]
    jds = [jonline.OnlineMELDataset(jcfg, s, tokenizer=jtok) for s in ("train", "valid", "test")]
    model = JaxGHMFCOnline(jcfg, JaxBertConfig(**dims))
    example = jds[0].online_batch(np.arange(2))
    params = jax.tree.map(np.asarray, model.init(jax.random.key(3), example[:-1])["params"])
    jtr = jtrainer.Trainer(jcfg, lambda p, f: model.apply({"params": p}, f),
                           jax.tree.map(jnp.asarray, params), log=lambda *a: None)
    ours, kind = get_model(pcfg, bert_cfg=BertConfig(**dims))
    ours.load_state_dict(ghmfc_online_state_dict_from_jax(params, pcfg, BertConfig(**dims)))
    ttr = ttrainer.Trainer(pcfg, ours, device="cpu", log=lambda *a: None)
    tds = _datasets(pcfg, vocab)
    for _ in range(2):
        want = jtr.fit(jds[0], jds[1], 1, kind="online") + [jtr.test(jds[2], kind="online")]
        got = ttr.fit(tds[0], tds[1], 1, kind="online") + [ttr.test(tds[2], kind="online")]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=2e-4, atol=1e-6)
            assert g["accs"] == w["accs"]
    assert ttr.state.step == int(jtr.state.step) == 4
    final = ghmfc_online_state_dict_from_jax(jax.device_get(jtr.state.params), pcfg,
                                             BertConfig(**dims))
    for k, v in ttr.state.model.state_dict().items():
        if k.endswith("attention.self.key.bias"):
            # its exact gradient is 0 (a constant added to every key leaves
            # the softmax as it is): both sides hold rounding noise, which
            # Adam turns into steps of the learning rate's size
            assert float(v.abs().max()) < 4 * pcfg.learning_rate, k
            continue
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), rtol=2e-4,
                                   atol=2e-4 * float(final[k].abs().max()) + 1e-6, err_msg=k)


def _jax_cfg(cfg):
    from drin_tpu.common.config import make_config as jax_make_config

    d = dataclasses.asdict(cfg)
    return jax_make_config(d.pop("model_type"), d.pop("dataset_name"), **d)
