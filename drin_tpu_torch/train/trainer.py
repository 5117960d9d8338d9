# -*- coding: utf-8 -*-
"""Train/eval harness on one device (port of ``drin_tpu/train/trainer.py``).

  * ``train_step`` / ``eval_step`` hold the model forward, the triplet loss,
    the Adam update and the metric counters; the counters stay on the device
    and are read on the host at log time only,
  * float32 master parameters with the model body in ``cfg.compute_dtype``:
    every float parameter and feature is cast for the forward, the scores
    come back as float32, and the gradients land in the masters (this is
    what the JAX step does; ``torch.autocast`` is a different thing),
  * checkpoints keyed by global step (``torch.save``) behind
    ``cfg.enable_checkpointing``; ``fit``'s per-epoch saves are written by a
    background thread from a host copy taken at the step boundary, and
    SIGTERM / SIGINT during ``fit`` save at the next step boundary and stop,
  * ``torch.profiler`` traces in step windows behind ``cfg.profiling``
    (:class:`WindowedProfiler`).

Not ported yet: everything multi-device.
"""

from __future__ import annotations

import datetime
import os
import re
import sys
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from drin_tpu_torch.common.config import Config
from drin_tpu_torch.data.prefetch import Prefetcher
from drin_tpu_torch.train import metrics as M
from drin_tpu_torch.train.loss import triplet_loss


class TrainState:
    """The model (float32 master parameters), its optimizer and the global
    step count.  Steps update it in place."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int = 0):
        self.model, self.optimizer, self.step = model, optimizer, step


def make_optimizer(model: torch.nn.Module, cfg: Config) -> torch.optim.Optimizer:
    """Plain Adam, torch-default betas and eps, over all parameters, BERT's
    left out unless ``cfg.finetune_bert`` (a frozen BERT gets no moment
    buffers and no updates; it runs under ``torch.no_grad()``, so it gets no
    gradient either)."""
    params = [p for name, p in model.named_parameters()
              if cfg.finetune_bert or not name.startswith("bert.")]
    return torch.optim.Adam(params, lr=cfg.learning_rate)


def create_train_state(model: torch.nn.Module, cfg: Config) -> TrainState:
    return TrainState(model, make_optimizer(model, cfg), 0)


class StepFns(NamedTuple):
    train_step: Callable
    eval_step: Callable
    loss_and_metrics: Callable  # (batch, valid, mstate, rng=None) -> (loss, mstate, scores)


def step_generator(cfg: Config, step: int, device) -> torch.Generator:
    """The random stream of one train step, made from ``cfg.seed`` and the
    step count: the same seed and step give the same dropout masks."""
    g = torch.Generator(device=device)
    g.manual_seed((cfg.seed * 1_000_003 + step) % (2 ** 63))
    return g


def build_step_fns(model: torch.nn.Module, cfg: Config,
                   feats_fn: Optional[Callable] = None) -> StepFns:
    """``train_step(state, batch, valid, mstate) -> (state, loss, mstate)``
    and ``eval_step(batch, valid, mstate) -> (loss, mstate, scores)``.

    Steps take the full batch tuple of tensors on the model's device (answer
    last) plus a [B] valid mask for padded ragged batches.  ``feats_fn`` maps
    the raw batch features to model features inside the step (the
    device-resident entity tables' gather, ``data/device_store.py``).  The
    train step runs the model in train mode (attention dropout at
    ``cfg.transformer_dropout`` from the step's generator); eval is always
    deterministic."""
    topk = tuple(cfg.metrics_topk)
    compute_dtype = getattr(torch, cfg.compute_dtype)

    def forward(feats, **kw):
        if compute_dtype == torch.float32:
            return model(feats, **kw)
        # mixed precision: float32 masters, the model body in the compute
        # dtype; the casts are differentiable, so gradients stay float32
        cast = lambda x: x.to(compute_dtype) if x.is_floating_point() else x
        feats = tuple(cast(x) for x in feats)
        weights = {name: cast(p) for name, p in model.named_parameters()}
        return torch.func.functional_call(model, weights, (feats,), kw).float()

    def loss_and_metrics(batch, valid, mstate, rng=None):
        feats, answer = tuple(batch[:-1]), batch[-1]
        if feats_fn is not None:
            feats = feats_fn(feats)
        kw = {} if rng is None else {"deterministic": False, "rng": rng}
        scores = forward(feats, **kw)
        loss = triplet_loss(answer, scores, cfg.triplet_margin, valid)
        mstate = M.add_loss(M.update(mstate, scores, answer, topk, valid), loss)
        return loss, mstate, scores

    def train_step(state: TrainState, batch, valid, mstate):
        rng = step_generator(cfg, state.step, valid.device)
        state.optimizer.zero_grad(set_to_none=True)
        loss, mstate, _ = loss_and_metrics(batch, valid, mstate, rng)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), mstate

    @torch.no_grad()
    def eval_step(batch, valid, mstate):
        # also returns the raw [B, C] scores for the test-result dump
        loss, mstate, scores = loss_and_metrics(batch, valid, mstate)
        return loss, mstate, scores

    return StepFns(train_step, eval_step, loss_and_metrics)


# ---------------------------------------------------------------------------


def _now() -> str:
    return datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")


_CKPT = re.compile(r"^step_(\d+)\.pt$")


def _host_copy(obj):
    """A copy on the host of every tensor in ``obj`` (nested dicts, lists
    and tuples); other leaves as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class WindowedProfiler:
    """Step-windowed ``torch.profiler`` traces, stepped once per train batch
    with the reference's schedule(wait=1, warmup=1, active=3, repeat=2).
    Each cycle skips ``wait + warmup`` steps, traces ``active`` steps into
    its own ``cycle{n}`` directory (a Chrome trace, ``*.pt.trace.json``), and
    the schedule ends after ``repeat`` cycles.  ``active == 0`` or
    ``repeat == 0`` traces the whole fit into ``profile_dir`` itself.  One
    instance serves a run: its cycles continue across fit chunks."""

    def __init__(self, cfg: Config, device):
        from torch.profiler import ProfilerActivity

        self.dir = cfg.profile_dir
        os.makedirs(self.dir, exist_ok=True)
        self.skip = max(cfg.profile_wait, 0) + max(cfg.profile_warmup, 0)
        self.active = cfg.profile_active
        self.repeat = cfg.profile_repeat
        self.windowed = self.active > 0 and self.repeat > 0
        self.activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
        self._prof = None
        self.pos = 0
        self.cycles = 0
        self.tracing = False
        if not self.windowed:
            self._start_trace(self.dir)
            self.tracing = True

    def _start_trace(self, path: str):
        from torch.profiler import profile, tensorboard_trace_handler

        self._prof = profile(activities=self.activities,
                             on_trace_ready=tensorboard_trace_handler(path))
        self._prof.start()

    def _stop_trace(self):
        self._prof.stop()  # writes the trace into the directory it was started for
        self._prof = None

    def before_step(self):
        if not self.windowed or self.tracing or self.cycles >= self.repeat:
            return
        if self.pos >= self.skip:
            self._start_trace(os.path.join(self.dir, f"cycle{self.cycles}"))
            self.tracing = True

    def after_step(self):
        if not self.windowed:
            return
        self.pos += 1
        if self.tracing and self.pos >= self.skip + self.active:
            self._stop_trace()
            self.tracing = False
            self.cycles += 1
            self.pos = 0

    def begin_fit(self):
        """Re-entry for the next fit chunk: windowed cycles go on counting
        (``repeat`` bounds the run's traces, not a chunk's); whole-fit mode
        starts its trace again."""
        if not self.windowed and not self.tracing:
            self._start_trace(self.dir)
            self.tracing = True

    def stop(self):
        if self.tracing:
            self._stop_trace()
            self.tracing = False
            if self.windowed:
                # a chunk that ends inside an active window closes that cycle:
                # it counts toward `repeat`, and the next chunk starts a fresh
                # wait / warmup into its own cycle directory
                self.cycles += 1
                self.pos = 0


class Trainer:
    """Epoch-loop harness with the reference's logging/eval protocol."""

    SPLITS = ("train", "valid", "test")

    def __init__(self, cfg: Config, model: torch.nn.Module, *, device,
                 feats_fn: Optional[Callable] = None, log=print,
                 output_test_result_path: str = "test-result.txt"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device=cuda was asked for and CUDA is not available "
                               "(pass device=cpu to train on the CPU)")
        self.log = log
        self.feats_fn = feats_fn
        self.state = create_train_state(model.to(self.device), cfg)
        self.fns = build_step_fns(self.state.model, cfg, feats_fn)
        self.epoch = 0
        self._test_result_path = output_test_result_path
        self._profiler = None
        self._interrupted = {}  # set by fit()'s signal handler
        self._writer = None  # the background checkpoint write in flight
        self._writer_error = None
        self._ckpt_dir = os.path.abspath(cfg.checkpoint_dir) if cfg.enable_checkpointing else None
        if self._ckpt_dir is not None:
            os.makedirs(self._ckpt_dir, exist_ok=True)
            if cfg.resume_from is not None or self.latest_step() is not None:
                self.restore(cfg.resume_from)

    # -- checkpointing -------------------------------------------------
    def _steps(self) -> list:
        found = (_CKPT.match(f) for f in os.listdir(self._ckpt_dir))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self._steps() if self._ckpt_dir is not None else []
        return steps[-1] if steps else None

    def save(self, wait: bool = True):
        """Checkpoint the train state, keyed by global step; the newest
        ``cfg.keep_checkpoints`` are kept.  A no-op without checkpointing.

        The model's and the optimizer's state are copied to the host before
        ``save`` returns: the next step's ``optimizer.step()`` updates the
        parameters in place.  ``wait=False`` writes the copy in a background
        thread (``fit``'s per-epoch saves, so that the next epoch's compute
        hides the write); a second save, ``restore`` and the end of ``fit``
        wait for it (:meth:`wait_until_finished`)."""
        if self._ckpt_dir is None:
            return
        self.wait_until_finished()
        payload = {"params": _host_copy(self.state.model.state_dict()),
                   "opt_state": _host_copy(self.state.optimizer.state_dict()),
                   "step": self.state.step, "epoch": self.epoch}
        if wait:
            self._write(payload)
            return

        def write():
            try:
                self._write(payload)
            except Exception as e:  # raised where the write is waited for
                self._writer_error = e

        self._writer = threading.Thread(target=write, name="checkpoint-writer")
        self._writer.start()

    def _write(self, payload):
        path = os.path.join(self._ckpt_dir, f"step_{payload['step']}.pt")
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)  # never a half-written checkpoint under its name
        for old in self._steps()[: -max(self.cfg.keep_checkpoints, 1)]:
            os.remove(os.path.join(self._ckpt_dir, f"step_{old}.pt"))

    def wait_until_finished(self):
        """Wait for a background checkpoint write; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise RuntimeError("writing the checkpoint failed") from err

    def restore(self, step: Optional[int] = None):
        if self._ckpt_dir is None:
            raise RuntimeError(
                "restore() needs checkpointing: construct the Trainer with "
                "enable_checkpointing=true (save() silently no-ops without "
                "it, but restoring from nowhere is always a caller error)")
        self.wait_until_finished()  # a save of this trainer may still be in flight
        if step is not None:
            try:
                step = int(step)
            except (TypeError, ValueError):
                raise ValueError(
                    "resume_from takes the checkpoint STEP number (e.g. "
                    "resume_from=2000; checkpoints are keyed by global "
                    f"step under checkpoint_dir), not a path: got {step!r}"
                ) from None
        else:
            step = self.latest_step()
        if step is None:
            return
        payload = torch.load(os.path.join(self._ckpt_dir, f"step_{step}.pt"),
                             map_location=self.device, weights_only=True)
        self.state.model.load_state_dict(payload["params"])
        self.state.optimizer.load_state_dict(payload["opt_state"])
        self.state.step = int(payload["step"])
        self.epoch = int(payload["epoch"])
        self.log(f"resumed from checkpoint step={step} epoch={self.epoch}")

    # ------------------------------------------------------------------
    def _put(self, batch, valid):
        """Host batch -> tensors on the device for the step."""
        put = lambda x: torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(self.device)
        return tuple(put(x) for x in batch), put(valid)

    def _index_batches(self, n: int, shuffle: bool, seed: int):
        """Batch indices + valid mask; ragged tails repeat the tail's first
        index so every batch has ``batch_size`` rows."""
        B = self.cfg.batch_size
        order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
        for i in range(0, n, B):
            idx = order[i : i + B]
            valid = np.zeros((B,), np.float32)
            valid[: len(idx)] = 1.0
            if len(idx) < B:
                idx = np.concatenate([idx, np.broadcast_to(idx[:1], (B - len(idx),))])
            yield idx, valid

    def _assemble(self, dataset, kind: str, idx: np.ndarray, valid: np.ndarray):
        if getattr(dataset, "accepts_bucket_idx", False):
            # online datasets take the length bucket from the global batch's
            # indices (one process: the batch's own)
            return self._put(dataset.make_batch(idx, kind, bucket_idx=idx), valid)
        return self._put(dataset.make_batch(idx, kind), valid)

    def _run_epoch(self, dataset, split: str, train: bool, kind: str):
        cfg = self.cfg
        correction = cfg.acc_correction[self.SPLITS.index(split)]
        mstate = M.init_state(cfg.metrics_topk, self.device)
        self.log(f"{_now()} {split} epoch {self.epoch} start")
        n_batches = 0
        t0 = time.time()
        shuffle = train and cfg.shuffle_train_data and not cfg.debug
        source = self._index_batches(len(dataset), shuffle, cfg.seed + self.epoch)
        # the running loss rides in the on-device metric state: the loop reads
        # it on the host only at the status-line refreshes
        log_every = 1 if cfg.debug else max(cfg.log_interval_steps, 1)
        assemble = lambda args: self._assemble(dataset, kind, *args)
        profiler = self._profiler if train else None
        # the context manager closes the worker thread and drops its queued
        # batches on an exception or on the break of a preemption
        with Prefetcher(source, assemble, depth=cfg.prefetch_depth) as pf:
            for batch, valid in pf:
                if train:
                    if profiler is not None:
                        profiler.before_step()
                    self.state, _, mstate = self.fns.train_step(self.state, batch, valid, mstate)
                    if profiler is not None:
                        profiler.after_step()
                else:
                    _, mstate, _ = self.fns.eval_step(batch, valid, mstate)
                if self._interrupted:
                    # preemption grace windows are seconds: stop at this step
                    # boundary, train or eval; fit() saves right after
                    break
                n_batches += 1
                if n_batches % log_every == 0:
                    accs = M.compute(mstate, cfg.metrics_topk, correction)
                    acc_str = ", ".join(f"top{k}: {float(v):.4f}" for k, v in accs.items())
                    print(f"\r{split} loss: {float(M.mean_loss(mstate)):.4f}, {acc_str}",
                          end="", file=sys.stderr, flush=True)
        return self._finalize_epoch(mstate, split, time.time() - t0)

    def _finalize_epoch(self, mstate, split: str, dt: float):
        cfg = self.cfg
        correction = cfg.acc_correction[self.SPLITS.index(split)]
        accs = {k: float(v) for k, v in M.compute(mstate, cfg.metrics_topk, correction).items()}
        total = float(mstate["total"])
        mean_loss = float(M.mean_loss(mstate))
        pairs_per_sec = total * cfg.num_candidates_model / max(dt, 1e-9)
        print("", file=sys.stderr)
        acc_str = ", ".join(f"top{k}: {v:.4f}" for k, v in accs.items())
        self.log(
            f"{_now()} {split} epoch {self.epoch} done: loss {mean_loss:.4f}, "
            f"{acc_str} ({total:.0f} mentions, {pairs_per_sec:,.0f} pairs/s)"
        )
        return {"loss": mean_loss, "accs": accs, "pairs_per_sec": pairs_per_sec}

    def fit(self, train_ds, valid_ds, num_epochs: int, kind: str = "drin"):
        """One fit chunk: ``num_epochs`` epochs of train + valid, a
        checkpoint after each epoch when checkpointing is on.

        With checkpointing on, SIGTERM / SIGINT during ``fit`` stop at the
        next train step boundary (or eval step boundary during validation),
        save a checkpoint keyed by the global step at once, and raise
        ``KeyboardInterrupt``; a restore re-runs the interrupted epoch from
        its start with the saved weights.  The handlers go in only on the
        main thread and the previous ones come back on the way out."""
        import signal

        cfg = self.cfg
        results = []
        if cfg.reset_optimizer_per_fit:
            # reference semantics: a fresh optimizer per chunk restarts
            # Adam's moments and step count
            self.state.optimizer = make_optimizer(self.state.model, cfg)
        if cfg.profiling:
            # one profiler for the run: windowed cycles continue across chunks
            if self._profiler is None:
                self._profiler = WindowedProfiler(cfg, self.device)
            else:
                self._profiler.begin_fit()

        interrupted = self._interrupted = {}
        prev_handlers = {}

        def _on_signal(signum, frame):
            interrupted["signum"] = signum

        in_main = threading.current_thread() is threading.main_thread()
        if self._ckpt_dir is not None and in_main:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _on_signal)
        try:
            for _ in range(num_epochs):
                self._run_epoch(train_ds, "train", True, kind)
                if interrupted:
                    # stopped at a step boundary: save the mid-epoch state
                    # under its global step and stop before the valid pass
                    self.save()
                    self.log(f"signal {interrupted['signum']} received: checkpoint saved at "
                             f"step {self.state.step} (epoch {self.epoch}), stopping")
                    raise KeyboardInterrupt
                results.append(self._run_epoch(valid_ds, "valid", False, kind))
                if interrupted:
                    # during validation the train state is at the epoch's end
                    self.save()
                    self.log(f"signal {interrupted['signum']} received during validation: "
                             f"checkpoint saved at step {self.state.step} (epoch {self.epoch}), "
                             f"stopping")
                    raise KeyboardInterrupt
                self.epoch += 1
                self.save(wait=False)  # the next epoch's compute hides the write
        finally:
            self._interrupted = {}
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
            self.wait_until_finished()  # a returned (or raising) fit leaves every save written
            if self._profiler is not None:
                self._profiler.stop()  # the instance stays: cycles span chunks
        return results

    def test(self, test_ds, kind: str = "drin"):
        if self.cfg.output_test_result:
            return self._dump_test_results(test_ds, kind)
        return self._run_epoch(test_ds, "test", False, kind)

    def _dump_test_results(self, dataset, kind: str):
        """Single-pass test epoch that also writes the raw score vectors and
        labels, one line per mention: ``s_0 ... s_C-1 | label``."""
        cfg = self.cfg
        mstate = M.init_state(cfg.metrics_topk, self.device)
        self.log(f"{_now()} test epoch {self.epoch} start")
        t0 = time.time()
        with open(self._test_result_path, "w") as f:
            for idx, valid in self._index_batches(len(dataset), False, 0):
                put, vput = self._assemble(dataset, kind, idx, valid)
                _, mstate, scores = self.fns.eval_step(put, vput, mstate)
                b = int(valid.sum())
                scores = scores[:b].float().cpu().numpy()
                labels = dataset.labels(idx[:b])
                for row, lab in zip(scores, labels):
                    f.write(" ".join(f"{v:.6f}" for v in row) + f" | {lab}\n")
        return self._finalize_epoch(mstate, "test", time.time() - t0)
