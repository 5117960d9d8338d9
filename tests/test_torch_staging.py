# -*- coding: utf-8 -*-
"""The pinned stager's packing (``drin_tpu_torch.data.staging``), on the CPU.

On the CPU the stager runs the same packing as on CUDA with an ordinary
arena: every field laid out at an aligned offset, filled and sent in chunks,
returned as a typed view of one fresh buffer.  Each staged field must equal,
bit for bit, what ``t.to(device, dtype)`` gives (``t.to(device)`` for an
integer field), the compute dtype float32 or bfloat16.  ``CHUNK_BYTES`` is
set small here so that fields split into many pieces and sends."""

import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from drin_tpu_torch.data import staging
from drin_tpu_torch.data.staging import PinnedStager


def drin_request(rng, B=4, L=12, D=16, R=5, Dr=24, Tm=3, C=7):
    """The ten rank fields of a DRIN rows batch, in their dtypes."""
    return (rng.standard_normal((B, L, D), dtype=np.float32),
            (rng.uniform(size=(B, L)) < 0.7).astype(np.int64),
            rng.integers(1, 4, B), rng.integers(4, 8, B),
            rng.standard_normal((B, R, Dr), dtype=np.float32),
            rng.standard_normal((B, Tm, Dr), dtype=np.float32),
            rng.uniform(0, 1, (B, Tm)).astype(np.float32),
            rng.integers(0, 40, (B, C)).astype(np.int32),
            rng.uniform(0, 40, (B, C)).astype(np.float32),
            rng.uniform(0, 40, (B, C)).astype(np.float32))


def online_request(rng, B=2, Lm=16, R=5, Dr=24, S=3, L=32, E=4):
    """The nine rank fields of an online GHMFC zipped batch, the mention
    token fields cut to their bucket (column slices, not contiguous)."""
    ids = rng.integers(0, 500, (B, 2 * Lm))
    return (ids[:, :Lm], np.ones((B, 2 * Lm), np.int64)[:, :Lm], np.ones(B, np.int64),
            np.full(B, 2), rng.standard_normal((B, R, Dr), dtype=np.float32),
            rng.integers(0, 500, (B, S, L)), np.ones((B, S, L), np.int64),
            rng.integers(0, L, (B, S, E)), np.zeros(B, np.float32))


def odd_request(rng):
    """Fields at the edges: a 0-d value, an empty field, a float64 list, a
    bool and a float16 array, a single row."""
    return (np.float32(3.5), np.zeros((0, 5), np.float32), [[1.25, -2.5, 1e-30]],
            rng.uniform(size=(3, 7)) < 0.5, rng.standard_normal((2, 3)).astype(np.float16),
            rng.standard_normal((1, 300), dtype=np.float32))


REQUESTS = {"drin": drin_request, "online": online_request, "odd": odd_request}


def expected(x, dtype):
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to("cpu", dtype) if t.is_floating_point() else t.to("cpu")


def bits(t):
    """A tensor's bytes, so that equality is bit equality (NaN and -0 too)."""
    return t.contiguous().view(-1).view(torch.uint8) if t.numel() else t.reshape(-1)


def assert_staged(got, fields, dtype):
    assert len(got) == len(fields)
    for g, x in zip(got, fields):
        want = expected(x, dtype)
        assert g.dtype == want.dtype and g.shape == want.shape and g.device == want.device
        assert torch.equal(bits(g), bits(want))


def counters():
    return {n: getattr(staging, n) for n in ("calls", "bytes", "passthrough", "waits", "grows")}


def moved(before):
    return {n: v - before[n] for n, v in counters().items()}


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(staging, "CHUNK_BYTES", 200)


@pytest.mark.parametrize("chunk", [200, 4096, staging.CHUNK_BYTES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(REQUESTS))
def test_staged_fields_equal_the_direct_copies(kind, dtype, chunk, monkeypatch):
    """Every field bit-equal to ``.to(device, dtype)``, integers in their
    own dtype, each at a 256-byte aligned offset of one shared buffer."""
    monkeypatch.setattr(staging, "CHUNK_BYTES", chunk)
    fields = REQUESTS[kind](np.random.default_rng(1))
    got = PinnedStager("cpu").stage(fields, dtype)
    assert_staged(got, fields, dtype)
    assert len({g.untyped_storage().data_ptr() for g in got}) == 1
    assert all(g.storage_offset() * g.element_size() % staging.ALIGN == 0 for g in got)


def test_arena_grows_once_and_is_reused(small_chunks):
    stager = PinnedStager("cpu")
    rng = np.random.default_rng(2)
    big, small = drin_request(rng, B=8), drin_request(rng, B=2)
    before = counters()
    first = stager.stage(big, torch.float32)
    assert_staged(first, big, torch.float32)
    arena = stager._arena
    end = max(g.storage_offset() * g.element_size() + g.nbytes
              for g in stager.stage(big, torch.float32))
    need = -(-end // staging.ALIGN) * staging.ALIGN
    assert arena.numel() == need and moved(before)["grows"] == 1
    for _ in range(3):
        assert_staged(stager.stage(small, torch.float32), small, torch.float32)
    assert stager._arena is arena and moved(before)["grows"] == 1
    assert_staged(first, big, torch.float32)  # later calls never write an earlier call's buffer
    # a larger request at least doubles the arena
    bigger = drin_request(rng, B=9)
    stager.stage(bigger, torch.float32)
    assert stager._arena.numel() == 2 * need and moved(before)["grows"] == 2


def _read_only(a):
    a = a.copy()
    a.setflags(write=False)
    return a


INPUTS = {"read_only": _read_only,
          "from_bytes": lambda a: np.frombuffer(a.tobytes(), a.dtype).reshape(a.shape),
          "column_slice": lambda a: np.repeat(a, 2, axis=-1)[..., ::2],
          "transposed": lambda a: np.ascontiguousarray(a.T).T,
          "reversed": lambda a: a[::-1].copy()[::-1],
          "broadcast": lambda a: np.broadcast_to(a[:1], a.shape)}


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_read_only_and_non_contiguous_inputs_stage_without_a_warning(kind, small_chunks,
                                                                     monkeypatch):
    """torch warns once a process on a read-only array and refuses negative
    strides: the stager hands torch neither (checked at ``from_numpy``, since
    an earlier test may have spent torch's one warning)."""
    from_numpy = torch.from_numpy

    def strict(a):
        assert a.flags.writeable and min(a.strides, default=0) >= 0, (a.flags, a.strides)
        return from_numpy(a)

    monkeypatch.setattr(torch, "from_numpy", strict)
    rng = np.random.default_rng(3)
    fields = [INPUTS[kind](a) for a in drin_request(rng)]
    want = [np.array(a) for a in fields]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = PinnedStager("cpu").stage(fields, torch.float32)
    assert_staged(got, want, torch.float32)


def test_tensors_on_the_device_pass_through():
    """A tensor already on the target device is not staged: ``.to`` gives it
    back (cast where it is floating and of another dtype)."""
    rng = np.random.default_rng(4)
    fields = list(drin_request(rng))
    on_device = [torch.from_numpy(fields[0]), torch.from_numpy(fields[7]),
                 torch.from_numpy(fields[8]).double()]
    mixed = on_device + fields[1:7] + fields[9:]
    before = counters()
    got = PinnedStager("cpu").stage(mixed, torch.float32)
    assert_staged(got, mixed, torch.float32)
    assert got[0] is on_device[0] and got[1] is on_device[1] and got[2].dtype == torch.float32
    m = moved(before)
    assert m["passthrough"] == 3 and m["calls"] == 1
    assert m["bytes"] == sum(np.asarray(x).nbytes for x in mixed[3:])


def test_threads_staging_at_once_get_their_own_values(small_chunks):
    """Threads sharing one stager (more threads than cores, the interpreter
    switching every microsecond) each get their own request's values."""
    stager = PinnedStager("cpu")
    reqs = [drin_request(np.random.default_rng(10 + i), B=1 + i % 3) for i in range(12)]
    errors, before = [], counters()

    def work(req):
        try:
            for _ in range(15):
                assert_staged(stager.stage(req, torch.bfloat16), req, torch.bfloat16)
        except Exception as e:  # reported below, with the thread's request
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(r,)) for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert moved(before)["calls"] == 15 * len(reqs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counters_count(dtype, small_chunks):
    """calls, bytes (the fields' bytes in their staged dtypes, padding left
    out), passthrough and grows; no waits on the CPU (no copies in flight)."""
    rng = np.random.default_rng(5)
    stager = PinnedStager("cpu")
    fields = drin_request(rng)
    size = lambda x: np.asarray(x).size * (dtype.itemsize if np.asarray(x).dtype.kind == "f"
                                            else np.asarray(x).itemsize)
    before = counters()
    for _ in range(3):
        stager.stage(fields, dtype)
    stager.stage([torch.zeros(2)], dtype)
    assert moved(before) == {"calls": 4, "bytes": 3 * sum(size(x) for x in fields),
                             "passthrough": 1, "waits": 0, "grows": 1}


def test_ranker_stages_every_request_through_its_stager(tmp_path):
    """A Ranker's rank and score each stage their request once, every byte
    of it; its fields on the device pass through."""
    from drin_tpu_torch.data.dataset import MELFeatureDataset, load_wikimel_entity_tables
    from drin_tpu_torch.data.synthetic import make_synthetic_store, tiny_config
    from drin_tpu_torch.models.drin import DRIN
    from drin_tpu_torch.serve import Ranker

    cfg = tiny_config("wikimel", "drin", preprocess_dir=str(tmp_path))
    make_synthetic_store(cfg, n_mentions=6, n_entities=30, seed=3)
    tables = load_wikimel_entity_tables(cfg)
    batch = MELFeatureDataset(cfg, "train", tables).drin_rows_batch(np.arange(4))[:-1]
    weights = DRIN(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    ranker = Ranker(cfg, weights, tables, device="cpu")
    nbytes = sum(np.asarray(x).size * (ranker.dtype.itemsize if np.asarray(x).dtype.kind == "f"
                                       else np.asarray(x).itemsize) for x in batch)
    before = counters()
    s = ranker.score(batch)
    vals, idx = ranker.rank(batch, k=2)
    assert moved(before) == {"calls": 2, "bytes": 2 * nbytes, "passthrough": 0, "waits": 0,
                             "grows": 1}
    np.testing.assert_array_equal(vals, np.take_along_axis(s, idx, -1))
    before = counters()
    on_device = ranker.score(tuple(torch.as_tensor(np.asarray(x)) for x in batch))
    assert moved(before)["passthrough"] == len(batch)
    np.testing.assert_array_equal(on_device, s)
