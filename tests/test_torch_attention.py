# -*- coding: utf-8 -*-
"""Fused attention: the kernel's plain version against the JAX package's
Pallas kernel (interpret mode) and its XLA reference.

Tolerances: float32 at rtol 2e-4 / atol 1e-5 (the same math in another
summation order).  bfloat16 at rtol 2e-2 / atol 2e-2, the JAX package's own
bf16 bound for this kernel: both sides round p and the output to bf16 (8
bits).  The CUDA kernel is compared with the plain version on the card
(chip_smoke.py)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.ops.pallas.attention import attention_reference, fused_attention as jax_fused
from drin_tpu_torch.ops.cuda import attention as tattn

F32 = dict(rtol=2e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(shape, seed, masked):
    B, H, L, Dh = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        lens = rng.integers(1, L + 1, B)
        lens[0] = L // 3
        mask = np.where(np.arange(L)[None] < lens[:, None], 0.0,
                        np.finfo(np.float32).min).astype(np.float32)
    return q, k, v, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masked"])
@pytest.mark.parametrize("shape,block_q", [((2, 2, 32, 16), 128),  # one query block
                                           ((1, 3, 40, 8), 16),    # L not a multiple of block_q
                                           ((3, 2, 24, 64), 8)],
                         ids=["L32", "L40-ragged", "L24-Dh64"])
def test_plain_matches_pallas_interpret_and_reference(shape, block_q, masked):
    q, k, v, mask = _inputs(shape, 0, masked)
    tm = None if mask is None else torch.from_numpy(mask)
    got = tattn.attention_plain(*map(torch.from_numpy, (q, k, v)), tm).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, np.asarray(jax_fused(q, k, v, mask, block_q, True)), **F32)
    np.testing.assert_allclose(got, np.asarray(attention_reference(q, k, v, mask)), **F32)


def test_plain_bf16_matches_pallas_interpret():
    q, k, v, mask = _inputs((2, 2, 64, 32), 1, True)
    jq, jk, jv, jm = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, mask))
    tq, tk, tv, tm = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, mask))
    # both masks hold finfo(bf16).min: float32's min rounds to -inf in bf16
    jm = jnp.where(jm < 0, jnp.finfo(jnp.bfloat16).min, 0).astype(jnp.bfloat16)
    tm = torch.where(tm < 0, torch.finfo(torch.bfloat16).min, 0.0).to(torch.bfloat16)
    got = tattn.attention_plain(tq, tk, tv, tm)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_fused(jq, jk, jv, jm, 128, True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_fully_masked_row_is_uniform_like_the_jax_kernel():
    """The mask keeps its magnitude (finfo.min, not -inf): a sequence whose
    keys are all dropped averages V, in both packages."""
    q, k, v, _ = _inputs((2, 2, 16, 8), 2, False)
    mask = np.zeros((2, 16), np.float32)
    mask[1] = np.finfo(np.float32).min
    got = tattn.attention_plain(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_fused(q, k, v, mask, 128, True)), **F32)
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(-2, keepdims=True), v[1].shape),
                               **F32)


def test_cpu_wrapper_returns_the_plain_result_and_counts_no_launch():
    q, k, v, mask = map(torch.from_numpy, _inputs((2, 2, 32, 16), 3, True))
    tattn.launches = 0
    got = tattn.fused_attention(q, k, v, mask)
    assert torch.equal(got, tattn.attention_plain(q, k, v, mask))
    # strided views (BERT's reshape + transpose) need no copy either
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(tattn.fused_attention(qt, k, v, mask), got)
    assert tattn.launches == 0


class _OnCard:
    """A CPU tensor that claims to live on a CUDA device, for the wrapper's
    argument checks (there is no card where these tests run)."""

    def __init__(self, t, device="cuda:0"):
        self._t, self.device, self.is_cuda = t, torch.device(device), True

    def __getattr__(self, name):
        return getattr(self._t, name)


def _on_card(*shape, dtype=torch.bfloat16, requires_grad=False):
    return _OnCard(torch.zeros(*shape, dtype=dtype, requires_grad=requires_grad))


@pytest.mark.parametrize("case,match", [
    ("fp16", "float32 or bfloat16"), ("dh32", "Dh=64"), ("L520", "multiple of 8 up to 512"),
    ("L20", "multiple of 8"), ("mask_dtype", "must be torch.bfloat16"),
    ("mask_shape", "additive_mask must be"), ("device", "must be on"),
    ("k_shape", "k must be"), ("misaligned", "16-byte aligned"), ("grad", None)])
def test_cuda_checks_refuse_what_the_kernel_does_not_take(case, match):
    shape = {"dh32": (2, 2, 256, 32), "L520": (1, 1, 520, 64), "L20": (1, 1, 20, 64)}.get(
        case, (2, 2, 256, 64))
    dt = torch.float16 if case == "fp16" else torch.bfloat16
    q, k, v = (_on_card(*shape, dtype=dt) for _ in range(3))
    mask = _on_card(shape[0], shape[2], dtype=dt)
    if case == "mask_dtype":
        mask = _on_card(2, 256, dtype=torch.float32)
    elif case == "mask_shape":
        mask = _on_card(2, 128)
    elif case == "device":
        v = _OnCard(v._t, "cuda:1")
    elif case == "k_shape":
        k = _on_card(2, 2, 128, 64)
    elif case == "misaligned":
        q = _OnCard(torch.zeros(2, 2, 256, 68, dtype=dt)[..., 4:])
    elif case == "grad":
        q = _on_card(*shape, dtype=dt, requires_grad=True)
    if match is None:  # an input that requires grad is taken: the backward is a kernel too
        with torch.enable_grad():
            assert tattn._check_cuda(q, k, v, mask) == shape
        return
    with torch.enable_grad(), pytest.raises(ValueError, match=match):
        tattn._check_cuda(q, k, v, mask)


def test_cuda_checks_accept_the_main_path_views():
    B, H, L, hd = 2, 12, 384, 64
    x = torch.zeros(B, L, H * hd, dtype=torch.bfloat16)
    q, k, v = (_OnCard(x.reshape(B, L, H, hd).transpose(1, 2)) for _ in range(3))
    mask = _OnCard(torch.zeros(B, 1, 1, L, dtype=torch.bfloat16)[:, 0, 0, :])
    assert tattn._check_cuda(q, k, v, mask) == (B, H, L, hd)
    assert tattn._check_cuda(q, k, v, None) == (B, H, L, hd)
    with torch.no_grad():  # frozen weights under no_grad pass the grad check
        q = _OnCard(torch.zeros(B, H, L, hd, dtype=torch.bfloat16, requires_grad=True))
        assert tattn._check_cuda(q, k, v, None) == (B, H, L, hd)


def test_cuda_tensor_without_a_card_raises(monkeypatch):
    """On a tensor that says it is on CUDA the wrapper goes for the kernel
    (here it fails allocating the output on the missing card, or else
    building without nvcc): an error, never the plain version."""
    from drin_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    monkeypatch.setattr(tattn, "attention_plain", None)  # calling it would be a TypeError
    q, k, v = (_on_card(1, 1, 256, 64) for _ in range(3))
    tattn.launches = 0
    with torch.no_grad(), pytest.raises((RuntimeError, AssertionError), match="CUDA|nvcc"):
        tattn.fused_attention(q, k, v, None)
    assert tattn.launches == 0


# sequence lengths around the kernels' 64- and 128-row tiles (a multiple of 8
# each, as the kernels take them) with kept prefixes on both sides of a tile
# edge, one key kept, and every key dropped
EDGE_CASES = [(8, [8, 7, 1, 0]), (72, [72, 65, 64, 63]), (136, [129, 128, 127, 0]),
              (264, [264, 257, 256, 255])]


def _prefix_mask(L, lens):
    return np.where(np.arange(L)[None] < np.asarray(lens)[:, None], 0.0,
                    np.finfo(np.float32).min).astype(np.float32)


@pytest.mark.parametrize("L,lens", EDGE_CASES, ids=[f"L{L}" for L, _ in EDGE_CASES])
def test_plain_matches_pallas_interpret_at_the_tile_edges(L, lens):
    shape = (len(lens), 2, L, 8)
    q, k, v, _ = _inputs(shape, 20 + L, False)
    mask = _prefix_mask(L, lens)
    got = tattn.attention_plain(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_fused(q, k, v, mask, 64, True)), **F32)
    np.testing.assert_allclose(got, np.asarray(attention_reference(q, k, v, mask)), **F32)
    for b, n in enumerate(lens):
        if n == 0:  # every key dropped: the mean of V
            np.testing.assert_allclose(got[b], np.broadcast_to(v[b].mean(-2, keepdims=True),
                                                               v[b].shape), **F32)


def test_tensor_map_layout_of_the_bert_views():
    """The element strides of B, H and L that go into the tensor map of a
    strided view (in bytes: multiples of 16 below 2**40); a dimension of size 1
    gets the packed stride."""
    B, H, L, hd = 3, 12, 384, 64
    x = torch.zeros(B, L, H * hd, dtype=torch.bfloat16)
    view = x.reshape(B, L, H, hd).transpose(1, 2)
    assert tattn._strides(view) == (L * H * hd, hd, H * hd)
    assert all(s * 2 % 16 == 0 and 0 < s * 2 < 2 ** 40 for s in tattn._strides(view))
    assert tattn._strides(view.contiguous()) == (H * L * hd, L * hd, hd)
    # PyTorch leaves a size-1 dimension's stride arbitrary (0 after expand)
    one = torch.zeros(1, 1, 8, hd, dtype=torch.bfloat16).expand(1, 1, 8, hd)
    assert tattn._strides(one) == (8 * hd, 8 * hd, hd)
    assert tattn._strides(torch.zeros(1, 4, 16, hd)[:, ::2]) == (2 * 2 * 16 * hd, 2 * 16 * hd, hd)


CSRC = Path(tattn.__file__).resolve().parents[2] / "csrc"
SMEM_PER_BLOCK = 232_448  # bytes of shared memory one block may use on the H100


def _cu_constants(source, **overrides):
    """The integer ``constexpr`` constants of ``csrc/hopper.cuh``,
    ``csrc/attention_common.cuh`` (which includes it) and ``csrc/<source>``,
    evaluated from the text of the sources, with the ``#define DRIN_ATTN_*``
    defaults (the knobs a ``-D`` build changes) or constants replaced by
    ``overrides``."""
    text = "".join((CSRC / name).read_text() for name in ("hopper.cuh", "attention_common.cuh", source))
    env = {name: int(value) for name, value in re.findall(r"#define (DRIN_ATTN_\w+) (\d+)", text)}
    env.update(overrides)
    for decl in re.findall(r"constexpr int ([^;]+);", text):
        for part in decl.split(","):
            name, expr = (x.strip() for x in part.split("=", 1))
            if name not in overrides:
                env[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, env)
    return env, text


@pytest.mark.parametrize("kernel,key_tile,stages,warpgroups,want", [
    ("fwd", 64, 4, 2, 1024 + 16384 + 4 * 16384 + 2048 + 72),  # the forward as shipped
    ("dq", 64, 3, 2, 1024 + 2 * 16384 + 3 * 16384 + 2048 + 56),  # the backward as shipped
    ("dkv", 64, 3, 1, 1024 + 2 * 8192 + 3 * 17408 + 56),
    # the f32 forward as shipped: a ring of raw (K, V) tiles, two split buffers
    # of K lo, V^T hi and V^T lo (q's tiles borrow the second), the mask row
    ("f32", 64, 3, 2, 1024 + 3 * 32768 + 2 * 49152 + 2048 + 32),
    ("fwd", 128, 4, 4, None), ("fwd", 64, 8, 4, None), ("dq", 64, 4, 2, None),
    ("dkv", 64, 4, 2, None), ("f32", 64, 2, 3, None)])
def test_shared_memory_of_a_block_fits_the_card(kernel, key_tile, stages, warpgroups, want):
    """The dynamic shared memory a block asks for, as the sources compute it
    (``kFwdSmem``, ``kDqSmem``, ``kDkvSmem``, ``kF32Smem``), at the shipped knobs (where it
    is also the figure the records quote) and at other knobs the sweep tool
    builds: within what the card gives one block, which is the limit the
    sources' own ``static_assert`` holds."""
    source, knob, total = {"fwd": ("attention.cu", "FWD", "kFwdSmem"),
                           "dq": ("attention_bwd.cu", "DQ", "kDqSmem"),
                           "dkv": ("attention_bwd.cu", "DKV", "kDkvSmem"),
                           "f32": ("attention.cu", "F32", "kF32Smem")}[kernel]
    shipped, text = _cu_constants(source)
    if want is not None:  # the row holds the knobs compiled in
        assert (shipped[f"DRIN_ATTN_{knob}_STAGES"], shipped[f"DRIN_ATTN_{knob}_WG"]) == (stages, warpgroups)
        assert shipped[total] == want
    tile = {"kFwdKT": key_tile} if kernel == "fwd" else {}
    assert shipped[{"fwd": "kFwdKT", "f32": "kF32KT"}.get(kernel, "kBwdKT")] == 64
    env, _ = _cu_constants(source, **tile, **{f"DRIN_ATTN_{knob}_STAGES": stages,
                                             f"DRIN_ATTN_{knob}_WG": warpgroups})
    assert env[total] <= SMEM_PER_BLOCK
    assert re.search(rf"static_assert\([^;]*{total} <= {SMEM_PER_BLOCK}", text)


def test_shared_memory_refuses_an_unknown_kernel_and_an_oversized_ring_is_seen():
    """A ring the card cannot hold shows in the sources' arithmetic (the build
    would stop at the ``static_assert``); a constant the sources do not
    define is an error, not a default."""
    env, _ = _cu_constants("attention.cu", kFwdKT=128, DRIN_ATTN_FWD_STAGES=8)
    assert env["kFwdSmem"] > SMEM_PER_BLOCK
    with pytest.raises(KeyError):
        _cu_constants("attention.cu")[0]["kBwdSmem"]


def test_shared_memory_of_the_f32_forward_refuses_a_fourth_stage():
    """The f32 forward's ring of raw 32 KB (K, V) stages beside its two 48 KB
    split buffers: three stages fit one block, a fourth does not (by 40
    bytes), and the source's ``static_assert`` stops such a build; so do
    fewer than two stages (a tile's stage is refilled while the next is read)
    and warpgroups whose q tiles overflow the second split buffer."""
    env, text = _cu_constants("attention.cu", DRIN_ATTN_F32_STAGES=4)
    assert env["kF32Smem"] == SMEM_PER_BLOCK + 40
    assert _cu_constants("attention.cu")[0]["kF32Smem"] <= SMEM_PER_BLOCK
    assert re.search(r"static_assert\(kF32Stages >= 2", text)
    env, _ = _cu_constants("attention.cu", DRIN_ATTN_F32_WG=4)
    assert env["kF32WG"] * env["kF32Tile"] > env["kF32SplitBytes"]
    assert re.search(r"static_assert\(kF32WG \* kF32Tile <= kF32SplitBytes", text)


def test_shared_memory_of_the_f32_backward_fits_the_card():
    """The f32 backward kernels (split TF32 on wgmma) at their fixed shapes:
    the dq kernel's dO hi / lo for two warpgroups, two raw (K, V) stages, K
    lo, V lo, K^T hi / lo and the mask row; the dkv kernel's three raw (Q, dO)
    stages, Q lo, dO lo, Q^T and dO^T hi / lo, the P^T tile its two
    warpgroups hand over and a statistics tile per stage (K and V live in
    registers).  Both fit one block; a third dq stage or a fourth dkv stage
    would not, and the source's static_assert stops such a build."""
    tile = 64 * 64 * 4
    env, text = _cu_constants("attention_bwd.cu")
    assert env["kF32Tile"] == tile
    assert env["kF32DqSmem"] == 1024 + 4 * tile + 2 * 2 * tile + 4 * tile + 2048 + 24
    assert env["kF32DkvSmem"] == 1024 + 3 * 2 * tile + 6 * tile + tile + 3 * 768 + 32
    assert max(env["kF32DqSmem"], env["kF32DkvSmem"]) <= SMEM_PER_BLOCK
    assert _cu_constants("attention_bwd.cu", kF32DqStages=3)[0]["kF32DqSmem"] > SMEM_PER_BLOCK
    assert _cu_constants("attention_bwd.cu", kF32DkvStages=4)[0]["kF32DkvSmem"] > SMEM_PER_BLOCK
    assert re.search(rf"static_assert\(kF32DqSmem <= {SMEM_PER_BLOCK} && kF32DkvSmem <= {SMEM_PER_BLOCK}", text)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_checks_on_an_expanded_tensor(dtype):
    """A stride of 0 over a dimension that is walked cannot go into a tensor
    map, and both forward kernels read through one (the float32 one since its
    redesign for wgmma): the wrapper refuses it in either type."""
    q, k = (_on_card(2, 2, 256, 64, dtype=dtype) for _ in range(2))
    v = _OnCard(torch.zeros(1, 2, 256, 64, dtype=dtype).expand(2, 2, 256, 64))
    with pytest.raises(ValueError, match="tensor map"):
        tattn._check_cuda(q, k, v, None)
    # a batch of one may carry any stride there
    one = _OnCard(torch.zeros(1, 2, 256, 64, dtype=dtype).expand(1, 2, 256, 64))
    assert tattn._check_cuda(one, one, one, None) == (1, 2, 256, 64)
