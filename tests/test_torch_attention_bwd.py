# -*- coding: utf-8 -*-
"""Fused attention, backward: the kernels' plain version
(``attention_backward_plain``) against ``jax.grad`` of the JAX package's
Pallas kernel (interpret mode, which runs its two backward kernels) and of
its XLA reference; the wrapper's ``autograd.Function`` on the CPU against
autograd through ``attention_plain``.

Tolerances: float32 at rtol 2e-4 with a floor of 2e-4 of the tensor's largest
value (the same math in another summation order; gradients cancel).  bfloat16
at rtol 2e-2 with a floor of 2e-2 of the largest value: the port rounds P
and dS to bf16 before their products as its kernels do, the JAX backward
keeps them float32, and both round the results to bf16.  The CUDA kernels
are compared with the plain version on the card (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.ops.pallas.attention import attention_reference, fused_attention as jax_fused
from drin_tpu_torch.ops.cuda import attention as tattn
from test_torch_attention import EDGE_CASES, _inputs, _prefix_mask


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


def _jax_grads(fn, q, k, v, mask, do):
    if mask is None:
        return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v, None).astype(jnp.float32) * do),
                        argnums=(0, 1, 2))(q, k, v)
    return jax.grad(lambda q, k, v, m: jnp.sum(fn(q, k, v, m).astype(jnp.float32) * do),
                    argnums=(0, 1, 2, 3))(q, k, v, mask)


CASES = [((2, 2, 32, 16), True), ((2, 2, 32, 16), False), ((1, 3, 40, 8), True),
         ((3, 2, 24, 64), True), ((1, 2, 24, 64), False)]


@pytest.mark.parametrize("shape,masked", CASES,
                         ids=["L32-masked", "L32-nomask", "L40-masked", "L24-Dh64-masked",
                              "L24-Dh64-nomask"])
def test_backward_plain_matches_jax_grad(shape, masked):
    q, k, v, mask = _inputs(shape, 4, masked)
    if masked:  # one sequence with every key dropped: uniform P, a live mask cotangent
        mask[-1] = np.finfo(np.float32).min
    do = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    tm = None if mask is None else torch.from_numpy(mask)
    got = tattn.attention_backward_plain(*map(torch.from_numpy, (q, k, v)), tm,
                                         torch.from_numpy(do))
    assert (got[3] is None) == (mask is None)
    pallas = _jax_grads(lambda *a: jax_fused(*a, 128, True), q, k, v, mask, do)
    xla = _jax_grads(attention_reference, q, k, v, mask, do)
    for g, a, b in zip(got, pallas, xla):
        assert g.shape == a.shape
        _close(g.numpy(), a, 2e-4)
        _close(g.numpy(), b, 2e-4)


def test_backward_plain_bf16_matches_the_pallas_backward():
    q, k, v, mask = _inputs((2, 2, 64, 32), 6, True)
    do = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    neg = float(jnp.finfo(jnp.bfloat16).min)
    jm = jnp.where(jnp.asarray(mask) < 0, neg, 0).astype(jnp.bfloat16)
    tm = torch.where(torch.from_numpy(mask) < 0, neg, 0.0).to(torch.bfloat16)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    got = tattn.attention_backward_plain(tq, tk, tv, tm, tdo)
    want = _jax_grads(lambda *a: jax_fused(*a, 128, True), jq, jk, jv, jm,
                      jnp.asarray(tdo.float().numpy()))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g.float().numpy(), np.asarray(w, np.float32), 2e-2)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "nomask"])
def test_function_on_cpu_equals_autograd_of_the_plain_forward(masked):
    q, k, v, mask = _inputs((2, 3, 40, 16), 8, masked)
    do = torch.from_numpy(np.random.default_rng(9).standard_normal(q.shape).astype(np.float32))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    if masked:
        leaves.append(torch.from_numpy(mask).requires_grad_(True))
    m = leaves[3] if masked else None
    tattn.launches = tattn.bwd_launches = tattn.bwd_nomask_launches = 0
    out = tattn.fused_attention(*leaves[:3], m)
    assert type(out.grad_fn).__name__ == "_FusedAttentionBackward"
    got = torch.autograd.grad(out, leaves, do)
    want = torch.autograd.grad(tattn.attention_plain(*leaves[:3], m), leaves, do)
    written = tattn.attention_backward_plain(*leaves[:3], m, do)
    for g, w, x in zip(got, want, written):
        assert torch.equal(g, x)  # the Function's CPU backward is the plain version
        _close(g.numpy(), w.numpy(), 2e-5)  # written out step by step == autograd, f32
    # a mask that needs no gradient gets none; nothing was launched on the CPU
    if masked:
        out = tattn.fused_attention(*leaves[:3], leaves[3].detach())
        assert len(torch.autograd.grad(out, leaves[:3], do)) == 3
    assert (tattn.launches, tattn.bwd_launches, tattn.bwd_nomask_launches) == (0, 0, 0)
    with torch.no_grad():  # no gradient asked for: no Function in the way
        assert tattn.fused_attention(*leaves[:3], m).grad_fn is None


def test_gradient_flows_through_bert_views_without_copies():
    """q, k, v as BERT hands them over (views of [B, L, H*Dh] projections),
    the gradient arriving as a view too."""
    B, L, H, hd = 2, 16, 2, 8
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((B, L, H * hd)).astype(np.float32))
    ws = [torch.from_numpy(rng.standard_normal((H * hd, H * hd)).astype(np.float32) * 0.3)
          .requires_grad_(True) for _ in range(3)]

    def run(attend):
        q, k, v = ((x @ w).reshape(B, L, H, hd).transpose(1, 2) for w in ws)
        out = attend(q, k, v, None).transpose(1, 2).reshape(B, L, H * hd)
        return torch.autograd.grad(out.square().sum(), ws)

    for g, w in zip(run(tattn.fused_attention), run(tattn.attention_plain)):
        _close(g.numpy(), w.numpy(), 2e-5)


def test_function_under_activation_checkpointing():
    """A BERT whose layers are recomputed in the backward (``remat``) gives
    the gradients of one that keeps its activations, with the attention
    ``Function`` on the path (256 tokens: the gate lets it through)."""
    from drin_tpu_torch.encoders.bert import BertConfig, BertModel

    cfg = BertConfig(vocab_size=50, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=32, max_position_embeddings=256)
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(rng.integers(1, 50, (2, 256)))
    mask = torch.ones(2, 256, dtype=torch.int64)
    mask[1, 100:] = 0
    grads = []
    for remat in (False, True):
        bert = BertModel(cfg, remat=remat, fused_attention=True,
                         generator=torch.Generator().manual_seed(0))
        assert bert.encoder.layer[0].attention.self.takes_kernel("cpu", 256)
        hidden, pooled = bert(ids, mask)
        (hidden.square().mean() + pooled.sum()).backward()
        grads.append({n: p.grad.clone() for n, p in bert.named_parameters()})
    for n, g in grads[0].items():
        np.testing.assert_allclose(grads[1][n].numpy(), g.numpy(), rtol=1e-5, atol=1e-8, err_msg=n)


@pytest.mark.parametrize("L,lens", EDGE_CASES, ids=[f"L{L}" for L, _ in EDGE_CASES])
def test_backward_plain_matches_jax_grad_at_the_tile_edges(L, lens):
    """Lengths around the kernels' 64- and 128-row tiles, kept prefixes on both
    sides of a tile edge, and (L = 8, 136) a sequence with every key dropped:
    its P is uniform and its mask cotangent live."""
    shape = (len(lens), 2, L, 8)
    q, k, v, _ = _inputs(shape, 30 + L, False)
    mask = _prefix_mask(L, lens)
    do = np.random.default_rng(31 + L).standard_normal(shape).astype(np.float32)
    got = tattn.attention_backward_plain(*map(torch.from_numpy, (q, k, v, mask, do)))
    pallas = _jax_grads(lambda *a: jax_fused(*a, 64, True), q, k, v, mask, do)
    for g, a in zip(got, pallas):
        assert g.shape == a.shape and np.isfinite(g.numpy()).all()
        _close(g.numpy(), a, 2e-4)
    for b, n in enumerate(lens):
        if n == 0:  # uniform P = 1 / L: dV is the mean of dO over the queries, for every key
            want = np.broadcast_to(do[b].mean(-2, keepdims=True), do[b].shape)
            np.testing.assert_allclose(got[2][b].numpy(), want, rtol=2e-4, atol=1e-5)


def test_backward_workspace_is_cut_in_tiles_of_64_queries():
    """The wrapper allocates [B, H, ceil(L / STATS_TILE), 3, STATS_TILE] f32
    for the two launches; the dq kernel writes, and the dkv kernel's ring
    loads, tiles of ``kStatTile`` floats: the two sizes are one."""
    from test_torch_attention import _cu_constants

    env, text = _cu_constants("attention_bwd.cu")
    assert env["kStatTile"] == 3 * tattn.STATS_TILE == 192
    assert env["kBwdKT"] == tattn.STATS_TILE  # a streamed query tile and its statistics go together
    # a ring stage of the dkv kernel: Q, dO and 1024 bytes that hold the statistics
    assert env["kDkvStageBytes"] - 2 * env["kTile64"] >= env["kStatTile"] * 4
    assert env["kDkvStageTx"] == 2 * env["kTile64"] + env["kStatTile"] * 4
    assert "B * H * ceil(L / 64) * 192 floats" in text  # the C entry's contract for the workspace
    # the f32 kernels (split TF32 on wgmma) share the layout: the dq kernel
    # writes a tile per warpgroup of 64 queries, the dkv kernel's statistics
    # area holds one tile per raw stage, and each stage's barrier counts it
    assert env["kF32DqRows"] == env["kF32DqWG"] * tattn.STATS_TILE
    assert env["kF32DkvOffBars"] - env["kF32DkvOffStats"] == env["kF32DkvStages"] * env["kStatTile"] * 4
    assert "mbar_expect_tx(full(s), kF32StageBytes + kStatTile * 4)" in text
