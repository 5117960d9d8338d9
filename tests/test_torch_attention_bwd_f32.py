# -*- coding: utf-8 -*-
"""Kernel 3's float32 backward in split-precision TF32, its numerics on the
CPU.

The card's float32 backward (``csrc/attention_bwd.cu``, ``attn_bwd_dq_f32``
and ``attn_bwd_dkv_f32``) takes all five products on ``wgmma`` with TF32
operands, each operand split into hi and lo and each product taken as
lo.hi + hi.lo + hi.hi in float32 (``tests/test_torch_attention_f32.py``
emulates the same split for the forward):

* the dq launch: S = q.k^T, dP = dO.v^T, then dQ = s dS.K over K^T tiles;
* the dkv launch, on the transposed tiles: S^T = k.q^T, dP^T = v.dO^T, then
  dV = P^T.dO and dK = s dS^T.q over dO^T and q^T tiles; dmask = the column
  sums of dS^T, summed over heads by the wrapper.

P and dS leave the accumulators as split A fragments whose key (or query)
positions come in the order 0 2 4 6 1 3 5 7 within each group of 8, and the
transposed B tiles hold their rows in that order; the softmax is recomputed
in natural units from the forward's row max m and row sum l, and delta is
rowsum(dO * o) of the forward's output.  The CUDA kernels cannot run here,
so this file emulates that arithmetic with plain tensor code (it is on no
path of the package) and holds it against the kernels' plain version and
``jax.grad`` of the JAX package's Pallas kernel (interpret mode) and its
reference, at the port's float32 tolerance (rtol 2e-4 / atol 1e-5), with the
measured gap required to be far smaller; and it shows that one TF32 pass
falls outside the tolerance ``chip_smoke.py`` holds the card's kernels to,
and so does delta left out of dS."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from drin_tpu.ops.pallas.attention import attention_reference, fused_attention as jax_fused
from drin_tpu_torch.ops.cuda import attention as tattn
from test_torch_attention_f32 import F32, _inputs, _split

# the order in which a product's accumulator hands its columns over as A
# positions 0..7 of a k-step (columns 2t at t, 2t + 1 at t + 4), and in which
# the transposed B tiles hold their rows
PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])
# the split's own gap to the float32 plain version, as a share of the floor
# chip_smoke.py's ATTN_BWD_F32_TOL allows (1e-5 of the sequence's largest
# value beyond rtol 1e-4): 0.02-0.05 measured here and at the card's
# [4, 12, 512, 64] and [2, 12, 264, 64], held at 0.5
SPLIT_SHARE = 0.5


def _order(n: int) -> torch.Tensor:
    """Positions 0..n-1 as the kernels walk a summed dimension of n (a
    multiple of 8): each group of 8 in PERM's order."""
    return torch.from_numpy((np.arange(0, n, 8)[:, None] + PERM[None]).reshape(-1))


def _product(a, b, passes: int = 3):
    """a @ b on the tensor cores in split precision, the summed dimension in
    the kernels' order: A's columns and B's rows permuted alike."""
    order = _order(a.shape[-1])
    a, b = a[..., order], b[..., order, :]
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    if passes == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _emulated_backward(q, k, v, mask, do, passes: int = 3, delta: bool = True):
    """(dq, dk, dv, dmask) as the two launches compute them; mask [B, L] or
    None.  ``delta=False`` leaves delta out of dS (a planted fault)."""
    scale = q.shape[-1] ** -0.5
    qT, kT, vT, doT = (x.transpose(-1, -2) for x in (q, k, v, do))
    col = 0 if mask is None else mask[:, None, None, :]
    # the f32 forward: logits from the same split product, m the row max,
    # l = sum exp(logit - m), o = e.v / l
    logits = _product(q, kT, passes) * scale + col
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    l = e.sum(-1, keepdim=True)
    o = _product(e, v, passes) / l
    dl = (do * o).sum(-1, keepdim=True) if delta else torch.zeros_like(l)
    # dq launch: rows are queries
    p = torch.exp(_product(q, kT, passes) * scale + col - m) / l
    ds = p * (_product(do, vT, passes) - dl)
    dq = _product(ds, k, passes) * scale
    # dkv launch: rows are keys, the statistics broadcast along them
    row = 0 if mask is None else mask[:, None, :, None]
    mT, lT, dlT = (x.transpose(-1, -2) for x in (m, l, dl))
    pT = torch.exp(_product(k, qT, passes) * scale + row - mT) / lT
    dsT = pT * (_product(v, doT, passes) - dlT)
    dv = _product(pT, do, passes)
    dk = _product(dsT, q, passes) * scale
    dmask = None if mask is None else dsT.sum(-1).sum(1)
    return dq, dk, dv, dmask


def _do(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_grads(fn, q, k, v, mask, do):
    if mask is None:
        return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v, None) * do), argnums=(0, 1, 2))(q, k, v)
    return jax.grad(lambda q, k, v, m: jnp.sum(fn(q, k, v, m) * do), argnums=(0, 1, 2, 3))(q, k, v, mask)


def test_permuted_product_is_the_product():
    """The kernels' order of a summed dimension pairs A's positions with B's
    rows: the permuted product in float64 is the plain one to rounding."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(s)).double() for s in ((5, 24), (24, 7)))
    order = _order(24)
    assert sorted(order.tolist()) == list(range(24)) and order[:8].tolist() == PERM.tolist()
    torch.testing.assert_close(a[:, order] @ b[order], a @ b, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("B,H,L,lens", [
    (2, 1, 128, [128, 50]),      # two tiles each way, one of them ragged by the mask
    (3, 1, 136, [136, 0, 9]),    # L past a tile edge, a sequence with every key dropped
    (2, 1, 8, [8, 3]),           # a sequence shorter than one tile
    (2, 1, 72, None)],           # the mask-free form, ragged
    ids=["L128", "L136-ragged", "L8", "L72-nomask"])
def test_split_tf32_backward_matches_plain_and_jax(B, H, L, lens):
    q, k, v, mask = _inputs(B, H, L, 40 + L, lens if lens is not None else [L] * B)
    if lens is None:
        mask = None
    do = _do(q.shape, 41 + L)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    got = _emulated_backward(tq, tk, tv, tm, tdo)
    plain = tattn.attention_backward_plain(tq, tk, tv, tm, tdo)
    pallas = _jax_grads(lambda *a: jax_fused(*a, 64, True), q, k, v, mask, do)
    xla = _jax_grads(attention_reference, q, k, v, mask, do)
    n = 3 if mask is None else 4
    assert (got[3] is None) == (mask is None)
    for name, g, w, a, x in zip(("dq", "dk", "dv", "dmask")[:n], got, plain, pallas, xla):
        g = g.numpy()
        assert g.shape == w.shape == a.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w.numpy(), **F32, err_msg=name)
        np.testing.assert_allclose(g, np.asarray(a), **F32, err_msg=name)
        np.testing.assert_allclose(g, np.asarray(x), **F32, err_msg=name)
        # the card's check, with the floor's share in use far below 1
        share = chip_smoke.excess_rel(torch.from_numpy(g), w, **chip_smoke.ATTN_BWD_F32_TOL).max().item()
        assert share <= SPLIT_SHARE, (name, share)
    for b, kept in enumerate(lens or []):
        if kept == 0:  # uniform P = 1 / L: dV is the mean of dO over the queries, for every key
            want = np.broadcast_to(do[b].mean(-2, keepdims=True), do[b].shape)
            np.testing.assert_allclose(got[2][b].numpy(), want, **F32)


@pytest.mark.parametrize("fault", ["one TF32 pass", "delta left out of dS"])
def test_planted_faults_fall_outside_the_card_tolerance(fault):
    """The faults ``chip_smoke.py`` plants at its float32 backward cases: the
    products with one TF32 pass (hi.hi alone), and dS without delta.  Each
    puts values outside ``ATTN_BWD_F32_TOL``, which the three-pass split
    stays inside."""
    q, k, v, mask = map(torch.from_numpy, _inputs(2, 4, 256, 3, [256, 100]))
    do = torch.from_numpy(_do(tuple(q.shape), 4))
    want = tattn.attention_backward_plain(q, k, v, mask, do)
    tol = chip_smoke.ATTN_BWD_F32_TOL
    good = _emulated_backward(q, k, v, mask, do)
    assert all(chip_smoke.outside_rel(g, w, **tol) == 0 for g, w in zip(good, want))
    bad = _emulated_backward(q, k, v, mask, do, **({"passes": 1} if fault == "one TF32 pass"
                                                    else {"delta": False}))
    seen = dict(zip(("dq", "dk", "dv", "dmask"),
                    (chip_smoke.outside_rel(g, w, **tol) for g, w in zip(bad, want))))
    assert seen["dq"] > want[0].numel() // 100, seen
    # dV = P^T.dO does not read delta
    assert all(n for name, n in seen.items() if fault == "one TF32 pass" or name != "dv"), seen


def _emulated_attention(passes: int):
    """The kernels' float32 attention as an autograd Function: the forward
    and backward emulations above."""
    from test_torch_attention_f32 import _emulated

    class Split(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask):
            ctx.save_for_backward(q, k, v, mask)
            return _emulated(q, k, v, mask, passes)

        @staticmethod
        def backward(ctx, do):
            q, k, v, mask = ctx.saved_tensors
            dq, dk, dv, _ = _emulated_backward(q, k, v, mask, do, passes)
            return dq, dk, dv, None

    return Split.apply


def test_split_moves_a_small_berts_gradients_by_float32_roundings():
    """The prediction behind ``chip_smoke.TRAIN_F32_GRAD_REL``: in a 2-layer
    BERT at L=256 (Dh=64, a prefix mask), the gradients through the split
    differ from those through the plain float32 attention by ~1e-6 relative L2
    per tensor (the key biases left out, as on the card); one TF32 pass moves
    them by ~1e-3, a planted fault the card's limit (1e-4) must see, and the
    split stays far under that limit."""
    from drin_tpu_torch.encoders import bert as bert_module
    from drin_tpu_torch.encoders.bert import BertConfig, BertModel

    L, hidden = 256, 128
    cfg = BertConfig(vocab_size=100, hidden_size=hidden, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=2 * hidden, max_position_embeddings=L)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 100, (4, L)))
    mask = torch.ones(4, L, dtype=torch.int64)
    mask[1, 100:], mask[2, 9:] = 0, 0
    w = torch.from_numpy(rng.standard_normal((4, L, hidden)).astype(np.float32))
    bert = BertModel(cfg, fused_attention=True, generator=torch.Generator().manual_seed(0))

    def grads(attend):
        bert.zero_grad(set_to_none=True)
        bert_module.fused_attention = attend
        try:
            hidden_states, pooled = bert(ids, mask)
            ((hidden_states * w).sum() + pooled.sum()).backward()
        finally:
            bert_module.fused_attention = tattn.fused_attention
        return {n: p.grad.clone() for n, p in bert.named_parameters()
                if p.grad is not None and not n.endswith("attention.self.key.bias")}

    plain = grads(tattn.attention_plain)
    worst = {}
    for passes in (3, 1):
        g = grads(_emulated_attention(passes))
        worst[passes] = max(((g[n] - plain[n]).norm() / plain[n].norm()).item() for n in plain)
    limit = chip_smoke.TRAIN_F32_GRAD_REL
    assert worst[3] <= limit / 20, worst
    assert worst[1] >= 5 * limit, worst
