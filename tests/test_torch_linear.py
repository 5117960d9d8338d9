# -*- coding: utf-8 -*-
"""The float32 linear of ``drin_tpu_torch/ops/cuda/linear.py`` on the CPU:
its plain version, the wrapper's refusals, the split image's lifetime, its
autograd backward, the kernel's layout arithmetic, and BERT through it.

The kernel itself (``csrc/linear_f32.cu``) runs only on the card:
``chip_smoke.phase_linear`` holds it against a float64 product there."""

from __future__ import annotations

import copy
import math
import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from drin_tpu_torch.encoders.bert import BertConfig, BertModel
from drin_tpu_torch.ops.cuda import linear as lin


def _problem(M=6, K=64, sizes=(128,), seed=0, residual=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    ws = [torch.randn(n, K, generator=g) * 0.05 for n in sizes]
    bs = [torch.randn(n, generator=g) * 0.05 for n in sizes]
    res = torch.randn(M, sum(sizes), generator=g) if residual else None
    return x, ws, bs, res


@pytest.mark.parametrize("epi,sizes", [("bias", (128,)), ("gelu", (128,)), ("residual", (128,)),
                                       ("bias", (64, 64, 64)), ("gelu", (64, 64, 64))],
                         ids=["bias", "gelu", "residual", "stacked", "stacked-gelu"])
def test_plain_is_f_linear_and_its_epilogue_bit_for_bit(epi, sizes):
    """One weight: ``F.linear`` then the epilogue; several: their outputs
    stacked on a new first dimension."""
    x, ws, bs, res = _problem(sizes=sizes, residual=epi == "residual")
    got = lin.linear_plain(x, ws, bs, gelu=epi == "gelu", residual=res)
    want = [F.linear(x, w, b) for w, b in zip(ws, bs)]
    want = want[0] if len(want) == 1 else torch.stack(want)
    if epi == "gelu":
        want = F.gelu(want, approximate="none")
    if res is not None:
        want = res + want
    assert torch.equal(got, want)
    # the CPU path of the wrapper is the plain version, whatever image it is handed
    assert torch.equal(lin.linear(x, ws, bs, gelu=epi == "gelu", residual=res,
                                  image=lin.SplitImage()), want)


class _OnCard:
    """A CPU tensor that claims to live on a CUDA device, for the wrapper's
    argument checks (there is no card where these tests run)."""

    def __init__(self, t):
        self._t, self.device, self.is_cuda = t, torch.device("cuda:0"), True

    def __getattr__(self, name):
        return getattr(self._t, name)


def _card(M=64, K=768, sizes=(768,), dtype=torch.float32, residual=False):
    z = lambda *s: _OnCard(torch.zeros(s, dtype=dtype))  # noqa: E731
    res = _OnCard(torch.zeros(M, sum(sizes))) if residual else None
    return z(M, K), [z(n, K) for n in sizes], [z(n) for n in sizes], res


# refusals of the weights, made when an image is built; every other case is
# refused before one is
WEIGHT_CASES = {"K=760", "K=16", "N=700", "stacked N=320", "weight on the CPU", "bias shape",
                "stacked shapes", "four weights", "bias misaligned"}


@pytest.mark.parametrize("case,match", [
    ("bf16", "takes float32"), ("fp16", "takes float32"), ("K=760", "multiple of 32"),
    ("K=16", "multiple of 32"), ("rows strided", "contiguous rows"),
    ("3-D strided", "must be contiguous"), ("row stride", "16 bytes apart"),
    ("N=700", "multiple of 128"), ("stacked N=320", "multiple of 128"),
    ("gelu and residual", "not both"), ("stacked residual", "one weight"),
    ("weight on the CPU", "must be on"), ("bias shape", "share one shape"),
    ("stacked shapes", "share one shape"), ("x's K", "does not fit"),
    ("residual shape", "residual must be"), ("four weights", "one to three"),
    ("bias misaligned", "bias must start 8-byte aligned"),
    ("residual misaligned", "residual must start 8-byte aligned")])
def test_cuda_checks_refuse_what_the_kernel_does_not_take(monkeypatch, case, match):
    """Every type, shape and layout the kernel does not take is refused by
    name before a launch, on the launch's own path (``_prepare``); what is
    wrong with x or the residual before any image is built."""
    x, ws, bs, res = _card(dtype={"bf16": torch.bfloat16, "fp16": torch.float16}.get(case, torch.float32))
    gelu = False
    if case.startswith("K="):
        K = int(case[2:])
        x, ws, bs, res = _card(K=K)
    elif case == "rows strided":
        x = _OnCard(torch.zeros(768, 64).t())
    elif case == "3-D strided":
        x = _OnCard(torch.zeros(4, 64, 768)[:, ::2])
    elif case == "row stride":
        x = _OnCard(torch.zeros(64, 770)[:, :768])
    elif case == "N=700":
        x, ws, bs, res = _card(sizes=(700,))
    elif case == "stacked N=320":
        x, ws, bs, res = _card(sizes=(320, 320, 320))
    elif case == "gelu and residual":
        x, ws, bs, res = _card(residual=True)
        gelu = True
    elif case == "stacked residual":
        x, ws, bs, res = _card(sizes=(768, 768, 768))
        res = _OnCard(torch.zeros(64, 3 * 768))
    elif case == "stacked shapes":
        x, ws, bs, res = _card(sizes=(768, 768, 1536))
    elif case == "x's K":
        x = _OnCard(torch.zeros(64, 800))
    elif case == "weight on the CPU":
        ws = [torch.zeros(768, 768)]
    elif case == "bias shape":
        bs = [_OnCard(torch.zeros(767))]
    elif case == "residual shape":
        res = _OnCard(torch.zeros(64, 767))
    elif case == "four weights":
        x, ws, bs, res = _card(sizes=(192, 192, 192, 192))
    elif case == "bias misaligned":  # a contiguous view one float in
        bs = [_OnCard(torch.zeros(769)[1:])]
    elif case == "residual misaligned":
        res = _OnCard(torch.zeros(64 * 768 + 1)[1:].view(64, 768))
    built, image = [], lin._image
    monkeypatch.setattr(lin, "_image", lambda w, b: (built.append(len(w)), image(w, b))[1])
    with pytest.raises(ValueError, match=match):
        lin._prepare(x, ws, bs, res, gelu, None)
    assert built == ([len(ws)] if case in WEIGHT_CASES else [])


@pytest.mark.parametrize("sizes,residual", [((768,), False), ((768, 768, 768), False),
                                            ((3072,), False), ((768,), True)])
def test_cuda_checks_take_berts_products(sizes, residual):
    """BERT's four products: the stacked query / key / value, the attention
    output with its residual, the FFN's two; x of 3 dimensions too.  The
    weights pass the build's checks; ``_prepare`` then takes x with the kept
    image."""
    x, ws, bs, res = _card(sizes=sizes, residual=residual)
    image = lin.SplitImage()
    image.get(ws, bs, lambda w, b: (lin._check_weights(w, b, w[0].device), ("image", "bias"))[1])
    assert lin._prepare(x, ws, bs, res, False, image) == ("image", "bias", 64, sum(sizes), 768)
    x3 = _OnCard(torch.zeros(2, 32, 768))
    res3 = _OnCard(torch.zeros(2, 32, sum(sizes))) if residual else None
    gelu = not residual and len(sizes) == 1
    assert lin._prepare(x3, ws, bs, res3, gelu, image)[2:] == (64, sum(sizes), 768)


@pytest.mark.parametrize("M,N,cols", [(36864, 768, 128), (36864, 2304, 128), (36864, 3072, 128),
                                      (1024, 768, 64), (1024, 2304, 128), (1024, 3072, 128),
                                      (128, 128, 64)])
def test_tile_width_from_m(M, N, cols):
    """128-column tiles, but 64 where the 128-column ones leave the SMs idle
    for longer than the narrow tiles' lower rate costs."""
    assert lin.tile_cols(M, N, 132) == cols


def _counting_build(calls):
    def build(weights, biases):
        calls.append(tuple(weights))
        return torch.cat(list(weights)), torch.cat(list(biases))
    return build


def test_split_image_is_kept_while_the_weights_are_unchanged():
    """The image is built once for the same tensors; an in-place update, a
    replaced tensor or ``.data`` swapped build a new one, and ``splits``
    counts each build; a copied module starts without one."""
    x, ws, bs, _ = _problem(sizes=(128, 128))
    image, calls = lin.SplitImage(), []
    build = _counting_build(calls)
    before = lin.splits
    img, bias = image.get(ws, bs, build)
    assert torch.equal(img, torch.cat(ws)) and torch.equal(bias, torch.cat(bs))
    image.get(ws, bs, build)
    image.get(list(ws), tuple(bs), build)  # the same tensors in another container
    assert len(calls) == 1 and lin.splits == before + 1
    with torch.no_grad():
        ws[1].add_(1.0)  # an optimizer step's in-place update
    img, _ = image.get(ws, bs, build)
    assert len(calls) == 2 and torch.equal(img[128:], ws[1])
    bs[0].mul_(2.0)  # a bias counts too
    image.get(ws, bs, build)
    swapped = [w.clone() for w in ws]  # other tensors with the same values
    image.get(swapped, bs, build)
    image.get(ws, bs, build)
    ws[0].data = ws[0].data.clone()  # the same tensor over new storage
    image.get(ws, bs, build)
    assert len(calls) == 6 and lin.splits == before + 6
    assert copy.deepcopy(image).state is None and pickle.loads(pickle.dumps(image)).state is None


def test_split_image_builds_once_for_threads_at_once():
    """Several threads of one module's forward (the HTTP front's, the
    micro-batcher's flushes in flight) asking a fresh image for the same
    weights while it is built: one build, and every thread gets it."""
    _, ws, bs, _ = _problem(sizes=(128, 128))
    image, calls, n = lin.SplitImage(), [], 8
    start = threading.Barrier(n)

    def slow_build(weights, biases):
        calls.append(1)
        time.sleep(0.05)  # the build's launch and allocations release the GIL
        return torch.cat(list(weights)), torch.cat(list(biases))

    def ask(_):
        start.wait()
        return image.get(ws, bs, slow_build)

    with ThreadPoolExecutor(n) as pool:
        got = list(pool.map(ask, range(n)))
    assert len(calls) == 1
    assert all(img is got[0][0] and bias is got[0][1] for img, bias in got)
    assert torch.equal(got[0][0], torch.cat(ws))


def test_split_image_sees_a_functional_call_swap():
    """A module whose forward reads its weight through a SplitImage, called
    through ``torch.func.functional_call`` with other tensors (the trainer's
    swaps, a remat's recompute): each swap builds an image of the tensors
    handed in, and the module's own weights build theirs again after."""
    calls = []
    build = _counting_build(calls)

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dense = torch.nn.Linear(32, 128)
            self.image = lin.SplitImage()

        def forward(self, x):
            img, bias = self.image.get([self.dense.weight], [self.dense.bias], build)
            return F.linear(x, img, bias)

    m, x = Probe(), torch.randn(3, 32)
    m(x)
    m(x)
    assert len(calls) == 1
    other = {n: p.detach() * 2 for n, p in m.named_parameters()}
    got = torch.func.functional_call(m, other, (x,))
    assert len(calls) == 2 and calls[-1][0] is other["dense.weight"]
    assert torch.allclose(got, F.linear(x, other["dense.weight"], other["dense.bias"]))
    same = dict(m.named_parameters())  # a remat hands in the layer's own tensors: kept
    torch.func.functional_call(m, same, (x,))
    assert len(calls) == 3  # the last image was the swap's
    m(x)
    assert len(calls) == 3 and calls[-1][0] is m.dense.weight


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """The autograd Function with its launch replaced by the plain product
    over the stacked weights (the image): the backward under test is the
    one the card runs."""
    def check(x, weights, biases, residual, gelu):
        return x.numel() // x.shape[-1], sum(w.shape[0] for w in weights), x.shape[-1]

    def prepare(x, weights, biases, residual, gelu, image):
        img, bias = (image or lin.SplitImage()).get(weights, biases, lin._image)
        return (img, bias, *check(x, weights, biases, residual, gelu))

    def launch(x, img, bias, M, N, K, n, epi, residual=None, lib_fn=None):
        y = F.linear(x, img, bias)
        if n > 1:  # the stacked outputs, each contiguous
            y = torch.stack(y.split(N // n, dim=-1))
        if epi == lin.EPI_GELU:
            y = F.gelu(y, approximate="none")
        return residual + y if epi == lin.EPI_RESIDUAL else y

    monkeypatch.setattr(lin, "_prepare", prepare)
    monkeypatch.setattr(lin, "_launch", launch)
    monkeypatch.setattr(lin, "_image", lambda ws, bs: (torch.cat(list(ws)), torch.cat(list(bs))))


@pytest.mark.parametrize("epi,sizes", [("bias", (128,)), ("gelu", (128,)), ("residual", (128,)),
                                       ("bias", (64, 64, 64))],
                         ids=["bias", "gelu", "residual", "stacked"])
def test_autograd_backward_is_the_plain_products(kernel_on_cpu, epi, sizes):
    """Gradients of x, the weights, the biases and the residual through the
    Function's hand-written backward (gelu's derivative from the kept
    input) against autograd through ``linear_plain``, x of 3 dimensions."""
    x, ws, bs, res = _problem(M=10, sizes=sizes, residual=epi == "residual", seed=3)
    x = x.reshape(2, 5, -1)
    res = None if res is None else res.reshape(2, 5, -1)
    gelu = epi == "gelu"
    shape = (2, 5, sizes[0]) if len(sizes) == 1 else (len(sizes), 2, 5, sizes[0])
    g = torch.randn(*shape, generator=torch.Generator().manual_seed(4))

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in [x, *ws, *bs]
                  + ([res] if res is not None else [])]
        xx, rest = leaves[0], leaves[1:]
        n = len(ws)
        y = fn(xx, rest[:n], rest[n:2 * n], rest[2 * n] if res is not None else None)
        (y * g).sum().backward()
        return y.detach(), [t.grad for t in leaves]

    y_f, g_f = grads(lambda xx, w, b, r: lin._Linear.apply(xx, r, gelu, lin.SplitImage(), len(w),
                                                           *w, *b))
    y_p, g_p = grads(lambda xx, w, b, r: lin.linear_plain(xx, w, b, gelu, r))
    torch.testing.assert_close(y_f, y_p, rtol=0, atol=0)
    for a, b in zip(g_f, g_p):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_autograd_leaves_what_needs_no_gradient(kernel_on_cpu):
    """Frozen weights (BERT under finetune_bert=False upstream of a trained
    head): x alone gets a gradient."""
    x, ws, bs, _ = _problem(sizes=(128,))
    x.requires_grad_()
    y = lin._Linear.apply(x, None, True, None, 1, *ws, *bs)
    y.sum().backward()
    assert x.grad is not None and ws[0].grad is None and bs[0].grad is None


def _tf32(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: to nearest on the 13 low mantissa bits, ties away."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    return (((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _image_like_the_kernel(ws: list, K: int) -> np.ndarray:
    """``linear_image_f32``'s index arithmetic, element by element: [N / 128]
    [K / 32][hi, lo][128][32], 16-byte chunk pc of row r holding chunk
    pc ^ (r % 8), a k-step's positions 0..7 holding columns 0 2 4 6 1 3 5 7."""
    W = np.concatenate(ws).astype(np.float32)
    N = W.shape[0]
    img = np.zeros((N // 128, K // 32, 2, 128, 32), np.float32)
    for nb in range(N // 128):
        for ks in range(K // 32):
            for r in range(128):
                for pc in range(8):
                    c = pc ^ (r & 7)
                    cols = ks * 32 + (c >> 1) * 8 + (c & 1) + np.array([0, 2, 4, 6])
                    x = W[nb * 128 + r, cols]
                    hi = _tf32(x)
                    img[nb, ks, 0, r, 4 * pc:4 * pc + 4] = hi
                    img[nb, ks, 1, r, 4 * pc:4 * pc + 4] = _tf32(x - hi)
    return img


@pytest.mark.parametrize("passes", [3, 1])
def test_kernel_layout_gives_the_product(passes):
    """The kernel's operands as its index arithmetic reads them, emulated for
    one 64-row consumer tile of 128 columns over K = 64: A's fragments from
    the raw x tile (thread (g, t) of warp w at rows 16 w + (2 (g % 4) + g / 4)
    (+ 8), positions t and t + 4 of k-step kk at columns 8 kk + 2t and + 1,
    as the tile's 128-byte swizzle lays them), B from the image at the
    wgmma descriptor's K-major, 128-byte-swizzled reading.  Three TF32
    passes give the float64 product within a few float32 roundings; one
    pass (the planted fault) does not."""
    rng = np.random.default_rng(7)
    K, N = 64, 128
    x = rng.standard_normal((64, K)).astype(np.float32)
    ws = [(rng.standard_normal((N, K)) * 0.05).astype(np.float32)]
    img = _image_like_the_kernel(ws, K)
    # the x tile as TMA lays it: row r's 16-byte chunk c at chunk c ^ (r % 8)
    acc = np.zeros((64, N), np.float64)
    for ks in range(K // 32):
        tile = np.zeros((64, 32), np.float32)
        for r in range(64):
            for c in range(8):
                tile[r, 4 * (c ^ (r & 7)):4 * (c ^ (r & 7)) + 4] = x[r, ks * 32 + 4 * c:ks * 32 + 4 * c + 4]
        for kk in range(4):
            a = np.zeros((64, 8), np.float32)  # A [64 rows, 8 positions] as the fragments hold it
            rows = np.zeros(64, int)
            for w in range(4):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for h in range(2):
                        frag_row = 16 * w + g + 8 * h
                        row = 16 * w + ((g & 3) << 1 | g >> 2) + 8 * h
                        rows[frag_row] = row
                        byte = ((2 * kk + (t >> 1)) ^ (row & 7)) * 16 + (t & 1) * 8
                        a[frag_row, t], a[frag_row, t + 4] = tile[row, byte // 4], tile[row, byte // 4 + 1]
            b = np.zeros((2, N, 8), np.float32)  # B [n, position], hi and lo
            for n in range(N):
                for p in range(8):
                    byte = kk * 32 + 4 * p
                    phys = ((byte // 16) ^ (n & 7)) * 16 + byte % 16
                    b[:, n, p] = img[0, ks, :, n, phys // 4]
            ahi = _tf32(a)
            alo = _tf32(a - ahi)
            terms = [(ahi, b[0])] if passes == 1 else [(alo, b[0]), (ahi, b[1]), (ahi, b[0])]
            for aa, bb in terms:
                acc[rows] += aa.astype(np.float64) @ bb.T.astype(np.float64)
    want = x.astype(np.float64) @ ws[0].T.astype(np.float64)
    err = np.abs(acc - want).max() / np.abs(want).max()
    if passes == 3:
        assert err < 2e-6, err
    else:
        assert err > 2e-5, err


def _bert(remat=False, seed=0):
    cfg = BertConfig(vocab_size=50, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=128, max_position_embeddings=64)
    return BertModel(cfg, remat=remat, generator=torch.Generator().manual_seed(seed))


def _bert_before(model, ids, mask):
    """BertModel's forward as it was written before its float32 linears went
    through ``linear``: three separate projections, ``F.gelu`` after the
    intermediate ``F.linear``, ``residual + dense(h)``; same parameters."""
    x = model.embeddings(ids, torch.zeros_like(ids))
    neg = torch.finfo(x.dtype).min
    additive = torch.zeros(mask.shape, dtype=x.dtype).masked_fill(mask == 0, neg)[:, None, None, :]
    for layer in model.encoder.layer:
        sa = layer.attention.self
        B, L, D = x.shape
        H = sa.num_heads
        q, k, v = (m(x).reshape(B, L, H, D // H).transpose(1, 2) for m in (sa.query, sa.key, sa.value))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D // H) + additive
        att = torch.matmul(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(B, L, D)
        out = layer.attention.output
        x = out.LayerNorm(x + out.dense(att))
        h = F.gelu(layer.intermediate.dense(x), approximate="none")
        x = layer.output.LayerNorm(x + layer.output.dense(h))
    return x, torch.tanh(model.pooler.dense(x[:, 0]))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_bert_on_the_cpu_is_unchanged(remat):
    """BertModel in float32 on the CPU, its linears through ``linear``'s
    plain version: the outputs equal the forward as written before bit for
    bit, and the gradients of every parameter agree (the stacked q / k / v
    product's backward sums x's three gradient terms in another order)."""
    model = _bert(remat)
    ids = torch.randint(0, 50, (3, 16), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, 10:] = 0

    def run(fn):
        model.zero_grad(set_to_none=True)
        x, p = fn()
        (x.square().mean() + p.sum()).backward()
        return x.detach(), p.detach(), {n: q.grad.clone() for n, q in model.named_parameters()}

    x_new, p_new, g_new = run(lambda: model(ids, mask))
    x_old, p_old, g_old = run(lambda: _bert_before(model, ids, mask))
    assert torch.equal(x_new, x_old) and torch.equal(p_new, p_old)
    for n in g_old:
        torch.testing.assert_close(g_new[n], g_old[n], rtol=1e-6, atol=1e-7, msg=n)


def test_bert_stacked_qkv_equals_the_three_projections():
    """The stacked product's q, k and v: one [3, B, L, D] output whose parts
    are contiguous [B, L, D] tensors, laid out as the three projections lay
    theirs, holding exactly what they give."""
    model = _bert()
    sa = model.encoder.layer[0].attention.self
    x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(5))
    parts = (sa.query, sa.key, sa.value)
    qkv = lin.linear(x, [m.weight for m in parts], [m.bias for m in parts], image=sa.qkv_image)
    assert qkv.shape == (3, 2, 8, 64)
    for got, m in zip(qkv.unbind(0), parts):
        want = m(x)
        assert got.is_contiguous() and got.stride() == want.stride() and torch.equal(got, want)


def test_bert_bf16_keeps_f_linear(monkeypatch):
    """Only float32 activations take ``linear``: a bf16 BERT (the served and
    trained bf16 bodies) never calls it, and neither does the pooler."""
    from drin_tpu_torch.encoders import bert as bert_module

    seen = []
    real = bert_module.linear
    monkeypatch.setattr(bert_module, "linear", lambda x, *a, **kw: (seen.append(x.dtype), real(x, *a, **kw))[1])
    model = _bert()
    ids = torch.randint(0, 50, (2, 8), generator=torch.Generator().manual_seed(2))
    model(ids, torch.ones_like(ids))
    assert seen == [torch.float32] * 8  # 4 a layer: q / k / v, attention out, FFN in, FFN out
    seen.clear()
    model.to(torch.bfloat16)(ids, torch.ones_like(ids))
    assert seen == []
