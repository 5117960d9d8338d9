# -*- coding: utf-8 -*-
"""The port's detection ops (``drin_tpu_torch.ops.detection``) against
``drin_tpu.ops.detection`` on the same seeded numpy inputs: IoU, box coding,
clipping, anchors and RoIAlign at rtol 2e-4 (float32 on both sides, the
same operation order; XLA may fuse differently), ``nms_plain`` index for
index against the JAX loop on random boxes and on the edge cases the smoke
run holds the kernel to (no score above -inf, every box equal, an IoU
exactly at the threshold, equal scores), batched problems against one at a
time, and the detector's bilinear resize against ``jax.image.resize``.
The NMS kernel itself runs on the card only (``chip_smoke.py``'s
``phase_nms``); here its wrapper's refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.ops import detection as jdet
from drin_tpu_torch.ops import detection as tdet
from drin_tpu_torch.ops.cuda import nms as cuda_nms

F32 = dict(rtol=2e-4, atol=1e-5)


def _boxes(rng, n, lo=0.0, hi=80.0, wmin=2.0, wmax=40.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(wmin, wmax, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_iou_matches_jax_and_is_symmetric():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 30), _boxes(rng, 20)
    a[3] = [5, 5, 5, 9]  # zero width
    got = tdet.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdet.box_iou(a, b)), **F32)
    sq = tdet.box_iou(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(sq, sq.T)  # bit for bit: the kernel's mask rows rely on it
    batched = tdet.box_iou(torch.from_numpy(np.stack([a[:20], b])), torch.from_numpy(np.stack([b, a[:20]])))
    np.testing.assert_array_equal(batched[1].numpy(), tdet.box_iou(torch.from_numpy(b), torch.from_numpy(a[:20])).numpy())


@pytest.mark.parametrize("size,stride,sizes,ratios", [
    ((5, 7), 4, (32,), (0.5, 1.0, 2.0)),
    ((3, 2), 16, (32, 64, 128), (0.5, 1.0, 2.0)),
    ((2, 2), 64, (512,), (0.5, 1.0, 2.0)),
    ((4, 3), 8, (5, 11), (0.25, 1.0, 3.0))])  # halves: rounded to even
def test_generate_anchors_matches_jax(size, stride, sizes, ratios):
    got = tdet.generate_anchors(size, stride, sizes, ratios).numpy()
    want = np.asarray(jdet.generate_anchors(size, stride, sizes, ratios))
    np.testing.assert_array_equal(got, want)


def test_box_coding_and_clip_match_jax():
    rng = np.random.default_rng(1)
    anchors = _boxes(rng, 50, wmin=4.0)
    deltas = rng.standard_normal((50, 4)).astype(np.float32)
    deltas[:5, 2:] = 9.0  # past the exp clip
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        got = tdet.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors), w).numpy()
        np.testing.assert_allclose(got, np.asarray(jdet.decode_boxes(deltas, anchors, w)), **F32)
        boxes = _boxes(rng, 50, wmin=4.0)
        got = tdet.encode_boxes(torch.from_numpy(boxes), torch.from_numpy(anchors), w).numpy()
        np.testing.assert_allclose(got, np.asarray(jdet.encode_boxes(boxes, anchors, w)), **F32)
    # batched over images, and clipped
    d3, a3 = deltas.reshape(5, 10, 4), anchors.reshape(5, 10, 4)
    got = tdet.decode_boxes(torch.from_numpy(d3), torch.from_numpy(a3)).numpy().reshape(50, 4)
    np.testing.assert_allclose(got, np.asarray(jdet.decode_boxes(deltas, anchors)), **F32)
    big = _boxes(rng, 50, lo=-30.0, hi=100.0)
    np.testing.assert_array_equal(tdet.clip_boxes(torch.from_numpy(big), 64.0, 80.0).numpy(),
                                  np.asarray(jdet.clip_boxes(big, 64.0, 80.0)))


@pytest.mark.parametrize("aligned,ratio,scale", [(True, 2, 0.25), (True, 1, 0.5), (False, 2, 0.125)])
def test_roi_align_matches_jax(aligned, ratio, scale):
    rng = np.random.default_rng(2)
    H, W, C = 13, 11, 5
    feats = rng.standard_normal((H, W, C)).astype(np.float32)
    boxes = _boxes(rng, 12, lo=0.0, hi=0.9 / scale * W, wmin=1.0, wmax=0.5 / scale * W)
    boxes[0] = [-20.0, -12.0, 10.0, 8.0]  # past the top-left border: zero-padded samples
    boxes[1] = [0.8 / scale * W, 0.7 / scale * H, 1.6 / scale * W, 1.5 / scale * H]  # bottom-right
    boxes[2] = [3.0, 3.0, 3.0, 3.0]  # degenerate
    got = tdet.roi_align(torch.from_numpy(feats), torch.from_numpy(boxes), (7, 7), scale, ratio,
                         aligned).numpy()
    want = np.asarray(jdet.roi_align(feats, boxes, (7, 7), scale, ratio, aligned))
    np.testing.assert_allclose(got, want, **F32)
    assert np.abs(want[1]).min() == 0.0  # the border box really reads zeros somewhere


def test_roi_align_nchw_batches_images():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((3, 4, 9, 10)).astype(np.float32)
    boxes = _boxes(rng, 8, hi=30.0, wmax=20.0)
    image = np.array([2, 0, 1, 1, 0, 2, 2, 0])
    got = tdet.roi_align_nchw(torch.from_numpy(feats), torch.from_numpy(boxes),
                              torch.from_numpy(image), (7, 7), 0.25).numpy()
    for k in range(8):
        want = np.asarray(jdet.roi_align(feats[image[k]].transpose(1, 2, 0), boxes[k:k + 1],
                                         (7, 7), 0.25))[0].transpose(2, 0, 1)
        np.testing.assert_allclose(got[k], want, **F32)


def nms_edge_cases():
    """(name, boxes [N, 4], scores [N], threshold, top_k): the cases the
    kernel is held to on the card, at a size the CPU runs in a moment."""
    rng = np.random.default_rng(4)
    cases = []
    b = _boxes(rng, 40)
    cases.append(("no score above -inf", b, np.full(40, -np.inf, np.float32), 0.5, 10))
    some = rng.uniform(0, 1, 40).astype(np.float32)
    some[rng.uniform(size=40) < 0.6] = -np.inf
    cases.append(("some -inf", b, some, 0.5, 40))
    cases.append(("every box equal", np.tile(b[:1], (40, 1)), rng.uniform(0, 1, 40).astype(np.float32),
                  0.5, 10))
    # IoU exactly 0.5: [0,0,4,1] against [0,0,2,1] (inter 2, union 4); a
    # `>=` would remove the second, `>` keeps both
    at = np.array([[0, 0, 4, 1], [0, 0, 2, 1], [10, 10, 14, 11], [10, 10, 12, 11]], np.float32)
    cases.append(("IoU at the threshold", at, np.array([0.9, 0.8, 0.7, 0.6], np.float32), 0.5, 4))
    ties = rng.integers(0, 4, 40).astype(np.float32) / 4  # four distinct scores
    cases.append(("equal scores", b, ties, 0.3, 40))
    cases.append(("top_k past N", b[:6], rng.uniform(0, 1, 6).astype(np.float32), 0.5, 9))
    return cases


@pytest.mark.parametrize("case", nms_edge_cases(), ids=lambda c: c[0])
def test_nms_plain_matches_jax_on_edge_cases(case):
    _, boxes, scores, thr, top_k = case
    got = tdet.nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores), thr, top_k).numpy()
    want = np.asarray(jdet.nms(boxes, scores, thr, top_k))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


def test_nms_plain_matches_jax_on_random_problems_batched():
    """20 random problems (RPN-like: many overlaps, threshold 0.7; class
    NMS-like: offset labels, threshold 0.5) in one batched call, each equal
    to JAX's loop on its own problem."""
    rng = np.random.default_rng(5)
    P, N = 20, 120
    boxes = np.stack([_boxes(rng, N) for _ in range(P)])
    labels = rng.integers(1, 6, (P, N)).astype(np.float32)
    boxes[10:] += labels[10:, :, None] * 202.0
    scores = rng.standard_normal((P, N)).astype(np.float32)
    scores[rng.uniform(size=(P, N)) < 0.1] = -np.inf
    for thr, top_k in ((0.7, N), (0.5, 30)):
        got = tdet.nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr, top_k).numpy()
        nms_jit = jax.jit(jdet.nms, static_argnums=(2, 3))
        for p in range(P):
            np.testing.assert_array_equal(got[p], np.asarray(nms_jit(boxes[p], scores[p], thr, top_k)))
    # the leading dimensions come back as they went in
    got = tdet.nms(torch.from_numpy(boxes.reshape(4, 5, N, 4)),
                   torch.from_numpy(scores.reshape(4, 5, N)), 0.5, 7)
    assert got.shape == (4, 5, 7)


def test_nms_cuda_refuses_what_it_cannot_take():
    b, s = torch.zeros(3, 4), torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_nms.nms_cuda(b, s, 0.5, 2)
    # on the CPU the dispatching nms never reaches the kernel
    before = cuda_nms.launches
    assert tdet.nms(b, s, 0.5, 2).tolist() == [0, 1]  # zero-area boxes: IoU 0
    assert cuda_nms.launches == before


def test_resize_bilinear_matches_jax_upsample_borders():
    """56 -> 200 (the stage's 224 -> 800 ratio, smaller): every row,
    the border rows whose outer taps fall off the image included."""
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (2, 56, 48, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (2, 200, 172, 3), "bilinear"))
    got = tdet.resize_bilinear(torch.from_numpy(img).permute(0, 3, 1, 2), (200, 172))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:, [0, 1, -2, -1]], want[:, [0, 1, -2, -1]], rtol=1e-5, atol=1e-6)
