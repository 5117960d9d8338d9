# -*- coding: utf-8 -*-
"""The port's Faster R-CNN (``drin_tpu_torch.encoders.frcnn``) against
``drin_tpu.encoders.frcnn`` at the JAX suite's ``TINY`` widths.

One fabricated torchvision state dict (``tests/test_frcnn.py``'s, in the
key layout before torchvision 0.13 and after) goes through both packages'
loaders (``load_detector`` from a ``torch.save``d file; the JAX package's
``frcnn_params_from_torch``); then flax ``init`` params go through
``frcnn_state_dict_from_jax``.  Compared on two seeded images: the five FPN
levels, the RPN logits and the proposals (the flax model's, captured where
it hands them to the RoI stage) at rtol 2e-4 (float32 on both sides, sums
in another order); the detections' labels exactly, scores at rtol 1e-4 and
boxes within 1e-3 px (``tests/test_frcnn.py``'s own oracle tolerances).  Also
``load_detector``'s ``mask_rcnn`` / ``faster_rcnn`` validation and its
refusal of a missing key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drin_tpu.encoders import frcnn as jfrcnn
from drin_tpu_torch.encoders import frcnn as tfrcnn
from drin_tpu_torch.encoders.checkpoints import load_detector
from drin_tpu_torch.models.convert import frcnn_state_dict_from_jax
from test_frcnn import TINY, _fabricate_torchvision_sd

F32 = dict(rtol=2e-4, atol=1e-5)
T_TINY = tfrcnn.FRCNNConfig(
    depths=(1, 1, 1, 1), stem_width=8, fpn_channels=16,
    anchor_sizes=((16,), (32,), (64,), (128,), (256,)),
    pre_nms_topk=50, post_nms_topk=20, detections_per_img=5,
    num_classes=7, representation_size=32, min_size=64)


class _Captured(jfrcnn.FasterRCNN):
    """The flax model, sowing the proposals it hands to the RoI stage."""

    def _multiscale_roi_align(self, feats, boxes, output_size):
        self.sow("intermediates", "proposals", boxes)
        return super()._multiscale_roi_align(feats, boxes, output_size)


def _images(seed=1, n=2, size=64):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


def _jax_side(params, images):
    """Per image: FPN levels (NHWC), RPN logits, proposals and detections."""
    model = _Captured(TINY)
    run = jax.jit(lambda p, x: model.apply({"params": p}, x, mutable=["intermediates"]))
    bound = jfrcnn.FasterRCNN(TINY).bind({"params": params})
    out = []
    for img in images:
        (boxes, scores, labels), state = run(params, img)
        x = (img - np.asarray(TINY.image_mean)) / np.asarray(TINY.image_std)
        feats = bound.fpn(bound.body(jnp.asarray(x)[None]))
        logits, _ = bound.rpn_head(feats)
        out.append(dict(feats=[np.asarray(f[0]) for f in feats],
                        logits=[np.asarray(lg[0]) for lg in logits],
                        proposals=np.asarray(state["intermediates"]["proposals"][0]),
                        boxes=np.asarray(boxes), scores=np.asarray(scores),
                        labels=np.asarray(labels)))
    return out


def _port_side(state_dict, images):
    with torch.device("meta"):
        model = tfrcnn.FasterRCNN(T_TINY)
    model.load_state_dict(state_dict, assign=True)
    model = model.float().eval()
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.inference_mode():
        feats = model.features(x)
        logits, deltas = model.rpn.head(feats)
        proposals = model.proposals(feats, logits, deltas, 64, 64)
        boxes, scores, labels = model(x)
    return dict(feats=[f.permute(0, 2, 3, 1).numpy() for f in feats],
                logits=[lg.permute(0, 2, 3, 1).numpy() for lg in logits],
                proposals=proposals.numpy(), boxes=boxes.numpy(), scores=scores.numpy(),
                labels=labels.numpy())


def _compare(port, jax_out):
    found = 0
    for i, want in enumerate(jax_out):
        for lvl in range(5):
            np.testing.assert_allclose(port["feats"][lvl][i], want["feats"][lvl], **F32,
                                       err_msg=f"image {i} FPN level {lvl}")
            np.testing.assert_allclose(port["logits"][lvl][i], want["logits"][lvl], **F32,
                                       err_msg=f"image {i} RPN logits {lvl}")
        np.testing.assert_allclose(port["proposals"][i], want["proposals"], rtol=2e-4, atol=1e-3,
                                   err_msg=f"image {i} proposals")
        np.testing.assert_array_equal(port["labels"][i], want["labels"])
        np.testing.assert_allclose(port["scores"][i], want["scores"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(port["boxes"][i], want["boxes"], rtol=1e-3, atol=1e-3)
        found += int((want["scores"] > 0).sum())
    assert found, "no detection to compare: the check would hold nothing"


def _save(tmp_path, sd, name="frcnn.pt"):
    path = tmp_path / name
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    return str(path)


@pytest.mark.parametrize("new_style", [False, True], ids=["pre-0.13 keys", "0.13 keys"])
def test_frcnn_from_one_torchvision_state_dict_matches_jax(new_style, tmp_path):
    sd = _fabricate_torchvision_sd(TINY, new_style)
    cfg, port_sd = load_detector(_save(tmp_path, sd), T_TINY, "faster_rcnn")
    assert cfg is T_TINY
    images = _images()
    _compare(_port_side(port_sd, images), _jax_side(jfrcnn.frcnn_params_from_torch(sd, TINY), images))


def test_both_key_layouts_load_the_same_tensors(tmp_path):
    _, old = load_detector(_save(tmp_path, _fabricate_torchvision_sd(TINY, False), "a.pt"), T_TINY)
    _, new = load_detector(_save(tmp_path, _fabricate_torchvision_sd(TINY, True), "b.pt"), T_TINY)
    assert sorted(old) == sorted(new)
    for k in old:
        torch.testing.assert_close(old[k], new[k], rtol=0, atol=0, msg=k)


def test_frcnn_from_flax_init_params_matches_jax():
    images = _images(seed=2)
    params = jax.jit(jfrcnn.FasterRCNN(TINY).init)(jax.random.key(0), images[0])["params"]
    params = jax.tree.map(np.asarray, params)
    _compare(_port_side(frcnn_state_dict_from_jax(params, TINY), images), _jax_side(params, images))


def test_load_detector_validates_the_architecture(tmp_path):
    mask = _save(tmp_path, _fabricate_torchvision_sd(TINY, True, mask_rcnn=True), "mask.pt")
    plain = _save(tmp_path, _fabricate_torchvision_sd(TINY, True), "plain.pt")
    _, sd = load_detector(mask, T_TINY, "mask_rcnn")  # the mask branch is dropped
    assert not any(k.startswith("roi_heads.mask_") for k in sd)
    with pytest.raises(ValueError, match="no roi_heads.mask"):
        load_detector(plain, T_TINY, "mask_rcnn")
    with pytest.raises(ValueError, match="has roi_heads.mask"):
        load_detector(mask, T_TINY, "faster_rcnn")
    with pytest.raises(ValueError, match="unknown drin_object_detector"):
        load_detector(plain, T_TINY, "yolo")
    partial = _fabricate_torchvision_sd(TINY, True)
    del partial["rpn.head.bbox_pred.bias"]
    with pytest.raises(KeyError, match="rpn.head.bbox_pred.bias"):
        load_detector(_save(tmp_path, partial, "partial.pt"), T_TINY)


def test_assign_levels_matches_jax():
    rng = np.random.default_rng(3)
    side = np.concatenate([rng.uniform(1, 900, 60), [224.0, 112.0, 448.0, 0.0]]).astype(np.float32)
    boxes = np.stack([np.zeros_like(side), np.zeros_like(side), side, side * 0.5], 1)
    got = tfrcnn.assign_levels(torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfrcnn.assign_levels(boxes)))
