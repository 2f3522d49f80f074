"""The port's matcher (coalign_tpu_torch/models/matcher.py) and its pieces
against the JAX package's (coalign_tpu/models/matcher.py), on the CPU:

  * tests/golden/matcher_io.npz, the reference matcher's recording, at the
    JAX test's 2e-5 (tests/test_fpvrcnn.py::
    test_match_and_fuse_reference_golden_parity);
  * the port's quad_intersection_area (utils/iou.py) against the JAX
    package's quad_intersection_area_sorted on the matcher's pairs, and
    boxes_iou3d_matrix in its 'pcdet' and 'hwl' orders, within 1e-5;
  * both versions ('ref', 'nms') of match_and_fuse on three agents' boxes
    of a few shared objects, batched over two frames, within 1e-5 of the
    JAX package's, masks equal;
  * fault 4 (ROADMAP §3), padded boxes: zero boxes appended with valid
    False change no cluster, no fused box and no score in either version,
    and the port's output on the zero-padded input is the JAX package's;
    nms_rotated's ``max_keep`` is the JAX cap, and zero boxes change no
    survivor of the NMS.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coalign_tpu.models import matcher as JM
from coalign_tpu.utils.iou import quad_intersection_area_sorted
from coalign_tpu.utils.nms import nms_rotated as jax_nms
from coalign_tpu_torch.models import matcher as M
from coalign_tpu_torch.utils.box_utils import boxes_to_corners_3d
from coalign_tpu_torch.utils.iou import quad_intersection_area
from coalign_tpu_torch.utils.nms import nms_rotated

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "matcher_io.npz")
RANGE = [-30.0, -30.0, -3.0, 30.0, 30.0, 1.0]


def _t(x):
    return torch.from_numpy(np.array(x))


def _agents_boxes(seed: int, frames: int = 2, agents: int = 3,
                  per_agent: int = 6):
    """Each agent's noisy view of ``per_agent`` shared objects, some of
    them seen flipped by pi: boxes (F, A * per_agent, 7) 'hwl', scores and
    valid (about one box in six invalid)."""
    rng = np.random.default_rng(seed)
    objs = np.concatenate([
        rng.uniform(-20, 20, (frames, 1, per_agent, 2)),
        rng.uniform(-1.5, -0.5, (frames, 1, per_agent, 1)),
        np.broadcast_to([1.5, 1.8, 4.2], (frames, 1, per_agent, 3)),
        rng.uniform(-np.pi, np.pi, (frames, 1, per_agent, 1))], -1)
    noise = np.concatenate([
        rng.normal(0, 0.3, (frames, agents, per_agent, 3)),
        rng.normal(0, 0.1, (frames, agents, per_agent, 3)),
        rng.normal(0, 0.05, (frames, agents, per_agent, 1))
        + np.pi * (rng.random((frames, agents, per_agent, 1)) < 0.2)], -1)
    boxes = (objs + noise).reshape(frames, -1, 7).astype(np.float32)
    scores = rng.uniform(0.2, 1.0, boxes.shape[:2]).astype(np.float32)
    valid = rng.random(boxes.shape[:2]) > 0.15
    return boxes, scores, valid


def _pad(boxes, scores, valid, extra: int):
    """Zero boxes, zero scores, valid False appended (padded slots)."""
    f = boxes.shape[0]
    return (np.concatenate([boxes, np.zeros((f, extra, 7), np.float32)], 1),
            np.concatenate([scores, np.zeros((f, extra), np.float32)], 1),
            np.concatenate([valid, np.zeros((f, extra), bool)], 1))


def _jax_match(boxes, scores, valid, version, max_keep):
    out = jax.vmap(lambda b, s, v: JM.match_and_fuse(
        b, s, v, 0.1, max_keep, version=version, gt_range=RANGE))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_match(boxes, scores, valid, version, max_keep):
    out = M.match_and_fuse(_t(boxes), _t(scores), _t(valid), 0.1, max_keep,
                           version=version, gt_range=RANGE)
    return {k: v.numpy() for k, v in out.items()}


def _same_fusion(got, want, atol=1e-5):
    np.testing.assert_array_equal(got["mask"], want["mask"])
    m = want["mask"]
    np.testing.assert_allclose(got["boxes"][m][:, :6], want["boxes"][m][:, :6],
                               rtol=0, atol=atol)
    for fn in (np.sin, np.cos):
        np.testing.assert_allclose(fn(got["boxes"][m][:, 6]),
                                   fn(want["boxes"][m][:, 6]), rtol=0,
                                   atol=atol)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=atol)
    assert not got["boxes"][~m].any() and not got["scores"][~m].any()


def test_matcher_reference_golden():
    io = np.load(GOLDEN)
    boxes = np.concatenate([io["agent0"], io["agent1"]], axis=0)
    scores = np.concatenate([io["scores0"], io["scores1"]], axis=0)
    pad_b = np.zeros((12, 7), np.float32)
    pad_b[:len(boxes)] = boxes
    pad_s = np.zeros((12,), np.float32)
    pad_s[:len(scores)] = scores
    valid = np.arange(12) < len(boxes)
    out = M.match_and_fuse(_t(pad_b[None]), _t(pad_s[None]), _t(valid[None]),
                           0.1, max_keep=8, version="ref",
                           gt_range=io["pc_range"].tolist())
    m = out["mask"][0].numpy()
    got_boxes = out["boxes"][0].numpy()[m]
    got_scores = out["scores"][0].numpy()[m]
    want_boxes = io["boxes_fused"]
    assert got_boxes.shape == want_boxes.shape
    np.testing.assert_allclose(got_boxes[:, :6], want_boxes[:, :6], atol=2e-5)
    np.testing.assert_allclose(np.sin(got_boxes[:, 6]),
                               np.sin(want_boxes[:, 6]), atol=2e-5)
    np.testing.assert_allclose(np.cos(got_boxes[:, 6]),
                               np.cos(want_boxes[:, 6]), atol=2e-5)
    np.testing.assert_allclose(got_scores, io["scores_fused"].reshape(-1),
                               atol=2e-5)


def test_intersection_areas_and_iou3d_match_jax():
    boxes, _, _ = _agents_boxes(7, frames=1)
    boxes = _pad(boxes, np.zeros((1, 18)), np.zeros((1, 18), bool), 2)[0][0]
    c = boxes_to_corners_3d(boxes, "lwh")[:, :4, :2]
    k = len(c)
    c1 = np.broadcast_to(c[:, None], (k, k, 4, 2))
    c2 = np.broadcast_to(c[None, :], (k, k, 4, 2))
    want = np.asarray(quad_intersection_area_sorted(jnp.asarray(c1),
                                                    jnp.asarray(c2)))
    got = quad_intersection_area(_t(c1), _t(c2)).numpy()
    assert (want > 1.0).sum() > k                # overlaps beyond the diagonal
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    for order in ("pcdet", "hwl"):
        want = np.asarray(JM.boxes_iou3d_matrix(jnp.asarray(boxes), order))
        got = M.boxes_iou3d_matrix(_t(boxes), order).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=order)
        # the zero boxes of padded slots: IoU 0 with every box
        assert not got[-2:].any() and not got[:, -2:].any()


@pytest.mark.parametrize("version", ["ref", "nms"])
def test_match_and_fuse_matches_jax(version):
    boxes, scores, valid = _agents_boxes(11)
    want = _jax_match(boxes, scores, valid, version, 12)
    got = _port_match(boxes, scores, valid, version, 12)
    assert want["mask"].sum() >= 8              # several clusters a frame
    _same_fusion(got, want)


@pytest.mark.parametrize("version", ["ref", "nms"])
def test_padded_boxes_change_nothing(version):
    """Fault 4: zero boxes in padded slots are masked by ``valid``; they
    change no cluster and no fused box or score, in the port as in the
    JAX package, which the port matches on the padded input."""
    boxes, scores, valid = _agents_boxes(13)
    padded = _pad(boxes, scores, valid, 6)
    bare = _port_match(boxes, scores, valid, version, 12)
    got = _port_match(*padded, version, 12)
    want = _jax_match(*padded, version, 12)
    _same_fusion(got, want)
    np.testing.assert_array_equal(got["mask"], bare["mask"])
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key], bare[key], rtol=0, atol=1e-6)
    assert np.isfinite(got["boxes"]).all()


def test_nms_max_keep_and_padding_match_jax():
    boxes, scores, valid = _agents_boxes(17, frames=1, per_agent=10)
    boxes, scores, valid = _pad(boxes, scores, valid, 6)
    n = boxes.shape[1] - 6
    corners = boxes_to_corners_3d(boxes, "hwl")[..., :4, :2]
    uncapped = None
    for max_keep in (None, 4):
        order, keep = nms_rotated(_t(corners), _t(scores), _t(valid), 0.15,
                                  max_keep=max_keep)
        jorder, jkeep = jax_nms(jnp.asarray(corners[0]), jnp.asarray(scores[0]),
                                jnp.asarray(valid[0]), 0.15, max_keep=max_keep)
        np.testing.assert_array_equal(order[0].numpy(), np.asarray(jorder))
        np.testing.assert_array_equal(keep[0].numpy(), np.asarray(jkeep))
        if max_keep is None:
            uncapped = int(keep.sum())
        assert int(keep.sum()) == (4 if max_keep else uncapped) < uncapped \
            or max_keep is None
        # the padded zero boxes survive nothing and suppress nothing
        kept = set(order[0][keep[0]].tolist())
        assert kept.isdisjoint(range(n, n + 6))
        o2, k2 = nms_rotated(_t(corners[:, :n]), _t(scores[:, :n]),
                             _t(valid[:, :n]), 0.15, max_keep=max_keep)
        assert set(o2[0][k2[0]].tolist()) == kept
