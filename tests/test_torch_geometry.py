"""Geometry of the PyTorch port: the reference's recorded conventions
(tests/golden/*_io.npz, at their 1e-5) and the JAX package on the same
inputs (float32, 1e-5; 1e-4 where a warp interpolates values of order 1)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coalign_tpu.config import yaml_utils as JY
from coalign_tpu.ops import warp as JW
from coalign_tpu.utils import box_utils as JB
from coalign_tpu.utils import common as JC
from coalign_tpu.utils import transforms as JT
from coalign_tpu_torch.config import yaml_utils as TY
from coalign_tpu_torch.ops.warp import warp_agents_to_ego
from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
from coalign_tpu_torch.postprocess.decode import (correct_direction,
                                                  delta_to_boxes3d)
from coalign_tpu_torch.utils import box_utils as TB
from coalign_tpu_torch.utils import common as TC
from coalign_tpu_torch.utils import transforms as TT

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _poses(rng, shape, dof=6):
    p = np.zeros(shape + (dof,), np.float32)
    p[..., 0:2] = rng.uniform(-80, 80, shape + (2,))
    if dof == 6:
        p[..., 2] = rng.uniform(-1, 1, shape)
        p[..., 3:6] = rng.uniform(-10, 10, shape + (3,))
        p[..., 4] = rng.uniform(-180, 180, shape)
    else:
        p[..., 2] = rng.uniform(-180, 180, shape)
    return p


def test_normalize_pairwise_tfm_matches_reference_recording():
    io = np.load(os.path.join(GOLDEN, "pairwise_tfm_io.npz"))
    got = TT.normalize_pairwise_tfm(torch.from_numpy(io["mats"]), int(io["H"]),
                                    int(io["W"]), float(io["ds"]))
    np.testing.assert_allclose(got.numpy(), io["out"], atol=1e-5)


def test_anchors_and_decode_match_reference_recording():
    io = np.load(os.path.join(GOLDEN, "anchors_decode_io.npz"))
    anchors = generate_anchor_box({
        "W": 64, "H": 64, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
        "vw": 0.4, "vh": 0.4, "feature_stride": 2,
        "cav_lidar_range": [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0]})
    np.testing.assert_allclose(anchors, io["anchors"], atol=1e-5)
    boxes = delta_to_boxes3d(torch.from_numpy(io["deltas"]),
                             torch.from_numpy(anchors))
    np.testing.assert_allclose(boxes.numpy(), io["boxes"], atol=1e-5)


def test_warp_matches_reference_grid_sample_recording():
    io = np.load(os.path.join(GOLDEN, "grid_sample_io.npz"))
    x = torch.from_numpy(io["x"])                   # (3, C, H, W)
    theta = torch.from_numpy(io["theta"])           # (3, 2, 3)
    # agent slot 1 of a two-agent frame is sampled; slot 0 is the ego copy
    feats = torch.stack([torch.zeros_like(x), x], dim=1)
    aff = torch.stack([torch.zeros_like(theta), theta], dim=1)
    got = warp_agents_to_ego(feats, aff, torch.ones(3, 2, dtype=torch.bool))
    np.testing.assert_allclose(got[:, 1].numpy(), io["out"], atol=1e-5)


@pytest.mark.parametrize("dof", [3, 6])
def test_pose_and_pairwise_transforms_match_jax(dof):
    rng = np.random.default_rng(dof)
    poses = _poses(rng, (2, 4), dof)
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    np.testing.assert_allclose(
        TT.pose_to_tfm(torch.from_numpy(poses)).numpy(),
        np.asarray(JT.pose_to_tfm(jnp.asarray(poses))), atol=1e-5)
    got = TT.get_pairwise_transformation(torch.from_numpy(poses),
                                         torch.from_numpy(mask))
    want = np.asarray(JT.get_pairwise_transformation(jnp.asarray(poses),
                                                     jnp.asarray(mask)))
    # translations reach 160 m: 1e-5 relative to their size
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # the numpy path of the port computes the same
    np.testing.assert_allclose(TT.get_pairwise_transformation(poses, mask),
                               want, atol=1e-5, rtol=1e-5)
    aff = TT.normalize_pairwise_tfm(got, 200, 704, 0.4)
    np.testing.assert_allclose(
        aff.numpy(),
        np.asarray(JT.normalize_pairwise_tfm(jnp.asarray(want), 200, 704,
                                             0.4)), atol=1e-5)


def test_warp_agents_to_ego_matches_jax():
    rng = np.random.default_rng(11)
    b, l, h, w, c = 2, 3, 12, 20, 5
    feats = rng.normal(size=(b, l, h, w, c)).astype(np.float32)
    poses = _poses(rng, (b, l), 3)
    poses[..., :2] *= 0.02                          # within a 8 m x 5 m map
    mask = np.array([[1, 1, 1], [1, 0, 1]], bool)
    pair = JT.get_pairwise_transformation(poses, mask)
    aff = np.asarray(JT.normalize_pairwise_tfm(pair, h, w, 0.4))[:, 0]
    want = np.asarray(JW.warp_agents_to_ego(jnp.asarray(feats),
                                            jnp.asarray(aff),
                                            jnp.asarray(mask)))
    got = warp_agents_to_ego(torch.from_numpy(feats).permute(0, 1, 4, 2, 3),
                             torch.from_numpy(aff), torch.from_numpy(mask))
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want,
                               atol=1e-4)
    assert not got[1, 1].any()


def test_box_geometry_matches_jax():
    rng = np.random.default_rng(12)
    boxes = np.zeros((2, 50, 7), np.float32)
    boxes[..., :2] = rng.uniform(-60, 60, (2, 50, 2))
    boxes[..., 2] = rng.uniform(-3, 1.5, (2, 50))
    boxes[..., 3:6] = rng.uniform(0.5, 8.0, (2, 50, 3))
    boxes[..., 6] = rng.uniform(-7, 7, (2, 50))
    tfm = np.asarray(JT.pose_to_tfm(_poses(rng, (2,), 6)))
    want_c = np.asarray(JB.boxes_to_corners_3d(jnp.asarray(boxes), "hwl"))
    got_c = TB.boxes_to_corners_3d(torch.from_numpy(boxes), "hwl")
    np.testing.assert_allclose(got_c.numpy(), want_c, atol=1e-5, rtol=1e-6)
    want_p = np.stack([np.asarray(JB.project_box3d(jnp.asarray(want_c[i]),
                                                   jnp.asarray(tfm[i])))
                       for i in range(2)])
    got_p = TB.project_box3d(got_c, torch.from_numpy(tfm)[:, None])
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=1e-5, rtol=1e-6)
    rng_box = [-50.0, -40.0, -3.0, 50.0, 40.0, 1.0]
    for t_fn, j_fn in (
            (TB.remove_large_pred_bbx, JB.remove_large_pred_bbx),
            (TB.remove_bbx_abnormal_z, JB.remove_bbx_abnormal_z),
            (lambda c: TB.mask_corners_all_inside_range(c, rng_box),
             lambda c: JB.mask_corners_all_inside_range(c, rng_box))):
        np.testing.assert_array_equal(t_fn(torch.tensor(want_c)).numpy(),
                                      np.asarray(j_fn(want_c)))
        # numpy in, numpy out, as in the JAX package
        np.testing.assert_array_equal(t_fn(want_c), np.asarray(j_fn(want_c)))


def test_limit_period_and_direction_fix_match_jax():
    from coalign_tpu.postprocess.decode import correct_direction as jfix

    rng = np.random.default_rng(13)
    yaw = rng.uniform(-10, 10, 200).astype(np.float32)
    np.testing.assert_allclose(TC.limit_period(torch.from_numpy(yaw)).numpy(),
                               np.asarray(JC.limit_period(jnp.asarray(yaw))),
                               atol=1e-5)
    boxes = rng.normal(size=(1, 64, 7)).astype(np.float32) * 3
    logits = rng.normal(size=(1, 64, 2)).astype(np.float32)
    got = correct_direction(torch.from_numpy(boxes), torch.from_numpy(logits),
                            0.7853, 2)
    want = np.asarray(jfix(jnp.asarray(boxes), jnp.asarray(logits), 0.7853,
                           2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_flagship_yaml_loads_as_in_jax():
    path = os.path.join(REPO, "coalign_tpu", "hypes_yaml", "opv2v",
                        "pointpillar_coalign.yaml")
    assert TY.load_yaml(path) == JY.load_yaml(path)
