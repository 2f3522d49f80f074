"""The port's pose graph (coalign_tpu_torch/posegraph) against the JAX
package's (coalign_tpu/posegraph) on the CPU, on seeded problems of
tests/test_posegraph.py's generator (copied here) made harder: random
uncertainties, yaw-varying clusters, single-agent boxes and empty slots.

Bounds: cluster labels and the abandoned decision exactly; refined x and y
within 1e-3 m and yaw within 1e-3 degrees in float32 (the two float32
programs agree to ~2e-6 on these problems); the analytic Jacobian within
1e-10 relative of autograd's in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coalign_tpu.posegraph import BoxAlignConfig as JaxConfig
from coalign_tpu.posegraph import align_poses_batch as jax_align_batch
from coalign_tpu.posegraph import box_align as JB
from coalign_tpu.posegraph import box_alignment_relative_sample as jax_sample
from coalign_tpu_torch.posegraph import (BoxAlignConfig,
                                         align_poses_batch,
                                         box_alignment_relative_sample)
from coalign_tpu_torch.posegraph import box_align as TB
from coalign_tpu_torch.utils.transforms import get_pairwise_transformation

FLAGS = {"default": {}, "no_abandon": {"abandon_hard_cases": False},
         "keep_hard_boxes": {"drop_hard_boxes": False},
         "landmark_R2": {"landmark_SE2": False},
         "adaptive_landmark": {"adaptive_landmark": True},
         "no_uncertainty": {"use_uncertainty": False},
         "normalized_uncertainty": {"normalize_uncertainty": True}}


def _se2_apply_inv(pose, xyyaw):
    """World box (x, y, yaw-rad) -> agent frame given agent (x, y, yaw-rad)."""
    c, s = np.cos(pose[2]), np.sin(pose[2])
    dx, dy = xyyaw[0] - pose[0], xyyaw[1] - pose[1]
    return np.array([c * dx + s * dy, -s * dx + c * dy, xyyaw[2] - pose[2]])


def _make_problem(rng, l=3, k=12, n_landmarks=8, pos_noise=0.4,
                  yaw_noise_deg=2.0):
    true_pose = np.zeros((l, 6), dtype=np.float32)
    true_pose[1:, 0] = rng.uniform(-10, 10, l - 1)
    true_pose[1:, 1] = rng.uniform(-10, 10, l - 1)
    true_pose[1:, 4] = rng.uniform(-60, 60, l - 1)

    landmarks = np.zeros((n_landmarks, 3), dtype=np.float32)
    landmarks[:, 0] = rng.uniform(-25, 25, n_landmarks)
    landmarks[:, 1] = rng.uniform(-25, 25, n_landmarks)
    landmarks[:, 2] = rng.uniform(-np.pi, np.pi, n_landmarks)

    boxes = np.zeros((l, k, 3), dtype=np.float32)
    mask = np.zeros((l, k), dtype=bool)
    for a in range(l):
        se2 = np.array([true_pose[a, 0], true_pose[a, 1],
                        np.deg2rad(true_pose[a, 4])])
        for j in range(n_landmarks):
            boxes[a, j] = _se2_apply_inv(se2, landmarks[j])
            mask[a, j] = True

    noisy = true_pose.copy()
    noisy[:, :2] += rng.normal(0, pos_noise, (l, 2))
    noisy[:, 4] += rng.normal(0, yaw_noise_deg, l)
    unc = np.full((l, k, 3), -3.0, dtype=np.float32)  # confident
    agent_mask = np.ones(l, dtype=bool)
    return true_pose, noisy, boxes, mask, unc, agent_mask


def _hard_problem(seed: int, **kw):
    """_make_problem with detection noise (0.1 m, 0.05 rad), random
    log-variances, two clusters whose yaw varies (agent 1 sees them turned
    by 1.2 rad), one box that only agent 2 sees and a masked slot holding a
    box that must be ignored."""
    rng = np.random.default_rng(seed)
    true_pose, noisy, boxes, mask, unc, agent_mask = _make_problem(rng, **kw)
    boxes += rng.normal(0.0, [0.1, 0.1, 0.05], boxes.shape).astype(np.float32)
    unc = rng.uniform(-4.0, -1.0, unc.shape).astype(np.float32)
    boxes[1, :2, 2] += 1.2
    boxes[2, -2] = [40.0, 40.0, 0.3]
    mask[2, -2] = True
    boxes[0, -1] = boxes[1, 0]
    return true_pose, noisy, boxes, mask, unc, agent_mask


def _jax_refined(problem, cfg_kw):
    _, noisy, boxes, mask, unc, agent_mask = problem
    return np.asarray(jax_sample(
        jnp.asarray(boxes), jnp.asarray(mask), jnp.asarray(unc),
        jnp.asarray(noisy), jnp.asarray(agent_mask), JaxConfig(**cfg_kw)))


def _port(problem, cfg_kw, dtype=torch.float32):
    _, noisy, boxes, mask, unc, agent_mask = problem
    t = [torch.as_tensor(x)[None] for x in (boxes, mask, unc, noisy,
                                             agent_mask)]
    t = [x.to(dtype) if x.is_floating_point() else x for x in t]
    out = TB.align_xyyaw(*t, cfg=BoxAlignConfig(**cfg_kw))
    return {k: v[0].numpy() for k, v in out.items()}


def _jax_labels(problem, thres=1.5):
    """The JAX package's _cluster_min_label on the boxes' world distances
    (box_align.py:117-144, in numpy float32)."""
    _, noisy, boxes, mask, _, agent_mask = problem
    l, k, _ = boxes.shape
    ego = noisy[0, :2]
    se2 = np.stack([noisy[:, 0] - ego[0], noisy[:, 1] - ego[1],
                    np.deg2rad(noisy[:, 4])], -1).astype(np.float32)
    agent = np.repeat(np.arange(l), k)
    ap = se2[agent]
    flat = boxes.reshape(-1, 3)
    c, s = np.cos(ap[:, 2]), np.sin(ap[:, 2])
    wx = ap[:, 0] + c * flat[:, 0] - s * flat[:, 1]
    wy = ap[:, 1] + s * flat[:, 0] + c * flat[:, 1]
    xy = np.stack([wx, wy], -1)
    d2 = ((xy[:, None] - xy[None]) ** 2).sum(-1)
    dist = np.sqrt(np.maximum(d2, 1e-12)).astype(np.float32)
    valid = (mask & agent_mask[:, None]).reshape(-1)
    return np.asarray(JB._cluster_min_label(
        jnp.asarray(dist), jnp.asarray(valid),
        jnp.asarray(agent[:, None] == agent[None]), thres))


def _assert_poses_close(got, want, what):
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=1e-3, err_msg=f"{what}: x, y (m)")
    dyaw = np.abs((got[..., 2] - want[..., 2] + 180.0) % 360.0 - 180.0)
    assert dyaw.max() <= 1e-3, f"{what}: yaw off by {dyaw.max()} degrees"


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_under_each_flag(flag, seed):
    problem = _hard_problem(seed)
    want = _jax_refined(problem, FLAGS[flag])
    got = _port(problem, FLAGS[flag])
    np.testing.assert_array_equal(got["labels"], _jax_labels(problem))
    jax_abandoned = np.array_equal(want, problem[1][:, [0, 1, 4]])
    assert bool(got["abandoned"]) == jax_abandoned
    _assert_poses_close(got["refined"], want, flag)


def test_flags_change_the_solution():
    # every flag of FLAGS moves the refined poses on the hard problem, so
    # the parity above holds each code path, not one path seven times
    problem = _hard_problem(0)
    base = _port(problem, {})["refined"]
    for flag, kw in FLAGS.items():
        if kw and "abandon" not in flag:
            assert np.abs(_port(problem, kw)["refined"] - base).max() > 1e-4, \
                flag


def test_recovers_relative_poses():
    # tests/test_posegraph.py::test_recovers_relative_poses on the port
    problem = _make_problem(np.random.default_rng(303))
    true_pose, noisy, boxes, mask, unc, agent_mask = problem
    refined = box_alignment_relative_sample(boxes, mask, unc, noisy,
                                            agent_mask, device="cpu").numpy()

    def pair_err(xyyaw):
        pose = np.zeros((3, 6), np.float32)
        pose[:, [0, 1, 4]] = xyyaw
        mask = np.ones(3, bool)
        return np.abs(get_pairwise_transformation(pose, mask)[..., :2, 3]
                      - get_pairwise_transformation(true_pose, mask)
                      [..., :2, 3]).max()
    assert pair_err(noisy[:, [0, 1, 4]]) > 0.2
    assert pair_err(refined) < 0.05
    np.testing.assert_allclose(refined[0], noisy[0, [0, 1, 4]], atol=1e-5)


def test_single_sample_entry_point_matches_jax():
    problem = _hard_problem(2)
    _, noisy, boxes, mask, unc, agent_mask = problem
    got = box_alignment_relative_sample(boxes, mask, unc, noisy, agent_mask,
                                        device="cpu").numpy()
    _assert_poses_close(got, _jax_refined(problem, {}), "sample")


def test_masked_agent_rows_unchanged():
    true_pose, noisy, boxes, mask, unc, agent_mask = _make_problem(
        np.random.default_rng(4), l=4)
    agent_mask[2] = False
    problem = (true_pose, noisy, boxes, mask, unc, agent_mask)
    got = _port(problem, {})
    assert not got["abandoned"]
    np.testing.assert_array_equal(got["refined"][2], noisy[2, [0, 1, 4]])
    _assert_poses_close(got["refined"], _jax_refined(problem, {}), "masked")
    np.testing.assert_array_equal(got["labels"], _jax_labels(problem))


def test_few_landmarks_abandoned():
    problem = _make_problem(np.random.default_rng(5), n_landmarks=3)
    got = _port(problem, {"abandon_hard_cases": True})
    assert got["abandoned"]
    np.testing.assert_array_equal(got["refined"], problem[1][:, [0, 1, 4]])
    np.testing.assert_array_equal(_jax_refined(problem, {}),
                                  problem[1][:, [0, 1, 4]])


def test_batch_of_three_matches_jax():
    problems = [_hard_problem(s) for s in (6, 7, 8)]
    stacked = [np.stack([p[i] for p in problems]) for i in range(1, 6)]
    noisy, boxes, mask, unc, agent_mask = stacked
    stacked[4][1, 2] = False                 # a padded agent in sample 1
    want = np.asarray(jax_align_batch(
        jnp.asarray(boxes), jnp.asarray(mask), jnp.asarray(unc),
        jnp.asarray(noisy), jnp.asarray(agent_mask)))
    got = align_poses_batch(boxes, mask, unc, noisy, agent_mask,
                            device="cpu")
    assert got.dtype == torch.float32 and got.shape == (3, 3, 6)
    got = got.numpy()
    _assert_poses_close(got[..., [0, 1, 4]], want[..., [0, 1, 4]], "batch")
    np.testing.assert_array_equal(got[..., [2, 3, 5]], noisy[..., [2, 3, 5]])


def test_float64_input_solves_in_float64():
    problem = _hard_problem(9)
    _, noisy, boxes, mask, unc, agent_mask = problem
    got = align_poses_batch(boxes[None], mask[None], unc[None],
                            noisy[None].astype(np.float64), agent_mask[None],
                            device="cpu")
    assert got.dtype == torch.float64
    _assert_poses_close(got[0].numpy()[:, [0, 1, 4]],
                        _jax_refined(problem, {}), "float64")


def test_nine_hop_chain_splits_after_eight_rounds():
    # ten boxes 1 m apart along x, alternating between two agents (boxes of
    # one agent are never adjacent), the lowest index at one end: 8 rounds
    # carry label 0 eight hops, so the far end keeps another label
    l, k = 2, 6
    boxes = np.zeros((l, k, 3), np.float32)
    mask = np.zeros((l, k), bool)
    for i in range(10):
        boxes[i % 2, i // 2] = [float(i), 0.0, 0.0]
        mask[i % 2, i // 2] = True
    noisy = np.zeros((l, 6), np.float32)
    unc = np.full((l, k, 3), -3.0, np.float32)
    problem = (None, noisy, boxes, mask, unc, np.ones(l, bool))
    got = _port(problem, {})["labels"]
    np.testing.assert_array_equal(got, _jax_labels(problem))
    chain = [(i % 2) * k + i // 2 for i in range(10)]
    assert got[chain[0]] == 0 and got[chain[8]] == 0
    assert got[chain[9]] != 0


def test_analytic_jacobian_matches_autograd():
    problem = _hard_problem(10)
    _, noisy, boxes, mask, unc, agent_mask = problem
    t = [torch.as_tensor(x)[None] for x in (boxes, mask, unc, noisy,
                                             agent_mask)]
    t = [x.double() if x.is_floating_point() else x for x in t]
    graph = TB._build_graph(*t, BoxAlignConfig(adaptive_landmark=True))
    n_u = (3 + boxes.shape[0] * boxes.shape[1]) * 3
    x = torch.from_numpy(np.random.default_rng(11).normal(
        0, 0.05, (1, n_u)))
    _, analytic = TB._jacobian(x, graph)
    auto = torch.autograd.functional.jacobian(
        lambda v: TB._jacobian(v, graph)[0], x)[:, :, 0]
    assert analytic.abs().max() > 1.0
    torch.testing.assert_close(analytic, auto, rtol=1e-10, atol=1e-12)


def test_config_from_yaml_matches_jax():
    args = {"use_uncertainty": False, "landmark_SE2": False,
            "adaptive_landmark": True, "normalize_uncertainty": True,
            "abandon_hard_cases": False, "drop_hard_boxes": False}
    assert tuple(BoxAlignConfig.from_yaml(args)) == \
        tuple(JaxConfig.from_yaml(args))
    assert tuple(BoxAlignConfig()) == tuple(JaxConfig())
