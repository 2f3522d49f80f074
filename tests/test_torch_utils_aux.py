"""The PyTorch port's auxiliary utils against the JAX package's
(tests/test_utils_aux.py's functions), on the CPU:

  * heter: AgentSelector draws the same modalities from the same seed;
    get_cav_box and fix_cavs_box give the JAX boxes (1e-5 m), scores,
    records and counts, on the JAX tests' poses and on seeded ones;
  * compression's accounting equals the JAX package's; Draco is refused
    without its binary;
  * consensus: the same best candidate and score as the JAX grid search;
  * subsampling: the same arrays;
  * keypoints: the same keypoint indices as the JAX sampler, also with
    points exactly on the BEV cells' boundaries (the cells come from
    ops/voxels.cell_index: faults 9, 10 and 12);
  * model_utils on torch state dicts: the JAX surgery's results under
    "."-joined keys, count_params, cleanup_checkpoints on net_epoch files;
  * device_trace; the TensorBoard callback with a writer and with none
    importable.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coalign_tpu.utils import box_utils as JB
from coalign_tpu.utils import compression as JC
from coalign_tpu.utils import heter as JH
from coalign_tpu.utils import model_utils as JM
from coalign_tpu.utils import subsampling as JS
from coalign_tpu.utils.consensus import max_consensus_align as jax_consensus
from coalign_tpu.utils.keypoints import sample_bev_keypoints as jax_keypoints
from coalign_tpu_torch.utils import compression as C
from coalign_tpu_torch.utils import heter as H
from coalign_tpu_torch.utils import model_utils as M
from coalign_tpu_torch.utils import subsampling as S
from coalign_tpu_torch.utils.consensus import max_consensus_align
from coalign_tpu_torch.utils.keypoints import (bev_saliency,
                                               sample_bev_keypoints)
from coalign_tpu_torch.utils.profiling import device_trace
from coalign_tpu_torch.utils.tb_logging import make_tb_callback

torch.set_num_threads(1)


def test_agent_selector_draws_the_jax_modalities():
    for seed, ratio, ego in ((1, 0.5, "camera"), (303, 0.3, "lidar")):
        ours = H.AgentSelector(lidar_ratio=ratio, ego_modality=ego, seed=seed)
        ref = JH.AgentSelector(lidar_ratio=ratio, ego_modality=ego, seed=seed)
        for n in (10, 0, 5):
            assert ours.select(n) == ref.select(n)
    assert H.AgentSelector(ego_modality="camera").select(4)[0] == "camera"


def _poses(seed, n=5):
    rng = np.random.default_rng(seed)
    poses = np.zeros((n, 6), np.float32)
    poses[:, :3] = rng.uniform(-40, 40, (n, 3))
    poses[:, 3:] = rng.uniform(-180, 180, (n, 3)) * [0.02, 1.0, 0.02]
    return poses


@pytest.mark.parametrize("seed", [0, 1])
def test_get_cav_box_matches_jax(seed):
    poses = _poses(seed)
    mask = np.array([True, True, False, True, True])
    mods = H.AgentSelector(seed=seed).select(4)
    for modalities in (None, mods):
        boxes, record = H.get_cav_box(poses, mask, modalities)
        want, want_record = JH.get_cav_box(poses, mask, modalities)
        assert boxes.dtype == np.float32 and boxes.shape == (4, 8, 3)
        np.testing.assert_allclose(boxes, want, atol=1e-5)
        np.testing.assert_array_equal(record, want_record)


def test_get_cav_box_positions():
    """tests/test_utils_aux.py's case: the markers land at each live
    agent's position in the ego frame."""
    poses = np.zeros((4, 6), dtype=np.float32)
    poses[1, :2] = [10.0, 5.0]
    poses[2, :2] = [-8.0, 2.0]
    poses[2, 4] = 90.0
    mask = np.array([True, True, True, False])
    boxes, record = H.get_cav_box(poses, mask,
                                  modalities=["lidar", "camera", "lidar"])
    np.testing.assert_allclose(boxes[1, :, :2].mean(0), [10, 5], atol=1e-4)
    np.testing.assert_allclose(boxes[2, :, :2].mean(0), [-8, 2], atol=1e-4)
    assert record.tolist() == [1, 0, 1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fix_cavs_box_matches_jax(seed):
    rng = np.random.default_rng(seed)
    poses = _poses(seed, 3)
    poses[:, 2] = 0.0
    poses[1, :2] = poses[0, :2] + [12.0, 0.0]
    mask = np.array([True, True, True])
    det7 = np.zeros((8, 7), np.float32)
    det7[:, :2] = rng.uniform(-30, 30, (8, 2))
    det7[:, 3:6] = [1.5, 2.0, 4.5]
    det7[:, 6] = rng.uniform(-3, 3, 8)
    det7[0, :2] = [12.0, 0.0]               # on agent 1 in the ego frame
    det7[1, :2] = det7[2, :2] + 0.3          # a near duplicate
    det = np.asarray(JB.boxes_to_corners_3d(det7, "hwl"))
    scores = rng.uniform(0.3, 0.95, 8).astype(np.float32)
    got = H.fix_cavs_box(det, scores, det[:5], poses, mask)
    want = JH.fix_cavs_box(det, scores, det[:5], poses, mask)
    assert got[3] == want[3] == 3
    assert got[0].shape == want[0].shape and got[2].shape == want[2].shape
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)


def test_compression_accounting_matches_jax(monkeypatch):
    for shape, bits, ratio in (((100, 352, 256), 32, 1.0),
                               ((100, 352, 256), 8, 64.0), ((64, 64), 16, 2)):
        assert C.feature_map_bytes(shape, bits, ratio) == \
            JC.feature_map_bytes(shape, bits, ratio)
        assert C.comm_volume_mbits(shape, bits, ratio) == \
            JC.comm_volume_mbits(shape, bits, ratio)
        assert C.masked_comm_volume_mbits(0.01, shape, bits) == \
            JC.masked_comm_volume_mbits(0.01, shape, bits)
    monkeypatch.setattr(C.shutil, "which", lambda name: None)
    assert not C.draco_available()
    with pytest.raises(RuntimeError, match="draco_encoder"):
        C.draco_compressed_bytes(np.zeros((4, 3), np.float32))


@pytest.mark.parametrize("yaw_steps,yaw_span", [(1, 0.0), (9, 4.0)])
def test_consensus_matches_jax(yaw_steps, yaw_span):
    rng = np.random.default_rng(0)
    dst = rng.uniform(-10, 10, (40, 2)).astype(np.float32)
    src = (dst - np.array([1.0, -0.5], np.float32)
           + rng.normal(0, 0.02, (40, 2)).astype(np.float32))
    src_mask = rng.uniform(size=40) > 0.1
    dst_mask = rng.uniform(size=40) > 0.1
    kw = dict(xy_span=2.0, xy_steps=9, yaw_span_deg=yaw_span,
              yaw_steps=yaw_steps, radius=0.3)
    best, score = max_consensus_align(
        torch.from_numpy(src), torch.from_numpy(src_mask),
        torch.from_numpy(dst), torch.from_numpy(dst_mask), **kw)
    want, want_score = jax_consensus(jnp.asarray(src), jnp.asarray(src_mask),
                                     jnp.asarray(dst), jnp.asarray(dst_mask),
                                     **kw)
    np.testing.assert_allclose(best.numpy(), np.asarray(want), atol=1e-6)
    assert int(score) == int(want_score) >= 30


def test_subsampling_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (500, 4)).astype(np.float32)
    pts[0] = [0.1, 0.1, 0, 0]
    np.testing.assert_array_equal(S.voxel_grid_subsample(pts, 2.0),
                                  JS.voxel_grid_subsample(pts, 2.0))
    np.testing.assert_array_equal(
        S.random_subsample(pts, 100, np.random.default_rng(3)),
        JS.random_subsample(pts, 100, np.random.default_rng(3)))
    assert S.random_subsample(pts[:50], 100) is not None
    np.testing.assert_array_equal(S.mask_ego_points(pts),
                                  JS.mask_ego_points(pts))


def _wall_cloud(on_boundaries: bool):
    """tests/test_utils_aux.py's wall and ground, optionally snapped to
    the 0.5 m BEV cells' boundaries."""
    rng = np.random.default_rng(0)
    wall = np.stack([np.full(300, 5.0) + rng.normal(0, 0.05, 300),
                     np.linspace(-8, 8, 300), rng.uniform(0, 1.5, 300)], -1)
    ground = np.stack([rng.uniform(-15, 15, 300), rng.uniform(-15, 15, 300),
                       np.full(300, -1.9)], -1)
    pts = np.concatenate([wall, ground]).astype(np.float32)
    if on_boundaries:
        pts[::3, :2] = np.round(pts[::3, :2] * 2) / 2
    return pts


@pytest.mark.parametrize("on_boundaries", [False, True])
def test_keypoints_match_jax(on_boundaries):
    pts = _wall_cloud(on_boundaries)
    mask = np.ones(600, dtype=bool)
    mask[-7:] = False
    lr = [-16, -16, -3, 16, 16, 2]
    idx = sample_bev_keypoints(torch.from_numpy(pts), torch.from_numpy(mask),
                               lr, voxel=0.5, num_keypoints=64, pool=256)
    want = np.asarray(jax_keypoints(jnp.asarray(pts), jnp.asarray(mask), lr,
                                    voxel=0.5, num_keypoints=64, pool=256))
    np.testing.assert_array_equal(idx.numpy(), want)
    assert (idx.numpy() < 300).mean() > 0.5      # on the structure


def test_bev_saliency_is_the_gradient_magnitude():
    occ = torch.zeros(5, 6)
    occ[2, 3] = 1.0
    sal = bev_saliency(occ)
    assert sal[2, 2] == 1 and sal[2, 4] == 1 and sal[1, 3] == 1
    assert sal[2, 3] == 0 and sal[0].sum() == 0


def test_param_surgery_matches_jax():
    nested = {"backbone": {"conv1": {"weight": np.ones((3, 3))}},
              "heads": {"cls": {"bias": np.zeros(2)}}}
    flat = M.flatten_params(nested)
    assert list(flat) == [k.replace("/", ".")
                          for k in JM.flatten_params(nested)]
    assert M.unflatten_params(flat) == nested

    sd = {k: torch.as_tensor(v) for k, v in flat.items()}
    renamed = M.rename_param_keys(sd, r"^backbone", "encoder")
    want = JM.flatten_params(JM.rename_param_keys(nested, r"^backbone",
                                                  "encoder"))
    assert list(renamed) == [k.replace("/", ".") for k in want]

    donor = {"backbone.conv1.weight": torch.full((3, 3), 7.0),
             "heads.cls.bias": torch.ones(2), "extra.weight": torch.ones(1)}
    merged = M.compose_params(sd, donor, [r"backbone\."])
    assert list(merged) == list(sd)
    assert (merged["backbone.conv1.weight"] == 7).all()
    assert (merged["heads.cls.bias"] == 0).all()
    assert M.count_params(sd) == JM.count_params(nested) == 11
    assert M.count_params(nested) == 11
    assert M.count_params(torch.nn.Linear(3, 2)) == 8


def test_cleanup_checkpoints(tmp_path):
    for name in ("net_epoch1.pth", "net_epoch2.pth", "net_epoch10.pth",
                 "net_epoch9.pth", "net_epoch_bestval_at2.pth", "x.pth"):
        (tmp_path / name).write_bytes(b"")
    removed = M.cleanup_checkpoints(str(tmp_path), keep=2)
    assert removed == ["net_epoch1.pth", "net_epoch2.pth"]
    assert sorted(os.listdir(tmp_path)) == [
        "net_epoch10.pth", "net_epoch9.pth", "net_epoch_bestval_at2.pth",
        "x.pth"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with device_trace(logdir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_tb_callback_writes_scalars(tmp_path):
    seen = []
    cb, close = make_tb_callback(str(tmp_path / "tb"), inner=seen.append)
    cb({"step": 1, "epoch": 0, "loss": 0.5, "val_loss": 0.4})
    close()
    assert seen == [{"step": 1, "epoch": 0, "loss": 0.5, "val_loss": 0.4}]
    assert any(f.startswith("events.") for f in os.listdir(tmp_path / "tb"))


def test_tb_callback_is_a_no_op_without_a_writer(tmp_path, monkeypatch):
    """As on the card's machine, which has neither tensorboard nor
    tensorboardX: the callback is the inner one and closing does
    nothing."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    seen = []
    cb, close = make_tb_callback(str(tmp_path / "tb"), inner=seen.append)
    cb({"step": 1, "loss": 0.5})
    close()
    assert seen == [{"step": 1, "loss": 0.5}]
    assert not os.path.exists(tmp_path / "tb")
    cb, close = make_tb_callback(str(tmp_path / "tb"))
    cb({"step": 2})
    close()
