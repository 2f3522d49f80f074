"""Batch assembly: frames -> padded fixed-shape host arrays.

Port of coalign_tpu/data/batch.py's ``IntermediateFusionBatcher`` (ref
opencood/data_utils/datasets/intermediate_fusion_dataset.py:236-575),
``EarlyFusionBatcher``, ``KDFusionBatcher`` and ``LateFusionBatcher`` (ref
early_fusion_dataset.py, late_fusion_dataset.py, train_w_kd.py). Agents are
padded to ``L = max_cav`` with ``agent_mask`` instead of the reference's
flattened ``record_len``; voxelization happens
on the device (models/pillar_encoder.py), so the host only masks and pads
raw points, and labels are assigned on the device from the padded gt boxes
(postprocess/anchors.assign_targets).

Batch contract:
  points            (B, L, N, 4)       lidar in each agent's own frame
  point_mask        (B, L, N) bool
  agent_mask        (B, L)    bool     slot 0 = ego
  pairwise_t_matrix (B, L, L, 4, 4)    from the NOISY poses
  lidar_pose        (B, L, 6)          noisy; lidar_pose_clean (B, L, 6)
  gt_boxes          (B, M, 7) hwl      ego-frame gt (CLEAN poses)
  gt_mask           (B, M)   bool
  transformation_matrix (B, 4, 4)      identity for intermediate fusion;
                        (B, L, 4, 4) T_ego<-agent for late fusion
Early fusion merges the agents into one: points (B, 1, L*N, 4), and
shipped_points (B,), the non-ego points it sends.
"""

from __future__ import annotations

import numpy as np

from coalign_tpu_torch import native as _native
from coalign_tpu_torch.utils import box_utils as B
from coalign_tpu_torch.utils.transforms import (get_pairwise_transformation,
                                                inverse_tfm, pose_to_tfm)


class IntermediateFusionBatcher:
    """Assemble intermediate-fusion batches from base frames. One
    ``default_rng(seed)`` draws, in order, the pose noise, the point
    subsamples and the shuffles. With ``train`` set, ``batches`` yields
    ``assemble_train``'s batches where the batcher has one (late fusion
    trains on one agent a frame).

    Each agent's points are range-masked, cut to ``max_points`` and padded
    by the C++ data plane with ``native`` (the default, as in the JAX
    package where its library builds): x and y in [min, max), z in [min,
    max], a deterministic stride subsample that draws nothing from the
    generator (native.mask_pad_points). With ``native=False`` numpy does it
    as the JAX package's fallback does: every bound inclusive, and a random
    subsample ``rng.choice`` that advances the generator the pose noise
    draws from next. The two paths give different batches when a cloud
    overflows ``max_points`` or a point lies on a range bound."""

    def __init__(self, max_cav=5, max_points=30000, max_objects=100,
                 lidar_range=(-140.8, -40, -3, 140.8, 40, 1),
                 comm_range=70.0, pos_std=0.0, rot_std=0.0, seed=303,
                 augmentor=None, train=False, laplace=False, native=True):
        self.native = native
        self.train = train
        self.max_cav = max_cav
        self.max_points = max_points
        self.max_objects = max_objects
        self.lidar_range = lidar_range
        self.comm_range = comm_range
        self.pos_std = pos_std
        self.rot_std = rot_std
        self.laplace = laplace  # ref pose_utils.py:19 'laplace' arg key
        self.rng = np.random.default_rng(seed)
        self.augmentor = augmentor  # data/augment.WorldAugmentor or None

    def _noise(self):
        if self.pos_std == 0 and self.rot_std == 0:
            return np.zeros(6, dtype=np.float32)
        draw = self.rng.laplace if self.laplace else self.rng.normal
        n = np.zeros(6, dtype=np.float32)
        n[:2] = draw(0, self.pos_std, 2)
        n[4] = draw(0, self.rot_std)
        return n

    def assemble(self, frames: list) -> dict:
        """frames: list of base-data frames (see data/synthetic.py)."""
        b, l, n, m = (len(frames), self.max_cav, self.max_points,
                      self.max_objects)
        points = np.zeros((b, l, n, 4), dtype=np.float32)
        point_mask = np.zeros((b, l, n), dtype=bool)
        agent_mask = np.zeros((b, l), dtype=bool)
        poses_clean = np.zeros((b, l, 6), dtype=np.float32)
        poses_noisy = np.zeros((b, l, 6), dtype=np.float32)
        gt_boxes = np.zeros((b, m, 7), dtype=np.float32)
        gt_mask = np.zeros((b, m), dtype=bool)

        for bi, frame in enumerate(frames):
            if self.augmentor is not None:
                frame = self.augmentor(frame)
            agents = frame["agents"]
            ego_pose = agents[0]["pose"]
            # comm-range filter wrt ego (ref intermediate_fusion_dataset.py:277)
            kept = [agents[0]] + [
                ag for ag in agents[1:]
                if np.linalg.norm(ag["pose"][:2] - ego_pose[:2])
                <= self.comm_range]
            for ai, ag in enumerate(kept[:l]):
                pts = ag["points"]
                if self.native:
                    points[bi, ai], point_mask[bi, ai] = \
                        _native.mask_pad_points(pts, self.lidar_range, n)
                else:
                    pts = pts[B.mask_points_by_range(pts, self.lidar_range)]
                    if len(pts) > n:
                        pts = pts[self.rng.choice(len(pts), n,
                                                  replace=False)]
                    points[bi, ai, :len(pts)] = pts
                    point_mask[bi, ai, :len(pts)] = True
                agent_mask[bi, ai] = True
                poses_clean[bi, ai] = ag["pose"]
                poses_noisy[bi, ai] = ag["pose"] + self._noise()

            # fused gt in the ego frame from the CLEAN poses
            t_ew = inverse_tfm(pose_to_tfm(ego_pose))
            corners_w = B.boxes_to_corners_3d(frame["objects"]["boxes"], "hwl")
            corners_e = B.project_box3d(corners_w, t_ew)
            boxes_e = B.corner_to_center(corners_e, "hwl")
            keep = B.mask_corners_outside_range(corners_e, self.lidar_range)
            boxes_e = boxes_e[keep][:m]
            gt_boxes[bi, :len(boxes_e)] = boxes_e
            gt_mask[bi, :len(boxes_e)] = True

        pair = get_pairwise_transformation(poses_noisy, agent_mask).astype(
            np.float32)
        return {
            "points": points,
            "point_mask": point_mask,
            "agent_mask": agent_mask,
            "pairwise_t_matrix": pair,
            "lidar_pose": poses_noisy,
            "lidar_pose_clean": poses_clean,
            "gt_boxes": gt_boxes,
            "gt_mask": gt_mask,
            "transformation_matrix": np.tile(np.eye(4, dtype=np.float32),
                                             (b, 1, 1)),
        }

    def batches(self, dataset, batch_size, shuffle=True, drop_last=True):
        """Yield assembled batches of ``batch_size`` frames of ``dataset``,
        in an order shuffled by the batcher's generator; in train mode
        ``assemble_train``'s where the batcher has one."""
        assemble = (self.assemble_train
                    if self.train and hasattr(self, "assemble_train")
                    else self.assemble)
        idx = np.arange(len(dataset))
        if shuffle:
            self.rng.shuffle(idx)
        for start in range(0, len(idx), batch_size):
            chunk = idx[start:start + batch_size]
            if drop_last and len(chunk) < batch_size:
                return
            yield assemble([dataset[i] for i in chunk])


def merge_agents(batch: dict, lidar_range) -> dict:
    """Early fusion of an intermediate batch: every agent's points projected
    into the ego frame with the batch's (NOISY) transforms
    ``pairwise_t_matrix[b, a, 0]`` = T_ego<-a, re-masked to the ego's
    ``lidar_range`` and stacked into one virtual agent, points
    (B, 1, L*N, 4); ``shipped_points`` (B,) counts the valid non-ego points
    after projection, what crosses the channel (ref lidar_benchmark.md:9,
    'Early' row). The other keys stay (poses cut to the ego's)."""
    b, l, n, _ = batch["points"].shape
    points = np.asarray(batch["points"]).reshape(b, l * n, 4).copy()
    mask = np.asarray(batch["point_mask"]).reshape(b, l * n).copy()
    ones = np.ones((n, 1), np.float32)
    for bi in range(b):
        for ai in range(1, l):
            if not batch["agent_mask"][bi, ai]:
                continue
            t = batch["pairwise_t_matrix"][bi, ai, 0]
            seg = slice(ai * n, (ai + 1) * n)
            xyz1 = np.concatenate([points[bi, seg, :3], ones], -1)
            points[bi, seg, :3] = (xyz1 @ t.T)[:, :3]
    r = lidar_range
    mask &= ((points[..., 0] >= r[0]) & (points[..., 0] < r[3])
             & (points[..., 1] >= r[1]) & (points[..., 1] < r[4]))
    out = dict(batch)
    out.update(
        shipped_points=mask.reshape(b, l, n)[:, 1:].sum((1, 2)).astype(
            np.float32),
        points=points[:, None], point_mask=mask[:, None],
        agent_mask=np.ones((b, 1), dtype=bool),
        pairwise_t_matrix=np.tile(np.eye(4, dtype=np.float32),
                                  (b, 1, 1, 1, 1)))
    for key in ("lidar_pose", "lidar_pose_clean"):
        if key in batch:
            out[key] = batch[key][:, :1]
    return out


def late_transforms(batch: dict) -> dict:
    """Late fusion's test batch: the intermediate batch with a per-agent
    ``transformation_matrix`` (B, L, 4, 4) = T_ego<-agent from the NOISY
    poses, ``pairwise_t_matrix[:, :, 0]`` (pairwise[i, j] = T_j<-i), which
    projects each agent's boxes into the ego frame before the joint NMS;
    the identity for the ego and for padded slots."""
    out = dict(batch)
    out["transformation_matrix"] = np.asarray(
        batch["pairwise_t_matrix"])[:, :, 0].astype(np.float32)
    return out


class EarlyFusionBatcher(IntermediateFusionBatcher):
    """Early ("2-round") fusion: every agent's raw cloud, projected into the
    ego frame with the noisy poses, becomes one virtual agent that a
    single-agent model detects on (ref early_fusion_dataset.py:40-140); gt
    comes from the clean poses as usual."""

    def assemble(self, frames: list) -> dict:
        return merge_agents(super().assemble(frames), self.lidar_range)


class KDFusionBatcher(EarlyFusionBatcher):
    """Knowledge-distillation batches (coalign_tpu/data/batch.py:215-230;
    ref intermediate_fusion_dataset's ``teacher_processed_lidar``,
    train_w_kd.py:32-112): the intermediate batch for the student plus the
    merged ego-frame cloud of merge_agents as ``teacher_points`` (B, 1,
    L*N, 4) and ``teacher_point_mask`` for the frozen early-fusion teacher;
    both views share one draw of the pose noise."""

    def assemble(self, frames: list) -> dict:
        inter = IntermediateFusionBatcher.assemble(self, frames)
        early = merge_agents(inter, self.lidar_range)
        inter["teacher_points"] = early["points"]
        inter["teacher_point_mask"] = early["point_mask"]
        return inter


class LateFusionBatcher(IntermediateFusionBatcher):
    """Late fusion: each agent is a single-agent detection problem (ref
    late_fusion_dataset.py).

    ``assemble_train``: one random agent a frame in its own frame, with its
    own-frame gt (ref :52-69); the batch has L = 1. ``assemble``: every
    agent, with late_transforms' per-agent ``transformation_matrix`` (ref
    :72-128); gt stays the ego frame's."""

    def assemble_train(self, frames: list) -> dict:
        # one draw a frame, before assemble draws noise and subsamples
        picked = []
        for frame in frames:
            agents = frame["agents"]
            ag = agents[int(self.rng.integers(0, len(agents)))]
            picked.append({"agents": [ag], "objects": frame["objects"]})
        out = super().assemble(picked)
        for key in ("points", "point_mask", "agent_mask", "lidar_pose",
                    "lidar_pose_clean"):
            out[key] = out[key][:, :1]
        out["pairwise_t_matrix"] = out["pairwise_t_matrix"][:, :1, :1]
        return out

    def assemble(self, frames: list) -> dict:
        return late_transforms(super().assemble(frames))
