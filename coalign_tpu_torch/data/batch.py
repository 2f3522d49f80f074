"""Batch assembly: frames -> padded fixed-shape host arrays.

Port of coalign_tpu/data/batch.py ``IntermediateFusionBatcher`` (ref
opencood/data_utils/datasets/intermediate_fusion_dataset.py:236-575),
numpy only. Agents are padded to ``L = max_cav`` with ``agent_mask``
instead of the reference's flattened ``record_len``; voxelization happens
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
  transformation_matrix (B, 4, 4)      identity for intermediate fusion
"""

from __future__ import annotations

import numpy as np

from coalign_tpu_torch.utils import box_utils as B
from coalign_tpu_torch.utils.transforms import (get_pairwise_transformation,
                                                inverse_tfm, pose_to_tfm)


class IntermediateFusionBatcher:
    """Assemble intermediate-fusion batches from base frames. One
    ``default_rng(seed)`` draws, in order, the pose noise, the point
    subsamples and the shuffles."""

    def __init__(self, max_cav=5, max_points=30000, max_objects=100,
                 lidar_range=(-140.8, -40, -3, 140.8, 40, 1),
                 comm_range=70.0, pos_std=0.0, rot_std=0.0, seed=303,
                 augmentor=None, laplace=False):
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
                pts = pts[B.mask_points_by_range(pts, self.lidar_range)]
                if len(pts) > n:
                    pts = pts[self.rng.choice(len(pts), n, replace=False)]
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
        in an order shuffled by the batcher's generator."""
        idx = np.arange(len(dataset))
        if shuffle:
            self.rng.shuffle(idx)
        for start in range(0, len(idx), batch_size):
            chunk = idx[start:start + batch_size]
            if drop_last and len(chunk) < batch_size:
                return
            yield self.assemble([dataset[i] for i in chunk])
