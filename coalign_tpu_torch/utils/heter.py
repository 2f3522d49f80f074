"""Heterogeneous-modality agent assignment and per-CAV eval boxes.

Port of coalign_tpu/utils/heter.py (ref opencood/utils/heter_utils.py:10
AgentSelector, tools/inference_utils.py:200-302): each agent is assigned a
sensing modality (lidar or camera) from the ego's modality and a lidar
ratio, seeded so that train and eval runs agree; marker boxes at each
collaborating agent's position join the prediction and gt sets, so that
camera-only agents count in AP even when they detect nothing. Host-side
numpy, as in the JAX package; the dedup NMS takes the plain rotated IoU on
the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from coalign_tpu_torch.utils.box_utils import project_box3d
from coalign_tpu_torch.utils.iou import rotated_iou_plain
from coalign_tpu_torch.utils.transforms import inverse_tfm, pose_to_tfm


class AgentSelector:
    def __init__(self, lidar_ratio: float = 0.5,
                 ego_modality: str = "lidar", seed: int = 303):
        self.lidar_ratio = lidar_ratio
        self.ego_modality = ego_modality
        self.rng = np.random.default_rng(seed)

    def select(self, num_agents: int):
        """A list of 'lidar' / 'camera' per agent, ego first."""
        mods = ["lidar" if self.rng.random() < self.lidar_ratio
                else "camera" for _ in range(num_agents)]
        if num_agents:
            mods[0] = self.ego_modality
        return mods


def _marker_corners(extent, z_offset=-1.2):
    """(1, 8, 3) axis-aligned marker box at the agent origin (ref
    inference_utils.py create_bbx: half-extents, z lowered 1.2 m)."""
    ex, ey, ez = extent
    corners = np.array(
        [[ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez], [-ex, -ey, -ez],
         [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez], [-ex, -ey, ez]],
        dtype=np.float32)
    corners[:, 2] += z_offset
    return corners[None]


def _relative_transforms(lidar_pose, agent_mask):
    """T_ego<-cav of each live agent: (N, 4, 4) numpy."""
    live = np.flatnonzero(np.asarray(agent_mask))
    poses = np.asarray(lidar_pose)[live]
    t_ew = inverse_tfm(pose_to_tfm(poses[0]))          # ego <- world
    return np.stack([t_ew @ pose_to_tfm(p) for p in poses])


def get_cav_box(lidar_pose, agent_mask, modalities=None):
    """Per-CAV marker boxes in the ego frame and the lidar-agent record
    (ref inference_utils.py:266 get_cav_box).

    lidar_pose (L, 6) world poses, agent_mask (L,); ``modalities`` from
    AgentSelector.select, all lidar by default. Returns (cav_box (N, 8, 3)
    float32, lidar_agent_record (N,) int64)."""
    rel = _relative_transforms(lidar_pose, agent_mask)
    marker = _marker_corners([0.2, 0.2, 0.2])
    boxes = [marker[0]] + [np.asarray(project_box3d(marker, rel[i]))[0]
                           for i in range(1, len(rel))]
    n = len(boxes)
    record = np.ones(n, dtype=np.int64) if modalities is None else np.array(
        [1 if m == "lidar" else 0 for m in modalities[:n]], dtype=np.int64)
    return np.stack(boxes).astype(np.float32), record


def _nms_dedup(corners, scores):
    """Greedy dedup at IoU 0.01 in score order (stable), survivors in index
    order."""
    bev = torch.from_numpy(np.ascontiguousarray(corners[:, :4, :2]))
    iou = rotated_iou_plain(bev, bev).numpy()
    keep = []
    for i in np.argsort(-scores, kind="stable"):
        if all(iou[i, j] <= 0.01 for j in keep):
            keep.append(i)
    keep = np.array(sorted(keep), dtype=np.int64)
    return corners[keep], scores[keep]


def fix_cavs_box(pred_corners, pred_scores, gt_corners, lidar_pose,
                 agent_mask):
    """Car-sized marker boxes at every live agent's position join BOTH the
    prediction and the gt corner sets (score 1.0; gt 0.5 for the real
    boxes), each set then deduped at IoU 0.01 (ref inference_utils.py:200
    fix_cavs_box). Corner sets (N, 8, 3) in the ego frame, numpy.
    Returns (pred_corners, pred_scores, gt_corners, num_cavs)."""
    rel = _relative_transforms(lidar_pose, agent_mask)
    marker = _marker_corners([2.45, 1.06, 0.75])
    cav = np.concatenate(
        [marker] + [np.asarray(project_box3d(marker, rel[i]))
                    for i in range(1, len(rel))], axis=0).astype(np.float32)
    n = cav.shape[0]
    pred = np.concatenate([cav, np.asarray(pred_corners, np.float32)])
    ps = np.concatenate([np.ones(n, np.float32),
                         np.asarray(pred_scores, np.float32)])
    pred, ps = _nms_dedup(pred, ps)
    gt = np.concatenate([cav, np.asarray(gt_corners, np.float32)])
    gs = np.concatenate([np.ones(n, np.float32),
                         np.full(len(gt_corners), 0.5, np.float32)])
    gt, _ = _nms_dedup(gt, gs)
    return pred, ps, gt, n
