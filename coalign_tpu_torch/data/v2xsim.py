"""V2X-Sim 2.0 dataset reader (a preprocessed info pickle).

Port of coalign_tpu/data/v2xsim.py (ref opencood/data_utils/datasets/
basedataset/v2xsim_basedataset.py:78-177): one pickle holds the frames'
infos, each with ``agent_num`` and, for agent i from 1, ``lidar_path_i``
(a float32 (N, 5) ``.bin`` scan, of which x, y, z, intensity are kept),
``lidar_pose_i`` (a 4x4 world transform) and ``labels_i`` holding
``gt_boxes_global`` (N, 10) = [x, y, z, dx (l), dy (w), dz (h), qw, qx, qy,
qz], world-frame boxes, and ``gt_object_ids`` (ref
box_utils.project_world_objects_v2x:516).

In training the agents come in a random order, drawn for every frame by
``np.random.default_rng(seed)``'s ``permutation``, as the JAX reader draws
them, so that both packages serve the same frames from the same seed.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from coalign_tpu_torch.utils.transforms import tfm_to_pose


def quat_to_yaw(q: np.ndarray) -> np.ndarray:
    """(N, 4) wxyz quaternions -> yaw (rad): atan2 of the rotation
    matrix's R[1, 0] = 2(xy + wz) over R[0, 0] = 1 - 2(y^2 + z^2)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.arctan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z))


def global_boxes_to_world_hwl(gt_boxes: np.ndarray):
    """(N, 10) [xyz, l w h, quat wxyz] -> (N, 7) world hwl boxes, yaw
    only."""
    if len(gt_boxes) == 0:
        return np.zeros((0, 7), np.float32)
    xyz = gt_boxes[:, :3]
    l, w, h = gt_boxes[:, 3], gt_boxes[:, 4], gt_boxes[:, 5]
    yaw = quat_to_yaw(gt_boxes[:, 6:10])
    return np.stack([xyz[:, 0], xyz[:, 1], xyz[:, 2], h, w, l, yaw],
                    axis=-1).astype(np.float32)


class V2XSIMBaseDataset:
    """Serves frames from a V2X-Sim info pickle; the scans' relative paths
    are taken from ``data_root`` (by default the pickle's directory)."""

    def __init__(self, info_pkl: str, train: bool = True, max_cav: int = 5,
                 data_root: str | None = None, load_lidar: bool = True,
                 seed: int = 303):
        with open(info_pkl, "rb") as f:
            self.infos = pickle.load(f)
        self.train = train
        self.max_cav = max_cav
        self.load_lidar = load_lidar
        self.data_root = data_root or os.path.dirname(
            os.path.abspath(info_pkl))
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.infos)

    def _lidar_path(self, p: str) -> str:
        if os.path.isabs(p) and os.path.exists(p):
            return p
        return os.path.join(self.data_root, p)

    def __getitem__(self, idx):
        info = self.infos[idx]
        n = int(info["agent_num"])
        cav_ids = (list(1 + self.rng.permutation(n)) if self.train
                   else list(range(1, n + 1)))[:self.max_cav]

        agents = []
        all_boxes, all_ids, seen = [], [], set()
        for cav_id in cav_ids:
            pose = np.asarray(tfm_to_pose(np.asarray(
                info[f"lidar_pose_{cav_id}"], dtype=np.float64)),
                dtype=np.float32)
            labels = info[f"labels_{cav_id}"]
            boxes = global_boxes_to_world_hwl(
                np.asarray(labels["gt_boxes_global"], dtype=np.float64))
            ids = np.asarray(labels["gt_object_ids"], dtype=np.int64)
            agent = {"pose": pose, "cav_id": str(cav_id), "visible_ids": ids}
            if self.load_lidar:
                scan = np.fromfile(
                    self._lidar_path(info[f"lidar_path_{cav_id}"]),
                    dtype=np.float32)
                agent["points"] = scan.reshape(-1, 5)[:, :4].copy()
            agents.append(agent)
            # the fused gt: the union over the agents, deduplicated by id
            for b, oid in zip(boxes, ids):
                if int(oid) not in seen:
                    seen.add(int(oid))
                    all_boxes.append(b)
                    all_ids.append(int(oid))

        return {"agents": agents,
                "objects": {
                    "boxes": (np.stack(all_boxes).astype(np.float32)
                              if all_boxes else np.zeros((0, 7), np.float32)),
                    "ids": np.asarray(all_ids, dtype=np.int64)}}
