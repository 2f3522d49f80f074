"""Point-cloud subsampling on the host.

Port of coalign_tpu/utils/subsampling.py (ref
opencood/utils/subsampling_utils.py, pcd_utils.downsample_lidar and
mask_ego_points): vectorized numpy, run in the data plane before the points
are padded to fixed shapes.
"""

from __future__ import annotations

import numpy as np


def voxel_grid_subsample(points: np.ndarray, voxel_size: float):
    """One point per occupied voxel, the first (as the reference's
    hash-based picker). points (N, >=3) -> (M, ...)."""
    keys = np.floor(points[:, :3] / voxel_size).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]


def random_subsample(points: np.ndarray, num: int, rng=None):
    """``num`` points drawn uniformly without replacement, or all when
    fewer (ref pcd_utils downsample_lidar)."""
    if len(points) <= num:
        return points
    rng = rng or np.random.default_rng(0)
    sel = rng.choice(len(points), num, replace=False)
    return points[sel]


def mask_ego_points(points: np.ndarray, x_radius=1.95, y_radius=1.1):
    """Drop the returns from the ego vehicle's body (ref pcd_utils
    mask_ego_points)."""
    keep = ~((np.abs(points[:, 0]) < x_radius)
             & (np.abs(points[:, 1]) < y_radius))
    return points[keep]
