"""BEV keypoint sampling (FPV-RCNN stage-2 support).

Port of coalign_tpu/utils/keypoints.py (ref opencood/utils/
keypoint_utils.py:157 bev_sample): saliency is the local occupancy-gradient
magnitude (the edges of structures, where the reference's line detector
fires), the top-S salient points form a fixed-size pool and farthest-point
sampling (ops/roi.py) spreads the K keypoints over it: fixed-shape device
ops. The BEV cells come from ops/voxels.cell_index, whose tensor divisor
gives the same cell on every device.
"""

from __future__ import annotations

import torch

from coalign_tpu_torch.ops.roi import farthest_point_sample
from coalign_tpu_torch.ops.voxels import cell_index


def bev_saliency(occupancy: torch.Tensor) -> torch.Tensor:
    """(H, W) occupancy or intensity -> (H, W) edge-magnitude saliency."""
    gx = torch.zeros_like(occupancy)
    gy = torch.zeros_like(occupancy)
    gx[:, 1:-1] = occupancy[:, 2:] - occupancy[:, :-2]
    gy[1:-1, :] = occupancy[2:, :] - occupancy[:-2, :]
    return gx.abs() + gy.abs()


def sample_bev_keypoints(points: torch.Tensor, mask: torch.Tensor,
                         lidar_range, voxel=0.4, num_keypoints: int = 512,
                         pool: int = 4096) -> torch.Tensor:
    """K spread-out keypoints from the salient parts of a cloud.

    points (N, 3+), mask (N,) bool -> (K,) int64 indices into points."""
    h = int(round((lidar_range[4] - lidar_range[1]) / voxel))
    w = int(round((lidar_range[3] - lidar_range[0]) / voxel))
    ix = cell_index(points[:, 0], lidar_range[0], voxel)
    iy = cell_index(points[:, 1], lidar_range[1], voxel)
    inb = mask & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    ids = torch.where(inb, iy * w + ix, h * w)
    occ = torch.zeros(h * w + 1, dtype=points.dtype, device=points.device)
    occ = occ.scatter_reduce(0, ids, inb.to(points.dtype), reduce="amax")
    sal = bev_saliency(occ[:-1].reshape(h, w)).reshape(-1)
    point_sal = torch.where(inb, sal[ids.clamp(0, h * w - 1)],
                            points.new_full((), -1.0))

    pool = min(pool, points.shape[0])
    # a stable sort, so that ties go to the lower index as with lax.top_k
    top_sal, top_idx = torch.sort(point_sal, descending=True, stable=True)
    top_sal, top_idx = top_sal[:pool], top_idx[:pool]
    k = min(num_keypoints, pool)
    sel = farthest_point_sample(points[top_idx, :3][None],
                                (top_sal > 0)[None], k)[0]
    return top_idx[sel]
