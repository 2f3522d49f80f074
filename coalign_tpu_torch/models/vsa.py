"""Voxel-set-abstraction keypoint features (FPV-RCNN's stage 2).

Port of coalign_tpu/models/vsa.py (ref opencood/models/sub_modules/
vsa.py:45 VoxelSetAbstraction): FPS keypoints from each frame's raw cloud,
each keypoint featured by bilinear reads of the frame's BEV map and by
multi-scale ball-query grouping over its points (ops/pointnet2.py), fused
by a Linear + masked batch norm + ReLU into the ``num_out_features``-dim
CPM the agents transmit. Always ``num_keypoints`` keypoints a frame,
carried with a mask. The "stage/fps" and "stage/ball_query" ranges name
the sampling and the grouping in a torch.profiler trace.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.models.layers import MaskedBatchNorm
from coalign_tpu_torch.ops.pointnet2 import SAModuleMSG
from coalign_tpu_torch.ops.roi import (farthest_point_sample,
                                       sample_bev_features)
from coalign_tpu_torch.utils.profiling import stage


class VoxelSetAbstraction(nn.Module):
    """Per-frame keypoint sampler and feature extractor. ``cfg`` is the
    yaml's ``vsa`` block (num_keypoints, num_out_features,
    sa_layer.raw_points {mlps, pool_radius, n_sample}); ``bev_channels``
    the width of the BEV map it reads at ``bev_stride``."""

    def __init__(self, cfg: dict, lidar_range, voxel_size,
                 bev_channels: int, point_features: int = 1,
                 bev_stride: int = 8):
        super().__init__()
        self.num_keypoints = int(cfg["num_keypoints"])
        self.lidar_range = tuple(lidar_range)
        self.voxel_size = tuple(voxel_size)
        self.bev_stride = bev_stride
        raw = cfg.get("sa_layer", {}).get("raw_points", {})
        self.sa = (SAModuleMSG(point_features, raw["pool_radius"],
                               raw["n_sample"], raw["mlps"]) if raw else None)
        width = bev_channels + (self.sa.out_channels if raw else 0)
        out = int(cfg["num_out_features"])
        self.fusion = nn.Linear(width, out, bias=False)
        self.norm = MaskedBatchNorm(out)

    def forward(self, points, pt_mask, bev_feat=None):
        """points (F, N, 4), pt_mask (F, N), bev_feat (F, C, H, W) or None.
        Returns kp_xyz (F, K, 3), kp_feat (F, K, num_out_features) and
        kp_mask (F, K)."""
        xyz = points[..., :3]
        with stage("stage/fps"):
            idx = farthest_point_sample(xyz, pt_mask, self.num_keypoints)
        kp_xyz = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
        kp_mask = torch.gather(pt_mask, 1, idx)
        # the z band (ref vsa.py:186 kpt_mask1: z in (-2.8, 1.0) for the
        # (-3, 1) range), taken from the configured range
        lo, hi = self.lidar_range[2] + 0.2, self.lidar_range[5]
        kp_mask = kp_mask & (kp_xyz[..., 2] > lo) & (kp_xyz[..., 2] < hi)

        feats = []
        if bev_feat is not None:
            feats.append(sample_bev_features(
                bev_feat.to(xyz.dtype), kp_xyz[..., :2], self.lidar_range,
                self.voxel_size, self.bev_stride))
        if self.sa is not None:
            with stage("stage/ball_query"):
                feats.append(self.sa(kp_xyz, kp_mask, xyz, pt_mask,
                                     feats=points[..., 3:]))
        x = self.fusion(torch.cat(feats, dim=-1))
        x = F.relu(self.norm(x, kp_mask)[0]) * kp_mask[..., None]
        return kp_xyz, x, kp_mask
