"""Intermediate BEV fusion: warp every agent into the ego frame, then reduce
over agents with a mask (ref fusion_in_one.py), ported from
coalign_tpu/models/fuse/fusion.py. None of these fusions has parameters.

Every fusion takes features (B, L, C, H, W), the normalized pairwise
affines (B, L, L, 2, 3) ([b, i, j] samples j's map into frame i) and
agent_mask (B, L), and returns the fused ego map (B, C, H, W).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from coalign_tpu_torch.ops.warp import warp_agents_to_ego


class MaxFusion(nn.Module):
    """Elementwise max over agents (F-Cooper, ref fusion_in_one.py:47)."""

    def forward(self, features, affines, agent_mask):
        warped = warp_agents_to_ego(features, affines[:, 0], agent_mask)
        m = agent_mask[:, :, None, None, None]
        neg = torch.finfo(features.dtype).min
        out = torch.where(m, warped, neg).amax(dim=1)
        return torch.where(agent_mask.any(dim=1)[:, None, None, None], out,
                           0.0)


class MeanFusion(nn.Module):
    """Masked mean over agents (ref mean_fuse.py:20)."""

    def forward(self, features, affines, agent_mask):
        warped = warp_agents_to_ego(features, affines[:, 0], agent_mask)
        m = agent_mask[:, :, None, None, None].to(features.dtype)
        return (warped * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


class AttFusion(nn.Module):
    """Per-pixel scaled-dot-product attention across agents with the ego
    map as the only query (ref fusion_in_one.py:91-136, att_fuse.py)."""

    def __init__(self, feature_dim: int):
        super().__init__()
        self.feature_dim = feature_dim

    def forward(self, features, affines, agent_mask):
        x = warp_agents_to_ego(features, affines[:, 0], agent_mask)
        c = x.shape[2]
        m = agent_mask[:, :, None, None]
        scores = (x[:, :1] * x).sum(dim=2) / math.sqrt(c)    # (B, L, H, W)
        scores = scores.masked_fill(~m, float("-inf"))
        att = torch.exp(scores - scores.amax(dim=1, keepdim=True))
        att = torch.where(m, att, 0.0)
        att = att / torch.clamp(att.sum(dim=1, keepdim=True), min=1e-9)
        return (att[:, :, None] * x).sum(dim=1)


_FUSIONS = {
    "max": lambda dim: MaxFusion(),
    "mean": lambda dim: MeanFusion(),
    "att": AttFusion,
}


def build_fusion(method: str, feature_dim: int) -> nn.Module:
    """A fusion module by its yaml name (``fusion_method``)."""
    if method not in _FUSIONS:
        raise KeyError(f"fusion {method!r} is not ported; have "
                       f"{sorted(_FUSIONS)}")
    return _FUSIONS[method](feature_dim)
