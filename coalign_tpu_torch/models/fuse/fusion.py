"""Intermediate BEV fusion: warp every agent into the ego frame, then reduce
over agents with a mask (ref fusion_in_one.py), ported from
coalign_tpu/models/fuse/fusion.py. None of these three fusions has
parameters; build_fusion also builds the learned ones of graph_fusion.py,
v2xvit.py and deform.py by their yaml names (deform's ``num_agents``, the
L of its batches, 5 unless ``deform.num_agents`` says otherwise).

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
        if x.dtype == torch.bfloat16:
            # bfloat16 maps (the compute-dtype policy): the JAX package's
            # scores are a bfloat16 product (float32 accumulator) divided by
            # a numpy float, so the attention and its output are float32
            x = x.float()
            scores = (x[:, :1] * x).sum(dim=2).bfloat16().float() / \
                math.sqrt(c)
        else:
            scores = (x[:, :1] * x).sum(dim=2) / math.sqrt(c)  # (B, L, H, W)
        scores = scores.masked_fill(~m, float("-inf"))
        att = torch.exp(scores - scores.amax(dim=1, keepdim=True))
        att = torch.where(m, att, 0.0)
        att = att / torch.clamp(att.sum(dim=1, keepdim=True), min=1e-9)
        return (att[:, :, None] * x).sum(dim=1)


def _v2vnet(args: dict, dim: int) -> nn.Module:
    from coalign_tpu_torch.models.fuse.graph_fusion import V2VNetFusion
    sub = args.get("v2vnet", {})
    if not sub.get("gru_flag", True):
        raise NotImplementedError("V2VNet without its ConvGRU "
                                  "('gru_flag: false') is not ported yet")
    # yaml forms: 3 | [3] | [[3, 3]] (ref conv_gru kernel_size nesting)
    ks = sub.get("conv_gru", {}).get("kernel_size", 3)
    while isinstance(ks, (list, tuple)):
        ks = ks[0]
    return V2VNetFusion(sub.get("in_channels", dim),
                        sub.get("num_iteration", 2),
                        sub.get("agg_operator", "avg"), int(ks))


def _disconet(args: dict, dim: int) -> nn.Module:
    from coalign_tpu_torch.models.fuse.graph_fusion import DiscoFusion
    return DiscoFusion(dim)


def _when2comm(args: dict, dim: int) -> nn.Module:
    from coalign_tpu_torch.models.fuse.graph_fusion import When2commFusion
    sub = args.get("when2comm", {})
    return When2commFusion(sub.get("in_channels", dim),
                           sub.get("query_size", 32),
                           sub.get("key_size", 256))


def _v2xvit(args: dict, dim: int) -> nn.Module:
    from coalign_tpu_torch.models.fuse.v2xvit import V2XViTFusion
    return V2XViTFusion(args["v2xvit"], dim)


def _deform(args: dict, dim: int) -> nn.Module:
    from coalign_tpu_torch.models.fuse.deform import DeformableFusion
    sub = args.get("deform", {})
    return DeformableFusion(dim, sub.get("num_agents", 5),
                            sub.get("num_points", 4))


_FUSIONS = {
    "max": lambda args, dim: MaxFusion(),
    "mean": lambda args, dim: MeanFusion(),
    "att": lambda args, dim: AttFusion(dim),
    "deform": _deform,
    "disconet": _disconet,
    "v2vnet": _v2vnet,
    "when2comm": _when2comm,
    "v2xvit": _v2xvit,
}


def build_fusion(method: str, args: dict, feature_dim: int) -> nn.Module:
    """A fusion module by its yaml name (``fusion_method``), configured
    from the model's yaml ``args`` (the JAX package's factories,
    coalign_tpu/models/fuse/fusion.py:77-136)."""
    if method not in _FUSIONS:
        raise KeyError(f"fusion {method!r} is not ported; have "
                       f"{sorted(_FUSIONS)}")
    return _FUSIONS[method](args, feature_dim)
