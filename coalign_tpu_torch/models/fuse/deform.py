"""Deformable-attention fusion.

Port of coalign_tpu/models/fuse/deform.py (ref opencood/models/
sub_modules/ms_deform_attn.py, functions/ms_deform_attn_func.py:18, whose
MultiScaleDeformableAttention is an external CUDA extension): deformable
sampling is zero-padded bilinear interpolation at learned offsets, here
F.grid_sample at pixel coordinates. Each ego pixel attends to
``num_points`` learned sample points on every agent's map warped into the
ego frame, with learned weights, one softmax over all agents' points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.models.fuse.robust import ZeroInitLinear
from coalign_tpu_torch.ops.warp import warp_agents_to_ego


def bilinear_sample(src: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor):
    """src (N, C, H, W) sampled at pixel coordinates fx, fy (N, H', W', K)
    (x along W), zero outside the map: the JAX package's 4-tap
    _bilinear_gather (ops/warp.py:63-95). Returns (N, C, H', W', K)."""
    n, c, h, w = src.shape
    k = fx.shape[-1]
    # align_corners=True maps pixel index i to -1 + 2 i / (size - 1)
    grid = torch.stack([fx * (2.0 / (w - 1)) - 1.0,
                        fy * (2.0 / (h - 1)) - 1.0], dim=-1)
    out = F.grid_sample(src, grid.reshape(n, fx.shape[1], -1, 2),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.reshape(n, c, fx.shape[1], fx.shape[2], k)


class DeformableFusion(nn.Module):
    """features (B, L, C, H, W) + affines + agent_mask -> (B, C, H, W).

    The head (a Linear on the ego pixel's features that starts at zero, as
    flax's kernel_init zeros) gives per agent and sample point 2 offsets,
    bounded to 4 pixels by a tanh, and a weight logit. Its width is fixed
    at construction: ``num_agents`` times ``num_points`` times 3, where the
    JAX package's Dense takes the L of its first input; the batches' L
    must be ``num_agents``. Masked agents' logits are -inf before the
    softmax; the ego's map is added back (a residual)."""

    def __init__(self, feature_dim: int, num_agents: int = 5,
                 num_points: int = 4):
        super().__init__()
        self.num_agents = num_agents
        self.num_points = num_points
        self.head = ZeroInitLinear(feature_dim, num_agents * num_points * 3)

    def forward(self, features, affines, agent_mask):
        warped = warp_agents_to_ego(features, affines[:, 0], agent_mask)
        b, l, c, h, w = warped.shape
        if l != self.num_agents:
            raise ValueError(f"DeformableFusion was built for "
                             f"{self.num_agents} agents, got {l}")
        k = self.num_points
        q = warped[:, 0]                                      # (B, C, H, W)
        head = self.head(q.permute(0, 2, 3, 1)).reshape(b, h, w, l, k, 3)
        offsets = torch.tanh(head[..., :2]) * 4.0
        logits = head[..., 2]                                 # (B,H,W,L,K)
        ys = torch.arange(h, dtype=q.dtype, device=q.device)[:, None, None,
                                                            None]
        xs = torch.arange(w, dtype=q.dtype, device=q.device)[None, :, None,
                                                            None]
        fx = (xs + offsets[..., 0]).permute(0, 3, 1, 2, 4)   # (B,L,H,W,K)
        fy = (ys + offsets[..., 1]).permute(0, 3, 1, 2, 4)
        sampled = bilinear_sample(warped.reshape(b * l, c, h, w),
                                  fx.reshape(b * l, h, w, k),
                                  fy.reshape(b * l, h, w, k))
        sampled = sampled.reshape(b, l, c, h, w, k)
        logits = logits.masked_fill(~agent_mask[:, None, None, :, None],
                                    float("-inf"))
        attn = torch.softmax(logits.reshape(b, h, w, l * k), dim=-1)
        attn = attn.reshape(b, h, w, l, k)
        return torch.einsum("bhwlk,blchwk->bchw", attn, sampled) + q
