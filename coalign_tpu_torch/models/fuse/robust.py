"""Robust V2VNet: learned pose correction, global consistency and agent
attention.

Port of coalign_tpu/models/fuse/robust.py (ref opencood/models/sub_modules/
v2v_robust_module.py, point_pillar_v2vnet_robust.py:21). Every stage runs
batched over the padded (B, L, L) grid of agent pairs: one conv net scores
and corrects all pairs at once, and the reference's t-distribution
weighted EM (WeightedEM:227) is replaced by its fixed point, a masked
weighted least squares for every agent's absolute (x, y, yaw) with the
ego pinned, solved as one small dense system a sample.

The parameters of the pose network, the attention network and ``alpha``
are the ones the three-stage curriculum (tools/train_robust.py) freezes
and trains by name: their module names contain ``pose_regression``,
``attention`` and ``alpha``, and no other parameter's does.
"""

from __future__ import annotations

import torch
from torch import nn

from coalign_tpu_torch.models.layers import MaskedSequential, conv_bn_relu
from coalign_tpu_torch.ops.warp import warp_affine
from coalign_tpu_torch.utils.transforms import (matmul_f32,
                                                normalize_pairwise_tfm)


def pairwise_warp(features: torch.Tensor, affines: torch.Tensor):
    """Every agent j warped into every agent i's frame: features
    (B, L, C, H, W), affines (B, L, L, 2, 3) with [b, i, j] taking j's map
    into i's frame. Returns (B, L, L, C, H, W)."""
    b, l, c, h, w = features.shape
    rep = features[:, None].expand(b, l, l, c, h, w).reshape(b * l * l, c,
                                                             h, w)
    return warp_affine(rep, affines.reshape(b * l * l, 2, 3)).reshape(
        b, l, l, c, h, w)


class ZeroInitLinear(nn.Linear):
    """A Linear that starts at zero (flax's kernel_init zeros), for
    models/zoo.init_weights."""

    def init_weights(self, generator: torch.Generator):
        self.weight.zero_()


class PairNet(nn.Module):
    """Conv trunk over the (warped j, ego i) channel concat of a pair ->
    a vector of ``out``: three stride-2 conv_bn_relu (no mask: the JAX
    package normalizes over every pair, padded ones included), a spatial
    mean, Linear + ReLU, and a Linear that starts at zero."""

    def __init__(self, in_ch: int, hidden: int, out: int):
        super().__init__()
        self.convs = MaskedSequential(*conv_bn_relu(in_ch, hidden, stride=2),
                                      *conv_bn_relu(hidden, hidden, stride=2),
                                      *conv_bn_relu(hidden, hidden, stride=2))
        self.fc = nn.Linear(hidden, hidden)
        self.out = ZeroInitLinear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convs(x).mean(dim=(-2, -1))
        return self.out(torch.relu(self.fc(x)))


def pose3_to_tfm(p: torch.Tensor) -> torch.Tensor:
    """(..., 3) [x, y, yaw (rad)] -> (..., 4, 4)."""
    x, y, yaw = p[..., 0], p[..., 1], p[..., 2]
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows = [torch.stack([c, -s, zero, x], -1),
            torch.stack([s, c, zero, y], -1),
            torch.stack([zero, zero, one, zero], -1),
            torch.stack([zero, zero, zero, one], -1)]
    return torch.stack(rows, -2)


def tfm_to_pose3(t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 3) [x, y, yaw (rad)]."""
    return torch.stack([t[..., 0, 3], t[..., 1, 3],
                        torch.atan2(t[..., 1, 0], t[..., 0, 0])], -1)


def global_consistency(rel_pose: torch.Tensor, weights: torch.Tensor,
                       agent_mask: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares absolute poses from relative measurements.

    rel_pose (B, L, L, 3): the measurement of p_j - p_i (small-angle
    composition); weights (B, L, L); the ego (slot 0) and padded agents
    pinned at 0. Returns the consistent relative poses (B, L, L, 3).
    ``solve_ex`` leaves the device unsynchronized and, like
    jnp.linalg.solve, does not raise on a singular system. torch's batched
    CPU LU fails with more than one thread (ROADMAP §3): on the CPU the
    forward solve runs on one thread, and a backward pass through it needs
    the caller to set one (the CPU tests do)."""
    b, l = agent_mask.shape
    pair_m = (agent_mask[:, :, None] & agent_mask[:, None, :]).to(
        rel_pose.dtype)
    w = weights * pair_m
    eye = torch.eye(l, dtype=rel_pose.dtype, device=rel_pose.device)
    deg = w.sum(1) + w.sum(2)                                  # (B, L)
    lap = torch.diag_embed(deg) - w - w.transpose(1, 2)
    rhs = torch.einsum("bij,bijd->bjd", w, rel_pose) - \
        torch.einsum("bij,bijd->bid", w, rel_pose)
    pin = ~agent_mask | (torch.arange(l, device=agent_mask.device) == 0)[None]
    lap = torch.where(pin[:, :, None], eye[None], lap)
    rhs = torch.where(pin[:, :, None], 0.0, rhs)
    if lap.device.type == "cpu":
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            abs_pose = torch.linalg.solve_ex(lap, rhs)[0]
        finally:
            torch.set_num_threads(threads)
    else:
        abs_pose = torch.linalg.solve_ex(lap, rhs)[0]        # (B, L, 3)
    return abs_pose[:, None, :, :] - abs_pose[:, :, None, :]


class RobustFusion(nn.Module):
    """Pose regression -> global consistency -> attention-weighted fusion
    over (B, L, C, H, W) maps and the noisy pairwise transforms. Returns
    (fused (B, C, H, W), {pose_corr (B, L, L, 3), agent_scores (B, L, L),
    pairwise_t_corrected (B, L, L, 4, 4)}).

    As in the JAX package, every pair is warped twice: once with the noisy
    transforms for the pair nets, once with the corrected ones, of which
    only the ego's row is fused."""

    def __init__(self, feature_dim: int, hidden: int = 128,
                 downsample_rate: float = 2.0, discrete_ratio: float = 0.4,
                 use_consistency: bool = True):
        super().__init__()
        self.downsample_rate = downsample_rate
        self.discrete_ratio = discrete_ratio
        self.use_consistency = use_consistency
        self.pose_regression = PairNet(2 * feature_dim, hidden, 3)
        self.attention = PairNet(2 * feature_dim, hidden, 1)
        self.alpha = nn.Parameter(torch.full((1,), 0.15))

    def init_weights(self, generator: torch.Generator):
        """flax's init of ``alpha``: 0.15."""
        self.alpha.fill_(0.15)

    def forward(self, features, pairwise_t_matrix, agent_mask):
        b, l, c, h, w = features.shape
        affines = normalize_pairwise_tfm(pairwise_t_matrix, h, w,
                                         self.discrete_ratio,
                                         self.downsample_rate)
        warped = pairwise_warp(features, affines)
        ego_rep = features[:, :, None].expand_as(warped)
        flat = torch.cat([warped, ego_rep], dim=3).reshape(
            b * l * l, 2 * c, h, w)
        pose_corr = self.pose_regression(flat).reshape(b, l, l, 3)
        score = torch.sigmoid(self.attention(flat).reshape(b, l, l))

        # the corrected relative transforms: T(pose_corr) @ T_noisy
        t_new = matmul_f32(pose3_to_tfm(pose_corr), pairwise_t_matrix)
        if self.use_consistency:
            t_new = pose3_to_tfm(global_consistency(tfm_to_pose3(t_new),
                                                    score, agent_mask))

        pair_m = agent_mask[:, :, None] & agent_mask[:, None, :]
        score = torch.where(pair_m, score, 0.0)
        weight = score / (score.sum(2, keepdim=True) + self.alpha + 1e-4)
        aff_new = normalize_pairwise_tfm(t_new, h, w, self.discrete_ratio,
                                         self.downsample_rate)
        ego_warped = pairwise_warp(features, aff_new)[:, 0]  # (B, L, C, H, W)
        fused = torch.einsum("bl,blchw->bchw", weight[:, 0], ego_warped)
        return fused, {"pose_corr": pose_corr, "agent_scores": score,
                       "pairwise_t_corrected": t_new}
