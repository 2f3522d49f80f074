"""PointPillars detection loss: focal classification, smooth-L1 regression
on the sin-difference yaw, direction cross-entropy.

Port of coalign_tpu/loss/point_pillar_loss.py (ref
opencood/loss/point_pillar_loss.py): a function of (outputs, targets)
returning (total, terms). The port's heads are NCHW and the labels NHWC
(postprocess/anchors.assign_targets), so every head map is permuted to
NHWC before it is flattened: anchor k of the flat order is (h, w, a) in
both, and regression channel c of anchor a is ``a * 7 + c``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from coalign_tpu_torch.parallel.distributed import global_sum
from coalign_tpu_torch.utils.common import limit_period


class PointPillarLossCfg(NamedTuple):
    pos_cls_weight: float = 2.0
    cls_alpha: float = 0.25
    cls_gamma: float = 2.0
    cls_weight: float = 2.0
    reg_sigma: float = 3.0
    reg_weight: float = 2.0
    use_dir: bool = False
    dir_weight: float = 0.2
    dir_offset: float = 0.7853
    num_bins: int = 2
    anchor_yaw_deg: tuple = (0.0, 90.0)


def build_loss(loss_args: dict) -> "PointPillarLoss":
    """From the yaml ``loss.args`` subtree."""
    dir_cfg = loss_args.get("dir", {})
    dir_args = dir_cfg.get("args", {})
    return PointPillarLoss(PointPillarLossCfg(
        pos_cls_weight=loss_args.get("pos_cls_weight", 2.0),
        cls_alpha=loss_args["cls"]["alpha"],
        cls_gamma=loss_args["cls"]["gamma"],
        cls_weight=loss_args["cls"]["weight"],
        reg_sigma=loss_args["reg"]["sigma"],
        reg_weight=loss_args["reg"]["weight"],
        use_dir="dir" in loss_args,
        dir_weight=dir_cfg.get("weight", 0.2),
        dir_offset=dir_args.get("dir_offset", 0.7853),
        num_bins=dir_args.get("num_bins", 2),
        anchor_yaw_deg=tuple(dir_args.get("anchor_yaw", (0, 90)))))


def sigmoid_focal_loss(logits, targets, alpha, gamma):
    """Elementwise sigmoid focal loss (ref point_pillar_loss.py:234-245)."""
    ce = (torch.clamp(logits, min=0) - logits * targets
          + torch.log1p(torch.exp(-torch.abs(logits))))
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    return (1.0 - p_t) ** gamma * alpha_w * ce


def weighted_smooth_l1(preds, targets, sigma):
    """Huber with a 1/sigma^2 transition (ref point_pillar_loss.py:222-230)."""
    diff = torch.abs(preds - targets)
    cut = 1.0 / sigma ** 2
    return torch.where(diff <= cut, 0.5 * (diff * sigma) ** 2,
                       diff - 0.5 * cut)


def _flat(head_map: torch.Tensor, width: int) -> torch.Tensor:
    """NCHW (B, A*width, H, W) -> (B, H*W*A, width)."""
    b = head_map.shape[0]
    return head_map.permute(0, 2, 3, 1).reshape(b, -1, width)


class PointPillarLoss:
    """outputs: cls_preds (B, A, H, W), reg_preds (B, 7A, H, W), optional
    dir_preds (B, bins*A, H, W); targets: pos_equal_one / neg_equal_one
    (B, H, W, A), targets (B, H, W, 7A). ``sample_mask`` (B,) leaves padded
    samples out and normalizes by the valid ones (the JAX package's
    replacement of the reference's record_len normalization)."""

    def __init__(self, cfg: PointPillarLossCfg):
        self.cfg = cfg

    def __call__(self, outputs: dict, targets: dict, sample_mask=None):
        cfg = self.cfg
        cls_logits = _flat(outputs["cls_preds"], 1)
        reg_p = _flat(outputs["reg_preds"], 7)
        b = cls_logits.shape[0]
        pos = targets["pos_equal_one"].reshape(b, -1, 1)
        neg = targets["neg_equal_one"].reshape(b, -1, 1)
        reg_t = targets["targets"].reshape(b, -1, 7)
        if sample_mask is None:
            sample_mask = torch.ones(b, dtype=cls_logits.dtype,
                                     device=cls_logits.device)
        sample_mask = sample_mask.to(cls_logits.dtype)
        # the batch-wide sums are the whole batch's under a process group
        # (parallel/distributed.global_sum); the per-sample normalizer is
        # each sample's own
        denom = torch.clamp(global_sum(sample_mask.sum()), min=1.0)
        pos = pos * sample_mask[:, None, None]
        neg = neg * sample_mask[:, None, None]
        pos_normalizer = torch.clamp(pos.sum(dim=1, keepdim=True), min=1.0)

        cls_weights = (pos * cfg.pos_cls_weight + neg) / pos_normalizer
        cls_loss = sigmoid_focal_loss(cls_logits, pos, cfg.cls_alpha,
                                      cfg.cls_gamma) * cls_weights
        cls_loss = global_sum(cls_loss.sum()) * cfg.cls_weight / denom

        reg_weights = pos / pos_normalizer
        # sin(a - b) = sin a cos b - cos a sin b, split between the two
        # sides (ref point_pillar_loss.py:126-137)
        sin_p = torch.sin(reg_p[..., 6]) * torch.cos(reg_t[..., 6])
        sin_t = torch.cos(reg_p[..., 6]) * torch.sin(reg_t[..., 6])
        reg_p = torch.cat([reg_p[..., :6], sin_p[..., None]], dim=-1)
        reg_tt = torch.cat([reg_t[..., :6], sin_t[..., None]], dim=-1)
        reg_loss = weighted_smooth_l1(reg_p, reg_tt, cfg.reg_sigma) \
            * reg_weights
        reg_loss = global_sum(reg_loss.sum()) * cfg.reg_weight / denom

        total = cls_loss + reg_loss
        terms = {"cls_loss": cls_loss, "reg_loss": reg_loss}
        if cfg.use_dir and "dir_preds" in outputs:
            logp = F.log_softmax(_flat(outputs["dir_preds"], cfg.num_bins),
                                 dim=-1)
            dir_ce = -(self._direction_targets(reg_t) * logp).sum(-1)
            dir_loss = global_sum((dir_ce * reg_weights[..., 0]).sum()) \
                * cfg.dir_weight / denom
            total = total + dir_loss
            terms["dir_loss"] = dir_loss
        terms["total_loss"] = total
        return total, terms

    def _direction_targets(self, reg_t):
        """One-hot direction bins from the yaw residuals
        (ref point_pillar_loss.py:139-166 get_direction_target)."""
        cfg = self.cfg
        k = reg_t.shape[1]
        anchor_yaw = torch.deg2rad(torch.tensor(cfg.anchor_yaw_deg,
                                                dtype=reg_t.dtype,
                                                device=reg_t.device))
        yaw_map = anchor_yaw.repeat(k // len(cfg.anchor_yaw_deg))
        offset_rot = limit_period(reg_t[..., 6] + yaw_map - cfg.dir_offset,
                                  0.0, 2 * math.pi)
        # divided by a tensor: IEEE's division on every device (see
        # utils/common.limit_period)
        bins = torch.floor(offset_rot / offset_rot.new_full(
            (), 2 * math.pi / cfg.num_bins)).long()
        bins = torch.clamp(bins, 0, cfg.num_bins - 1)
        return F.one_hot(bins, cfg.num_bins).to(reg_t.dtype)
