"""The pose-robust baselines' losses: robust V2VNet's and MASH's.

Port of coalign_tpu/loss/robust_loss.py (ref opencood/loss/
point_pillar_v2v_robust_loss.py:77, point_pillar_mash_loss.py). Each wraps
the PointPillars detection loss and adds its own term.
"""

from __future__ import annotations

import torch

from coalign_tpu_torch.loss.point_pillar_loss import build_loss as _build_pp
from coalign_tpu_torch.parallel.distributed import global_mean


def smooth_l1(x, beta=1.0):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax ** 2 / beta, ax - 0.5 * beta)


class RobustLoss:
    """Detection loss; from stage 1 on, with the model's ``pose_corr_target``
    (the noise correction from the clean poses), a smooth-L1 pose term on
    the pose correction (x, y, and ``angle_weight`` times the yaw residual
    wrapped to (-pi, pi]) and an attention term, -log of every pair's
    score (valid pairs should be trusted)."""

    def __init__(self, det_loss, stage: int = 0, pose_weight: float = 1.0,
                 score_weight: float = 0.2, angle_weight: float = 10.0):
        self.det_loss = det_loss
        self.stage = stage
        self.pose_weight = pose_weight
        self.score_weight = score_weight
        self.angle_weight = angle_weight

    def __call__(self, outputs: dict, labels: dict):
        total, terms = self.det_loss(outputs, labels)
        terms = dict(terms)
        if self.stage >= 1 and "pose_corr_target" in outputs:
            err = outputs["pose_corr"] - outputs["pose_corr_target"]
            yaw = torch.atan2(torch.sin(err[..., 2]), torch.cos(err[..., 2]))
            pose_loss = global_mean(smooth_l1(err[..., :2]).sum(-1)
                                    + self.angle_weight * smooth_l1(yaw))
            score = torch.clamp(outputs["agent_scores"], 1e-4, 1 - 1e-4)
            score_loss = global_mean(-torch.log(score))
            total = total + self.pose_weight * pose_loss \
                + self.score_weight * score_loss
            terms.update(pose_loss=pose_loss, score_loss=score_loss)
        terms["total_loss"] = total
        return total, terms


def build_robust_loss(args: dict) -> RobustLoss:
    """From the yaml ``loss.args``; the stage and weights under ``robust``."""
    rb = args.get("robust", {})
    return RobustLoss(_build_pp(args), stage=rb.get("stage", 0),
                      pose_weight=rb.get("pose_weight", 1.0),
                      score_weight=rb.get("score_weight", 0.2),
                      angle_weight=rb.get("angle_weight", 10.0))


class MashLoss:
    """Detection loss plus ``corr_weight`` times the mean entropy of the
    correspondence volume's softmax (``corr_vol``, the no-match bin
    included): pose-free training toward confident matches. The reference
    supervises the volume with a cross-entropy toward the true offset; the
    JAX package, and so the port, uses the entropy."""

    def __init__(self, det_loss, corr_weight: float = 0.1):
        self.det_loss = det_loss
        self.corr_weight = corr_weight

    def __call__(self, outputs: dict, labels: dict):
        total, terms = self.det_loss(outputs, labels)
        terms = dict(terms)
        if outputs.get("corr_vol") is not None:
            logits = outputs["corr_vol"]
            p = torch.exp(logits - logits.amax(-1, keepdim=True))
            p = p / p.sum(-1, keepdim=True)
            entropy = global_mean(-(p * torch.log(p + 1e-9)).sum(-1))
            total = total + self.corr_weight * entropy
            terms.update(corr_entropy=entropy)
        terms["total_loss"] = total
        return total, terms


def build_mash_loss(args: dict) -> MashLoss:
    """From the yaml ``loss.args``; ``mash.corr_weight`` (0.1)."""
    return MashLoss(_build_pp(args),
                    corr_weight=args.get("mash", {}).get("corr_weight", 0.1))
