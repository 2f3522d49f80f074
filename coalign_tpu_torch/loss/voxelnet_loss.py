"""VoxelNet's loss: a per-anchor BCE split into positive and negative terms,
and a smooth-L1 regression.

Port of coalign_tpu/loss/voxelnet_loss.py (ref opencood/loss/
voxel_net_loss.py:13-62):

  cls_pos = sum(-pos * log(sigmoid(psm) + 1e-6)) / (sum(pos) + 1e-6)
  cls_neg = sum(-neg * log(1 - sigmoid(psm) + 1e-6)) / (sum(neg) + 1e-6)
  reg     = sum(smooth_l1(rm * pos, targets * pos)) / (sum(pos) + 1e-6)
  total   = reg_coe * reg + alpha * cls_pos + beta * cls_neg

The reference's SmoothL1Loss(size_average=False) sums every element (kink
at 1). The heads are NCHW and the labels NHWC (postprocess/anchors.
assign_targets), so the maps are permuted to NHWC first, as the reference
does.
"""

from __future__ import annotations

import torch

from coalign_tpu_torch.parallel.distributed import global_sum


class VoxelNetLoss:
    def __init__(self, alpha: float = 1.5, beta: float = 1.0,
                 reg_coe: float = 2.0):
        self.alpha = alpha
        self.beta = beta
        self.reg_coe = reg_coe

    def __call__(self, outputs: dict, labels: dict):
        """outputs: cls_preds (B, A, H, W), reg_preds (B, 7A, H, W);
        labels: pos_equal_one / neg_equal_one (B, H, W, A), targets
        (B, H, W, 7A). Returns (total, terms)."""
        psm = outputs["cls_preds"].permute(0, 2, 3, 1)
        rm = outputs["reg_preds"].permute(0, 2, 3, 1)
        pos, neg = labels["pos_equal_one"], labels["neg_equal_one"]
        p_pos = torch.sigmoid(psm)
        pos_sum = global_sum(pos.sum())
        cls_pos = (global_sum((-pos * torch.log(p_pos + 1e-6)).sum())
                   / (pos_sum + 1e-6))
        cls_neg = (global_sum((-neg * torch.log1p(-(p_pos - 1e-6))).sum())
                   / (global_sum(neg.sum()) + 1e-6))
        shape = rm.shape[:-1] + (rm.shape[-1] // 7, 7)
        diff = (rm.reshape(shape) - labels["targets"].reshape(shape)) \
            * pos[..., None]
        sm = torch.where(diff.abs() < 1.0, 0.5 * diff ** 2, diff.abs() - 0.5)
        reg = global_sum(sm.sum()) / (pos_sum + 1e-6)
        conf = self.alpha * cls_pos + self.beta * cls_neg
        total = self.reg_coe * reg + conf
        return total, {"total_loss": total, "conf_loss": conf,
                       "reg_loss": reg, "cls_pos_loss": cls_pos,
                       "cls_neg_loss": cls_neg}


def build_voxelnet_loss(args: dict) -> VoxelNetLoss:
    return VoxelNetLoss(alpha=args.get("alpha", 1.5),
                        beta=args.get("beta", 1.0),
                        reg_coe=args.get("reg", 2.0))
