"""PIXOR's dense-map loss: BCE on the occupancy, masked smooth L1 on the
regression.

Port of coalign_tpu/loss/pixor_loss.py (ref opencood/loss/pixor_loss.py:
13-70): (outputs, labels) -> (total, terms). The maps are NCHW, the label
map NHWC (postprocess/dense_bev.assign_dense_targets); the maps are
permuted to NHWC first.
"""

from __future__ import annotations

import torch

from coalign_tpu_torch.parallel.distributed import global_mean, global_sum


class PixorLoss:
    def __init__(self, alpha: float = 1.0, beta: float = 1.0):
        self.alpha = alpha
        self.beta = beta

    def __call__(self, outputs: dict, labels: dict):
        """outputs: cls_map (B, 1, H, W), reg_map (B, 6, H, W); labels:
        label_map (B, H, W, 7)."""
        label_map = labels["label_map"]
        cls_t, reg_t = label_map[..., 0:1], label_map[..., 1:]
        cls_p = outputs["cls_map"].permute(0, 2, 3, 1)
        reg_p = outputs["reg_map"].permute(0, 2, 3, 1)

        ce = (torch.clamp(cls_p, min=0) - cls_p * cls_t
              + torch.log1p(torch.exp(-torch.abs(cls_p))))
        cls_loss = global_mean(ce)

        diff = (reg_p - reg_t) * cls_t
        sm = torch.where(torch.abs(diff) < 1.0, 0.5 * diff ** 2,
                         torch.abs(diff) - 0.5)
        reg_loss = global_sum(sm.sum()) / torch.clamp(global_sum(cls_t.sum()),
                                                      min=1.0)

        total = self.alpha * cls_loss + self.beta * reg_loss
        return total, {"total_loss": total, "cls_loss": cls_loss,
                       "reg_loss": reg_loss}


def build_pixor_loss(args: dict) -> PixorLoss:
    return PixorLoss(alpha=args.get("alpha", 1.0), beta=args.get("beta", 1.0))
