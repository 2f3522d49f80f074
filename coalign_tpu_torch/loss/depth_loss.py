"""Depth-distribution supervision of the LSS camera encoder.

Port of coalign_tpu/loss/depth_loss.py (ref lss_submodule.py:51-69
depth supervision, camera_utils.bin_depths): the cross-entropy between the
encoder's per-pixel depth logits and the binned gt depth map, over the
pixels whose depth falls inside the bins.
"""

from __future__ import annotations

import torch

from coalign_tpu_torch.ops.lss import bin_depths
from coalign_tpu_torch.parallel.distributed import global_sum


def depth_supervision_loss(depth_logits: torch.Tensor,
                           depth_map: torch.Tensor, ddiscr, mode: str,
                           downsample: int = 8) -> torch.Tensor:
    """depth_logits (F, N, D, fH, fW), the model's; depth_map (F, N, H, W)
    metric. The mean cross-entropy over the supervised pixels."""
    d = depth_logits.shape[2]
    fh, fw = depth_logits.shape[-2:]
    dm = depth_map[..., ::downsample, ::downsample][..., :fh, :fw]
    idx = bin_depths(dm, mode, ddiscr[0], ddiscr[1], d)     # d: ignored
    valid = idx < d
    logp = torch.log_softmax(depth_logits, dim=2)
    ce = -logp.gather(2, idx.clamp(max=d - 1)[:, :, None]).squeeze(2)
    return global_sum((ce * valid).sum()) / torch.clamp(
        global_sum(valid.sum().to(ce.dtype)), min=1)


class CameraDetLoss:
    """A detection loss plus, where the outputs have ``depth_logits`` and
    the labels a ``depth_map``, ``depth_weight`` times the depth
    supervision (the JAX package's CameraDetLoss)."""

    def __init__(self, det_loss, depth_weight: float, ddiscr, mode: str,
                 downsample: int = 8):
        self.det_loss = det_loss
        self.depth_weight = depth_weight
        self.ddiscr = ddiscr
        self.mode = mode
        self.downsample = downsample

    def __call__(self, outputs: dict, labels: dict):
        total, terms = self.det_loss(outputs, labels)
        terms = dict(terms)
        if (self.depth_weight and "depth_logits" in outputs
                and "depth_map" in labels):
            dl = depth_supervision_loss(
                outputs["depth_logits"], labels["depth_map"], self.ddiscr,
                self.mode, self.downsample)
            total = total + self.depth_weight * dl
            terms.update(depth_loss=dl, total_loss=total)
        return total, terms


def build_camera_loss(args: dict) -> CameraDetLoss:
    """``camera_loss`` / ``lss_loss``: point_pillar_loss of ``args`` and
    its ``depth`` subtree (weight 1, ddiscr (2, 50, 48), LID and
    downsample 8 by default; coalign_tpu/loss/depth_loss.py:59)."""
    from coalign_tpu_torch.loss.point_pillar_loss import build_loss

    dep = args.get("depth", {})
    return CameraDetLoss(build_loss(args), dep.get("weight", 1.0),
                         tuple(dep.get("ddiscr", (2, 50, 48))),
                         dep.get("mode", "LID"), dep.get("downsample", 8))
