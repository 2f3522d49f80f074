"""The two-stage models' loss.

Port of coalign_tpu/loss/fpvrcnn_loss.py (ref opencood/loss/
fpvrcnn_loss.py:7, ciassd_loss.py:9): stage 1 is point_pillar_loss on the
per-agent ``*_single`` maps against per-agent ``*_single`` labels
(train.make_train_step assigns them, ``wants_single_labels``); stage 2
matches each RoI to the gt of highest BEV IoU and applies an IoU-aware
confidence BCE and a smooth-L1 on the refined boxes of positives.

Stage 2 runs only when the labels carry ``gt_boxes``, as in the JAX
package, whose train step never adds them (coalign_tpu/train.py:105-123):
training through the CLI trains stage 1 alone, and the validation loss of
a multi-agent batch, which has no ``_single`` labels and whose frame
labels do not match the B * L agent rows, is 0. The port follows both.

The RoI x gt IoU runs through the rotated-IoU kernel on CUDA and its plain
version on the CPU (kernels/rotated_iou.py), in float32. It needs no
gradient: the RoIs are detached proposals and the gt is constant. Padded
RoIs and gt are zero boxes whose IoU the kernel computes like any other
(ROADMAP §3 fault 4); ``gt_mask`` and ``roi_mask`` mask them after the
IoU, as the JAX package does.
"""

from __future__ import annotations

import torch

from coalign_tpu_torch.kernels.rotated_iou import rotated_iou
from coalign_tpu_torch.loss.point_pillar_loss import build_loss as _build_pp
from coalign_tpu_torch.utils.box_utils import boxes_to_corners_3d


def roi_box_iou(rois: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """BEV IoU of (B, R, 7) RoIs against (B, M, 7) gt, 'hwl' -> (B, R, M)
    in the boxes' dtype, computed in float32 outside autograd."""
    if rois.requires_grad or gt.requires_grad:
        raise ValueError("the RoI x gt IoU takes detached boxes")
    rc = boxes_to_corners_3d(rois, "hwl")[..., :4, :2].float().contiguous()
    gc = boxes_to_corners_3d(gt, "hwl")[..., :4, :2].float().contiguous()
    return rotated_iou(rc, gc).to(rois.dtype)


def roi_stage2_loss(outputs: dict, gt_boxes, gt_mask, pos_iou: float = 0.5,
                    neg_iou: float = 0.25):
    """(cls loss, reg loss) of stage 2 for a batch: each the mean over the
    frames of a frame's mean over its RoIs (cls) or its positives (reg).
    gt_boxes (B, M, 7), gt_mask (B, M)."""
    rois, roi_mask = outputs["rois"], outputs["roi_mask"]
    cls, refined = outputs["roi_cls"], outputs["boxes_refined"]
    gt_boxes = gt_boxes.to(rois.dtype)
    iou = torch.where(gt_mask[:, None, :], roi_box_iou(rois, gt_boxes), 0.0)
    best, tgt_idx = iou.amax(dim=-1), iou.argmax(dim=-1)
    pos = (best >= pos_iou) & roi_mask
    # the IoU-aware confidence target (CIA-SSD), a clipped linear map
    cls_tgt = torch.clamp((best - neg_iou) / (pos_iou - neg_iou), 0, 1)
    ce = (torch.clamp(cls, min=0) - cls * cls_tgt
          + torch.log1p(torch.exp(-torch.abs(cls))))
    cls_loss = torch.where(roi_mask, ce, 0.0).sum(-1) / torch.clamp(
        roi_mask.sum(-1), min=1)

    matched = torch.gather(gt_boxes, 1, tgt_idx[..., None].expand(-1, -1, 7))
    diff = refined - matched
    yaw = torch.atan2(torch.sin(diff[..., 6]), torch.cos(diff[..., 6]))
    diff = torch.cat([diff[..., :6], yaw[..., None]], -1)
    sm = torch.where(torch.abs(diff) < 1.0, 0.5 * diff ** 2,
                     torch.abs(diff) - 0.5).sum(-1)
    reg_loss = torch.where(pos, sm, 0.0).sum(-1) / torch.clamp(pos.sum(-1),
                                                               min=1)
    return cls_loss.mean(), reg_loss.mean()


def _strip(tree: dict) -> dict:
    """The ``*_single`` entries of ``tree`` without their suffix."""
    return {k[:-len("_single")]: v for k, v in tree.items()
            if k.endswith("_single")}


class FpvRcnnLoss:
    """(outputs, labels) -> (total, terms). Stage 1: the ``_single`` maps
    against the ``_single`` labels, or, where the labels are the frame's
    and match the agent rows (single-agent batches), against those; stage
    2 (``stage`` >= 2) when the labels have ``gt_boxes``."""

    # train.make_train_step assigns the per-agent "_single" labels for this
    # loss (ref supervise_single's second pass, train.py:119-121)
    wants_single_labels = True

    def __init__(self, det_loss, stage2_cls_weight: float = 1.0,
                 stage2_reg_weight: float = 1.0, stage: int = 2):
        self.det_loss = det_loss
        self.stage2_cls_weight = stage2_cls_weight
        self.stage2_reg_weight = stage2_reg_weight
        self.stage = stage

    def __call__(self, outputs: dict, labels: dict):
        if "cls_preds_single" in outputs and "pos_equal_one_single" in labels:
            total, terms = self.det_loss(_strip(outputs), _strip(labels))
        elif ("cls_preds_single" in outputs and "pos_equal_one" in labels
              and outputs["cls_preds_single"].shape[0]
              == labels["pos_equal_one"].shape[0]):
            total, terms = self.det_loss(_strip(outputs), labels)
        else:
            total = outputs["rois"].new_zeros(())
            terms = {}
        terms = dict(terms)
        if self.stage >= 2 and "gt_boxes" in labels:
            cls_l, reg_l = roi_stage2_loss(outputs, labels["gt_boxes"],
                                           labels["gt_mask"])
            total = (total + self.stage2_cls_weight * cls_l
                     + self.stage2_reg_weight * reg_l)
            terms.update(stage2_cls=cls_l, stage2_reg=reg_l)
        terms["total_loss"] = total
        return total, terms


def build_fpvrcnn_loss(args: dict) -> FpvRcnnLoss:
    """From the yaml ``loss.args``: point_pillar_loss's args and a
    ``stage2`` block {stage, cls_weight, reg_weight}."""
    s2 = args.get("stage2", {})
    return FpvRcnnLoss(_build_pp(args), s2.get("cls_weight", 1.0),
                       s2.get("reg_weight", 1.0), s2.get("stage", 2))
