"""Anchor decode and detection post-processing, batched.

Port of coalign_tpu/postprocess/decode.py (ref voxel_postprocessor.py:243-450):
sigmoid -> threshold -> top-K prefilter -> decode -> direction fix -> project
-> sanity filters -> rotated NMS -> range mask, with fixed output shapes. The
JAX package runs it per frame inside its jitted program; here every step
takes the batch at once, so the NMS IoU matrix is one kernel launch per
batch.

Maps are NCHW, as the model emits them; they are flattened in the reference
order (permute to NHWC, then (H * W * A, ...)). The two-stage models' refined
RoIs go through post_process_refined instead.
"""

from __future__ import annotations

import math

import torch

from coalign_tpu_torch.utils import box_utils as B
from coalign_tpu_torch.utils.common import limit_period
from coalign_tpu_torch.utils.nms import nms_rotated


def _rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """(B, width * A, H, W) map -> (B, H * W * A, width) rows."""
    b = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(b, -1, width)


def delta_to_boxes3d_rows(d: torch.Tensor, anchors: torch.Tensor):
    """Decode (..., 7) regression deltas against (..., 7) 'hwl' anchors
    (ref voxel_postprocessor.py:404)."""
    diag = torch.sqrt(anchors[..., 4] ** 2 + anchors[..., 5] ** 2)
    xy = d[..., 0:2] * diag[..., None] + anchors[..., 0:2]
    z = d[..., 2:3] * anchors[..., 3:4] + anchors[..., 2:3]
    hwl = torch.exp(d[..., 3:6]) * anchors[..., 3:6]
    yaw = d[..., 6:7] + anchors[..., 6:7]
    return torch.cat([xy, z, hwl, yaw], dim=-1)


def delta_to_boxes3d(deltas: torch.Tensor, anchors: torch.Tensor):
    """(B, 7A, H, W) deltas against the (H, W, A, 7) anchor grid ->
    (B, H * W * A, 7) boxes (ref voxel_postprocessor.py:404)."""
    return delta_to_boxes3d_rows(_rows(deltas, 7), anchors.reshape(-1, 7))


def correct_direction(boxes7, dir_logits, dir_offset: float, num_bins: int):
    """Resolve the heading with the direction classifier
    (ref voxel_postprocessor.py:317-333). boxes7 (..., 7), dir_logits
    (..., num_bins)."""
    dir_labels = torch.argmax(dir_logits, dim=-1).to(boxes7.dtype)
    period = 2 * math.pi / num_bins
    dir_rot = limit_period(boxes7[..., 6] - dir_offset, 0.0, period)
    yaw = limit_period(dir_rot + dir_offset + period * dir_labels, 0.5,
                       2 * math.pi)
    return torch.cat([boxes7[..., :6], yaw[..., None]], dim=-1)


def post_process(cls_preds, reg_preds, anchors, transformation_matrix,
                 dir_preds=None, unc_preds=None, iou_preds=None, *,
                 score_threshold: float,
                 nms_threshold: float, gt_range, prefilter_k: int = 512,
                 max_keep: int = 100, dir_offset: float = 0.7853,
                 num_bins: int = 2) -> dict:
    """Head maps of a batch -> final boxes.

    cls_preds (B, A, H, W) logits, reg_preds (B, 7A, H, W), dir_preds
    (B, bins*A, H, W) or None (zero logits then: direction bin 0),
    unc_preds (B, U*A, H, W) log-variances or None, iou_preds (B, A, H, W)
    IoU-head logits or None, anchors (H, W, A, 7) 'hwl',
    transformation_matrix (B, 4, 4) to the ego frame. With iou_preds each
    score is rescored by ((sigmoid(iou) + 1) / 2) ** 4 before the threshold
    (CIA-SSD, ref voxel_postprocessor.py:335-339); the infer fns, as the
    JAX package's, pass none (ROADMAP §3).

    Returns corners3d (B, max_keep, 8, 3), boxes7 (B, max_keep, 7), scores
    (B, max_keep) and mask (B, max_keep) bool, ranked by score, and with
    unc_preds uncertainty (B, max_keep, U), each box's log-variances carried
    through the top-K gather and the NMS ranking (ref
    uncertainty_voxel_postprocessor.py post_process_stage1); entries with
    mask False are zero.
    """
    b = cls_preds.shape[0]
    scores = torch.sigmoid(_rows(cls_preds, 1)[..., 0])           # (B, k)
    if iou_preds is not None:
        iou = torch.clamp(torch.sigmoid(_rows(iou_preds, 1)[..., 0]), 0.0, 1.0)
        scores = scores * ((iou + 1) * 0.5) ** 4
    k = scores.shape[1]
    valid = scores > score_threshold

    # top-K prefilter by a stable sort: ties go to the lower index, as with
    # the JAX package's lax.top_k
    prefilter_k = min(prefilter_k, k)
    masked = torch.where(valid, scores, -1.0)
    sel_scores, sel_idx = torch.sort(masked, dim=-1, descending=True,
                                     stable=True)
    sel_scores = sel_scores[:, :prefilter_k]
    sel_idx = sel_idx[:, :prefilter_k]
    sel_valid = sel_scores > 0

    def take(rows):
        return torch.gather(rows, 1, sel_idx[..., None].expand(
            -1, -1, rows.shape[-1]))

    sel_boxes = delta_to_boxes3d_rows(take(_rows(reg_preds, 7)),
                                      anchors.reshape(-1, 7)[sel_idx])
    if dir_preds is None:
        # a model without a direction head: zero logits still resolve the
        # heading, as the JAX infer fns feed them (inference.py:104-107)
        dir_preds = cls_preds.new_zeros(
            (b, num_bins * cls_preds.shape[1]) + cls_preds.shape[2:])
    sel_boxes = correct_direction(sel_boxes, take(_rows(dir_preds, num_bins)),
                                  dir_offset, num_bins)

    corners = B.boxes_to_corners_3d(sel_boxes, "hwl")              # (B,P,8,3)
    corners = B.project_box3d(corners, transformation_matrix[:, None])

    # size/z sanity filters before NMS, the range mask after it (ref
    # voxel_postprocessor.py:375-397): an out-of-range box still suppresses
    sel_valid = (sel_valid & B.remove_large_pred_bbx(corners)
                 & B.remove_bbx_abnormal_z(corners))
    order, keep = nms_rotated(corners[..., :4, :2], sel_scores, sel_valid,
                              nms_threshold)

    p = corners.shape[1]
    parts = [corners.reshape(b, p, 24), sel_boxes, sel_scores[..., None]]
    if unc_preds is not None:
        a = cls_preds.shape[1]
        parts.append(take(_rows(unc_preds, unc_preds.shape[1] // a)))
    ranked = torch.cat(parts, dim=-1)
    top = order[:, :max_keep]
    ranked = torch.gather(ranked, 1, top[..., None].expand(
        -1, -1, ranked.shape[-1]))
    ranked_corners = ranked[..., :24].reshape(b, -1, 8, 3)
    keep = keep[:, :max_keep] & B.mask_corners_all_inside_range(
        ranked_corners, gt_range)
    out = {
        "corners3d": ranked_corners * keep[..., None, None],
        "boxes7": ranked[..., 24:31] * keep[..., None],
        "scores": torch.where(keep, ranked[..., 31], 0.0),
        "mask": keep,
    }
    if unc_preds is not None:
        out["uncertainty"] = ranked[..., 32:] * keep[..., None]
    return out


def post_process_refined(boxes7, cls_logits, roi_mask, transformation_matrix,
                         *, score_threshold: float, nms_threshold: float,
                         gt_range, order: str = "hwl") -> dict:
    """The two-stage models' RoI-refined outputs of a batch -> final boxes
    (port of post_process_refined_frame, coalign_tpu/postprocess/
    decode.py:172; ref fpvrcnn_postprocessor.py:21-246): sigmoid
    confidence, boxes projected by ``transformation_matrix`` (B, 4, 4) into
    the ego frame, valid where the RoI is, the score above the threshold
    and some corner in range, rotated NMS (one IoU launch for the batch).

    boxes7 (B, R, 7), cls_logits (B, R), roi_mask (B, R). Returns
    corners3d (B, R, 8, 3), boxes7 (B, R, 7), scores (B, R) and mask
    (B, R), ranked by score, zero where not kept."""
    b, r = cls_logits.shape[:2]
    scores = torch.sigmoid(cls_logits.reshape(b, r))
    boxes7 = B.project_boxes7_by_tfm(boxes7, transformation_matrix[:, None],
                                     order)
    corners = B.boxes_to_corners_3d(boxes7, order)
    valid = (roi_mask.reshape(b, r) & (scores > score_threshold)
             & B.mask_corners_outside_range(corners, gt_range))
    nms_order, keep = nms_rotated(corners[..., :4, :2], scores, valid,
                                  nms_threshold)
    ranked = torch.cat([corners.reshape(b, r, 24), boxes7, scores[..., None]],
                       dim=-1)
    ranked = torch.gather(ranked, 1, nms_order[..., None].expand(
        -1, -1, ranked.shape[-1]))
    return {"corners3d": ranked[..., :24].reshape(b, r, 8, 3)
            * keep[..., None, None],
            "boxes7": ranked[..., 24:31] * keep[..., None],
            "scores": torch.where(keep, ranked[..., 31], 0.0),
            "mask": keep}
