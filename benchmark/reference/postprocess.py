"""The plain reference of the detectors' post-processing: anchor decoding,
the direction classifier, the sanity filters, greedy rotated NMS and the
range mask (ref voxel_postprocessor.py post_process, delta_to_boxes3d,
box_utils.py, and the uncertainty postprocessor's stage-1 variant that
carries each box's log-variances).

The NMS is the textbook greedy loop: walk the candidates from the highest
score down, keep a box unless a kept box overlaps it by more than the
threshold. Its IoU is the plain rotated IoU of yardstick/iou.py.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.yardstick.iou import rotated_iou_plain

CORNERS = torch.tensor([[1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
                        [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1]],
                       dtype=torch.float64) / 2.0


def wrap(val, offset: float, period: float):
    return val - torch.floor(val / val.new_full((), period) + offset) * period


def corners_of(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) hwl boxes -> (..., 8, 3) corners."""
    lwh = boxes[..., [5, 4, 3]]
    local = lwh[..., None, :] * CORNERS.to(boxes)
    c = torch.cos(boxes[..., 6])[..., None]
    s = torch.sin(boxes[..., 6])[..., None]
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return torch.stack([x, y, local[..., 2]], -1) + boxes[..., None, :3]


def rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """(B, width * A, H, W) -> (B, H * W * A, width)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)


def greedy_nms(corners2d: torch.Tensor, valid: torch.Tensor,
               threshold: float) -> np.ndarray:
    """corners2d (K, 4, 2) in rank order, valid (K,) -> kept (K,) bool."""
    iou = rotated_iou_plain(corners2d.float(), corners2d.float()).cpu().numpy()
    valid = valid.cpu().numpy()
    kept = np.zeros(len(valid), bool)
    for i in np.flatnonzero(valid):
        kept[i] = not (iou[kept, i] > threshold).any()
    return kept


def _decode(reg, dirs, anchors, idx, dir_args, tfm):
    """Boxes (K, 7) and ego-frame corners (K, 8, 3) of anchors ``idx``."""
    period = 2 * math.pi / dir_args["num_bins"]
    anc = anchors[idx]
    d = reg[idx]
    diag = torch.sqrt(anc[:, 4] ** 2 + anc[:, 5] ** 2)
    boxes = torch.cat([d[:, :2] * diag[:, None] + anc[:, :2],
                       d[:, 2:3] * anc[:, 3:4] + anc[:, 2:3],
                       torch.exp(d[:, 3:6]) * anc[:, 3:6],
                       d[:, 6:7] + anc[:, 6:7]], -1)
    label = torch.argmax(dirs[idx], -1).to(boxes.dtype)
    rot = wrap(boxes[:, 6] - dir_args["dir_offset"], 0.0, period)
    boxes[:, 6] = wrap(rot + dir_args["dir_offset"] + period * label, 0.5,
                       2 * math.pi)
    corners = corners_of(boxes) @ tfm[:3, :3].t() + tfm[:3, 3]
    return boxes, corners


def _sane(corners):
    """The size and height filters (ref box_utils.py remove_large_pred_bbx,
    remove_bbx_abnormal_z)."""
    ext = corners.amax(1) - corners.amin(1)
    return ((ext[:, 0] <= 6.0) & (ext[:, 1] <= 6.0) & (ext[:, 1] != 0)
            & (corners[:, :, 2].amin(1) >= -3.0)
            & (corners[:, :, 2].amax(1) <= 1.0))


def detect(maps: dict, anchors: torch.Tensor, tfm: torch.Tensor, post: dict,
           max_keep: int, prefilter_k: int = 512, extra: int = 64):
    """Head maps of a batch -> for each frame (a list):
      kept        the kept boxes ranked by score: corners3d (n, 8, 3),
                  boxes7 (n, 7), scores (n,) and, where the maps hold
                  log-variances, uncertainty (n, U);
      candidates  the ``prefilter_k + extra`` best raw scores ranked:
                  corners (K, 8, 3), scores (K,), valid (K,) (above the
                  threshold, inside the prefilter, through the filters),
                  for yardstick/compare.py;
      nms_input   the (prefilter_k, 4, 2) corners that the NMS compares,
                  for the IoU kernel's operation count.
    The candidates are the ``prefilter_k`` highest scores above the
    threshold; the kept boxes those of the ``max_keep`` best-ranked valid
    candidates that no better kept one suppressed and that lie wholly
    inside gt_range (the rule of the program's post_process)."""
    thr = post["target_args"]["score_threshold"]
    dir_args = post["dir_args"]
    a = maps["cls_preds"].shape[1]
    scores = torch.sigmoid(rows(maps["cls_preds"], 1)[..., 0])
    reg = rows(maps["reg_preds"], 7)
    dirs = rows(maps["dir_preds"], dir_args["num_bins"])
    unc = (rows(maps["unc_preds"], maps["unc_preds"].shape[1] // a)
           if "unc_preds" in maps else None)
    flat_anchors = anchors.reshape(-1, 7)
    lo = torch.tensor(post["gt_range"][:3]).to(scores)
    hi = torch.tensor(post["gt_range"][3:]).to(scores)
    frames = []
    for b in range(scores.shape[0]):
        s = torch.where(scores[b] > thr, scores[b], -1.0)
        s, idx = torch.sort(s, descending=True, stable=True)
        s, idx = s[:prefilter_k], idx[:prefilter_k]
        boxes, corners = _decode(reg[b], dirs[b], flat_anchors, idx, dir_args,
                                 tfm[b])
        valid = (s > 0) & _sane(corners)
        kept = torch.as_tensor(greedy_nms(corners[:, :4, :2], valid,
                                          post["nms_thresh"]),
                               device=valid.device)
        # the program ranks the filtered-out candidates last and keeps the
        # survivors among its first max_keep ranks
        kept &= torch.cumsum(valid.long(), 0) <= max_keep
        kept &= ((corners >= lo) & (corners <= hi)).all(-1).all(-1)
        frame = {"corners3d": corners[kept], "boxes7": boxes[kept],
                 "scores": s[kept]}
        if unc is not None:
            frame["uncertainty"] = unc[b, idx][kept]
        raw, ridx = torch.sort(scores[b], descending=True, stable=True)
        raw, ridx = raw[:prefilter_k + extra], ridx[:prefilter_k + extra]
        _, rc = _decode(reg[b], dirs[b], flat_anchors, ridx, dir_args, tfm[b])
        rvalid = (raw > thr) & _sane(rc)
        rvalid[prefilter_k:] = False
        frames.append({
            "kept": {k: v.cpu() for k, v in frame.items()},
            "candidates": {"corners": rc.cpu().numpy(),
                           "scores": raw.cpu().numpy(),
                           "valid": rvalid.cpu().numpy()},
            "nms_input": corners[:, :4, :2]})
    return frames
