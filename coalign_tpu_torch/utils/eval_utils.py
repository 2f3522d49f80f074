"""Detection evaluation: VOC-2010 AP with global score sorting.

Port of coalign_tpu/utils/eval_utils.py (ref opencood/utils/eval_utils.py):
greedy per-frame TP/FP matching with gt removal, a global sort across
frames, VOC-2010 interpolation, IoU thresholds 0.3 / 0.5 / 0.7. Host numpy;
the polygon IoU is the plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from coalign_tpu_torch.utils.iou import rotated_iou_plain


def new_result_stat():
    return {t: {"tp": [], "fp": [], "score": [], "gt": 0}
            for t in (0.3, 0.5, 0.7)}


def voc_ap(rec, prec):
    """VOC-2010 AP (ref eval_utils.py:19)."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    ap = float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))
    return ap, mrec.tolist(), mpre.tolist()


def accumulate_tp_fp(det_corners, det_scores, gt_corners, result_stat,
                     iou_thresh: float):
    """Greedy TP/FP matching for one frame (ref eval_utils.py:45).

    det_corners (N, 4, 2) or (N, 8, 3), det_scores (N,), gt_corners
    (M, 4, 2) or (M, 8, 3); z is ignored.
    """
    stat = result_stat[iou_thresh]
    gt_corners = np.asarray(gt_corners)
    stat["gt"] += int(gt_corners.shape[0])
    if det_corners is None or len(det_corners) == 0:
        return
    det_corners = np.asarray(det_corners)
    det_scores = np.asarray(det_scores)
    if det_corners.shape[-2] == 8:
        det_corners = det_corners[:, :4, :2]
    if gt_corners.size and gt_corners.shape[-2] == 8:
        gt_corners = gt_corners[:, :4, :2]

    order = np.argsort(-det_scores, kind="stable")
    stat["score"] += det_scores[order].tolist()
    if gt_corners.shape[0] == 0:
        stat["fp"] += [1] * len(order)
        stat["tp"] += [0] * len(order)
        return

    iou = rotated_iou_plain(
        torch.from_numpy(np.ascontiguousarray(det_corners, np.float32)),
        torch.from_numpy(np.ascontiguousarray(gt_corners, np.float32))
    ).numpy()
    gt_alive = np.ones(gt_corners.shape[0], dtype=bool)
    for i in order:
        ious = np.where(gt_alive, iou[i], -1.0)
        j = int(np.argmax(ious))
        if not gt_alive.any() or ious[j] < iou_thresh:
            stat["fp"].append(1)
            stat["tp"].append(0)
            continue
        stat["fp"].append(0)
        stat["tp"].append(1)
        gt_alive[j] = False


def calculate_ap(result_stat, iou_thresh: float):
    """Global-sort PR curve + VOC-2010 AP (ref eval_utils.py:100)."""
    stat = result_stat[iou_thresh]
    fp = np.asarray(stat["fp"], dtype=np.float64)
    tp = np.asarray(stat["tp"], dtype=np.float64)
    score = np.asarray(stat["score"], dtype=np.float64)
    gt_total = max(stat["gt"], 1)
    order = np.argsort(-score)
    fp = np.cumsum(fp[order])
    tp = np.cumsum(tp[order])
    rec = tp / gt_total
    prec = tp / np.maximum(fp + tp, 1e-9)
    return voc_ap(rec, prec)


def eval_final_results(result_stat):
    """{'ap30', 'ap50', 'ap70'} (ref eval_utils.py:145)."""
    return {key: calculate_ap(result_stat, t)[0]
            for key, t in (("ap30", 0.3), ("ap50", 0.5), ("ap70", 0.7))}
