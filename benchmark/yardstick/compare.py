"""The comparison that decides ``correct`` for a detector's box set.

The program's kept boxes of a frame are held against the reference's
candidates of the same frame (reference/postprocess.py: the decoded,
filtered, score-ranked boxes that reach the NMS) in two stages:

  1. each kept box must be one of the reference's candidates: the nearest
     candidate's largest corner distance (``corner_gap_m``) and the
     difference of the two scores (``score_gap``);
  2. the kept set must be what the threshold, greedy NMS, the max_keep cut
     and the range mask make of those candidates, up to rounding: decisions
     that the reference's own numbers leave within score_eps of the score
     threshold or of another candidate's score, or within iou_eps of the NMS
     threshold, may go either way. Each candidate decided otherwise counts
     one ``nms_violations``. The cell's limits set both margins: a decision
     within the score gap, or the corner gap (an IoU moves by about as much
     as a corner does, in metres, on boxes a few metres long), that the
     comparison allows may go either way.

Stage 2 checks the kept set as a fixed point of the greedy rule rather than
against the reference's own kept set: a rounding-level difference at one
decision can legitimately change the decisions that depend on it, and the
fixed-point test accepts every outcome that a consistent greedy pass could
reach from numbers within rounding of the reference's.
"""

from __future__ import annotations

import numpy as np

from benchmark.yardstick.iou import rotated_iou_plain

MATCH_M = 0.5        # a kept box farther than this from every candidate is
#                      no candidate at all


def box_set_numbers(kept_corners: np.ndarray, kept_scores: np.ndarray,
                    cand: dict, post: dict, max_keep: int,
                    score_eps: float, iou_eps: float) -> dict:
    """kept_corners (n, 8, 3), kept_scores (n,): the program's kept boxes
    of one frame; ``cand``: the reference's candidates of that frame, ranked
    by score (corners (K, 8, 3), scores (K,), valid (K,) bool: above the
    threshold, inside the prefilter and through the sanity filters).
    Returns score_gap, corner_gap_m and nms_violations."""
    import torch
    thr = post["target_args"]["score_threshold"]
    nms_thr = post["nms_thresh"]
    lo = np.asarray(post["gt_range"][:3], np.float32)
    hi = np.asarray(post["gt_range"][3:], np.float32)
    cc, cs, cv = cand["corners"], cand["scores"], cand["valid"]
    out = {"score_gap": 0.0, "corner_gap_m": 0.0, "nms_violations": 0}
    if len(kept_scores) == 0 and not cv.any():
        return out
    # stage 1: which candidate each kept box is
    match = np.zeros(len(kept_scores), np.int64)
    for i, c in enumerate(kept_corners):
        d = np.abs(cc - c[None]).max(axis=(1, 2))
        j = int(np.argmin(d))
        match[i] = j
        out["corner_gap_m"] = max(out["corner_gap_m"], float(d[j]))
        out["score_gap"] = max(out["score_gap"],
                               float(abs(kept_scores[i] - cs[j])))
        if d[j] > MATCH_M:
            out["nms_violations"] += 1
    kept = np.zeros(len(cs), bool)
    if len(match):
        near = np.abs(cc[match] - kept_corners).max(axis=(1, 2)) <= MATCH_M
        kept[match[near]] = True
    # stage 2: the greedy rule over the candidates in rank order
    iou = rotated_iou_plain(torch.from_numpy(cc[:, :4, :2]).float(),
                            torch.from_numpy(cc[:, :4, :2]).float()).numpy()
    inside = ((cc >= lo) & (cc <= hi)).all(-1).all(-1)
    near_inside = ((cc >= lo - iou_eps) & (cc <= hi + iou_eps)).all(-1).all(-1)
    robust_inside = ((cc >= lo + iou_eps)
                     & (cc <= hi - iou_eps)).all(-1).all(-1)
    valid_rank = np.cumsum(cv) - 1
    cut_score = (cs[cv][max_keep - 1] if cv.sum() >= max_keep else -np.inf)
    nms_kept = np.zeros(len(cs), bool)     # kept by the NMS, in range or not
    for c in np.flatnonzero(cv | kept):
        above = nms_kept & (cs > cs[c] - score_eps)
        above[c] = False
        if kept[c]:
            marginal_valid = cs[c] > thr - score_eps
            beyond = (valid_rank[c] >= max_keep
                      and cs[c] < cut_score - score_eps)
            sure_above = nms_kept & (cs > cs[c] + score_eps)
            if (not (cv[c] or marginal_valid) or beyond
                    or (iou[sure_above, c] > nms_thr + iou_eps).any()
                    or not near_inside[c]):
                out["nms_violations"] += 1
            nms_kept[c] = True
            continue
        suppressed = (iou[above, c] > nms_thr - iou_eps).any()
        if suppressed:
            continue
        if not inside[c]:
            nms_kept[c] = True             # kept by the NMS, masked after it
            continue
        excused = (cs[c] < thr + score_eps
                   or (valid_rank[c] >= max_keep - 1
                       and cs[c] < cut_score + score_eps)
                   or not robust_inside[c]
                   or valid_rank[c] >= max_keep)
        if not excused:
            out["nms_violations"] += 1
    # a kept pair that overlaps beyond the threshold
    k = np.flatnonzero(kept)
    sub = iou[np.ix_(k, k)] - np.eye(len(k)) * 2
    out["nms_violations"] += int((sub > nms_thr + iou_eps).sum() // 2)
    return out

