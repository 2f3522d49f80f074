"""Cross-agent box matching and weighted fusion (FPV-RCNN's late stage).

Port of coalign_tpu/models/matcher.py (ref opencood/models/sub_modules/
matcher.py:16, matcher_v2.py:20), batched over frames: boxes (B, K, 7)
'hwl' with scores and a validity mask (B, K).

  * ``ref`` (the default, and every yaml's): the reference's greedy
    clustering over the (K, K) 3D-IoU matrix, by first unassigned *index*
    with overwrite (a later representative re-captures earlier members
    above the threshold), as K serial steps of a few launches each with no
    host sync; then its cluster fusion: the yaw of the score-minority
    direction flipped by pi, a score-weighted mean of centre, size and
    sin/cos yaw, the fused score min(sum_i s_(i)^(i+1), 1) over the
    members' scores in descending order, and the all-BEV-corner range mask.
    The 3D IoU takes BEV *intersection areas* (utils/iou.
    quad_intersection_area, the same candidate-vertex math as the JAX
    package's quad_intersection_area_sorted), which the rotated-IoU kernel
    does not return: on the card this path stays plain.
  * ``nms``: NMS representatives (utils/nms.nms_rotated, capped at
    ``max_keep``) with an IoU-weighted membership (the rotated-IoU kernel on
    CUDA) and the members' largest score.

A padded or degenerate box (ROADMAP §3 fault 4): the ``ref`` IoU floors its
union at 1e-6, so a zero box has IoU 0 with everything; its ``valid`` False
keeps it out of every cluster. The JAX package's semantics are kept
(tests/test_torch_matcher.py holds both against it on zero-padded boxes).
"""

from __future__ import annotations

import math

import torch

from coalign_tpu_torch.kernels.rotated_iou import rotated_iou
from coalign_tpu_torch.utils import box_utils as B
from coalign_tpu_torch.utils.common import limit_period
from coalign_tpu_torch.utils.iou import polygon_area, quad_intersection_area
from coalign_tpu_torch.utils.nms import nms_rotated


def boxes_iou3d_matrix(boxes, order: str = "pcdet"):
    """Pairwise 3D IoU of center-form boxes (..., K, 7) -> (..., K, K).

    'pcdet' (the default) is the reference's boxes_iou3d_gpu as its matcher
    calls it: columns 3 and 4 are read as the rotated BEV extents and 5 as
    the height, whatever the box order, and the matcher feeds 'hwl' boxes
    (a quirk of the reference kept for the golden recording); 'hwl' and
    'lwh' are the geometric forms."""
    k = boxes.shape[-2]
    if order == "pcdet":
        h = boxes[..., 5]
        c = B.boxes_to_corners_3d(boxes, "lwh")[..., :4, :2]
    else:
        h = boxes[..., 3] if order == "hwl" else boxes[..., 5]
        c = B.boxes_to_corners_3d(boxes, order)[..., :4, :2]
    lead = c.shape[:-3]
    c1 = c[..., :, None, :, :].expand(lead + (k, k, 4, 2))
    c2 = c[..., None, :, :, :].expand(lead + (k, k, 4, 2))
    bev_inter = quad_intersection_area(c1, c2)
    z_lo, z_hi = boxes[..., 2] - h / 2, boxes[..., 2] + h / 2
    z_overlap = torch.clamp(
        torch.minimum(z_hi[..., :, None], z_hi[..., None, :])
        - torch.maximum(z_lo[..., :, None], z_lo[..., None, :]), min=0.0)
    inter = bev_inter * z_overlap
    if order == "pcdet":
        vol = boxes[..., 3] * boxes[..., 4] * boxes[..., 5]
        union = torch.clamp(vol[..., :, None] + vol[..., None, :] - inter,
                            min=1e-6)
        return inter / union
    vol = polygon_area(c) * h
    union = vol[..., :, None] + vol[..., None, :] - inter
    return torch.where(union > 1e-9, inter / union, 0.0)


def _greedy_clusters(iou, valid, thr: float):
    """The reference's clustering: indices in order; an unassigned valid
    index becomes a representative and (re-)captures every valid box with
    IoU above ``thr``. iou (B, K, K), valid (B, K) -> (cluster_of (B, K)
    int64 representative index, is_rep (B, K) bool)."""
    k = iou.shape[-1]
    over = (iou > thr) & valid[:, None, :]
    assigned = ~valid
    cluster_of = torch.zeros_like(valid, dtype=torch.int64)
    reps = []
    for i in range(k):
        rep = valid[:, i] & ~assigned[:, i]
        take = over[:, i] & rep[:, None]
        cluster_of = torch.where(take, i, cluster_of)
        assigned = assigned | take
        reps.append(rep)
    return cluster_of, torch.stack(reps, dim=1)


def _fuse_clusters(boxes, scores, cluster_of, is_rep, gt_range):
    """The reference's cluster fusion for every candidate representative:
    (fused boxes (B, K, 7), fused scores (B, K), mask (B, K))."""
    k = boxes.shape[-2]
    member = ((cluster_of[:, None, :]
               == torch.arange(k, device=boxes.device)[None, :, None])
              & is_rep[:, :, None])                               # (B, R, K)
    s = torch.where(member, scores[:, None, :], 0.0)

    # the dominant direction: angular distance to the best member's yaw,
    # wrapped to [0, pi]; the side (beyond pi/2 or not) with less score is
    # flipped by pi
    dirs = limit_period(boxes[..., 6])[:, None, :]               # (B, 1, K)
    ref_dir = torch.gather(dirs[:, 0], 1, torch.argmax(s, dim=2))[..., None]
    diff = torch.abs(dirs - ref_dir)
    diff = torch.where(diff > math.pi, 2 * math.pi - diff, diff)
    far = diff > math.pi / 2
    score_far = torch.where(far, s, 0.0).sum(2, keepdim=True)
    score_near = torch.where(~far, s, 0.0).sum(2, keepdim=True)
    flip_far = score_far <= score_near
    flipped = torch.where(far == flip_far, dirs + math.pi, dirs)

    w = s / torch.clamp(s.sum(2, keepdim=True), min=1e-9)
    center_dim = torch.matmul(w, boxes[..., :6])
    theta = torch.atan2((w * torch.sin(flipped)).sum(2),
                        (w * torch.cos(flipped)).sum(2))
    fused = torch.cat([center_dim, theta[..., None]], dim=-1)

    # the fused score: the members' scores in descending order, sum of
    # s_i ** (i + 1), capped at 1 (padding zeros add 0)
    s_sorted = torch.sort(s, dim=2, descending=True).values
    powers = torch.arange(1, k + 1, device=s.device, dtype=s.dtype)
    s_fused = torch.clamp((s_sorted ** powers).sum(2), max=1.0)

    mask = is_rep
    if gt_range is not None:
        xy = B.boxes_to_corners_3d(fused, "hwl")[..., :2]
        lo = torch.as_tensor(gt_range[0:2], dtype=fused.dtype,
                             device=fused.device)
        hi = torch.as_tensor(gt_range[3:5], dtype=fused.dtype,
                             device=fused.device)
        mask = mask & ((xy >= lo) & (xy <= hi)).all(-1).all(-1)
    return fused, s_fused, mask


def match_and_fuse(boxes, scores, valid, iou_threshold: float = 0.1,
                   max_keep: int = 64, version: str = "ref", gt_range=None):
    """Cluster and fuse the ego-frame boxes of all agents.

    boxes (B, K, 7) 'hwl', scores (B, K), valid (B, K) bool. Returns boxes
    (B, max_keep, 7), scores (B, max_keep) and mask (B, max_keep): the
    representatives in index order ('ref') or score order ('nms'), zero
    where the mask is False."""
    if version == "nms":
        return _match_and_fuse_nms(boxes, scores, valid, iou_threshold,
                                   max_keep)
    if version != "ref":
        raise ValueError(f"unknown matcher version {version!r}")
    iou = boxes_iou3d_matrix(boxes)
    cluster_of, is_rep = _greedy_clusters(iou, valid, iou_threshold)
    fused, s_fused, mask = _fuse_clusters(boxes, scores, cluster_of, is_rep,
                                          gt_range)
    # compact the representatives into max_keep slots in index order; the
    # rest go to one dump slot past the end, which is cut off (every kept
    # slot is written by exactly one box)
    b = boxes.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    slot = torch.where(mask & (rank < max_keep), rank, max_keep)

    def compact(x):
        tail = x.shape[2:]
        out = x.new_zeros((b, max_keep + 1) + tail)
        idx = slot.reshape((b, -1) + (1,) * len(tail)).expand_as(x)
        return out.scatter(1, idx, x)[:, :max_keep]

    return {"boxes": compact(torch.where(mask[..., None], fused, 0.0)),
            "scores": compact(torch.where(mask, s_fused, 0.0)),
            "mask": compact(mask)}


def _match_and_fuse_nms(boxes, scores, valid, iou_threshold: float,
                        max_keep: int):
    """The round-2 formulation: NMS representatives, IoU-weighted members,
    the largest member score."""
    corners = B.boxes_to_corners_3d(boxes, "hwl")[..., :4, :2]
    order, keep = nms_rotated(corners, scores, valid, iou_threshold,
                              max_keep=max_keep)
    top = order[:, :max_keep]
    reps = torch.gather(boxes, 1, top[..., None].expand(-1, -1, 7))
    rep_mask = keep[:, :max_keep]
    rep_corners = B.boxes_to_corners_3d(reps, "hwl")[..., :4, :2]
    iou = rotated_iou(rep_corners.float().contiguous(),
                      corners.float().contiguous()).to(boxes.dtype)
    member = (iou > iou_threshold) & valid[:, None, :] & rep_mask[..., None]
    w = torch.where(member, scores[:, None, :], 0.0)              # (B, R, K)
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
    fused = torch.matmul(w, boxes[..., :6]) / wsum
    sin = torch.matmul(w, torch.sin(boxes[..., 6:7])) / wsum
    cos = torch.matmul(w, torch.cos(boxes[..., 6:7])) / wsum
    fused = torch.cat([fused, torch.atan2(sin, cos)], dim=-1)
    fused = torch.where(rep_mask[..., None], fused, 0.0)
    return {"boxes": fused,
            "scores": torch.where(rep_mask, w.amax(-1), 0.0),
            "mask": rep_mask}
