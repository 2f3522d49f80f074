"""Anchor grid generation and anchor-target assignment.

Port of coalign_tpu/postprocess/anchors.py (ref voxel_postprocessor.py:30
generate_anchor_box, :83 generate_label). The grid and its standup boxes
are host numpy, made once; :func:`assign_targets` labels a whole batch on
the device from the padded gt boxes, with tensor ops over (B, K, M) where
the JAX package vmaps one sample's assignment.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from coalign_tpu_torch.utils.box_utils import (boxes_to_corners_3d,
                                               corners_to_standup_2d)
from coalign_tpu_torch.utils.iou import standup_iou


class AnchorSpec(NamedTuple):
    anchors: np.ndarray          # (H, W, A, 7) boxes in ``order``
    standup: np.ndarray          # (H*W*A, 4) standup boxes of the anchors
    diag: np.ndarray             # (H*W*A,) anchor BEV diagonal
    order: str
    pos_threshold: float
    neg_threshold: float
    num_anchors: int

    def to(self, device) -> "AnchorSpec":
        """The spec with its arrays as float32 tensors on ``device``."""
        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)
        return self._replace(anchors=t(self.anchors),
                             standup=t(self.standup), diag=t(self.diag))


def generate_anchor_box(anchor_args: dict, order: str = "hwl") -> np.ndarray:
    """(H/s, W/s, A, 7) float32 anchor grid.

    anchor_args needs W, H (full-resolution grid), l, w, h, r (degree list),
    cav_lidar_range, vw, vh and optionally feature_stride (default 2).
    """
    W, H = anchor_args["W"], anchor_args["H"]
    l, w, h = anchor_args["l"], anchor_args["w"], anchor_args["h"]
    r = [math.radians(x) for x in anchor_args["r"]]
    num = len(r)
    vw, vh = anchor_args["vw"], anchor_args["vh"]
    rng = anchor_args["cav_lidar_range"]
    stride = anchor_args.get("feature_stride", 2)

    x = np.linspace(rng[0] + vw, rng[3] - vw, W // stride)
    y = np.linspace(rng[1] + vh, rng[4] - vh, H // stride)
    cx, cy = np.meshgrid(x, y)
    cx = np.tile(cx[..., None], num)
    cy = np.tile(cy[..., None], num)
    cz = np.full_like(cx, -1.0)
    ws = np.full_like(cx, w)
    ls = np.full_like(cx, l)
    hs = np.full_like(cx, h)
    rs = np.stack([np.full_like(cx[..., 0], ri) for ri in r], axis=-1)
    if order == "hwl":
        anchors = np.stack([cx, cy, cz, hs, ws, ls, rs], axis=-1)
    elif order == "lhw":
        anchors = np.stack([cx, cy, cz, ls, hs, ws, rs], axis=-1)
    else:
        raise ValueError(f"unknown order {order}")
    return anchors.astype(np.float32)


def make_anchor_spec(anchor_args: dict, target_args: dict,
                     order: str = "hwl") -> AnchorSpec:
    """Every static anchor array, computed once on the host."""
    anchors = generate_anchor_box(anchor_args, order)
    flat = anchors.reshape(-1, 7)
    corners = boxes_to_corners_3d(flat, order)
    standup = corners_to_standup_2d(corners[:, :4, :])
    diag = np.sqrt(flat[:, 4] ** 2 + flat[:, 5] ** 2)
    return AnchorSpec(
        anchors=anchors,
        standup=standup.astype(np.float32),
        diag=diag.astype(np.float32),
        order=order,
        pos_threshold=float(target_args["pos_threshold"]),
        neg_threshold=float(target_args["neg_threshold"]),
        num_anchors=anchors.shape[2],
    )


def assign_targets(gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                   spec: AnchorSpec) -> dict:
    """Anchor-target assignment of a batch, on the device of ``gt_boxes``.

    gt_boxes (B, M, 7) padded center-form gt in ``spec.order``, gt_mask
    (B, M) bool. Returns pos_equal_one (B, H, W, A), neg_equal_one
    (B, H, W, A) and targets (B, H, W, A*7), float32 (computed in the gt
    boxes' dtype, as the JAX package computes them): the label contract of
    ref voxel_postprocessor.py:201-205, NHWC as in the JAX package.

    As in the JAX package: IoU is standup IoU with the +1 size convention;
    positives are anchors above ``pos_threshold`` plus each valid gt's
    best anchor (a forced match, when that IoU is above 0); negatives are
    below ``neg_threshold`` everywhere and not forced; an anchor above the
    threshold takes its best-IoU gt (the first of equals, as argmax), and a
    forced anchor below it the gt that forced it, the largest gt index
    where several force the same anchor (the JAX package's
    ``.at[best_anchor].max``, here ``scatter_reduce("amax")``).
    """
    spec = spec.to(gt_boxes.device)
    h, w, a = spec.anchors.shape[:3]
    b, m = gt_mask.shape
    k = h * w * a

    gt_corners = boxes_to_corners_3d(gt_boxes, spec.order)
    gt_standup = corners_to_standup_2d(gt_corners[..., :4, :])
    iou = standup_iou(spec.standup, gt_standup, offset=1.0)   # (B, K, M)
    iou = torch.where(gt_mask[:, None, :], iou, 0.0)

    # forced matches: the best anchor of each valid gt with some overlap
    best_anchor = torch.argmax(iou, dim=1)                     # (B, M)
    best_iou = torch.gather(iou, 1, best_anchor[:, None, :])[:, 0]
    force = gt_mask & (best_iou > 0)
    forced = torch.zeros((b, k), dtype=torch.int32, device=iou.device)
    forced.scatter_reduce_(1, best_anchor, force.to(torch.int32), "amax")
    forced = forced > 0
    gt_index = torch.arange(m, device=iou.device).expand(b, m)
    forced_gt = torch.zeros((b, k), dtype=torch.int64, device=iou.device)
    forced_gt.scatter_reduce_(1, best_anchor,
                              torch.where(force, gt_index, 0), "amax")

    anchor_best_gt = torch.argmax(iou, dim=2)                  # (B, K)
    anchor_best_iou = torch.amax(iou, dim=2)
    pos_by_thresh = anchor_best_iou > spec.pos_threshold
    assigned = torch.where(pos_by_thresh, anchor_best_gt,
                           torch.where(forced, forced_gt, anchor_best_gt))
    pos = pos_by_thresh | forced
    neg = (anchor_best_iou < spec.neg_threshold) & ~forced

    anc = spec.anchors.reshape(k, 7)
    g = torch.gather(gt_boxes, 1, assigned[..., None].expand(b, k, 7))
    eps = 1e-6
    t = torch.stack([
        (g[..., 0] - anc[:, 0]) / spec.diag,
        (g[..., 1] - anc[:, 1]) / spec.diag,
        (g[..., 2] - anc[:, 2]) / anc[:, 3],
        torch.log(torch.clamp(g[..., 3], min=eps) / anc[:, 3]),
        torch.log(torch.clamp(g[..., 4], min=eps) / anc[:, 4]),
        torch.log(torch.clamp(g[..., 5], min=eps) / anc[:, 5]),
        g[..., 6] - anc[:, 6],
    ], dim=-1)
    t = torch.where(pos[..., None], t, 0.0)
    return {"pos_equal_one": pos.reshape(b, h, w, a).float(),
            "neg_equal_one": neg.reshape(b, h, w, a).float(),
            "targets": t.reshape(b, h, w, a * 7).float()}
