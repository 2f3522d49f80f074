"""Dense BEV (PIXOR) label maps and decoding, batched on the device.

Port of coalign_tpu/postprocess/dense_bev.py (ref opencood/data_utils/
post_processor/bev_postprocessor.py, which builds the label maps with a
loop over the boxes and point-in-polygon tests on the host): whether each
output pixel lies in each padded gt box is one broadcast test, the pixel
centres rotated into the boxes' frames, so labels are assigned on the
device in the train step, as postprocess/anchors.assign_targets does for
the anchor models.

The label map (B, H, W, 7), NHWC as the JAX package's (the heads are
NCHW): channel 0 the occupancy target, channels 1:7 [cos yaw, sin yaw, dx,
dy, log w, log l] normalized by TARGET_MEAN / TARGET_STD, (dx, dy) the
offset in metres from the pixel centre to the box centre.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from coalign_tpu_torch.ops.bev_raster import BevSpec
from coalign_tpu_torch.utils.box_utils import boxes_to_corners_3d
from coalign_tpu_torch.utils.nms import nms_rotated

# ref bev_postprocessor.py:24-29
TARGET_MEAN = np.array([0.008, 0.001, 0.202, 0.2, 0.43, 1.368],
                       dtype=np.float32)
TARGET_STD = np.array([0.866, 0.5, 0.954, 0.668, 0.09, 0.111],
                      dtype=np.float32)


class DenseBevSpec(NamedTuple):
    """The anchor-free family's target spec: the raster's geometry, the
    regression's normalization and the fixed z centre and height that lift
    a decoded 2D box to 7 dof."""

    bev: BevSpec
    target_mean: np.ndarray = TARGET_MEAN
    target_std: np.ndarray = TARGET_STD
    box_z: float = -1.0
    box_h: float = 1.56

    def to(self, device) -> "DenseBevSpec":
        """The spec needs nothing on a device (an AnchorSpec's interface,
        for make_train_step)."""
        return self


def _consts(spec: DenseBevSpec, like: torch.Tensor):
    def t(a):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return t(spec.target_mean), t(spec.target_std)


def pixel_centers(spec: DenseBevSpec, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """(H, W, 2) metric (x, y) centres of the label grid's pixels."""
    b = spec.bev
    step = b.res * b.downsample_rate
    h, w, _ = b.label_shape
    xs = b.L1 + (torch.arange(h, device=device, dtype=dtype) + 0.5) * step
    ys = b.W1 + (torch.arange(w, device=device, dtype=dtype) + 0.5) * step
    return torch.stack(torch.meshgrid(xs, ys, indexing="ij"), dim=-1)


def assign_dense_targets(gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                         spec: DenseBevSpec) -> torch.Tensor:
    """Padded gt (B, M, 7) hwl, mask (B, M) -> (B, H, W, 7) normalized
    label maps. A pixel is positive when its centre lies in a valid box's
    footprint; where boxes overlap the first valid one wins (the
    reference's order)."""
    centers = pixel_centers(spec, gt_boxes.device, gt_boxes.dtype)
    x, y = gt_boxes[..., 0], gt_boxes[..., 1]               # (B, M)
    w_, l_ = gt_boxes[..., 4], gt_boxes[..., 5]
    yaw = gt_boxes[..., 6]
    c, s = torch.cos(yaw), torch.sin(yaw)

    def bm(a):                                              # (B, 1, 1, M)
        return a[:, None, None, :]

    dx = centers[None, ..., 0, None] - bm(x)                # (B, H, W, M)
    dy = centers[None, ..., 1, None] - bm(y)
    u = dx * bm(c) + dy * bm(s)
    v = -dx * bm(s) + dy * bm(c)
    inside = ((torch.abs(u) <= bm(l_) / 2) & (torch.abs(v) <= bm(w_) / 2)
              & bm(gt_mask) & bm(w_ > 0) & bm(l_ > 0))
    any_pos = inside.any(-1)                                # (B, H, W)
    first = inside.to(torch.uint8).argmax(-1)               # first True

    tgt = torch.stack([c, s, x, y, torch.log(torch.clamp(w_, min=1e-3)),
                       torch.log(torch.clamp(l_, min=1e-3))], dim=-1)
    bsz, h, w = first.shape
    reg = torch.gather(tgt, 1, first.reshape(bsz, -1, 1).expand(
        -1, -1, 6)).reshape(bsz, h, w, 6)
    reg = torch.cat([reg[..., :2], reg[..., 2:3] - centers[..., 0, None],
                     reg[..., 3:4] - centers[..., 1, None], reg[..., 4:]],
                    dim=-1)
    mean, std = _consts(spec, reg)
    reg = (reg - mean) / std * any_pos[..., None]
    return torch.cat([any_pos[..., None].to(reg.dtype), reg], dim=-1)


def decode_dense_map(cls_map: torch.Tensor, reg_map: torch.Tensor,
                     spec: DenseBevSpec, score_threshold: float = 0.25,
                     nms_threshold: float = 0.15, max_keep: int = 100,
                     pre_top_k: int = 512) -> dict:
    """(B, 1, H, W) and (B, 6, H, W) maps -> fixed-size detections of each
    frame, in its own frame (ref bev_postprocessor.py:221-300;
    coalign_tpu/postprocess/dense_bev.py:90-127): sigmoid, threshold, the
    top ``pre_top_k`` scores (a stable sort, ties to the lower index as
    lax.top_k), each pixel's box decoded and lifted to hwl with the spec's
    z and height, one rotated NMS over the batch, then the first
    ``max_keep`` survivors among the first ``max_keep`` ranks, as the JAX
    package's nms_rotated(max_keep=) and its slice make it.

    Returns boxes (B, m, 7) hwl, scores (B, m) and valid (B, m), ranked by
    score, m = min(max_keep, pre_top_k, H*W)."""
    b = cls_map.shape[0]
    scores = torch.sigmoid(cls_map[:, 0]).reshape(b, -1)
    mean, std = _consts(spec, reg_map)
    reg = reg_map.permute(0, 2, 3, 1) * std + mean          # (B, H, W, 6)
    centers = pixel_centers(spec, reg.device, reg.dtype)
    yaw = torch.atan2(reg[..., 1], reg[..., 0])
    bx = reg[..., 2] + centers[..., 0]
    by = reg[..., 3] + centers[..., 1]
    boxes = torch.stack(
        [bx, by, torch.full_like(bx, spec.box_z),
         torch.full_like(bx, spec.box_h), torch.exp(reg[..., 4]),
         torch.exp(reg[..., 5]), yaw], dim=-1).reshape(b, -1, 7)

    k = min(pre_top_k, scores.shape[1])
    masked = torch.where(scores >= score_threshold, scores, -1.0)
    top_sc, top_idx = torch.sort(masked, dim=-1, descending=True,
                                 stable=True)
    top_sc, top_idx = top_sc[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 7))
    corners = boxes_to_corners_3d(top_boxes, "hwl")
    order, keep = nms_rotated(corners[..., :4, :2], top_sc, top_sc > 0,
                              nms_threshold)
    keep = keep & (torch.cumsum(keep.to(torch.int64), -1) <= max_keep)
    m = min(max_keep, k)
    order = order[:, :m]
    return {"boxes": torch.gather(top_boxes, 1,
                                  order[..., None].expand(-1, -1, 7)),
            "scores": torch.gather(top_sc, 1, order),
            "valid": keep[:, :m]}
