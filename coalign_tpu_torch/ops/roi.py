"""RoI features on BEV maps, points in rotated boxes and farthest-point
sampling.

Port of coalign_tpu/ops/roi.py (ref roiaware_pool3d, roi_head.py:13,
vsa.py:45) and of the zero-padded point sampler it reads maps with
(coalign_tpu/ops/warp.py:44 ``_bilinear_gather``): the port's ops/warp.py
samples whole maps through ``F.grid_sample``, which has no sampler at
arbitrary points. Every op takes a leading frame axis; maps are NCHW.

bev_grid_coords divides by a Python scalar before the bilinear floor, as
the JAX package does. On CUDA such a division is a multiply by the
reciprocal, which moves a floor across an integer now and then (ROADMAP
§3 faults 9, 10 and 12); bilinear sampling is continuous across cells, so
here it changes the sample by rounding only.
"""

from __future__ import annotations

import torch


def bev_grid_coords(xy, lidar_range, voxel_size, feature_stride):
    """Metric (..., 2) -> fractional (col, row) pixel coordinates on a BEV
    map whose rows are y and columns x."""
    fx = (xy[..., 0] - lidar_range[0]) / (voxel_size[0] * feature_stride)
    fy = (xy[..., 1] - lidar_range[1]) / (voxel_size[1] * feature_stride)
    return fx - 0.5, fy - 0.5


def bilinear_gather(src, fx, fy):
    """Zero-padded bilinear samples of src (F, C, H, W) at the fractional
    pixel coordinates fx, fy (F, ...) -> (F, ..., C), with the JAX
    package's operation order (ops/warp.py:44-95)."""
    f, c, h, w = src.shape
    shape = fx.shape
    fx, fy = fx.reshape(f, -1), fy.reshape(f, -1)
    flat = src.permute(0, 2, 3, 1).reshape(f, h * w, c)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    x0, y0 = x0.long(), y0.long()
    dt = src.dtype

    def tap(yi, xi):
        """(F, P, C) = src[yi, xi], zero where yi is off the map."""
        iny = (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * iny[..., None].to(dt)

    m0 = ((x0 >= 0) & (x0 < w))[..., None].to(dt)
    m1 = ((x0 + 1 >= 0) & (x0 + 1 < w))[..., None].to(dt)
    wx0 = (1 - tx)[..., None].to(dt) * m0
    wx1 = tx[..., None].to(dt) * m1
    ty_ = ty[..., None].to(dt)
    top = tap(y0, x0) * wx0 + tap(y0, x0 + 1) * wx1
    bot = tap(y0 + 1, x0) * wx0 + tap(y0 + 1, x0 + 1) * wx1
    return (top * (1 - ty_) + bot * ty_).reshape(shape + (c,))


def sample_bev_features(feat, xy, lidar_range, voxel_size, feature_stride):
    """Bilinear samples of (F, C, H, W) BEV maps at metric (F, ..., 2)
    points -> (F, ..., C)."""
    fx, fy = bev_grid_coords(xy, lidar_range, voxel_size, feature_stride)
    return bilinear_gather(feat, fx, fy)


def roi_grid_points(boxes, grid_size: int = 6):
    """A fixed rotated grid inside each box's footprint: (..., R, 7) 'hwl'
    boxes -> (..., R, grid_size ** 2, 2) metric xy."""
    g = grid_size
    u = (torch.arange(g, device=boxes.device, dtype=boxes.dtype) + 0.5) / g \
        - 0.5
    gx, gy = torch.meshgrid(u, u, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)      # (G, 2)
    l, w_, yaw = boxes[..., 5], boxes[..., 4], boxes[..., 6]
    local = grid * torch.stack([l, w_], -1)[..., None, :]
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    rx = local[..., 0] * c - local[..., 1] * s
    ry = local[..., 0] * s + local[..., 1] * c
    return torch.stack([rx + boxes[..., None, 0], ry + boxes[..., None, 1]],
                       -1)


def roi_grid_pool(feat, boxes, lidar_range, voxel_size, feature_stride,
                  grid_size: int = 6):
    """(F, C, H, W) BEV maps and (F, R, 7) boxes -> (F, R, grid_size ** 2,
    C) pooled features."""
    return sample_bev_features(feat, roi_grid_points(boxes, grid_size),
                               lidar_range, voxel_size, feature_stride)


def points_in_rotated_boxes(points, boxes):
    """(..., N, 3) points and (..., R, 7) 'hwl' boxes -> (..., R, N) bool
    membership (roiaware_pool3d's test as affine maps and bounds)."""
    dx = points[..., None, :, 0] - boxes[..., :, None, 0]
    dy = points[..., None, :, 1] - boxes[..., :, None, 1]
    dz = points[..., None, :, 2] - boxes[..., :, None, 2]
    c = torch.cos(boxes[..., 6])[..., None]
    s = torch.sin(boxes[..., 6])[..., None]
    u = dx * c + dy * s
    v = -dx * s + dy * c
    return ((torch.abs(u) <= boxes[..., None, 5] / 2)
            & (torch.abs(v) <= boxes[..., None, 4] / 2)
            & (torch.abs(dz) <= boxes[..., None, 3] / 2))


def farthest_point_sample(points, mask, k: int):
    """Iterative farthest-point sampling: (F, N, 3) points, (F, N) mask ->
    (F, k) int64 indices. The first is the first valid point; each next
    one the valid point farthest from those taken (ties to the lowest
    index, as argmax gives them). k - 1 serial steps of a few launches
    each, with no host sync; masked points start at -1e9 and, every
    distance being >= 0, stay there (the JAX package's where(mask, ., -big)
    each step changes nothing). The squared distance is summed x, y, then
    z, each op rounded on its own, so that the CPU and CUDA give the same
    bits, and the same argmax."""
    big = 1e9
    dist = torch.where(mask, big, -big).to(points.dtype)
    last = torch.argmax(mask.to(torch.uint8), dim=1)
    taken = [last]
    for _ in range(k - 1):
        p = torch.gather(points, 1, last[:, None, None].expand(-1, 1, 3))
        sq = (points - p) ** 2
        dist = torch.minimum(dist, sq[..., 0] + sq[..., 1] + sq[..., 2])
        last = torch.argmax(dist, dim=1)
        taken.append(last)
    return torch.stack(taken, dim=1)
