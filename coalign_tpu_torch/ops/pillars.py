"""Point -> pillar decoration and the dense-BEV scatter-max.

Port of coalign_tpu/ops/pillars.py (ref sp_voxel_preprocessor.py:22,
pillar_vfe.py:56, point_pillar_scatter.py:5). As in the JAX package, the raw
padded point list of each frame is reduced by flat pillar id, with no pillar
table and no per-pillar point cap. The JAX package sorts points by pillar id
so its segment reductions skip their internal sort; here ``index_add_`` and
``scatter_reduce_`` reduce unsorted ids directly, so there is no sort.

Frames are flattened into one global id space: frame f's pillar p is row
``f * ny * nx + p``, and every invalid point goes to one sentinel row at the
end. The BEV grid is y-major: row = y index, col = x index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coalign_tpu_torch.ops.voxels import cell_index


class PillarSpec(NamedTuple):
    """Static voxel-grid geometry from the yaml config."""

    lidar_range: tuple
    voxel_size: tuple
    nx: int
    ny: int

    @classmethod
    def from_config(cls, lidar_range, voxel_size):
        nx = int(round((lidar_range[3] - lidar_range[0]) / voxel_size[0]))
        ny = int(round((lidar_range[4] - lidar_range[1]) / voxel_size[1]))
        return cls(tuple(lidar_range), tuple(voxel_size), nx, ny)


def pillar_ids(points: torch.Tensor, mask: torch.Tensor, spec: PillarSpec):
    """Flat pillar id per point; invalid points get ``ny * nx``.

    points (..., N, 4), mask (..., N) bool -> (ids int64, valid bool).
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r = spec.lidar_range
    ix = cell_index(x, r[0], spec.voxel_size[0])
    iy = cell_index(y, r[1], spec.voxel_size[1])
    valid = (mask
             & (x >= r[0]) & (x < r[3]) & (y >= r[1]) & (y < r[4])
             & (z >= r[2]) & (z <= r[5])
             & (ix >= 0) & (ix < spec.nx) & (iy >= 0) & (iy < spec.ny))
    ids = torch.where(valid, iy * spec.nx + ix, spec.ny * spec.nx)
    return ids, valid


def global_ids(ids: torch.Tensor, valid: torch.Tensor,
               spec: PillarSpec) -> torch.Tensor:
    """(F, N) per-frame ids -> (F * N,) rows of the (F * ny * nx + 1)-row
    global table; invalid points go to the last (sentinel) row."""
    f = ids.shape[0]
    cells = spec.ny * spec.nx
    base = torch.arange(f, device=ids.device)[:, None] * cells
    return torch.where(valid, ids + base, f * cells).reshape(-1)


def decorate_points(points: torch.Tensor, ids: torch.Tensor,
                    valid: torch.Tensor, spec: PillarSpec) -> torch.Tensor:
    """Per-point 10-channel decoration (ref pillar_vfe.py:118-143):
    [x, y, z, i, xyz - pillar mean, xyz - pillar center], zero for invalid
    points. points (F, N, 4), ids/valid (F, N) -> (F, N, 10).

    The pillar mean is summed over pillar-centered coordinates (|value| <=
    voxel size), as the JAX package does, which keeps float32 sums of many
    points precise."""
    f, n = ids.shape
    ones = valid.to(points.dtype)
    ix = (ids % spec.nx).to(points.dtype)
    iy = torch.clamp(ids // spec.nx, max=spec.ny - 1).to(points.dtype)
    r, v = spec.lidar_range, spec.voxel_size
    cx = ix * v[0] + (v[0] / 2 + r[0])
    cy = iy * v[1] + (v[1] / 2 + r[1])
    cz = torch.full_like(cx, v[2] / 2 + r[2])
    f_center = points[..., :3] - torch.stack([cx, cy, cz], dim=-1)

    rel1 = torch.cat([f_center, torch.ones_like(points[..., :1])],
                     dim=-1) * ones[..., None]
    gid = global_ids(ids, valid, spec)
    seg = torch.zeros((f * spec.ny * spec.nx + 1, 4), dtype=points.dtype,
                      device=points.device)
    seg.index_add_(0, gid, rel1.reshape(f * n, 4))
    per_point = seg[gid].reshape(f, n, 4)
    mean_rel = per_point[..., :3] / torch.clamp(per_point[..., 3:], min=1.0)
    f_cluster = f_center - mean_rel
    feats = torch.cat([points, f_cluster, f_center], dim=-1)
    return feats * ones[..., None]


class _ScatterMax(torch.autograd.Function):
    """Max of the rows of ``feats`` into ``rows`` canvas rows by ``gid``,
    over a zero canvas, with the JAX package's backward
    (scatter_max_bev_cvjp, coalign_tpu/ops/pillars.py:337-401): every valid
    point whose feature equals its row's maximum takes the row's whole
    cotangent. torch's own amax backward splits a tie among the tying
    elements and the canvas's zero, which the JAX package does not."""

    @staticmethod
    def forward(ctx, feats, gid, valid, rows):
        canvas = torch.zeros((rows, feats.shape[1]), dtype=feats.dtype,
                             device=feats.device)
        canvas.scatter_reduce_(0, gid[:, None].expand(-1, feats.shape[1]),
                               feats, reduce="amax", include_self=True)
        ctx.save_for_backward(feats, gid, valid, canvas)
        return canvas

    @staticmethod
    def backward(ctx, grad):
        feats, gid, valid, canvas = ctx.saved_tensors
        win = valid[:, None] & (feats == canvas[gid])
        return torch.where(win, grad[gid], 0.0), None, None, None


def scatter_max_bev(point_feats: torch.Tensor, ids: torch.Tensor,
                    valid: torch.Tensor, spec: PillarSpec) -> torch.Tensor:
    """Max-reduce per-point features into the dense BEV canvas.

    point_feats (F, N, C) post-ReLU (non-negative), ids/valid (F, N) ->
    (F, ny * nx, C); empty pillars are 0, the reference's zero canvas. The
    canvas starts at 0 and takes the max with it, which for non-negative
    features is the JAX package's -inf -> 0 clamp. Its gradient goes whole
    to every valid point that attains its pillar's maximum (_ScatterMax)."""
    f, n, c = point_feats.shape
    gid = global_ids(ids, valid, spec)
    canvas = _ScatterMax.apply(point_feats.reshape(f * n, c), gid,
                               valid.reshape(-1), f * spec.ny * spec.nx + 1)
    return canvas[:-1].reshape(f, spec.ny * spec.nx, c)


def pillar_count_bev(ids: torch.Tensor, valid: torch.Tensor,
                     spec: PillarSpec) -> torch.Tensor:
    """(F, ny * nx) point counts per pillar."""
    f = ids.shape[0]
    gid = global_ids(ids, valid, spec)
    cnt = torch.zeros(f * spec.ny * spec.nx + 1, dtype=torch.int64,
                      device=ids.device)
    cnt.index_add_(0, gid, torch.ones_like(gid))
    return cnt[:-1].reshape(f, spec.ny * spec.nx)
