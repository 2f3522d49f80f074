"""3D voxelization as segment reductions (the SECOND / VoxelNet path).

Port of coalign_tpu/ops/voxels.py (ref sp_voxel_preprocessor.py:22,
mean_vfe.py:4, voxel_net.py SVFE): points are bucketed by flat voxel id
(iz * ny * nx + iy * nx + ix) and reduced on the device with ``index_add_``
(sums, counts) and ``scatter_reduce_`` (``amax``), as the pillar canvas is
(ops/pillars.py). There is no voxel table and no per-voxel point cap.

Frames are flattened into one id space where an op takes a batch: frame
f's voxel v is row ``f * (num_voxels + 1) + v`` (offset_ids), and each
frame's invalid points go to its own sentinel row ``num_voxels``. Dense
grids are channel-last (..., nz, ny, nx, C), as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VoxelSpec(NamedTuple):
    """Static 3D voxel-grid geometry: lidar_range (x_min, y_min, z_min,
    x_max, y_max, z_max), voxel_size (vx, vy, vz) and the grid size nx
    (x columns), ny (y rows), nz (z slabs)."""

    lidar_range: tuple
    voxel_size: tuple
    nx: int
    ny: int
    nz: int

    @classmethod
    def from_config(cls, lidar_range, voxel_size):
        nx = int(round((lidar_range[3] - lidar_range[0]) / voxel_size[0]))
        ny = int(round((lidar_range[4] - lidar_range[1]) / voxel_size[1]))
        nz = int(round((lidar_range[5] - lidar_range[2]) / voxel_size[2]))
        return cls(tuple(lidar_range), tuple(voxel_size), nx, ny, nz)

    @property
    def num_voxels(self) -> int:
        return self.nx * self.ny * self.nz


def cell_index(coord: torch.Tensor, lo: float, size: float) -> torch.Tensor:
    """floor((coord - lo) / size) as int64, the division IEEE's on every
    device, as the JAX package's and the CPU's: divided by a Python scalar,
    CUDA multiplies by its reciprocal instead, which puts about one
    coordinate in 1e4 in the neighbouring cell, and every point of a plane
    on a cell boundary (a flat ground at z = -1.9 m on a 0.1 m grid from
    -3 m: the card's voxel tables then differed from the CPU's)."""
    return torch.floor((coord - lo) / coord.new_full((), size)).to(
        torch.int64)


def voxel_ids(points: torch.Tensor, mask: torch.Tensor, spec: VoxelSpec):
    """Flat voxel id per point; an invalid point gets ``num_voxels``.

    points (..., N, 4), mask (..., N) bool -> (ids int64, valid bool)."""
    r, v = spec.lidar_range, spec.voxel_size
    ix, iy, iz = (cell_index(points[..., a], r[a], v[a]) for a in range(3))
    valid = (mask
             & (ix >= 0) & (ix < spec.nx)
             & (iy >= 0) & (iy < spec.ny)
             & (iz >= 0) & (iz < spec.nz))
    ids = torch.where(valid, (iz * spec.ny + iy) * spec.nx + ix,
                      spec.num_voxels)
    return ids, valid


def offset_ids(ids: torch.Tensor, num_voxels: int):
    """Per-frame ids (F, N) -> (flat ids over F * (num_voxels + 1) rows,
    the row count), so one reduction serves a batch of frames."""
    f = ids.shape[0]
    frame = torch.arange(f, device=ids.device)[:, None]
    return ids + frame * (num_voxels + 1), f * (num_voxels + 1)


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, rows: int):
    """values (K, C) or (K,) summed into ``rows`` rows by ids (K,)."""
    out = values.new_zeros((rows,) + values.shape[1:])
    return out.index_add_(0, ids, values)


def _segment_max(values: torch.Tensor, ids: torch.Tensor, rows: int):
    """Row-wise max of values (K, C) by ids (K,); an empty row holds the
    dtype's lowest value, as jax.ops.segment_max's."""
    out = values.new_full((rows, values.shape[1]),
                          torch.finfo(values.dtype).min)
    return out.scatter_reduce_(0, ids[:, None].expand_as(values), values,
                               "amax", include_self=True)


def mean_voxelize(points: torch.Tensor, mask: torch.Tensor, spec: VoxelSpec):
    """Points (F, N, 4) -> the dense (F, nz, ny, nx, 4) grid of each voxel's
    mean point and its occupancy (F, nz, ny, nx) bool (spconv's
    voxelization + MeanVFE without the per-voxel point cap, which only
    subsamples dense voxels)."""
    f, n, c = points.shape
    ids, valid = voxel_ids(points, mask, spec)
    flat, rows = offset_ids(ids, spec.num_voxels)
    ones = valid.to(points.dtype)
    sums = _segment_sum((points * ones[..., None]).reshape(f * n, c),
                        flat.reshape(-1), rows)
    cnt = _segment_sum(ones.reshape(-1), flat.reshape(-1), rows)
    mean = (sums / torch.clamp(cnt, min=1.0)[:, None]).reshape(
        f, spec.num_voxels + 1, c)[:, :-1]
    occ = (cnt.reshape(f, spec.num_voxels + 1)[:, :-1] > 0)
    grid = (mean * occ[..., None].to(mean.dtype)).reshape(
        f, spec.nz, spec.ny, spec.nx, c)
    return grid, occ.reshape(f, spec.nz, spec.ny, spec.nx)


def voxel_max_broadcast_batched(point_feats: torch.Tensor, ids: torch.Tensor,
                                valid: torch.Tensor, num_voxels: int):
    """Per-voxel max of (F, N, C) point features, gathered back to each
    point (VoxelNet's VFE: concat(pointwise, voxel max)); invalid points
    get 0."""
    f, n, c = point_feats.shape
    flat, rows = offset_ids(ids, num_voxels)
    lowest = torch.finfo(point_feats.dtype).min
    masked = torch.where(valid[..., None], point_feats, lowest)
    vmax = _segment_max(masked.reshape(f * n, c), flat.reshape(-1), rows)
    out = vmax[flat.reshape(-1)].reshape(f, n, c)
    return torch.where(valid[..., None], out, 0.0)


def voxel_max_broadcast(point_feats: torch.Tensor, ids: torch.Tensor,
                        valid: torch.Tensor, num_voxels: int):
    """One frame's :func:`voxel_max_broadcast_batched`: (N, C) features."""
    return voxel_max_broadcast_batched(point_feats[None], ids[None],
                                       valid[None], num_voxels)[0]


def voxel_mean_batched(xyz: torch.Tensor, ids: torch.Tensor,
                       valid: torch.Tensor, num_voxels: int):
    """Per-voxel centroid of (F, N, 3) coordinates, gathered back to each
    point (an invalid point reads its frame's sentinel row)."""
    f, n, c = xyz.shape
    flat, rows = offset_ids(ids, num_voxels)
    ones = valid.to(xyz.dtype)
    s = _segment_sum((xyz * ones[..., None]).reshape(f * n, c),
                     flat.reshape(-1), rows)
    cnt = _segment_sum(ones.reshape(-1), flat.reshape(-1), rows)
    mean = s / torch.clamp(cnt, min=1.0)[:, None]
    return mean[flat.reshape(-1)].reshape(f, n, c)


def scatter_max_voxels_batched(point_feats: torch.Tensor, ids: torch.Tensor,
                               valid: torch.Tensor, spec: VoxelSpec):
    """Max-reduce (F, N, C) point features into the dense
    (F, nz, ny, nx, C) grid; empty voxels are 0."""
    f, n, c = point_feats.shape
    flat, rows = offset_ids(ids, spec.num_voxels)
    lowest = torch.finfo(point_feats.dtype).min
    feats = torch.where(valid[..., None], point_feats, lowest)
    vmax = _segment_max(feats.reshape(f * n, c), flat.reshape(-1), rows)
    occ = _segment_sum(valid.to(torch.int32).reshape(-1), flat.reshape(-1),
                       rows) > 0
    grid = torch.where(occ[:, None], vmax, 0.0).reshape(
        f, spec.num_voxels + 1, c)[:, :-1]
    return grid.reshape(f, spec.nz, spec.ny, spec.nx, c)


def scatter_max_voxels(point_feats: torch.Tensor, ids: torch.Tensor,
                       valid: torch.Tensor, spec: VoxelSpec):
    """One frame's :func:`scatter_max_voxels_batched`: (N, C) features ->
    (nz, ny, nx, C)."""
    return scatter_max_voxels_batched(point_feats[None], ids[None],
                                      valid[None], spec)[0]
