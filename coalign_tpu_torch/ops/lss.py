"""Lift-Splat-Shoot geometry and pooling: camera frustum points to BEV.

Port of coalign_tpu/ops/lss.py (ref opencood/models/lift_splat_shoot.py:
65-171, opencood/utils/camera_utils.py:137-244). The frustum is a numpy
constant; the geometry is one batched chain of 3x3 products in the
cameras' float dtype (float32 in serving, never the compute dtype: the JAX
package pins it with Precision.HIGHEST, and the port keeps TF32 off); the
splat, the JAX package's segment_sum, is ``index_add_`` into the cells of
every agent frame plus one row that takes the points outside the grid and
is dropped. The cells come from ops/voxels.cell_index, which divides by a
tensor: CUDA divides by a Python scalar as a multiply by its reciprocal,
which moves points on a cell boundary into the neighbouring cell (ROADMAP
fault 12, a repeat of fault 9).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from coalign_tpu_torch.ops.voxels import cell_index


def depth_discretization(dmin, dmax, nbins, mode="LID") -> np.ndarray:
    """Depth bin centers (ref camera_utils.py:187): uniform (UD) or
    linear-increasing (LID) bins."""
    if mode == "UD":
        size = (dmax - dmin) / nbins
        return dmin + size * np.arange(nbins)
    if mode == "LID":
        size = 2 * (dmax - dmin) / (nbins * (1 + nbins))
        return dmin + size * (np.arange(nbins) * np.arange(1, 1 + nbins)) / 2
    raise NotImplementedError(mode)


def bin_depths(depth_map: torch.Tensor, mode: str, dmin, dmax,
               nbins: int) -> torch.Tensor:
    """Metric depth -> bin index (int64), ``nbins`` where it falls outside
    the bins or is not finite (ref camera_utils.py:137-170). The divisors
    are tensors, as in cell_index."""
    def div(x, d):
        return x / x.new_full((), d)

    if mode == "UD":
        idx = div(depth_map - dmin, (dmax - dmin) / nbins)
    elif mode == "LID":
        size = 2 * (dmax - dmin) / (nbins * (1 + nbins))
        idx = -0.5 + 0.5 * torch.sqrt(1 + div(8 * (depth_map - dmin), size))
    elif mode == "SID":
        idx = div(nbins * (torch.log(1 + depth_map) - math.log(1 + dmin)),
                  math.log(1 + dmax) - math.log(1 + dmin))
    else:
        raise NotImplementedError(mode)
    idx = torch.floor(idx)
    bad = (idx < 0) | (idx >= nbins) | ~torch.isfinite(idx)
    return torch.where(bad, nbins, idx).to(torch.int64)


class LSSSpec(NamedTuple):
    """The static LSS geometry of a yaml's ``grid_conf`` and
    ``data_aug_conf``."""

    xbound: tuple   # (min, max, step)
    ybound: tuple
    zbound: tuple
    ddiscr: tuple   # (dmin, dmax, nbins)
    mode: str
    final_dim: tuple  # (H, W) of the network's input images
    downsample: int   # the image features' stride

    @classmethod
    def from_config(cls, grid_conf: dict, data_aug_conf: dict,
                    downsample: int = 8):
        return cls(tuple(grid_conf["xbound"]), tuple(grid_conf["ybound"]),
                   tuple(grid_conf["zbound"]), tuple(grid_conf["ddiscr"]),
                   grid_conf.get("mode", "LID"),
                   tuple(data_aug_conf["final_dim"]), downsample)

    @property
    def nx(self):
        return int(round((self.xbound[1] - self.xbound[0]) / self.xbound[2]))

    @property
    def ny(self):
        return int(round((self.ybound[1] - self.ybound[0]) / self.ybound[2]))

    @property
    def nz(self):
        return int(round((self.zbound[1] - self.zbound[0]) / self.zbound[2]))

    @property
    def depth_bins(self):
        return int(self.ddiscr[2])

    @property
    def feat_hw(self):
        return (self.final_dim[0] // self.downsample,
                self.final_dim[1] // self.downsample)

    def frustum(self) -> np.ndarray:
        """(D, fH, fW, 3) float32 (u, v, depth) grid in the input image's
        pixel coordinates (ref create_frustum lift_splat_shoot.py:65)."""
        ogh, ogw = self.final_dim
        fh, fw = self.feat_hw
        ds = depth_discretization(*self.ddiscr, self.mode)
        d = np.broadcast_to(ds[:, None, None], (len(ds), fh, fw))
        xs = np.broadcast_to(np.linspace(0, ogw - 1, fw)[None, None, :],
                             d.shape)
        ys = np.broadcast_to(np.linspace(0, ogh - 1, fh)[None, :, None],
                             d.shape)
        return np.stack([xs, ys, d], axis=-1).astype(np.float32)


def get_geometry(frustum: torch.Tensor, rots, trans, intrins, post_rots,
                 post_trans) -> torch.Tensor:
    """Frustum pixels -> points in the agent's (lidar) frame.

    frustum (D, fH, fW, 3); rots, intrins, post_rots (..., 3, 3); trans,
    post_trans (..., 3) for any leading cameras dims. Returns (..., D, fH,
    fW, 3) in the cameras' dtype (ref get_geometry lift_splat_shoot.py:80):
    undo the image augmentation, scale (u, v) by the depth, then camera ->
    lidar."""
    lead = rots.shape[:-2]
    pts = frustum - post_trans[..., None, None, None, :]
    inv_post = torch.linalg.inv(post_rots)
    pts = torch.einsum("...ij,...dhwj->...dhwi", inv_post, pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = rots @ torch.linalg.inv(intrins)
    pts = torch.einsum("...ij,...dhwj->...dhwi", combine, pts)
    return pts + trans.reshape(lead + (1, 1, 1, 3))


def splat_cells(geom: torch.Tensor, spec: LSSSpec) -> torch.Tensor:
    """(F, ...) points -> flat cell ids over the F frames' grids, frame-
    major: ((f * nz + iz) * ny + iy) * nx + ix, and F * n_cells for a point
    outside the grid. The cells are cell_index's."""
    ix = cell_index(geom[..., 0], spec.xbound[0], spec.xbound[2])
    iy = cell_index(geom[..., 1], spec.ybound[0], spec.ybound[2])
    iz = cell_index(geom[..., 2], spec.zbound[0], spec.zbound[2])
    valid = ((ix >= 0) & (ix < spec.nx) & (iy >= 0) & (iy < spec.ny)
             & (iz >= 0) & (iz < spec.nz))
    f = geom.shape[0]
    n_cells = spec.nz * spec.ny * spec.nx
    frame = torch.arange(f, device=geom.device).reshape(
        (f,) + (1,) * (geom.dim() - 2))
    ids = ((frame * spec.nz + iz) * spec.ny + iy) * spec.nx + ix
    return torch.where(valid, ids, f * n_cells)


def voxel_pool(geom: torch.Tensor, feats: torch.Tensor,
               spec: LSSSpec) -> torch.Tensor:
    """Splat the depth-weighted features onto the BEV grid.

    geom (F, N, D, fH, fW, 3) lidar-frame points of F agent frames;
    feats (F, N, D, fH, fW, C). Returns (F, nz*C, ny, nx): rows y, columns
    x (the pillar canvas's convention; ref voxel_pooling
    lift_splat_shoot.py:116), z collapsed into the channels as the JAX
    package collapses it (coalign_tpu/ops/lss.py:150-154), channel z*C + c.
    """
    f, c = feats.shape[0], feats.shape[-1]
    n_cells = spec.nz * spec.ny * spec.nx
    ids = splat_cells(geom, spec).reshape(-1)
    # in the features' dtype: bfloat16 ones (the compute-dtype policy) are
    # summed in bfloat16, as the JAX package's segment_sum sums them
    if feats.dtype == torch.bfloat16 and feats.device.type == "cpu":
        pooled = _ordered_bf16_sum(ids, feats.reshape(-1, c), f * n_cells)
    else:
        pooled = feats.new_zeros((f * n_cells + 1, c)).index_add_(
            0, ids, feats.reshape(-1, c))[:-1]
    pooled = pooled.reshape(f, spec.nz, spec.ny, spec.nx, c)
    return pooled.permute(0, 1, 4, 2, 3).reshape(f, spec.nz * c, spec.ny,
                                                 spec.nx)


def _ordered_bf16_sum(ids: torch.Tensor, rows: torch.Tensor,
                      n_cells: int) -> torch.Tensor:
    """(n_cells, C) bfloat16 sums of ``rows`` by ``ids`` (ids >= n_cells
    dropped), each cell's sum rounded to bfloat16 after every add, the rows
    taken in their order: XLA's bfloat16 scatter-add on the CPU, which the
    CPU's index_add_ does not reproduce. The k-th row of every cell is added
    in step k. (On CUDA the adds are atomics in any order.)"""
    keep = ids < n_cells
    ids, rows = ids[keep], rows[keep]
    order = torch.sort(ids, stable=True).indices
    ids, rows = ids[order], rows[order]
    pos = torch.arange(len(ids), device=ids.device)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    out = rows.new_zeros((n_cells, rows.shape[1]))
    for k in range(int(rank.max()) + 1 if len(ids) else 0):
        m = rank == k
        out[ids[m]] = out[ids[m]] + rows[m]
    return out
