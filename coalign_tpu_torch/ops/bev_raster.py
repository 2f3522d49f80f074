"""BEV occupancy raster on the device (PIXOR's input).

Port of coalign_tpu/ops/bev_raster.py (ref opencood/data_utils/
pre_processor/bev_preprocessor.py:16-107, which loops over the points on
the host): the occupancy of each (x, y, z) cell and the mean intensity of
each (x, y) column, as a scatter max and two index sums over flat cell
ids. The reference's geometry: rows are the x axis (L1..L2), columns the
y axis (W1..W2), and the z slabs (H1..H2) the channels, then the
intensity. The JAX package's raster is NHWC (nx, ny, nz + 1) a frame;
the port's is NCHW (F, nz + 1, nx, ny).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coalign_tpu_torch.ops.voxels import cell_index


class BevSpec(NamedTuple):
    """The static PIXOR grid (the reference's ``geometry_param``)."""

    L1: float
    L2: float
    W1: float
    W2: float
    H1: float
    H2: float
    res: float
    downsample_rate: int = 4

    @classmethod
    def from_config(cls, g: dict):
        return cls(g["L1"], g["L2"], g["W1"], g["W2"], g["H1"], g["H2"],
                   g["res"], g.get("downsample_rate", 4))

    @property
    def nx(self) -> int:                 # rows (x axis)
        return int(round((self.L2 - self.L1) / self.res))

    @property
    def ny(self) -> int:                 # columns (y axis)
        return int(round((self.W2 - self.W1) / self.res))

    @property
    def nz(self) -> int:
        return int(round((self.H2 - self.H1) / self.res))

    @property
    def input_shape(self) -> tuple:
        """(nx, ny, nz + 1), the JAX package's (H, W, C) order."""
        return (self.nx, self.ny, self.nz + 1)

    @property
    def label_shape(self) -> tuple:
        return (self.nx // self.downsample_rate,
                self.ny // self.downsample_rate, 7)


def rasterize_bev(points: torch.Tensor, mask: torch.Tensor,
                  spec: BevSpec) -> torch.Tensor:
    """points (F, N, 4), mask (F, N) bool -> (F, nz + 1, nx, ny): channel z
    is 1 where a valid point falls in slab z of the cell, else 0; the last
    channel is the mean intensity of the cell's column (0 where empty).

    The cells come from ops/voxels.cell_index (IEEE division on every
    device); the occupancy is a ``scatter_reduce('amax')`` into zeros, so an
    empty cell is 0 as the JAX package's max(segment_max, 0) makes it; the
    intensity sums and counts are ``index_add_``."""
    f, n, _ = points.shape
    nx, ny, nz = spec.nx, spec.ny, spec.nz
    x, y, z, inten = points.unbind(-1)
    ix = cell_index(x, spec.L1, spec.res)
    iy = cell_index(y, spec.W1, spec.res)
    iz = cell_index(z, spec.H1, spec.res)
    valid = (mask & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
             & (iz >= 0) & (iz < nz))
    plane = nx * ny
    frame = torch.arange(f, device=points.device)[:, None] * (
        (nz + 1) * plane)
    col = ix * ny + iy
    # an invalid point goes to one dump slot past the frames' cells
    dump = f * (nz + 1) * plane
    vals = valid.to(points.dtype)
    occ_ids = torch.where(valid, frame + iz * plane + col, dump).reshape(-1)
    out = points.new_zeros(dump + 1)
    out.scatter_reduce_(0, occ_ids, vals.reshape(-1), "amax",
                        include_self=True)

    col_ids = torch.where(valid, torch.arange(f, device=points.device)[:, None]
                          * plane + col, f * plane).reshape(-1)
    ssum = points.new_zeros(f * plane + 1).index_add_(
        0, col_ids, (inten * vals).reshape(-1))
    cnt = points.new_zeros(f * plane + 1).index_add_(0, col_ids,
                                                     vals.reshape(-1))
    mean_i = (ssum / torch.clamp(cnt, min=1.0))[:-1].reshape(f, 1, nx, ny)
    occ = out[:-1].reshape(f, nz + 1, nx, ny)[:, :nz]
    return torch.cat([occ, mean_i], dim=1)
