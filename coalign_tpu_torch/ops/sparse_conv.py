"""Sparse 3D convolution on sorted-key voxel tables (the SECOND path at the
yamls' 0.1 m grids).

Port of coalign_tpu/ops/sparse_conv.py (ref sparse_backbone_3d.py:33,
spconv's SubMConv3d / SparseConv3d). A frame's active voxels are a table of
fixed height M: keys (flat cell ids (iz * ny + iy) * nx + ix, sorted
ascending; unused rows hold the sentinel nz * ny * nx, which sorts after
every real key), an (M, C) feature table and a valid mask. The caps are the
JAX package's, so both packages truncate the same voxels:

  * a voxel table holds at most ``max_voxels`` rows; beyond it the largest
    keys are dropped (sparse_mean_voxelize; the reference drops by point
    order, ref sp_voxel_preprocessor.py:22);
  * a strided conv's output table is as high as its input's, again
    dropping the largest keys (downsample_active).

A conv looks up, for every output site and each of the kernel's taps, the
row of the neighbouring input site (a rulebook: ``torch.searchsorted`` of
the tap-shifted keys in each frame's sorted row, -1 where no such site
is active), gathers those rows and multiplies them by the kernel as one
matrix product. The rulebook depends only on the active sets, so the
convs of a stage share one.

Every grid carries a leading frame axis: (F, M) keys / valid and
(F, M, C) features, so a batch of agent frames needs no loop (one frame
is F = 1). Rulebooks are (idx, found), each (F, Mout, K), K = kz * ky * kx
taps in the kernel's (dz, dy, dx) row-major order; idx indexes each
frame's own table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coalign_tpu_torch.ops.voxels import VoxelSpec, voxel_ids
from coalign_tpu_torch.runtime import lowp_call


class SparseGrid(NamedTuple):
    """Fixed-height sparse occupancy of F frames of an (nz, ny, nx) voxel
    grid: keys (F, M) int64 sorted, feats (F, M, C) (zero in unused rows),
    valid (F, M) bool and the static shape (nz, ny, nx)."""

    keys: torch.Tensor
    feats: torch.Tensor
    valid: torch.Tensor
    shape: tuple

    @property
    def sentinel(self) -> int:
        nz, ny, nx = self.shape
        return nz * ny * nx


def _coords(keys: torch.Tensor, shape: tuple):
    nz, ny, nx = shape
    return keys // (ny * nx), (keys // nx) % ny, keys % nx


def _flat(iz, iy, ix, shape: tuple):
    nz, ny, nx = shape
    return (iz * ny + iy) * nx + ix


def _table_from_sorted(sorted_keys: torch.Tensor, sentinel: int, cap: int):
    """Rank each row's distinct keys: sorted_keys (F, Q) ascending, the
    sentinel marking nothing. Returns (rank (F, Q): the dense rank of each
    entry's key, or ``cap`` where it is the sentinel's run or beyond the
    cap; keys (F, cap) of the first ``cap`` distinct keys, the sentinel
    after them)."""
    f, q = sorted_keys.shape
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[:, 1:] = sorted_keys[:, 1:] != sorted_keys[:, :-1]
    rank = torch.cumsum(first.to(torch.int64), dim=1) - 1
    kept = (rank < cap) & (sorted_keys < sentinel)
    seg = torch.where(kept, rank, cap)
    keys = torch.full((f, cap + 1), sentinel, dtype=torch.int64,
                      device=sorted_keys.device)
    keys.scatter_reduce_(1, seg, torch.where(kept, sorted_keys, sentinel),
                         "amin", include_self=True)
    return seg, keys[:, :cap]


def sparse_mean_voxelize(points: torch.Tensor, mask: torch.Tensor,
                         spec: VoxelSpec, max_voxels: int,
                         pad_z: int = 0) -> SparseGrid:
    """Points (F, N, 4) -> SparseGrid of each voxel's mean point
    (MeanVFE, ref mean_vfe.py:4), ``max_voxels`` rows a frame: the voxels
    beyond the cap are dropped in key order (count them with
    occupancy_overflow).

    ``pad_z`` declares the grid ``pad_z`` empty z slices taller (spconv's
    [1, 0, 0] pad, ref sparse_backbone_3d.py:39): the keys are z-major, so
    only the sentinel moves."""
    f, n, c = points.shape
    ids, valid = voxel_ids(points, mask, spec)
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    pts = points * valid[..., None].to(points.dtype)
    pts_s = torch.gather(pts, 1, order[..., None].expand(-1, -1, c))
    seg, keys = _table_from_sorted(ids_s, spec.num_voxels, max_voxels)
    m = max_voxels
    rows = (torch.arange(f, device=points.device)[:, None] * (m + 1)
            + seg).reshape(-1)
    sums = pts_s.new_zeros((f * (m + 1), c)).index_add_(
        0, rows, pts_s.reshape(f * n, c))
    cnts = pts_s.new_zeros(f * (m + 1)).index_add_(
        0, rows, torch.ones_like(rows, dtype=points.dtype))
    feats = (sums / torch.clamp(cnts, min=1.0)[:, None]).reshape(
        f, m + 1, c)[:, :m]
    vmask = keys < spec.num_voxels
    feats = feats * vmask[..., None].to(feats.dtype)
    shape = (spec.nz + pad_z, spec.ny, spec.nx)
    keys = torch.where(vmask, keys, shape[0] * shape[1] * shape[2])
    return SparseGrid(keys, feats, vmask, shape)


def occupancy_overflow(points: torch.Tensor, mask: torch.Tensor,
                       spec: VoxelSpec, max_voxels: int) -> torch.Tensor:
    """The distinct occupied voxels of each frame beyond ``max_voxels``,
    which sparse_mean_voxelize drops ((F,) int64; 0 when none): a nonzero
    count means the high-key (high z, then high y) end of the scene is
    gone."""
    ids, valid = voxel_ids(points, mask, spec)
    ids_s, _ = torch.sort(torch.where(valid, ids, spec.num_voxels), dim=1)
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    occupied = (first & (ids_s < spec.num_voxels)).sum(dim=1)
    return torch.clamp(occupied - max_voxels, min=0)


def lookup(keys: torch.Tensor, queries: torch.Tensor):
    """The row of each query key in its frame's sorted table: keys (F, M),
    queries (F, Q) -> (idx (F, Q), -1 where the key is absent; found
    (F, Q) bool). Unused rows hold the sentinel and a query never equals
    it (out-of-grid queries are sentinel + 1), so a match is a valid
    row."""
    m = keys.shape[1]
    idx = torch.clamp(torch.searchsorted(keys.contiguous(),
                                         queries.contiguous()), max=m - 1)
    found = torch.gather(keys, 1, idx) == queries
    return torch.where(found, idx, -1), found


def _offset_grid(kernel: tuple, device) -> tuple:
    """(dz, dy, dx) of every tap of ``kernel``, centred (pad = k // 2),
    in row-major tap order."""
    dz, dy, dx = torch.meshgrid(
        *(torch.arange(k, device=device) - k // 2 for k in kernel),
        indexing="ij")
    return dz.reshape(-1), dy.reshape(-1), dx.reshape(-1)


def make_rulebook(grid: SparseGrid, out_valid: torch.Tensor,
                  in_coord_of_out: tuple, kernel: tuple):
    """(idx, found), each (F, Mout, K): the row of ``grid``'s table under
    every tap of every output site, and whether that neighbour is active.
    ``in_coord_of_out`` is (iz, iy, ix) of each output site's receptive
    field centre in input coordinates, each (F, Mout); ``out_valid``
    (F, Mout)."""
    nz, ny, nx = grid.shape
    dz, dy, dx = _offset_grid(kernel, grid.keys.device)
    cz, cy, cx = (c[..., None] for c in in_coord_of_out)   # (F, Mout, 1)
    qz, qy, qx = cz + dz, cy + dy, cx + dx                 # (F, Mout, K)
    inb = ((qz >= 0) & (qz < nz) & (qy >= 0) & (qy < ny) & (qx >= 0)
           & (qx < nx) & out_valid[..., None])
    q = torch.where(inb, _flat(qz, qy, qx, grid.shape), grid.sentinel + 1)
    f, mo, k = q.shape
    idx, found = lookup(grid.keys, q.reshape(f, mo * k))
    return idx.reshape(f, mo, k), found.reshape(f, mo, k)


def subm_rulebook(grid: SparseGrid, kernel: tuple = (3, 3, 3)):
    """Rulebook of a submanifold conv: outputs at the input's active
    sites."""
    return make_rulebook(grid, grid.valid, _coords(grid.keys, grid.shape),
                         kernel)


class _TapGather(torch.autograd.Function):
    """rows = table[gidx], the table's last row zero, read by every missing
    tap. The backward adds each found tap's gradient into its row and
    leaves the missing taps out: autograd's own backward of the gather
    would accumulate them all into the zero row, millions of duplicates of
    one index, which CUDA's sorted accumulation walks one by one (a
    full-width B=4 train step of second_intermediate took 53 s on an
    H100)."""

    @staticmethod
    def forward(ctx, table, gidx, found):
        ctx.save_for_backward(gidx, found)
        ctx.rows = table.shape[0]
        return table[gidx]

    @staticmethod
    def backward(ctx, grad):
        gidx, found = ctx.saved_tensors
        # a missing tap adds 0 into a row of its own choosing: spread over
        # the table, no row gets more than a few of them
        spread = torch.arange(gidx.numel(), device=gidx.device) % (
            ctx.rows - 1)
        safe = torch.where(found, gidx, spread)
        out = grad.new_zeros((ctx.rows, grad.shape[-1]))
        out.index_put_((safe,), grad * found[:, None].to(grad.dtype),
                       accumulate=True)
        return out, None, None


def gather_neighbors(grid: SparseGrid, rulebook) -> torch.Tensor:
    """(F, Mout, K, C) neighbour features under a rulebook: one row gather
    of the frames' flattened tables, a missing tap reading an appended zero
    row."""
    idx, found = rulebook
    f, m, c = grid.feats.shape
    flat = torch.cat([grid.feats.reshape(f * m, c),
                      grid.feats.new_zeros((1, c))])
    base = torch.arange(f, device=idx.device)[:, None, None] * m
    gidx = torch.where(found, idx + base, f * m).reshape(-1)
    rows = _TapGather.apply(flat, gidx, found.reshape(-1))
    return rows.reshape(idx.shape + (c,))


def _apply_conv(grid: SparseGrid, weight: torch.Tensor, rulebook,
                out_valid: torch.Tensor) -> torch.Tensor:
    """The conv's output features (F, Mout, Cout): the gathered taps
    (F * Mout, K * Cin) times the kernel (K * Cin, Cout) in one product,
    zero at unused output rows. ``weight`` is (kz, ky, kx, Cin, Cout)."""
    taps = gather_neighbors(grid, rulebook)
    f, mo, k, c = taps.shape
    # in the table's dtype (bfloat16 under the compute-dtype policy, a
    # float32 accumulator)
    out = lowp_call(torch.matmul, taps.reshape(f * mo, k * c),
                    weight.reshape(k * c, -1).to(taps.dtype))
    return out.reshape(f, mo, -1) * out_valid[..., None].to(out.dtype)


def subm_conv(grid: SparseGrid, weight: torch.Tensor,
              rulebook=None) -> SparseGrid:
    """Submanifold sparse conv (SubMConv3d): outputs at the input's active
    sites, a missing neighbour contributing 0. ``weight`` (kz, ky, kx, Cin,
    Cout), spconv 1.x's layout; ``rulebook`` a subm_rulebook of ``grid``'s
    active set, made here when None."""
    if rulebook is None:
        rulebook = subm_rulebook(grid, tuple(weight.shape[:3]))
    return grid._replace(feats=_apply_conv(grid, weight, rulebook,
                                           grid.valid))


def downsample_active(grid: SparseGrid, kernel: tuple = (3, 3, 3),
                      stride: tuple = (2, 2, 2), pad: tuple = (1, 1, 1),
                      max_out: int | None = None) -> SparseGrid:
    """The active set of a strided sparse conv's output (SparseConv3d's
    index semantics, the dense twin's occupancy max-pool): output j is
    active iff an active input i has j * s - p <= i <= j * s - p + k - 1.
    Each input votes for its <= ceil(k / s)^3 outputs, whose union is
    sorted and deduplicated into ``max_out`` rows (the input's height when
    None), the largest keys dropped beyond it. Features are zero."""
    f, m = grid.keys.shape
    max_out = max_out or m
    oshape = tuple((d + 2 * p - k) // s + 1 for d, k, s, p in
                   zip(grid.shape, kernel, stride, pad))
    iz, iy, ix = _coords(grid.keys, grid.shape)

    def cand_1d(i, k, s, p, size):
        # the outputs covering input i: ceil((i + p - k + 1) / s) ..
        # floor((i + p) / s)
        lo = -((-(i + p - k + 1)) // s)
        hi = (i + p) // s
        j = lo[..., None] + torch.arange(-(-k // s), device=i.device)
        return j, (j <= hi[..., None]) & (j >= 0) & (j < size)

    jz, okz = cand_1d(iz, kernel[0], stride[0], pad[0], oshape[0])
    jy, oky = cand_1d(iy, kernel[1], stride[1], pad[1], oshape[1])
    jx, okx = cand_1d(ix, kernel[2], stride[2], pad[2], oshape[2])
    sentinel = oshape[0] * oshape[1] * oshape[2]
    ok = (okz[..., :, None, None] & oky[..., None, :, None]
          & okx[..., None, None, :] & grid.valid[..., None, None, None])
    cand = torch.where(ok, _flat(jz[..., :, None, None],
                                 jy[..., None, :, None],
                                 jx[..., None, None, :], oshape), sentinel)
    cand, _ = torch.sort(cand.reshape(f, -1), dim=1)
    _, keys = _table_from_sorted(cand, sentinel, max_out)
    return SparseGrid(keys, grid.feats.new_zeros((f, max_out,
                                                  grid.feats.shape[-1])),
                      keys < sentinel, oshape)


def strided_rulebook(grid: SparseGrid, out_grid: SparseGrid, kernel: tuple,
                     stride: tuple = (2, 2, 2), pad: tuple = (1, 1, 1)):
    """Rulebook of a strided conv: output j reads inputs j * s - p +
    (0 .. k - 1), i.e. the centre j * s - p + k // 2 and centred taps."""
    centre = tuple(o * s - p + k // 2 for o, s, p, k in
                   zip(_coords(out_grid.keys, out_grid.shape), stride, pad,
                       kernel))
    return make_rulebook(grid, out_grid.valid, centre, kernel)


def strided_conv(grid: SparseGrid, weight: torch.Tensor,
                 out_grid: SparseGrid, stride: tuple = (2, 2, 2),
                 pad: tuple = (1, 1, 1), rulebook=None) -> SparseGrid:
    """Strided sparse conv (SparseConv3d) from ``grid`` onto the active set
    ``out_grid`` (downsample_active's). ``weight`` (kz, ky, kx, Cin,
    Cout)."""
    if rulebook is None:
        rulebook = strided_rulebook(grid, out_grid, tuple(weight.shape[:3]),
                                    stride, pad)
    return out_grid._replace(feats=_apply_conv(grid, weight, rulebook,
                                               out_grid.valid))


def to_dense(grid: SparseGrid) -> torch.Tensor:
    """SparseGrid -> dense (F, nz, ny, nx, C), zero at inactive sites."""
    f, m, c = grid.feats.shape
    cells = grid.sentinel
    base = torch.arange(f, device=grid.keys.device)[:, None] * cells
    # unused rows hold zero features: adding them into the spare last row
    # leaves every cell exact
    tgt = torch.where(grid.valid, grid.keys + base, f * cells).reshape(-1)
    canvas = grid.feats.new_zeros((f * cells + 1, c)).index_add_(
        0, tgt, grid.feats.reshape(f * m, c))
    return canvas[:-1].reshape((f,) + grid.shape + (c,))


def from_dense(x: torch.Tensor, max_voxels: int) -> SparseGrid:
    """Dense (F, nz, ny, nx, C) -> SparseGrid of ``max_voxels`` rows a frame
    (occupied = any nonzero channel), for tests and interop."""
    f, nz, ny, nx, c = x.shape
    n = nz * ny * nx
    occ = x.abs().sum(-1).reshape(f, n) > 0
    keys = torch.where(occ, torch.arange(n, device=x.device), n)
    keys, order = torch.sort(keys, dim=1, stable=True)
    keys, order = keys[:, :max_voxels], order[:, :max_voxels]
    vmask = keys < n
    feats = torch.gather(x.reshape(f, n, c), 1,
                         order[..., None].expand(-1, -1, c))
    return SparseGrid(keys, feats * vmask[..., None].to(x.dtype), vmask,
                      (nz, ny, nx))
