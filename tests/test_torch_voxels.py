"""The port's voxel ops (coalign_tpu_torch/ops/voxels.py, sparse_conv.py)
against the JAX package's on the CPU, on the same numpy-seeded inputs at
the tiny grids of tests/test_sparse_conv.py and tests/test_second_family.py.

Tolerances: ids, keys, valid masks, rulebooks, active sets and overflow
counts exact; features within 1e-5 (absolute and relative: float32 sums
in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coalign_tpu.ops import sparse_conv as JS
from coalign_tpu.ops import voxels as JV
from coalign_tpu_torch.ops import sparse_conv as S
from coalign_tpu_torch.ops import voxels as V

FEAT_TOL = dict(rtol=1e-5, atol=1e-5)

# tests/test_second_family.py's grid: nz=8, ny=80, nx=80
LR = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
VOXEL = [0.4, 0.4, 0.5]
# tests/test_sparse_conv.py's small grid: nz=8, ny=6, nx=8
SMALL_LR = (0.0, 0.0, -2.0, 4.0, 3.0, 2.0)
SMALL_VOXEL = (0.5, 0.5, 0.5)


def _points(frames: int, n: int, lr, seed: int, cluster: float = 0.0):
    """(F, N, 4) points over a range a little wider than ``lr`` (some fall
    outside), a tenth of them masked; ``cluster`` > 0 packs the first half
    of each frame into a ``cluster``-metre cube, so voxels hold several
    points."""
    rng = np.random.default_rng(seed)
    lo = np.array(lr[:3]) - 0.5
    hi = np.array(lr[3:]) + 0.5
    pts = np.empty((frames, n, 4), np.float32)
    pts[..., :3] = rng.uniform(lo, hi, (frames, n, 3))
    pts[..., 3] = rng.uniform(0, 1, (frames, n))
    if cluster:
        pts[:, : n // 2, :3] = (np.array(lr[:3]) + 1.0
                                + rng.uniform(0, cluster, (frames, n // 2, 3)))
    mask = rng.random((frames, n)) > 0.1
    return pts, mask


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _specs(lr, voxel):
    return (JV.VoxelSpec.from_config(lr, voxel),
            V.VoxelSpec.from_config(lr, voxel))


def test_voxel_ids_and_offsets_match_jax():
    jspec, spec = _specs(LR, VOXEL)
    assert tuple(spec) == tuple(jspec)
    pts, mask = _points(3, 400, LR, seed=1)
    jids, jvalid = JV.voxel_ids(jnp.asarray(pts), jnp.asarray(mask), jspec)
    ids, valid = V.voxel_ids(_t(pts), _t(mask), spec)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    jflat, jrows = JV.offset_ids(jids, jspec.num_voxels)
    flat, rows = V.offset_ids(ids, spec.num_voxels)
    assert rows == jrows
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))


@pytest.mark.parametrize("frames", [1, 2])
def test_mean_voxelize_matches_jax(frames):
    """The port voxelizes a batch of frames at once, the JAX package one
    frame at a time."""
    jspec, spec = _specs(LR, VOXEL)
    pts, mask = _points(frames, 600, LR, seed=2, cluster=2.0)
    got, occ = V.mean_voxelize(_t(pts), _t(mask), spec)
    for f in range(frames):
        want, wocc = JV.mean_voxelize(jnp.asarray(pts[f]),
                                      jnp.asarray(mask[f]), jspec)
        np.testing.assert_array_equal(occ[f].numpy(), np.asarray(wocc))
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want),
                                   **FEAT_TOL)


def test_point_voxel_reductions_match_jax():
    """voxel_max_broadcast(_batched), voxel_mean_batched and
    scatter_max_voxels(_batched) on (F, N, C) features."""
    jspec, spec = _specs(LR, VOXEL)
    pts, mask = _points(3, 500, LR, seed=3, cluster=1.5)
    feats = np.random.default_rng(4).normal(size=(3, 500, 6)).astype(
        np.float32)
    jids, jvalid = JV.voxel_ids(jnp.asarray(pts), jnp.asarray(mask), jspec)
    ids, valid = V.voxel_ids(_t(pts), _t(mask), spec)
    nv = spec.num_voxels
    pairs = [
        (JV.voxel_max_broadcast_batched(jnp.asarray(feats), jids, jvalid, nv),
         V.voxel_max_broadcast_batched(_t(feats), ids, valid, nv)),
        (JV.voxel_max_broadcast(jnp.asarray(feats[1]), jids[1], jvalid[1],
                                nv),
         V.voxel_max_broadcast(_t(feats[1]), ids[1], valid[1], nv)),
        (JV.voxel_mean_batched(jnp.asarray(pts[..., :3]), jids, jvalid, nv),
         V.voxel_mean_batched(_t(pts[..., :3]), ids, valid, nv)),
        (JV.scatter_max_voxels_batched(jnp.asarray(feats), jids, jvalid,
                                       jspec),
         V.scatter_max_voxels_batched(_t(feats), ids, valid, spec)),
        (JV.scatter_max_voxels(jnp.asarray(feats[2]), jids[2], jvalid[2],
                               jspec),
         V.scatter_max_voxels(_t(feats[2]), ids[2], valid[2], spec)),
    ]
    for want, got in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FEAT_TOL)


def _grid_pair(cap: int, seed: int, pad_z: int = 0, frames: int = 3,
               n: int = 300):
    """A batched SparseGrid of the small grid from both packages, the last
    frame dense enough to overflow ``cap`` when it is small."""
    jspec, spec = _specs(SMALL_LR, SMALL_VOXEL)
    pts, mask = _points(frames, n, SMALL_LR, seed=seed)
    jg = JS.sparse_mean_voxelize(jnp.asarray(pts), jnp.asarray(mask), jspec,
                                 max_voxels=cap, pad_z=pad_z)
    g = S.sparse_mean_voxelize(_t(pts), _t(mask), spec, max_voxels=cap,
                               pad_z=pad_z)
    return jg, g, (pts, mask)


def _same_grid(g, jg, feats=True):
    assert g.shape == tuple(jg.shape)
    np.testing.assert_array_equal(g.keys.numpy(), np.asarray(jg.keys))
    np.testing.assert_array_equal(g.valid.numpy(), np.asarray(jg.valid))
    if feats:
        np.testing.assert_allclose(g.feats.numpy(), np.asarray(jg.feats),
                                   **FEAT_TOL)


@pytest.mark.parametrize("cap,pad_z", [(256, 0), (256, 1), (60, 1)])
def test_sparse_mean_voxelize_and_overflow_match_jax(cap, pad_z):
    """Keys, valid rows and mean features; at cap 60 every frame overflows
    (~200 occupied voxels) and both packages drop the same largest keys."""
    jg, g, (pts, mask) = _grid_pair(cap, seed=5, pad_z=pad_z)
    _same_grid(g, jg)
    jspec, spec = _specs(SMALL_LR, SMALL_VOXEL)
    want = np.asarray(JS.occupancy_overflow(jnp.asarray(pts),
                                            jnp.asarray(mask), jspec, cap))
    got = S.occupancy_overflow(_t(pts), _t(mask), spec, cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > 0).all() == (cap == 60)
    # one frame on its own (F = 1) gives that frame of the batch
    single = S.sparse_mean_voxelize(_t(pts[1:2]), _t(mask[1:2]), spec,
                                    max_voxels=cap, pad_z=pad_z)
    np.testing.assert_array_equal(single.keys[0].numpy(), g.keys[1].numpy())
    assert int(S.occupancy_overflow(_t(pts[1:2]), _t(mask[1:2]), spec,
                                    cap)[0]) == int(want[1])


def test_lookup_matches_jax():
    jg, g, _ = _grid_pair(256, seed=6)
    rng = np.random.default_rng(7)
    q = rng.integers(0, g.sentinel + 2, (3, 500))
    q[:, :50] = g.keys[:, :50].numpy()                  # present keys
    jidx, jfound = JS._lookup(jg.keys, jnp.asarray(q, jnp.int32))
    idx, found = S.lookup(g.keys, _t(q))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    assert found[:, :50].all()


def _rulebook_pair(jrb, rb, batched=True):
    """JAX (K, [F,] Mout) against the port's (F, Mout, K); the JAX
    package's single-frame form against the port's frame 0."""
    for j, p in zip(jrb, rb):
        p = p.numpy() if batched else p[0].numpy()
        np.testing.assert_array_equal(np.moveaxis(p, -1, 0), np.asarray(j))


def _same_grid_as(g, jg, batched):
    if not batched:
        g = S.SparseGrid(g.keys[:1], g.feats[:1], g.valid[:1], g.shape)
        jg = JS.SparseGrid(jg.keys[None], jg.feats[None], jg.valid[None],
                           jg.shape)
    _same_grid(g, jg)


@pytest.mark.parametrize("batched", [True, False])
def test_rulebooks_and_convs_match_jax(batched):
    """subm and strided rulebooks (exact), the neighbour gather, the subm
    and strided convs and the z-squash conv (1e-5): the JAX package's
    batched ops against the port's, and its single-frame ops against the
    port's on that one frame (F = 1)."""
    jg, g, _ = _grid_pair(256, seed=8, pad_z=1)
    if not batched:
        jg = JS.SparseGrid(jg.keys[0], jg.feats[0], jg.valid[0], jg.shape)
        g = S.SparseGrid(g.keys[:1], g.feats[:1], g.valid[:1], g.shape)
    rng = np.random.default_rng(9)

    def kernel(*shape):   # lecun-scaled: features stay O(1)
        fan_in = np.prod(shape[:4])
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    w1, w2, w3 = kernel(3, 3, 3, 4, 6), kernel(3, 3, 3, 6, 5), \
        kernel(3, 1, 1, 5, 7)

    jrb, rb = JS.subm_rulebook(jg), S.subm_rulebook(g)
    _rulebook_pair(jrb, rb, batched)
    taps = S.gather_neighbors(g, rb).numpy()
    np.testing.assert_allclose(
        np.moveaxis(taps if batched else taps[0], -2, 0),
        np.asarray(JS.gather_neighbors(jg, jrb)), **FEAT_TOL)
    jx = JS.subm_conv(jg, jnp.asarray(w1), rulebook=jrb)
    x = S.subm_conv(g, _t(w1), rulebook=rb)
    _same_grid_as(x, jx, batched)

    js2, s2 = JS.downsample_active(jx), S.downsample_active(x)
    _same_grid_as(s2, js2, batched)
    _rulebook_pair(JS.strided_rulebook(jx, js2, (3, 3, 3)),
                   S.strided_rulebook(x, s2, (3, 3, 3)), batched)
    jy = JS.strided_conv(jx, jnp.asarray(w2), js2)
    y = S.strided_conv(x, _t(w2), s2)
    _same_grid_as(y, jy, batched)

    kw = dict(kernel=(3, 1, 1), stride=(2, 1, 1), pad=(0, 0, 0))
    js3 = JS.downsample_active(jy, **kw)
    s3 = S.downsample_active(y, **kw)
    _same_grid_as(s3, js3, batched)
    jz = JS.strided_conv(jy, jnp.asarray(w3), js3, stride=(2, 1, 1),
                         pad=(0, 0, 0))
    z = S.strided_conv(y, _t(w3), s3, stride=(2, 1, 1), pad=(0, 0, 0))
    _same_grid_as(z, jz, batched)
    dense = S.to_dense(z).numpy()
    np.testing.assert_allclose(dense if batched else dense[0],
                               np.asarray(JS.to_dense(jz)), **FEAT_TOL)


def test_downsample_active_overflow_matches_jax():
    """A strided output set larger than max_out keeps the smallest keys in
    both packages."""
    jg, g, _ = _grid_pair(256, seed=10)
    full = S.downsample_active(g)
    need = int(full.valid.sum(1).max())
    cap = need // 2
    _same_grid(S.downsample_active(g, max_out=cap),
               JS.downsample_active(jg, max_out=cap))
    small = S.downsample_active(g, max_out=cap)
    assert bool((small.valid.sum(1) == cap).all())
    np.testing.assert_array_equal(small.keys.numpy(),
                                  full.keys[:, :cap].numpy())


def test_dense_roundtrip_matches_jax():
    rng = np.random.default_rng(11)
    occ = rng.random((6, 10, 12)) < 0.08
    x = (rng.normal(size=(6, 10, 12, 5)) * occ[..., None]).astype(np.float32)
    jg = JS.from_dense(jnp.asarray(x), max_voxels=256)
    g = S.from_dense(_t(x[None]), max_voxels=256)
    _same_grid_as(g, jg, batched=False)
    np.testing.assert_array_equal(S.to_dense(g).numpy()[0], x)
    # to_dense of a batch
    jb, b, _ = _grid_pair(256, seed=12)
    np.testing.assert_allclose(S.to_dense(b).numpy(),
                               np.asarray(JS.to_dense(jb)), **FEAT_TOL)
