"""The port's point ops of the two-stage models (coalign_tpu_torch/ops/
pointnet2.py, ops/roi.py) against the JAX package's, on the CPU, at the
sizes of tests/test_pointnet2.py and tests/test_fpvrcnn.py:

  * the ball query: the index sets of each query equal the JAX package's
    except where a support's squared distance lies within rounding of the
    radius squared (the matmul identity rounds differently in the two
    packages); such boundary flips are counted and must be few, and every
    other index is the JAX one in the JAX order (nearest first, ties by
    lower index), also on supports with many exact ties;
  * group_points and SAModuleMSG within 1e-5, SAModuleMSG in eval and in
    train mode, where its norms' running statistics after one forward are
    the JAX package's batch_stats within 1e-5;
  * farthest-point sampling: equal indices;
  * points_in_rotated_boxes: equal; roi_grid_points and roi_grid_pool on an
    80 x 80 map within 1e-5, samples off the map zero in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coalign_tpu.ops import pointnet2 as JP
from coalign_tpu.ops import roi as JR
from coalign_tpu_torch.ops import pointnet2 as P
from coalign_tpu_torch.ops import roi as R
from coalign_tpu_torch.utils.weights import _flatten

torch.set_num_threads(2)
LIDAR_RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
VOXEL = [0.4, 0.4, 0.5]


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(rng, frames, n, k, ties=False):
    """(queries, query mask, supports, support mask) of ``frames`` frames;
    with ``ties`` the supports sit on a coarse lattice, many at the same
    place, so that many distances tie exactly."""
    xyz = rng.uniform(-5, 5, (frames, n, 3)).astype(np.float32)
    q = rng.uniform(-5, 5, (frames, k, 3)).astype(np.float32)
    if ties:
        xyz = np.round(xyz / 2.0) * 2.0
        q = np.round(q / 2.0) * 2.0
    mask = rng.random((frames, n)) < 0.8
    qmask = rng.random((frames, k)) < 0.9
    return q, qmask, xyz, mask


def _jax_ball_query(q, qmask, xyz, mask, radius, nsample, chunk):
    return [np.asarray(a) for a in jax.vmap(
        lambda a, b, c, d: JP.masked_ball_query(a, b, c, d, radius, nsample,
                                                chunk=chunk))(
        jnp.asarray(q), jnp.asarray(qmask), jnp.asarray(xyz),
        jnp.asarray(mask))]


@pytest.mark.parametrize("ties", [False, True])
def test_ball_query_matches_jax(ties):
    rng = np.random.default_rng(3 if ties else 0)
    q, qmask, xyz, mask = _cloud(rng, 2, 200, 40, ties)
    radius, nsample = 2.0, 8
    want_idx, want_valid = _jax_ball_query(q, qmask, xyz, mask, radius,
                                           nsample, chunk=7)
    idx, valid = P.masked_ball_query(_t(q), _t(qmask), _t(xyz), _t(mask),
                                     radius, nsample, chunk=7)
    idx, valid = idx.numpy(), valid.numpy()
    d2 = ((q[:, :, None].astype(np.float64) - xyz[:, None]) ** 2).sum(-1)
    flips = 0
    for f in range(2):
        for k in range(q.shape[1]):
            got = set(idx[f, k][valid[f, k]].tolist())
            want = set(want_idx[f, k][want_valid[f, k]].tolist())
            for i in got ^ want:
                # a flip only where the distance is within rounding of r^2
                assert abs(d2[f, k, i] - radius ** 2) <= 1e-5, (f, k, i)
                flips += 1
            if got == want:
                np.testing.assert_array_equal(idx[f, k][valid[f, k]],
                                              want_idx[f, k][want_valid[f, k]])
    assert flips <= 2, flips
    # masked queries have no sample, masked supports are never taken
    assert not valid[~qmask].any()
    assert mask[np.arange(2)[:, None, None], idx][valid].all()


def test_group_points_matches_jax():
    rng = np.random.default_rng(1)
    q, qmask, xyz, mask = _cloud(rng, 2, 120, 16)
    feats = rng.normal(size=(2, 120, 5)).astype(np.float32)
    idx, valid = P.masked_ball_query(_t(q), _t(qmask), _t(xyz), _t(mask),
                                     1.5, 8)
    got = P.group_points(_t(q), _t(xyz), _t(feats), idx, valid).numpy()
    want = np.asarray(jax.vmap(JP.group_points)(
        jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(feats),
        jnp.asarray(idx.numpy().astype(np.int32)), jnp.asarray(valid.numpy())))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[~valid.numpy()].any()


def _seeded_sa(jsa, inputs, in_channels, rng):
    """The JAX module's variables (norms seeded) and the port's module with
    the same weights."""
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda *a: jsa.init(jax.random.PRNGKey(0), *a))(*inputs))
    stats = variables["batch_stats"]
    for norm in stats.values():
        norm["mean"] = rng.normal(0, 0.1, norm["mean"].shape).astype(
            np.float32)
        norm["var"] = rng.uniform(0.5, 1.5, norm["var"].shape).astype(
            np.float32)
    sa = P.SAModuleMSG(in_channels, jsa.radii, jsa.nsamples, jsa.mlps)
    state = {}
    for path, value in {**_flatten(variables["params"]),
                        **_flatten(stats)}.items():
        mod, leaf = path.rsplit("/", 1)
        kind, i = mod.rsplit("_", 1)
        name = {"Dense": "linears", "MaskedBatchNorm": "norms"}[kind]
        field = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "mean": "running_mean", "var": "running_var"}[leaf]
        state[f"{name}.{i}.{field}"] = _t(value.T if leaf == "kernel"
                                          else value)
    missing, unexpected = sa.load_state_dict(state, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked")
                                  for k in missing)
    return variables, sa


@pytest.mark.parametrize("train", [False, True])
def test_sa_module_msg_matches_jax(train):
    rng = np.random.default_rng(2)
    q, qmask, xyz, mask = _cloud(rng, 2, 160, 24)
    feats = rng.normal(size=(2, 160, 4)).astype(np.float32)
    jsa = JP.SAModuleMSG(radii=(0.8, 1.6), nsamples=(8, 16),
                         mlps=((8, 8), (8, 12)))
    inputs = tuple(jnp.asarray(a) for a in (q, qmask, xyz, mask, feats))
    variables, sa = _seeded_sa(jsa, inputs, 4, rng)
    if train:
        want, upd = jax.jit(lambda v, *a: jsa.apply(
            v, *a, train=True, mutable=["batch_stats"]))(variables, *inputs)
        sa.train()
    else:
        want = jax.jit(lambda v, *a: jsa.apply(v, *a))(variables, *inputs)
        sa.eval()
    with torch.no_grad():
        got = sa(*(_t(a) for a in (q, qmask, xyz, mask)), feats=_t(feats))
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if train:
        for path, value in _flatten(jax.tree_util.tree_map(
                np.asarray, upd["batch_stats"])).items():
            mod, leaf = path.rsplit("/", 1)
            i = mod.rsplit("_", 1)[1]
            field = {"mean": "running_mean", "var": "running_var"}[leaf]
            np.testing.assert_allclose(
                getattr(sa.norms[int(i)], field).numpy(), value, rtol=0,
                atol=1e-5 * np.abs(value).max(), err_msg=path)


def test_farthest_point_sample_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-10, 10, (3, 300, 3)).astype(np.float32)
    mask = rng.random((3, 300)) < 0.7
    mask[2, :5] = False                  # the first valid point is not 0
    want = np.asarray(jax.vmap(lambda p, m: JR.farthest_point_sample(
        p, m, 64))(jnp.asarray(pts), jnp.asarray(mask)))
    got = R.farthest_point_sample(_t(pts), _t(mask), 64).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2, 0] == np.argmax(mask[2])
    assert mask[np.arange(3)[:, None], got].all()


def test_points_in_rotated_boxes_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-6, 6, (2, 400, 3)).astype(np.float32)
    boxes = np.concatenate([
        rng.uniform(-4, 4, (2, 6, 3)), rng.uniform(0.5, 4, (2, 6, 3)),
        rng.uniform(-np.pi, np.pi, (2, 6, 1))], -1).astype(np.float32)
    boxes[1, -1] = 0.0                   # a padded box
    want = np.asarray(jax.vmap(JR.points_in_rotated_boxes)(
        jnp.asarray(pts), jnp.asarray(boxes)))
    got = R.points_in_rotated_boxes(_t(pts), _t(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    # the JAX package's oracle (tests/test_fpvrcnn.py)
    box = torch.tensor([[0.0, 0.0, 0.0, 2.0, 2.0, 4.0, np.pi / 2]])
    p = torch.tensor([[0.0, 1.9, 0.0], [1.9, 0.0, 0.0], [0.9, 0.0, 0.0],
                      [0.0, 0.0, 1.2]])
    assert R.points_in_rotated_boxes(p, box)[0].tolist() == [True, False,
                                                             True, False]


def test_roi_grid_pool_matches_jax():
    rng = np.random.default_rng(6)
    feat = rng.normal(size=(2, 80, 80, 3)).astype(np.float32)
    boxes = np.concatenate([
        rng.uniform(-17, 17, (2, 8, 3)), rng.uniform(1, 5, (2, 8, 3)),
        rng.uniform(-np.pi, np.pi, (2, 8, 1))], -1).astype(np.float32)
    boxes[0, 0, :2] = 40.0               # wholly off the map
    jpts = jax.vmap(lambda b: JR.roi_grid_points(b, 6))(jnp.asarray(boxes))
    pts = R.roi_grid_points(_t(boxes), 6)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0,
                               atol=1e-5)
    want = np.asarray(jax.vmap(lambda f, b: JR.roi_grid_pool(
        f, b, LIDAR_RANGE, VOXEL, 1, grid_size=6))(jnp.asarray(feat),
                                                    jnp.asarray(boxes)))
    got = R.roi_grid_pool(_t(feat).permute(0, 3, 1, 2), _t(boxes),
                          LIDAR_RANGE, VOXEL, 1, grid_size=6).numpy()
    assert got.shape == (2, 8, 36, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[0, 0].any()
    # the JAX package's oracle: a box at the origin reads column ~39.5
    col = np.zeros((1, 2, 80, 80), np.float32)
    col[0, 0] = np.arange(80)[None, :]
    pooled = R.roi_grid_pool(_t(col), torch.tensor([[[0.0, 0.0, 0.0, 1.5,
                                                      2.0, 4.0, 0.0]]]),
                             LIDAR_RANGE, VOXEL, 1, grid_size=4)
    assert abs(float(pooled[0, 0, :, 0].mean()) - 39.5) < 1.5
