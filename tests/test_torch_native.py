"""The port's host data plane (coalign_tpu_torch/native) against the JAX
package's, on the CPU: both libraries build with g++ where the tests run.

  * parse_pcd, parse_pcd_batch (threads), mask_pad_points (the range
    bounds, the ego box cut, the capacity subsample), transform_points and
    PillarVoxelizer give the JAX library's arrays exactly (the same C++);
  * the OPV2V reader and every batcher on the native path give the JAX
    ones' on the native path exactly, and on the numpy path the JAX ones'
    numpy path (subsampled clouds and pose noise: each path draws the
    generator as the JAX batcher's does); the two paths give different
    batches where a cloud overflows;
  * the library builds only under coalign_tpu_torch/_build/, and a build
    that fails raises, with the compiler's output, instead of falling back
    to numpy.
"""

import os

import numpy as np
import pytest

from coalign_tpu import native as JN
from coalign_tpu.data import batch as JBATCH
from coalign_tpu.data import build_dataset as jax_build_dataset
from coalign_tpu.data import fixtures as JFIX
from coalign_tpu.data import opv2v as JOPV2V
from coalign_tpu.data import synthetic as JS
from coalign_tpu_torch import native
from coalign_tpu_torch.data import batch as TBATCH
from coalign_tpu_torch.data import build_dataset
from coalign_tpu_torch.data.opv2v import OPV2VBaseDataset
from coalign_tpu_torch.data.pcd_io import write_pcd
from coalign_tpu_torch.data.synthetic import SyntheticScenes

from test_torch_data import _assert_same
from test_torch_datasets import _assert_same_frames, _params

LR = (-40.0, -40.0, -3.0, 40.0, 40.0, 1.0)
SCENES = dict(num_frames=4, num_agents=3, num_objects=5, lidar_range=LR,
              points_per_object=40, ground_points=300, seed=7)
# 200 points an agent: every cloud overflows and is subsampled
BATCHER = dict(max_cav=3, max_points=200, max_objects=8, lidar_range=LR,
               comm_range=60.0, pos_std=0.2, rot_std=0.2, seed=5)


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native_tree"))
    return JFIX.write_opv2v_fixture(root, JS.SyntheticScenes(**SCENES),
                                    frames_per_scenario=2, rsu_last=True)


def _cloud(seed, n=3000, spread=50.0):
    """Points over a square of +-spread m, with rows exactly on each range
    bound of LR and inside the ego box."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-spread, spread, (n, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-4, 2, n)
    pts[:8, 0] = [LR[0], LR[3], 0.5, -0.5, 10, 10, 10, 10]
    pts[:8, 1] = [5, 5, 0.3, -0.2, LR[1], LR[4], 5, 5]
    pts[:8, 2] = [0, 0, 0, 0, 0, 0, LR[2], LR[5]]
    return pts


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_parse_pcd_equals_jax(tmp_path, binary):
    pts = np.random.default_rng(1).normal(size=(700, 4)).astype(np.float32)
    pts[3, 2] = np.nan                                  # a dropped row
    path = str(tmp_path / "c.pcd")
    write_pcd(path, pts, binary=binary)
    got = native.parse_pcd(path)
    assert got.shape == (699, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, JN.parse_pcd(path))
    np.testing.assert_array_equal(native.parse_pcd(path, max_points=50),
                                  JN.parse_pcd(path, max_points=50))
    with pytest.raises(IOError):
        native.parse_pcd(str(tmp_path / "missing.pcd"))


def test_parse_pcd_batch_equals_jax(tmp_path):
    paths = []
    for i in range(7):
        pts = np.random.default_rng(i).normal(
            size=(100 + 37 * i, 4)).astype(np.float32)
        paths.append(str(tmp_path / f"b{i}.pcd"))
        write_pcd(paths[-1], pts, binary=i % 2 == 0)
    got = native.parse_pcd_batch(paths, max_points=2048, n_threads=3)
    want = JN.parse_pcd_batch(paths, max_points=2048, n_threads=3)
    assert len(got) == len(want) == 7
    for g, w, p in zip(got, want, paths):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, native.parse_pcd(p))
    assert native.parse_pcd_batch([]) == []
    with pytest.raises(IOError, match="missing"):
        native.parse_pcd_batch([paths[0], str(tmp_path / "missing.pcd")])


@pytest.mark.parametrize("max_out,ego", [(4096, (0.0, 0.0)),
                                         (4096, (1.95, 1.1)),
                                         (900, (0.0, 0.0)),
                                         (900, (1.95, 1.1))],
                         ids=["fits", "ego_cut", "subsampled",
                              "subsampled_ego_cut"])
def test_mask_pad_points_equals_jax(max_out, ego):
    pts = _cloud(2)
    got = native.mask_pad_points(pts, LR, max_out, *ego)
    want = JN.mask_pad_points(pts, LR, max_out, *ego)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    out, mask = got
    kept = out[mask]
    # x and y half-open, z closed; the ego box cut
    assert (kept[:, 0] < LR[3]).all() and (kept[:, 1] < LR[4]).all()
    assert (kept[:, 2] <= LR[5]).all() and (kept[:, 2] >= LR[2]).all()
    inside = ((np.abs(kept[:, 0]) < ego[0]) & (np.abs(kept[:, 1]) < ego[1]))
    assert not inside.any()
    assert mask[:mask.sum()].all() and not mask[mask.sum():].any()
    if max_out == 900:
        assert 800 <= mask.sum() <= 900


def test_transform_points_equals_jax():
    pts = _cloud(3, n=200)
    t = np.random.default_rng(4).normal(size=(4, 4)).astype(np.float32)
    got = native.transform_points(pts, t)
    np.testing.assert_array_equal(got, JN.transform_points(pts, t))
    np.testing.assert_array_equal(got[:, 3], pts[:, 3])
    np.testing.assert_allclose(got[:, :3], pts[:, :3] @ t[:3, :3].T
                               + t[:3, 3], rtol=1e-5, atol=1e-4)


def test_pillar_voxelizer_equals_jax():
    pts = _cloud(5, n=5000, spread=45.0)
    ours = native.PillarVoxelizer(LR, (0.8, 0.8, 4.0), max_pillars=3000,
                                  max_pts=8)
    theirs = JN.PillarVoxelizer(LR, (0.8, 0.8, 4.0), max_pillars=3000,
                                max_pts=8)
    for cloud in (pts, pts[::3]):          # the epoch reset between calls
        got, want = ours(cloud), theirs(cloud)
        assert got[3] == want[3] > 0
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
def test_reader_equals_jax_on_each_path(jax_tree, monkeypatch, use_native):
    if not use_native:
        monkeypatch.setattr(JOPV2V, "_native", None)
    got = OPV2VBaseDataset(jax_tree, train=False, native=use_native)
    _assert_same_frames(got, JOPV2V.OPV2VBaseDataset(jax_tree, train=False))
    # the native reader's clouds own their memory
    assert got[0]["agents"][0]["points"].base is None


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for bg, bw in zip(got, want):
        assert sorted(bg) == sorted(bw)
        for key in bw:
            _assert_same(bg[key], bw[key], key)


@pytest.mark.parametrize("kind", ["IntermediateFusionBatcher",
                                  "EarlyFusionBatcher", "LateFusionBatcher",
                                  "KDFusionBatcher"])
@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
def test_batchers_equal_jax_on_each_path(monkeypatch, kind, use_native):
    if not use_native:
        monkeypatch.setattr(JBATCH, "_native", None)
    scenes = SyntheticScenes(**SCENES)
    got = getattr(TBATCH, kind)(**BATCHER, native=use_native)
    want = getattr(JBATCH, kind)(**BATCHER)
    _same_batches(list(got.batches(scenes, 2)),
                  list(want.batches(JS.SyntheticScenes(**SCENES), 2)))
    # a further draw of each generator: both paths consume it alike
    assert got.rng.integers(1 << 30) == want.rng.integers(1 << 30)


def test_native_and_numpy_paths_differ_on_overflow():
    scenes = SyntheticScenes(**SCENES)
    frames = [scenes[0], scenes[1]]
    nat = TBATCH.IntermediateFusionBatcher(**BATCHER).assemble(frames)
    num = TBATCH.IntermediateFusionBatcher(**BATCHER, native=False).assemble(
        frames)
    assert nat["point_mask"].sum() > 0
    assert not np.array_equal(nat["points"], num["points"])
    # numpy's subsample draws from the generator before the pose noise
    assert not np.array_equal(nat["lidar_pose"], num["lidar_pose"])
    np.testing.assert_array_equal(nat["lidar_pose_clean"],
                                  num["lidar_pose_clean"])


@pytest.mark.parametrize("fusion", ["intermediate", "late"])
def test_build_dataset_equals_jax_on_the_native_path(jax_tree, fusion):
    params = _params(jax_tree, fusion)
    params["train_params"]["max_cav"] = 3
    base, batcher = build_dataset(params, train=True)
    assert base.native and batcher.native
    jbase, jbatcher = jax_build_dataset(params, train=True)
    for b in (batcher, jbatcher):
        b.max_points = 100                         # every cloud overflows
    _same_batches(list(batcher.batches(base, 2)),
                  list(jbatcher.batches(jbase, 2)))


def test_builds_only_under_the_port_build_dir():
    path, _ = native.build()
    build_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(native.__file__))), "_build")
    assert os.path.dirname(str(path)) == build_dir
    assert os.path.exists(path)
    src_dir = os.path.dirname(os.path.abspath(native.__file__))
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "COMPILER", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        native.mask_pad_points(_cloud(0, n=10), LR, 16)
    # a compiler that runs and fails: its stderr is in the error
    monkeypatch.setattr(native, "COMPILER", "g++")
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.load()
    assert not list((tmp_path / "build").glob("*.so"))
