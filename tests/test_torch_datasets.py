"""The PyTorch port's on-disk data path against the JAX package's.

  * read_pcd / write_pcd: a binary file round-trips exactly, an ascii one
    within 1e-6 (six decimals); NaN rows are dropped; the port's reader
    gives the JAX reader's arrays exactly (the JAX reader takes its C++
    parser where it builds, tests/test_native.py holds it to the numpy
    one);
  * OPV2VBaseDataset on a tree that the JAX fixture writer wrote gives the
    JAX reader's frames, and the port's writer writes that tree byte for
    byte: poses, points, ids and visible ids exact, boxes within 1e-5 (the
    same numpy calls; the bound leaves room for a numpy build that orders a
    sum otherwise);
  * an RSU is never the ego; shuffle_cavs draws the JAX reader's agent
    order from the same seed; cache_frames serves parsed frames again;
    precache_json's side files read as the yamls do; V2XSet reads as OPV2V;
    camera parameters read as the JAX reader reads them;
  * build_dataset gives the JAX build_dataset's batches for intermediate,
    early and late fusion, with pose noise, in train mode (augmentation,
    late fusion's one agent a frame) and eval mode, the JAX batcher held to
    its numpy path, at tests/test_torch_data.py's bounds;
  * the inputs and models that are not ported raise.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from coalign_tpu.data import batch as JBATCH
from coalign_tpu.data import build_dataset as jax_build_dataset
from coalign_tpu.data import fixtures as JFIX
from coalign_tpu.data import opv2v as JOPV2V
from coalign_tpu.data import pcd_io as JPCD
from coalign_tpu.data import synthetic as JS
from coalign_tpu_torch.data import build_dataset
from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
from coalign_tpu_torch.data.opv2v import (OPV2VBaseDataset, V2XSETBaseDataset,
                                          precache_json)
from coalign_tpu_torch.data.pcd_io import read_pcd, write_pcd
from coalign_tpu_torch.data.synthetic import SyntheticScenes

from test_torch_data import AUGMENT, _assert_same

LR = (-40.0, -40.0, -3.0, 40.0, 40.0, 1.0)
SCENES = dict(num_frames=4, num_agents=3, num_objects=5, lidar_range=LR,
              points_per_object=32, ground_points=64, seed=7)


@pytest.fixture(scope="module")
def scenes():
    return SyntheticScenes(**SCENES)


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """A tree written by the JAX package's fixture writer, with an RSU."""
    root = str(tmp_path_factory.mktemp("jax_tree"))
    return JFIX.write_opv2v_fixture(root, JS.SyntheticScenes(**SCENES),
                                    frames_per_scenario=2, rsu_last=True)


@pytest.fixture
def jax_numpy_batcher(monkeypatch):
    monkeypatch.setattr(JBATCH, "_native", None)


def _assert_same_frames(got, want):
    assert len(got) == len(want)
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert (g["scenario"], g["timestamp"]) == (w["scenario"],
                                                   w["timestamp"])
        assert [a["cav_id"] for a in g["agents"]] == \
            [a["cav_id"] for a in w["agents"]]
        for ga, wa in zip(g["agents"], w["agents"]):
            for key in ("pose", "points", "visible_ids"):
                assert ga[key].dtype == wa[key].dtype, key
                np.testing.assert_array_equal(ga[key], wa[key], err_msg=key)
        np.testing.assert_array_equal(g["objects"]["ids"],
                                      w["objects"]["ids"])
        np.testing.assert_allclose(g["objects"]["boxes"],
                                   w["objects"]["boxes"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_pcd_roundtrip_and_jax_reader(tmp_path, binary):
    pts = np.random.default_rng(5).normal(size=(100, 4)).astype(np.float32)
    path = str(tmp_path / "cloud.pcd")
    write_pcd(path, pts, binary=binary)
    got = read_pcd(path)
    assert got.dtype == np.float32 and got.shape == pts.shape
    if binary:
        np.testing.assert_array_equal(got, pts)
    else:
        np.testing.assert_allclose(got, pts, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, JOPV2V.read_pcd(path))
    np.testing.assert_array_equal(got, JPCD.read_pcd(path))


def test_pcd_reader_drops_nan_rows(tmp_path):
    pts = np.arange(24, dtype=np.float32).reshape(6, 4)
    pts[2, 1] = np.nan
    path = str(tmp_path / "nan.pcd")
    write_pcd(path, pts)
    np.testing.assert_array_equal(read_pcd(path), np.delete(pts, 2, axis=0))


def test_reader_matches_jax_on_a_jax_tree(jax_tree):
    got = OPV2VBaseDataset(jax_tree, train=False)
    want = JOPV2V.OPV2VBaseDataset(jax_tree, train=False)
    assert len(got) == 4
    _assert_same_frames(got, want)


def test_writer_writes_the_jax_tree(jax_tree, scenes, tmp_path):
    root = write_opv2v_fixture(str(tmp_path / "port_tree"), scenes,
                               frames_per_scenario=2, rsu_last=True)
    n_files = 0
    for dirpath, _, files in os.walk(jax_tree):
        rel = os.path.relpath(dirpath, jax_tree)
        for name in files:
            assert filecmp.cmp(os.path.join(dirpath, name),
                               os.path.join(root, rel, name), shallow=False)
            n_files += 1
    assert n_files == sum(len(f) for _, _, f in os.walk(root)) == 4 * 3 * 2
    _assert_same_frames(OPV2VBaseDataset(root, train=False),
                        JOPV2V.OPV2VBaseDataset(jax_tree, train=False))


def test_frames_recover_the_scenes(jax_tree, scenes):
    ds = OPV2VBaseDataset(jax_tree, train=False)
    for i in range(len(ds)):
        frame, ref = ds[i], scenes[i]
        # the RSU, written last, is read last
        assert int(frame["agents"][0]["cav_id"]) > 0
        assert int(frame["agents"][-1]["cav_id"]) < 0
        for ag, rg in zip(frame["agents"], ref["agents"]):
            np.testing.assert_array_equal(ag["pose"], rg["pose"])
            np.testing.assert_array_equal(ag["points"], rg["points"])
        np.testing.assert_array_equal(frame["objects"]["ids"],
                                      ref["objects"]["ids"])
        got, exp = frame["objects"]["boxes"], ref["objects"]["boxes"]
        np.testing.assert_allclose(got[:, :6], exp[:, :6], rtol=0, atol=1e-4)
        dyaw = np.abs(np.mod(got[:, 6] - exp[:, 6] + np.pi, 2 * np.pi) - np.pi)
        assert dyaw.max() < 1e-4


def test_rsu_is_never_ego_even_when_it_sorts_first(tmp_path):
    root = str(tmp_path / "rsu_first")
    write_opv2v_fixture(root, SyntheticScenes(**SCENES), frames_per_scenario=2,
                        rsu_last=True)
    # "-3" sorts before "001": the reader moves it to the end
    for scen in os.listdir(root):
        assert sorted(os.listdir(os.path.join(root, scen)))[0].startswith("-")
    ds = OPV2VBaseDataset(root, train=False, max_cav=2)
    assert [a["cav_id"] for a in ds[0]["agents"]] == ["001", "002"]
    _assert_same_frames(ds, JOPV2V.OPV2VBaseDataset(root, train=False,
                                                    max_cav=2))


def test_shuffle_cavs_matches_jax(jax_tree):
    got = OPV2VBaseDataset(jax_tree, train=True, shuffle_cavs=True, seed=11)
    want = JOPV2V.OPV2VBaseDataset(jax_tree, train=True, shuffle_cavs=True,
                                   seed=11)
    orders = set()
    for _ in range(4):
        _assert_same_frames(got, want)
        orders.add(tuple(a["cav_id"] for a in got[0]["agents"]))
        assert int(got[0]["agents"][0]["cav_id"]) > 0
        got.reinitialize()
        want.reinitialize()
    assert len(orders) > 1  # the reshuffle moved agents
    # an eval dataset never shuffles
    assert not OPV2VBaseDataset(jax_tree, train=False,
                                shuffle_cavs=True).shuffle_cavs


def test_cache_frames(jax_tree):
    ds = OPV2VBaseDataset(jax_tree, train=False, cache_frames=True)
    first = ds[1]
    assert ds[1] is first
    ds.reinitialize()
    assert ds[1] is not first
    _assert_same_frames(ds, JOPV2V.OPV2VBaseDataset(jax_tree, train=False))
    assert not OPV2VBaseDataset(jax_tree, train=True, cache_frames=True,
                                shuffle_cavs=True).cache_frames


def test_precache_json_reads_as_the_yamls(scenes, tmp_path):
    root = write_opv2v_fixture(str(tmp_path / "tree"), scenes,
                               frames_per_scenario=2)
    from_yaml = OPV2VBaseDataset(root, train=False)
    frames = [from_yaml[i] for i in range(len(from_yaml))]
    assert precache_json(root) == 4 * 3
    assert precache_json(root) == 0
    _assert_same_frames(OPV2VBaseDataset(root, train=False), frames)


def test_camera_parameters_match_jax(tmp_path):
    root = JFIX.write_opv2v_fixture(
        str(tmp_path / "cams"), JS.SyntheticScenes(**{**SCENES,
                                                      "num_frames": 2}),
        frames_per_scenario=2, with_cameras=True, cam_hw=(8, 12))
    got = OPV2VBaseDataset(root, train=False, load_camera=True)[1]
    want = JOPV2V.OPV2VBaseDataset(root, train=False, load_camera=True)[1]
    for ga, wa in zip(got["agents"], want["agents"]):
        assert ga["camera_files"] == wa["camera_files"]
        assert sorted(ga["cameras"]) == ["camera0", "camera1", "camera2",
                                         "camera3"]
        for cam in wa["cameras"]:
            for key, value in wa["cameras"][cam].items():
                np.testing.assert_array_equal(ga["cameras"][cam][key], value)


def _params(root, fusion, dataset="opv2v"):
    return {"fusion": {"core_method": fusion, "dataset": dataset},
            "root_dir": root, "validate_dir": root,
            "train_params": {"max_cav": 3},
            "preprocess": {"cav_lidar_range": list(LR)},
            "comm_range": 60.0,
            "noise_setting": {"add_noise": True,
                              "args": {"pos_std": 0.2, "rot_std": 0.2,
                                       "pos_mean": 0, "rot_mean": 0}},
            "data_augment": AUGMENT}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("fusion", ["intermediate", "early", "late"])
def test_build_dataset_batches_match_jax(jax_tree, jax_numpy_batcher, fusion,
                                         train):
    params = _params(jax_tree, fusion)
    base, batcher = build_dataset(params, train=train, native=False)
    jbase, jbatcher = jax_build_dataset(params, train=train)
    assert type(batcher).__name__ == type(jbatcher).__name__
    assert (batcher.augmentor is not None) == train
    batches = list(zip(batcher.batches(base, 2, shuffle=train),
                       jbatcher.batches(jbase, 2, shuffle=train)))
    assert len(batches) == 2
    for got, want in batches:
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_same(got[key], want[key], key)
        if fusion == "late" and train:
            assert got["points"].shape[1] == 1
    # the noise was drawn: noisy poses differ from the clean ones
    assert not np.array_equal(got["lidar_pose"], got["lidar_pose_clean"])


def test_v2xset_reads_as_opv2v(jax_tree, jax_numpy_batcher):
    base, batcher = build_dataset(_params(jax_tree, "intermediate", "v2xset"),
                                  train=False, native=False)
    assert isinstance(base, V2XSETBaseDataset)
    _assert_same_frames(base, JOPV2V.V2XSETBaseDataset(jax_tree, train=False))


def test_unported_datasets_and_inputs_raise(jax_tree, scenes, tmp_path):
    # DAIR-V2X and V2X-Sim read (tests/test_torch_dairv2x_v2xsim.py); the
    # two-stage model of their fpvrcnn.yaml builds (ROADMAP item 8 ported
    # it), on the meta device: its full-size grid needs no weights here
    from coalign_tpu_torch.config.yaml_utils import load_yaml
    from coalign_tpu_torch.models.zoo import _MODELS
    for folder in ("dairv2x", "v2xsim"):
        y = load_yaml(os.path.join(os.path.dirname(__file__), "..",
                                   "coalign_tpu", "hypes_yaml", folder,
                                   "fpvrcnn.yaml"))
        with torch.device("meta"):
            model = _MODELS[y["model"]["core_method"]](y["model"]["args"])
        assert type(model).__name__ == "FpvRcnn"
    with pytest.raises(KeyError, match="unknown dataset"):
        build_dataset(_params(jax_tree, "intermediate", "kitti"))
    with pytest.raises(FileNotFoundError):
        OPV2VBaseDataset(str(tmp_path))
