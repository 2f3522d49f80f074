"""The port's DAIR-V2X and V2X-Sim readers (coalign_tpu_torch/data/
dairv2x.py, v2xsim.py), their fixture writers and build_dataset against
the JAX package's, and the yamls of hypes_yaml/dairv2x/ and v2xsim/
through tools/run.py, on the CPU:

  * on trees the JAX writers wrote, the port's readers give the JAX
    readers' frames exactly (poses, points, visible ids, single boxes, the
    fused gt), DAIR's clouds on the C++ and the numpy path alike, with the
    complemented and the backup label; V2X-Sim's train-time agent order
    draws as the JAX reader's from the same seed;
  * the port's writers write the JAX writers' files byte for byte (the
    json and pcd files; the pickles hold equal arrays);
  * the calibration chains: the vehicle's lidar -> novatel -> world and
    the infrastructure's virtuallidar -> world plus its system error
    offset give the JAX reader's poses;
  * build_dataset serves both datasets: intermediate, early and late
    batches equal the JAX build_dataset's (tests/test_torch_data.py's
    bounds), on the C++ path and on the numpy path;
  * one DAIR and one V2X-Sim yaml trained by the JAX run CLI and by the
    port's on the same tree: the same frames and bandwidth, finite AP; the
    port's checkpoint then evaluated by both CLIs' inference gives the same
    AP.
"""

import filecmp
import glob
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
import yaml

from coalign_tpu.data import batch as JBATCH
from coalign_tpu.data import build_dataset as jax_build_dataset
from coalign_tpu.data import dairv2x as JDAIR
from coalign_tpu.data import fixtures as JFIX
from coalign_tpu.data import synthetic as JS
from coalign_tpu.data import v2xsim as JV2XSIM
from coalign_tpu_torch.config.yaml_utils import load_yaml
from coalign_tpu_torch.data import build_dataset
from coalign_tpu_torch.data.dairv2x import DAIRV2XBaseDataset
from coalign_tpu_torch.data.fixtures import (write_dairv2x_fixture,
                                             write_v2xsim_fixture)
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.data.v2xsim import V2XSIMBaseDataset
from coalign_tpu_torch.tools import run

from chip_smoke import HYPES_ROOT
from test_torch_data import AUGMENT, _assert_same

torch.set_num_threads(1)
CPU = ["--device", "cpu"]
LR = (-40.0, -40.0, -3.0, 40.0, 40.0, 1.0)
SCENES = dict(num_frames=4, num_agents=3, num_objects=5, lidar_range=LR,
              points_per_object=32, ground_points=64, seed=7)
# a 24 x 24 pillar canvas (3 x 3 at the trunk's /8), a 48 x 48 x 20 voxel
# grid: the CPU's NMS then ranks 288 anchors, not 512
CUT = [-4.8, -4.8, -3.0, 4.8, 4.8, 1.0]
CUT_SCENES = dict(num_frames=2, num_agents=2, num_objects=2, lidar_range=CUT,
                  points_per_object=24, ground_points=48, seed=3)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """JAX-written trees: DAIR (root, split json) and V2X-Sim (pickle)."""
    root = tmp_path_factory.mktemp("jax_trees")
    split = JFIX.write_dairv2x_fixture(str(root / "dair"),
                                       JS.SyntheticScenes(**SCENES))
    os.makedirs(root / "v2xsim")
    pkl = JFIX.write_v2xsim_fixture(str(root / "v2xsim" / "infos.pkl"),
                                    JS.SyntheticScenes(**SCENES))
    return str(root / "dair"), split, pkl


def _assert_same_frames(got, want, n):
    """Frame i of ``got`` equals frame i of ``want``; returns the agent
    orders (each frame read once from each)."""
    assert len(got) == len(want) == n
    orders = []
    for i in range(n):
        g, w = got[i], want[i]
        orders.append(tuple(a["cav_id"] for a in g["agents"]))
        assert g.get("frame_id") == w.get("frame_id")
        assert [a["cav_id"] for a in g["agents"]] == \
            [a["cav_id"] for a in w["agents"]]
        for ga, wa in zip(g["agents"], w["agents"]):
            assert sorted(ga) == sorted(wa)
            for key in ("pose", "points", "visible_ids", "single_boxes"):
                if key in wa:
                    assert ga[key].dtype == wa[key].dtype, key
                    np.testing.assert_array_equal(ga[key], wa[key],
                                                  err_msg=key)
        for key in ("boxes", "ids"):
            np.testing.assert_array_equal(g["objects"][key],
                                          w["objects"][key], err_msg=key)
    return orders


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
@pytest.mark.parametrize("complemented", [True, False])
def test_dairv2x_reader_matches_jax(trees, native, complemented):
    root, split, _ = trees
    got = DAIRV2XBaseDataset(root, split, native=native,
                             use_complemented_label=complemented)
    _assert_same_frames(got, JDAIR.DAIRV2XBaseDataset(
        root, split, use_complemented_label=complemented), 4)
    frame = got[0]
    assert [a["cav_id"] for a in frame["agents"]] == ["0", "1"]
    assert len(frame["agents"][0]["visible_ids"]) == 5
    assert len(frame["agents"][1]["visible_ids"]) == 0
    assert frame["agents"][1]["single_boxes"].shape == (0, 7)


def test_dairv2x_calibration_chains_match_jax(trees, tmp_path):
    """A tree whose vehicle pose is split over a rotated lidar -> novatel
    and whose infrastructure has a system error offset, with single-side
    labels: the same poses and single boxes as the JAX reader."""
    import json
    root, split, _ = trees
    tree = str(tmp_path / "dair")
    shutil.copytree(root, tree)
    yaw = np.deg2rad(20.0)
    rot = [[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0],
           [0.0, 0.0, 1.0]]
    for path in glob.glob(f"{tree}/vehicle-side/calib/lidar_to_novatel/*"):
        with open(path, "w") as f:
            json.dump({"transform": {"rotation": rot, "translation":
                                     [[1.5], [-0.3], [1.9]]}}, f)
    info_path = f"{tree}/cooperative/data_info.json"
    with open(info_path) as f:
        info = json.load(f)
    for i, fi in enumerate(info):
        fi["system_error_offset"] = {"delta_x": 0.7 * i, "delta_y": -0.4}
    with open(info_path, "w") as f:
        json.dump(info, f)
    label = [{"3d_dimensions": {"h": 1.5, "w": 1.8, "l": 4.2},
              "3d_location": {"x": 3.0, "y": -2.0, "z": -1.0},
              "rotation": 0.3, "type": "car"}]
    for side in ("vehicle-side/label/lidar",
                 "infrastructure-side/label/virtuallidar"):
        for path in glob.glob(f"{tree}/{side}/*.json"):
            with open(path, "w") as f:
                json.dump(label, f)
    got = DAIRV2XBaseDataset(tree, split)
    want = JDAIR.DAIRV2XBaseDataset(tree, split)
    _assert_same_frames(got, want, 4)
    before = DAIRV2XBaseDataset(root, split)
    assert not np.allclose(got[1]["agents"][0]["pose"],
                           before[1]["agents"][0]["pose"])
    assert got[1]["agents"][1]["pose"][0] != before[1]["agents"][1]["pose"][0]
    assert got[0]["agents"][0]["single_boxes"].shape == (1, 7)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_v2xsim_reader_matches_jax(trees, train):
    _, _, pkl = trees
    got = V2XSIMBaseDataset(pkl, train=train, max_cav=2, seed=11)
    want = JV2XSIM.V2XSIMBaseDataset(pkl, train=train, max_cav=2, seed=11)
    orders = set()
    for _ in range(2):           # the generator moves on from frame to frame
        orders.update(_assert_same_frames(got, want, 4))
    assert all(len(o) == 2 for o in orders)
    assert (len(orders) > 1) == train


def test_writers_write_the_jax_trees(trees, tmp_path):
    root, _, pkl = trees
    split = write_dairv2x_fixture(str(tmp_path / "dair"),
                                  SyntheticScenes(**SCENES))
    n = 0
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for name in files:
            assert filecmp.cmp(os.path.join(dirpath, name),
                               os.path.join(tmp_path, "dair", rel, name),
                               shallow=False), (rel, name)
            n += 1
    assert n == sum(len(f) for _, _, f in os.walk(tmp_path / "dair")) \
        == 1 + 1 + 4 * 9
    assert os.path.basename(split) == "split.json"
    os.makedirs(tmp_path / "v2xsim")
    mine = write_v2xsim_fixture(str(tmp_path / "v2xsim" / "infos.pkl"),
                                SyntheticScenes(**SCENES))
    for name in os.listdir(os.path.dirname(pkl)):
        if name.endswith(".bin"):
            assert filecmp.cmp(os.path.join(os.path.dirname(pkl), name),
                               os.path.join(tmp_path, "v2xsim", name),
                               shallow=False), name
    with open(pkl, "rb") as f:
        want = pickle.load(f)
    with open(mine, "rb") as f:
        got = pickle.load(f)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, value in w.items():
            if isinstance(value, dict):
                for k, v in value.items():
                    np.testing.assert_array_equal(g[key][k], v)
            else:
                np.testing.assert_array_equal(g[key], value)


def _params(trees, dataset, fusion):
    root, split, pkl = trees
    params = {"fusion": {"core_method": fusion, "dataset": dataset},
              "root_dir": split if dataset == "dairv2x" else pkl,
              "validate_dir": split if dataset == "dairv2x" else pkl,
              "train_params": {"max_cav": 2 if dataset == "dairv2x" else 3},
              "preprocess": {"cav_lidar_range": list(LR)},
              "comm_range": 60.0,
              "noise_setting": {"add_noise": True,
                                "args": {"pos_std": 0.2, "rot_std": 0.2,
                                         "pos_mean": 0, "rot_mean": 0}},
              "data_augment": AUGMENT}
    if dataset == "dairv2x":
        params["data_dir"] = root
    return params


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
@pytest.mark.parametrize("fusion", ["intermediate", "early", "late"])
@pytest.mark.parametrize("dataset", ["dairv2x", "v2xsim"])
def test_build_dataset_batches_match_jax(trees, monkeypatch, dataset, fusion,
                                         native):
    """Eval batches for the C++ path, train batches (augmentation, pose
    noise, V2X-Sim's shuffled agents) for the numpy one."""
    if not native:
        monkeypatch.setattr(JBATCH, "_native", None)
    train = not native
    params = _params(trees, dataset, fusion)
    base, batcher = build_dataset(params, train=train, native=native)
    jbase, jbatcher = jax_build_dataset(params, train=train)
    assert type(base).__name__ == type(jbase).__name__
    assert type(batcher).__name__ == type(jbatcher).__name__
    batches = list(zip(batcher.batches(base, 2, shuffle=train),
                       jbatcher.batches(jbase, 2, shuffle=train)))
    assert len(batches) == 2
    for got, want in batches:
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_same(got[key], want[key], key)


def _cut_yaml(tmp_path, rel: str, tree: dict) -> tuple:
    """hypes_yaml/``rel`` cut to CUT on ``tree``'s dataset: the ranges,
    0.2 m voxels for the SECOND family, 2 frames a batch of at most 2
    agents, no pose noise, no box_align json; the stage-1 config of
    precalc.yaml alike. Returns (path, params)."""
    params = load_yaml(os.path.join(HYPES_ROOT, rel))
    dataset = params["fusion"]["dataset"]
    root = tree["split"] if dataset == "dairv2x" else tree["pkl"]
    params.update(root_dir=root, validate_dir=root, test_dir=None)
    if dataset == "dairv2x":
        params["data_dir"] = tree["dair"]
    params["train_params"].update(batch_size=2, epoches=1, max_cav=2)
    params["noise_setting"] = {"add_noise": False}
    params.pop("box_align", None)
    params["preprocess"]["cav_lidar_range"] = CUT
    params["postprocess"]["gt_range"] = CUT
    params["postprocess"].get("anchor_args", {})["cav_lidar_range"] = CUT
    voxel = params["preprocess"].get("args", {}).get("voxel_size")
    if voxel and voxel[0] < 0.4:                 # the SECOND family's grid
        params["preprocess"]["args"]["voxel_size"] = [0.2, 0.2, 0.2]
    for args in (params["model"]["args"],
                 params.get("box_align_pre_calc", {}).get(
                     "stage1_model_config", {})):
        if not args:
            continue
        args["lidar_range"] = CUT
        if args.get("voxel_size", [1])[0] < 0.4:
            args["voxel_size"] = [0.2, 0.2, 0.2]
    pc = params.get("box_align_pre_calc")
    if pc:
        pc.update(stage1_model_path="", batch_size=2,
                  output_save_path=str(tmp_path / "precalc_out"))
    path = str(tmp_path / os.path.basename(rel))
    with open(path, "w") as f:
        yaml.safe_dump(params, f)
    return path, params


@pytest.fixture(scope="module")
def cut_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("cut_trees")
    scenes = SyntheticScenes(**CUT_SCENES)
    split = write_dairv2x_fixture(str(root / "dair"), scenes)
    os.makedirs(root / "v2xsim")
    pkl = write_v2xsim_fixture(str(root / "v2xsim" / "infos.pkl"), scenes)
    return {"dair": str(root / "dair"), "split": split, "pkl": pkl}


@pytest.mark.parametrize("rel", ["dairv2x/pointpillar_early.yaml",
                                 "v2xsim/pointpillar_fcooper.yaml"])
def test_run_cli_matches_jax(rel, cut_trees, tmp_path, monkeypatch):
    from coalign_tpu.tools.run import main as jax_main
    monkeypatch.setattr(JBATCH, "_native", None)
    path, _ = _cut_yaml(tmp_path, rel, cut_trees)
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _, got = run.main(["train", "-y", path, "--model_dir", got_dir,
                       "--epochs", "1", "--eval_frames", "2", *CPU])
    _, want = jax_main(["train", "-y", path, "--model_dir", want_dir,
                        "--epochs", "1", "--eval_frames", "2"])
    assert got["frames"] == want["frames"] == 2
    assert got["bandwidth_mb_per_frame"] == pytest.approx(
        want["bandwidth_mb_per_frame"])
    assert np.isfinite(got["ap30"]) and np.isfinite(want["ap30"])
    # the port's checkpoint through both CLIs' inference
    jax_dir = str(tmp_path / "jax_eval")
    shutil.copytree(got_dir, jax_dir)
    for d in glob.glob(os.path.join(jax_dir, "step_*")):
        shutil.rmtree(d)
    mine = run.main(["inference", "--model_dir", got_dir, *CPU])
    theirs = jax_main(["inference", "--model_dir", jax_dir])
    assert mine["frames"] == theirs["frames"] == 2
    for key in ("ap30", "ap50", "ap70"):
        assert abs(mine[key] - theirs[key]) <= 0.005, (key, mine, theirs)


def test_dair_grid_odd_maps_match_jax(trees):
    """DAIR's 504 x 200 canvas meets the multiscale trunk's strides as odd
    maps (63 x 25 at /8), which its deblocks upsample back to 252 x 100:
    dairv2x/pointpillar_coalign.yaml's model at that grid, its widths cut
    to 16/32/64, against the JAX model with the same seeded weights on a
    frame of the DAIR tree, eval mode, head maps within 1e-4 of each
    map's largest."""
    import jax
    import jax.numpy as jnp
    from conftest import jit_init

    from coalign_tpu.models import build_model as jax_build_model
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.utils.weights import from_jax_params
    from test_torch_flagship import _randomize_norms

    y = load_yaml(os.path.join(HYPES_ROOT, "dairv2x",
                               "pointpillar_coalign.yaml"))
    args = y["model"]["args"]
    args["pillar_vfe"]["num_filters"] = [16]
    args["point_pillar_scatter"]["num_features"] = 16
    args["base_bev_backbone"].update(num_filters=[16, 32, 64],
                                     layer_nums=[1, 1, 1],
                                     num_upsample_filter=[16, 16, 16])
    args["att"]["feat_dim"] = [16, 32, 64]
    args["shrink_header"].update(input_dim=48, dim=[32])
    params = {**_params(trees, "dairv2x", "intermediate"),
              "preprocess": y["preprocess"]}
    base, batcher = build_dataset(params, train=False, native=False)
    batch = batcher.assemble([base[0]])
    cfg = {"core_method": y["model"]["core_method"], "args": args}
    jmodel = jax_build_model(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(0), jbatch, train=False)),
        np.random.default_rng(0))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(variables, [1, 1, 1]), strict=True)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, jbatch)
    with torch.no_grad():
        got = model({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()})
    for key in ("cls_preds", "reg_preds", "dir_preds"):
        g = got[key].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[key])
        assert g.shape == w.shape == (1, 100, 252, g.shape[-1]), key
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), key
