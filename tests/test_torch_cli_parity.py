"""The PyTorch port's run CLI held to the JAX package's
(coalign_tpu/tools/run.py), on fixture trees at +-12.8 m, on the CPU:

  * CLI parity: a reference-style run directory (the tiny flagship with
    tests/golden/coalign_multiscale.pth) through the JAX cmd_inference and
    the port's: the same npy box sets at chip_smoke.match_box_sets' bounds
    (same count, matched IoU > 0.95, scores within 1e-3) and AP30/50/70
    within 0.005 (tests/test_torch_flagship.py's AP bound);
  * precalc parity: the port's stage1_boxes.json from a stage-1 .pth
    (the tiny flagship's shared weights, coalign_multiscale.pth, and a
    seeded uncertainty head) holds the boxes and uncertainties that the
    JAX make_stage1_fn and dump_stage1_json give with the same weights
    (imported by coalign_tpu.utils.ckpt_import) within 1e-4;
  * the offline box_align hook corrects the same frames as the JAX one
    (tests/test_torch_posegraph.py's bounds: abandonment exact, poses
    within 1e-3 m and 1e-3 degrees).
The JAX batcher is held to its numpy path (tests/test_torch_data.py).
"""

import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from conftest import jit_init

from coalign_tpu.data import batch as JBATCH
from coalign_tpu_torch.config.yaml_utils import load_yaml
from coalign_tpu_torch.data import SyntheticScenes
from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
from coalign_tpu_torch.tools import run

from chip_smoke import (LATE_RANGE, TINY_STAGE1_ARGS, hypes_at,
                        match_box_sets, oracle_stage1, stage1_model,
                        tiny_reference_run)
from test_torch_cli import CPU, _tree

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def jax_numpy_batcher(monkeypatch):
    monkeypatch.setattr(JBATCH, "_native", None)


def _box_sets(npy_dir):
    """(corners, scores) of each dumped frame's kept boxes."""
    out = []
    for mask in sorted(glob.glob(os.path.join(npy_dir, "*_pred_mask.npy"))):
        m = np.load(mask)[0]
        pre = mask[:-len("pred_mask.npy")]
        out.append((np.load(pre + "pred_corners.npy")[0][m],
                    np.load(pre + "pred_scores.npy")[0][m]))
    return out


def test_cli_inference_matches_jax(tmp_path, capsys):
    from coalign_tpu.tools.run import main as jax_main

    _, port_dir = tiny_reference_run(str(tmp_path), device="cpu")
    jax_dir = str(tmp_path / "jax_run")
    shutil.copytree(port_dir, jax_dir)
    got = run.main(["inference", "--model_dir", port_dir, "--save_npy", *CPU])
    want = jax_main(["inference", "--model_dir", jax_dir, "--save_npy"])
    assert '"imported_reference_checkpoint"' in capsys.readouterr().out
    assert got["frames"] == want["frames"] == 4
    for key in ("ap30", "ap50", "ap70"):
        assert abs(got[key] - want[key]) <= 0.005, (key, got, want)
    assert got["ap30"] > 0.1 and got["ap30"] > got["ap70"]
    ours, ref = _box_sets(os.path.join(port_dir, "npy")), \
        _box_sets(os.path.join(jax_dir, "npy"))
    assert len(ours) == len(ref) == 4
    for (oc, os_), (rc, rs) in zip(ours, ref):
        assert len(rc) >= 6
        match_box_sets(oc, os_, rc, rs)


def _precalc_yaml(tmp_path, tree):
    """The stage-1 precompute on ``tree`` (tests/test_precalc.py's config)
    of the tiny flagship's stage-1 twin: coalign_multiscale.pth's shared
    weights and a seeded uncertainty head, saved as a .pth. (The boxes of
    tests/golden/point_pillar_uncertainty.pth's random weights are all
    larger than the post-process's size filter on these scenes.)"""
    ckpt = str(tmp_path / "stage1.pth")
    torch.save(stage1_model("cpu", TINY_STAGE1_ARGS,
                            "coalign_multiscale.pth").state_dict(), ckpt)
    params = hypes_at("pointpillar_uncertainty", tree, LATE_RANGE)
    params.update(validate_dir=None, test_dir=None)
    params["fusion"] = {"core_method": "intermediate", "dataset": "opv2v"}
    params["train_params"].update(batch_size=2, max_cav=2)
    params["noise_setting"] = {"add_noise": False}
    params["box_align_pre_calc"] = {
        "stage1_model": "point_pillar_uncertainty",
        "stage1_model_config": TINY_STAGE1_ARGS,
        "stage1_model_path": ckpt,
        "output_save_path": str(tmp_path / "precalc_out"),
        "max_boxes": 24, "batch_size": 2}
    path = str(tmp_path / "precalc.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(params, f)
    return path, params


def _jax_stage1_json(params, path):
    """What the JAX package's make_stage1_fn and dump_stage1_json give on
    the same dataset, with the golden's weights imported."""
    from coalign_tpu.data import build_dataset as jax_build_dataset
    from coalign_tpu.models import build_model as jax_build_model
    from coalign_tpu.postprocess.anchors import generate_anchor_box
    from coalign_tpu.tools.stage1 import dump_stage1_json, make_stage1_fn
    from coalign_tpu.utils.ckpt_import import load_reference_checkpoint

    pc = params["box_align_pre_calc"]
    model = jax_build_model({"core_method": pc["stage1_model"],
                             "args": pc["stage1_model_config"]})
    base, batcher = jax_build_dataset(params, train=False)
    batch = {k: jnp.asarray(v) for k, v in
             batcher.assemble([base[0], base[1]]).items()}
    variables = load_reference_checkpoint(
        pc["stage1_model_path"],
        jit_init(model, jax.random.PRNGKey(0), batch, train=False))
    post = run.postprocess_cfg(params)
    stage1 = make_stage1_fn(model, generate_anchor_box(
        post["anchor_args"], "hwl"), post, max_boxes=pc["max_boxes"])
    dump_stage1_json({k: np.asarray(v) for k, v in
                      stage1(variables, batch).items()}, [0, 1], path)
    with open(path) as f:
        return json.load(f)


def test_precalc_matches_jax(tmp_path):
    tree = _tree(tmp_path / "opv2v", seed=5)
    cfg, params = _precalc_yaml(tmp_path, tree)
    written = run.main(["precalc", "-y", cfg, *CPU])
    assert written == [str(tmp_path / "precalc_out" / "train" /
                           "stage1_boxes.json")]
    with open(written[0]) as f:
        got = json.load(f)
    want = _jax_stage1_json(load_yaml(cfg), str(tmp_path / "jax.json"))
    assert set(got) == set(want) == {"0", "1"}
    n_boxes = 0
    for fid in want:
        assert len(got[fid]) == len(want[fid]) == 2
        for g, w in zip(got[fid], want[fid]):
            for key in ("box_poses", "uncertainty"):
                assert np.shape(g[key]) == np.shape(w[key]), (fid, key)
                np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-4)
            n_boxes += len(w["box_poses"])
    assert n_boxes >= 8


def test_offline_hook_matches_jax(tmp_path, capsys):
    """The box_align hook of an eval config whose ``val_result`` names a
    stage-1 json: oracle detections (chip_smoke.oracle_stage1, the gt in
    each agent's clean frame) written by dump_stage1_json, read back by
    both packages' hooks on the same noisy batches."""
    from coalign_tpu.tools.run import _box_align_hook as jax_hook
    from coalign_tpu_torch.data import build_dataset
    from coalign_tpu_torch.tools.stage1 import dump_stage1_json

    scenes = SyntheticScenes(num_frames=4, num_agents=3, num_objects=10,
                             lidar_range=LATE_RANGE, points_per_object=32,
                             ground_points=64, agent_spread=6.0, seed=17)
    tree = write_opv2v_fixture(str(tmp_path / "opv2v"), scenes,
                               frames_per_scenario=2)
    params = hypes_at("pointpillar_coalign", tree, LATE_RANGE)
    params["train_params"]["max_cav"] = 3
    params["noise_setting"] = {"add_noise": True, "args": {
        "pos_std": 0.4, "rot_std": 0.4, "pos_mean": 0, "rot_mean": 0}}
    base, batcher = build_dataset(params, train=False)
    frames = [base[i] for i in range(len(base))]
    oracle = oracle_stage1(frames, batcher.assemble(frames), k=10)
    json_path = str(tmp_path / "oracle.json")
    dump_stage1_json(oracle, list(range(len(frames))), json_path)
    params["box_align"]["val_result"] = json_path

    ours_hook = run._box_align_hook(params, torch.device("cpu"))
    ref_hook = jax_hook(params)
    _, batcher = build_dataset(params, train=False)
    changed = []
    for ids in ([0, 1], [2, 3]):
        batch = batcher.assemble([frames[i] for i in ids])
        ours = ours_hook(batch, ids)
        ref = ref_hook({k: jnp.asarray(v) for k, v in batch.items()}, ids)
        got, want = ours["lidar_pose"].numpy(), np.asarray(ref["lidar_pose"])
        moved = np.abs(want - batch["lidar_pose"]).max(axis=(1, 2)) > 0
        np.testing.assert_array_equal(
            np.abs(got - batch["lidar_pose"]).max(axis=(1, 2)) > 0, moved)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        changed += list(moved)
    assert any(changed)

    # the CLI applies the hook when the config's box_align names the json
    model_dir = tmp_path / "balign_run"
    model_dir.mkdir()
    with open(model_dir / "config.yaml", "w") as f:
        yaml.safe_dump(params, f)
    shutil.copyfile(os.path.join(GOLDEN, "fullscale_multiscale.pth"),
                    model_dir / "net_epoch1.pth")
    capsys.readouterr()
    res = run.main(["inference", "--model_dir", str(model_dir),
                    "--eval_frames", "2", *CPU])
    assert '"box_align_json"' in capsys.readouterr().out
    assert np.isfinite(res["ap30"]) and res["frames"] == 2
