"""The PyTorch port's run CLI (coalign_tpu_torch.tools.run and the
noise_sweep and pose_graph_eval command lines) on fixture trees at
+-12.8 m, on the CPU: the twins of tests/test_config_zoo.py's CLI round
trip, tests/test_noise_sweep_cli.py and
tests/test_pose_graph_eval.py::test_pose_graph_eval_cli
(tests/test_torch_cli_parity.py holds the CLI to the JAX package's):

  * train writes config.yaml (pad_parity false), scripts_backup.zip and
    net_epoch1.pth; a second train resumes from it; inference prefers the
    bestval checkpoint and saves its result and the npy dump;
    config_generate expands a yaml; the checkpoints are ordered by number;
  * the pad_parity trap: a run directory the port trained reloads to the
    in-memory model's detections and head maps (exactly: the same weights
    on the same CPU), while the same checkpoint in a reference run
    directory, whose config has no pad_parity, gets pad_parity true and
    other maps;
  * lss_coalign_fusion.yaml trains on a camera tree and its run directory
    infers, also under --bf16;
  * the refused subcommand, flags, datasets and a config's ``heter`` block
    raise and name their ROADMAP item; without --device and without a GPU
    every command raises;
"""

import os
import shutil
import zipfile

import numpy as np
import pytest
import torch
import yaml

from coalign_tpu_torch.config.yaml_utils import load_yaml
from coalign_tpu_torch.data import SyntheticScenes
from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
from coalign_tpu_torch.inference import make_infer_fn, to_device
from coalign_tpu_torch.tools import noise_sweep, pose_graph_eval, run
from coalign_tpu_torch.train import inference_checkpoint, latest_checkpoint

from chip_smoke import LATE_RANGE, hypes_at

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def _tree(path, seed, frames=2):
    scenes = SyntheticScenes(num_frames=frames, num_agents=2, num_objects=3,
                             lidar_range=LATE_RANGE, points_per_object=32,
                             ground_points=64, seed=seed)
    return write_opv2v_fixture(str(path), scenes, frames_per_scenario=2)


def _tiny_yaml(path, name, tree, **train_params):
    """The OPV2V yaml ``name`` at +-12.8 m on ``tree``, 2 agents, no noise,
    no box_align, as the JAX CLI tests cut it."""
    params = hypes_at(name, tree, LATE_RANGE)
    params.pop("box_align", None)
    params["noise_setting"] = {"add_noise": False}
    params["train_params"].update(batch_size=2, epoches=1, max_cav=2,
                                  **train_params)
    with open(path, "w") as f:
        yaml.safe_dump(params, f)
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tiny flagship yaml trained one epoch through the CLI, with a
    validation each epoch; returns (tmp dir, yaml, run dir, model, stdout
    lines)."""
    tmp = tmp_path_factory.mktemp("trained")
    tree = _tree(tmp / "opv2v", seed=3)
    cfg = _tiny_yaml(tmp / "tiny.yaml", "pointpillar_coalign", tree,
                     eval_freq=1)
    model_dir = str(tmp / "run")
    model, res = run.main(["train", "-y", cfg, "--model_dir", model_dir,
                           "--epochs", "1", "--eval_frames", "2", *CPU])
    assert np.isfinite(res["ap30"]) and res["frames"] == 2
    return tmp, cfg, model_dir, model


def test_train_resume_inference_and_config_generate(trained, capsys):
    tmp, cfg, model_dir, _ = trained
    saved = load_yaml(os.path.join(model_dir, "config.yaml"))
    assert saved["model"]["args"]["pillar_vfe"]["pad_parity"] is False
    with zipfile.ZipFile(os.path.join(model_dir, "scripts_backup.zip")) as z:
        names = set(z.namelist())
    assert {"coalign_tpu_torch/tools/run.py",
            "coalign_tpu_torch/csrc/rotated_iou.cu"} <= names
    assert not any("_build" in n for n in names)

    # a second train in the same directory resumes (ref train.py:55-75)
    work = str(tmp / "resumed")
    shutil.copytree(model_dir, work)
    capsys.readouterr()
    run.main(["train", "-y", cfg, "--model_dir", work, "--epochs", "1",
              "--eval_frames", "1", *CPU])
    out = capsys.readouterr().out
    assert '"resumed_from": "net_epoch1.pth"' in out
    assert os.path.exists(os.path.join(work, "net_epoch2.pth"))
    assert os.path.exists(os.path.join(work, "net_epoch_bestval_at2.pth"))

    # inference prefers the bestval checkpoint (ref load_saved_model)
    res = run.main(["inference", "--model_dir", work, "--save_npy", *CPU])
    out = capsys.readouterr().out
    assert '"loaded_checkpoint": "net_epoch_bestval_at2.pth"' in out
    assert res["frames"] == 2 and np.isfinite(res["ap30"])
    assert res["bandwidth_mb_per_frame"] > 0
    assert load_yaml(os.path.join(work, "eval_intermediate.yaml")) == res
    npy = sorted(os.listdir(os.path.join(work, "npy")))
    assert len(npy) == 2 * 5 and npy[0] == "00000_gt_boxes.npy"

    out_yaml = str(tmp / "full.yaml")
    assert run.main(["config_generate", "-y", cfg, "--output", out_yaml,
                     *CPU]) == out_yaml
    assert load_yaml(out_yaml) == load_yaml(cfg)


def test_checkpoints_are_ordered_by_number(tmp_path):
    for name in ("net_epoch9.pth", "net_epoch10.pth", "net_epoch2.pth",
                 "net_epoch_bestval_at3.pth", "notes.pth"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == (
        10, str(tmp_path / "net_epoch10.pth"))
    assert inference_checkpoint(str(tmp_path)) == (
        3, str(tmp_path / "net_epoch_bestval_at3.pth"))
    (tmp_path / "net_epoch_bestval_at3.pth").unlink()
    assert inference_checkpoint(str(tmp_path))[0] == 10


def test_resumed_schedule_goes_on():
    """A run resumed at epoch N steps its learning rate on from N epochs of
    steps (build_optimizer's start_step), as a run that never stopped."""
    from coalign_tpu_torch.train import build_optimizer
    sched = {"core_method": "multistep", "gamma": 0.1, "step_size": [1, 3]}
    for start, lrs in ((0, [1.0, 1.0, 0.1, 0.1]), (2, [0.1] * 4),
                       (6, [0.01] * 4)):
        w = torch.nn.Parameter(torch.zeros(1))
        opt, sch = build_optimizer([w], {"lr": 1.0}, sched,
                                   steps_per_epoch=2, start_step=start)
        got = []
        for _ in range(4):
            got.append(opt.param_groups[0]["lr"])
            opt.step()
            sch.step()
        np.testing.assert_allclose(got, lrs, rtol=1e-6)


def test_port_trained_dir_reloads_to_the_same_detections(trained):
    tmp, cfg, model_dir, model = trained

    class Opt:
        root_dir = None
        device = "cpu"

    Opt.model_dir = model_dir
    params, base, batcher, loaded, spec, dev = run._load_model_dir(Opt)
    assert loaded.pillar_vfe.pad_parity is False
    batch = batcher.assemble([base[0], base[1]])
    post = run.postprocess_cfg(params)
    want = make_infer_fn(model, spec.anchors, post, device="cpu")(batch)
    got = make_infer_fn(loaded, spec.anchors, post, device="cpu")(batch)
    for key in ("mask", "scores", "corners3d"):
        assert torch.equal(got[key], want[key]), key
    # one step of training leaves no box through the post-process's size
    # filter, so the head maps are held too
    b = to_device(batch, "cpu")
    with torch.no_grad():
        maps = model(b)
        for key, value in loaded(b).items():
            assert torch.equal(value, maps[key]), key

    # the same directory as a reference run's, without pad_parity in its
    # config: the loader sets it, and the same weights then give other maps
    ref_dir = str(tmp / "as_reference")
    shutil.copytree(model_dir, ref_dir)
    params["model"]["args"]["pillar_vfe"].pop("pad_parity")
    with open(os.path.join(ref_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(params, f)
    Opt.model_dir = ref_dir
    as_reference = run._load_model_dir(Opt)[3]
    assert as_reference.pillar_vfe.pad_parity is True
    with torch.no_grad():
        assert not torch.allclose(as_reference(b)["cls_preds"],
                                  maps["cls_preds"], rtol=0, atol=1e-3)


def test_noise_sweep_cli(trained):
    _, _, model_dir, _ = trained
    results = noise_sweep.main(["--model_dir", model_dir, "--levels",
                                "0,0.4", "--eval_frames", "2",
                                "--also_laplace", *CPU])
    assert set(results) == {(0.0, 0.0), (0.4, 0.4)}
    for v in results.values():
        assert np.isfinite(v["ap30"]) and v["frames"] == 2
    loaded = load_yaml(os.path.join(model_dir, "eval_noise_sweep.yaml"))
    assert {"0_0", "0.4_0.4", "laplace_0_0", "laplace_0.4_0.4"} == set(loaded)


def test_pose_graph_eval_cli(tmp_path):
    tree = _tree(tmp_path / "opv2v", seed=13)
    cfg = _tiny_yaml(tmp_path / "unc.yaml", "pointpillar_uncertainty", tree)
    model_dir = str(tmp_path / "run")
    run.main(["train", "-y", cfg, "--model_dir", model_dir, "--epochs", "1",
              "--eval_frames", "1", *CPU])
    res = pose_graph_eval.main(["--model_dir", model_dir, "--pos_std", "0.4",
                                "--rot_std", "0.4", "--eval_frames", "2",
                                "--batch_size", "2", *CPU])
    assert res["frames"] == 2
    for phase in ("before", "after"):
        assert np.isfinite(res[phase]["trans_mean"])
    assert os.path.exists(os.path.join(model_dir, "eval_pose_graph.yaml"))


def test_refused_commands_raise(trained, tmp_path, monkeypatch):
    _, cfg, model_dir, _ = trained
    for argv, item in ((["export", "--model_dir", model_dir], "item 9"),
                       (["inference", "--model_dir", model_dir,
                         "--save_vis"], "item 9"),
                       (["inference", "--model_dir", model_dir,
                         "--profile", "trace"], "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            run.main(argv + CPU)
    # a directory of the JAX package's orbax checkpoints, and none at all
    (tmp_path / "orbax" / "step_10").mkdir(parents=True)
    shutil.copy(os.path.join(model_dir, "config.yaml"), tmp_path / "orbax")
    with pytest.raises(FileNotFoundError, match="from_jax_params"):
        run.main(["inference", "--model_dir", str(tmp_path / "orbax"), *CPU])
    shutil.rmtree(tmp_path / "orbax" / "step_10")
    with pytest.raises(FileNotFoundError, match="no net_epoch"):
        run.main(["inference", "--model_dir", str(tmp_path / "orbax"), *CPU])
    # the real precalc.yaml's SECOND stage-1 builds, the family ported: none
    # of its dataset directories exists here, so it writes nothing
    hypes = os.path.join(os.path.dirname(__file__), "..", "coalign_tpu",
                         "hypes_yaml")
    assert run.main(["precalc", "-y", os.path.join(hypes, "opv2v",
                                                   "precalc.yaml"), *CPU]) == []
    # without a GPU the commands need --device cpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((run.main, ["config_generate", "-y", cfg]),
                       (run.main, ["inference", "--model_dir", model_dir]),
                       (noise_sweep.main, ["--model_dir", model_dir]),
                       (pose_graph_eval.main, ["--model_dir", model_dir])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


def test_heter_block_is_refused(trained, tmp_path):
    """A run directory whose config has a ``heter`` block (the JAX
    package's heterogeneous AP sets, coalign_tpu/tools/run.py:257-268) is
    refused, naming ROADMAP item 9, and so is evaluate_dataset's
    ``heter_selector``, rather than evaluated to another AP without a
    word."""
    from coalign_tpu_torch.inference import evaluate_dataset
    _, _, model_dir, _ = trained
    heter = tmp_path / "heter"
    shutil.copytree(model_dir, heter)
    params = load_yaml(str(heter / "config.yaml"))
    params["heter"] = {"lidar_ratio": 0.5, "ego_modality": "lidar"}
    with open(heter / "config.yaml", "w") as f:
        yaml.safe_dump(params, f)
    with pytest.raises(NotImplementedError, match="heter.*item 9"):
        run.main(["inference", "--model_dir", str(heter), *CPU])
    with pytest.raises(NotImplementedError, match="item 9"):
        evaluate_dataset(None, None, None, None, {}, heter_selector=object(),
                         device="cpu")


@pytest.mark.parametrize("bf16", [False, True])
def test_lss_run_dir_infers(bf16, tmp_path):
    """lss_coalign_fusion.yaml (cut as tests/test_torch_dataset_yamls.py
    cuts it) trains on a camera fixture tree, then ``run inference`` of its
    run directory reloads the checkpoint and evaluates a frame from disk;
    with ``--bf16`` both commands run under the bfloat16 policy, which the
    test resets."""
    from coalign_tpu_torch.models.layers import set_compute_dtype
    from test_torch_dataset_yamls import cut_lss_yaml
    from coalign_tpu_torch.data.synthetic import SyntheticScenes as Scenes
    scenes = Scenes(num_frames=2, num_agents=2, num_objects=3,
                    lidar_range=[-8.0, -8.0, -3.0, 8.0, 8.0, 1.0],
                    points_per_object=16, ground_points=32, seed=4)
    tree = write_opv2v_fixture(str(tmp_path / "cams"), scenes,
                               frames_per_scenario=2, with_cameras=True,
                               cam_hw=(64, 96))
    path, _ = cut_lss_yaml(tmp_path, "lss_coalign_fusion", tree)
    flag = ["--bf16"] if bf16 else []
    model_dir = str(tmp_path / "run")
    try:
        _, res = run.main(["train", "-y", path, "--model_dir", model_dir,
                           "--epochs", "1", "--eval_frames", "1", *flag,
                           *CPU])
        res2 = run.main(["inference", "--model_dir", model_dir,
                         "--eval_frames", "1", *flag, *CPU])
    finally:
        set_compute_dtype(None)
    assert res2["frames"] == 1 and np.isfinite(res2["ap30"])
    if not bf16:
        assert res2 == res
    assert os.path.exists(os.path.join(model_dir, "eval_intermediate.yaml"))
