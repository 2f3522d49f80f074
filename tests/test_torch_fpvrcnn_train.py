"""Training the two-stage models in the port, on the CPU:

  * one float64 step of FPV-RCNN (tests/test_torch_fpvrcnn.py's model and
    batch: 2 agents in 3 slots, non-identity poses) under the yaml's loss
    and optimizer (fpvrcnn_loss, AdamW lr 0.002, weight decay 1e-4) against
    coalign_tpu.train.make_train_step, with the JAX package's float32 pins
    patched to float64 (test_torch_fpvrcnn.patch_float64): the per-agent
    ``_single`` labels (wants_single_labels, assign_targets_per_agent)
    equal; the loss terms within 1e-7 relative (the float32 sin and cos of
    the float32 targets' yaw round an ulp apart in the two packages); each
    gradient within 1e-7 of its tensor's largest plus 1e-12; the
    parameters after the step within 1e-9 where the gradient is settled
    (test_torch_baselines_train.settled). The step trains stage 1 alone, as
    the JAX package's, whose labels carry no gt boxes: the RoI head, VSA,
    RoI-grid set abstraction and IoU head get zero gradients in both (not
    None), and AdamW decays them as optax.adamw does, within 1e-12;
  * ``run train`` then ``run inference`` of opv2v/fpvrcnn.yaml and
    opv2v/fvoxelrcnn.yaml on a fixture tree (tests/test_fpvrcnn.py's CLI
    round trip: +-8 m, 0.5 m voxels, 2 agents; FPV-RCNN cut to 256
    keypoints): the per-agent labels of the train step and the refined
    decode of the eval.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from coalign_tpu.postprocess import anchors as JANC
from coalign_tpu_torch.config.yaml_utils import load_yaml
from coalign_tpu_torch.data import SyntheticScenes
from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
from coalign_tpu_torch.tools.run import main as run_main

from chip_smoke import HYPES
from test_torch_baselines_train import jax_step_float64, port_step, settled
from test_torch_fpvrcnn import (ANCHOR_ARGS, make_batch, patch_float64,
                                seeded_pair)

torch.set_num_threads(2)
STAGE2 = ("roi_head.", "vsa.", "roi_grid_pool.", "iou_head.")


def test_train_step_matches_jax_in_float64(monkeypatch):
    y = load_yaml(f"{HYPES}/fpvrcnn.yaml")
    loss_cfg, opt_cfg = y["loss"], y["optimizer"]
    targets = y["postprocess"]["target_args"]
    assert loss_cfg["core_method"] == "fpvrcnn_loss"
    assert opt_cfg["args"]["weight_decay"] == 1e-4
    batch = make_batch()
    jmodel, variables, model = seeded_pair("fpvrcnn", batch)
    patch_float64(monkeypatch)
    metrics, want_grads, want_params = jax_step_float64(
        monkeypatch, jmodel, variables, loss_cfg,
        JANC.make_anchor_spec(ANCHOR_ARGS, targets), opt_cfg, batch, None)
    before = {k: p.detach().double() for k, p in model.named_parameters()}
    terms, grads, params = port_step(model, batch, loss_cfg,
                                     make_anchor_spec(ANCHOR_ARGS, targets),
                                     opt_cfg, torch.float64)
    assert set(terms) == set(metrics) == {"cls_loss", "reg_loss",
                                          "total_loss"}
    for key, want in metrics.items():
        # the anchor targets are float32 in both packages, and the loss
        # takes float32 sin and cos of their yaw, whose libraries round
        # an ulp apart (6e-8): 1e-7, not the 1e-9 of yaw-free targets
        np.testing.assert_allclose(terms[key], want, rtol=1e-7, err_msg=key)
    assert set(grads) == set(want_grads)
    lr_wd = opt_cfg["lr"] * opt_cfg["args"]["weight_decay"]
    stage2 = 0
    for key, want in want_grads.items():
        err = float((grads[key] - want).abs().max())
        assert err <= 1e-7 * float(want.abs().max()) + 1e-12, (key, err)
        ok = settled(want)
        torch.testing.assert_close(params[key][ok], want_params[key][ok],
                                   rtol=1e-9, atol=1e-12, msg=key)
        if key.startswith(STAGE2):
            stage2 += 1
            assert not want.any() and not grads[key].any(), key
            decayed = before[key] * (1 - lr_wd)
            torch.testing.assert_close(params[key], decayed, rtol=0,
                                       atol=1e-12, msg=key)
            torch.testing.assert_close(want_params[key], decayed, rtol=0,
                                       atol=1e-12, msg=key)
    # the RoI head's 4 Linears; the VSA's Linear and norm, its set
    # abstraction's 4 Linears and 4 norms; the RoI-grid set abstraction's;
    # the IoU head's conv
    assert stage2 == 4 * 2 + (1 + 2 + 4 + 4 * 2) + (4 + 4 * 2) + 2
    assert float(grads["cls_head.weight"].abs().max()) > 0


@pytest.mark.parametrize("name", ["fpvrcnn", "fvoxelrcnn"])
def test_cli_train_then_inference(name, tmp_path):
    lr = [-8.0, -8.0, -3.0, 8.0, 8.0, 1.0]
    scenes = SyntheticScenes(num_frames=2, num_agents=2, num_objects=2,
                             lidar_range=lr, points_per_object=24,
                             ground_points=48, seed=3)
    root = write_opv2v_fixture(str(tmp_path / "opv2v"), scenes,
                               frames_per_scenario=2)
    params = load_yaml(f"{HYPES}/{name}.yaml")
    params.update(root_dir=root, validate_dir=root,
                  noise_setting={"add_noise": False})
    params["train_params"].update(batch_size=2, epoches=1, max_cav=2)
    params["preprocess"]["cav_lidar_range"] = lr
    params["preprocess"]["args"]["voxel_size"] = [0.5, 0.5, 0.5]
    params["postprocess"]["gt_range"] = lr
    params["postprocess"]["anchor_args"]["cav_lidar_range"] = lr
    args = params["model"]["args"]
    args.update(lidar_range=lr, voxel_size=[0.5, 0.5, 0.5])
    args["anchor_args"]["cav_lidar_range"] = lr
    if "vsa" in args:
        args["vsa"]["num_keypoints"] = 256
    cfg = str(tmp_path / f"{name}.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(params, f)
    model_dir = str(tmp_path / "run")
    model, res = run_main(["train", "-y", cfg, "--model_dir", model_dir,
                           "--epochs", "1", "--eval_frames", "1",
                           "--device", "cpu"])
    assert type(model).__name__ == {"fpvrcnn": "FpvRcnn",
                                    "fvoxelrcnn": "FVoxelRcnn"}[name]
    assert res["frames"] == 1 and np.isfinite(res["ap30"])
    assert os.path.exists(os.path.join(model_dir, "net_epoch1.pth"))
    res2 = run_main(["inference", "--model_dir", model_dir,
                     "--eval_frames", "1", "--device", "cpu"])
    assert res2["frames"] == 1 and np.isfinite(res2["ap30"])
