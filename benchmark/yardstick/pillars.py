"""What the PointPillars cells share: the pool of host batches, the seeded
and calibrated weights of the flagship and of the stage-1 detector, the
program's models loaded with them, and the reference's box sets of a
batch."""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.reference import pointpillar as ref
from benchmark.reference.postprocess import detect
from benchmark.yardstick import scenes
from benchmark.yardstick.geometry import anchor_grid
from benchmark.yardstick.weights import seeded, shift_cls_bias

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BATCH_KEYS = {"points": torch.float32, "point_mask": torch.bool,
              "agent_mask": torch.bool, "pairwise_t_matrix": torch.float32,
              "transformation_matrix": torch.float32,
              "lidar_pose": torch.float32}


def on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(batch[k], device=device).to(dt)
            for k, dt in BATCH_KEYS.items() if k in batch}


def pool(seed: int, traffic: dict, config: dict) -> list:
    """The traffic's pool of frames and their clean host batches."""
    rng = config["model"]["args"]["lidar_range"]
    frames = [scenes.make_frame(seed, i, traffic, rng)
              for i in range(traffic["pool_frames"])]
    return frames, [scenes.assemble(f, config["max_cav"],
                                    traffic["pad_points"]) for f in frames]


def anchors(config: dict, device) -> torch.Tensor:
    return torch.as_tensor(anchor_grid(config["postprocess"]["anchor_args"]),
                           device=device)


def _calibration_batch(config: dict, seed: int, device) -> dict:
    cal = config["calibration"]
    frame = scenes.make_frame(seed, 0, cal["scene"],
                              config["model"]["args"]["lidar_range"])
    return on_device(scenes.assemble(frame, config["max_cav"],
                                     cal["scene"]["pad_points"]), device)


def flagship_weights(config: dict, device) -> dict:
    """The flagship's weights: seeded from the configuration's weight seed,
    norms calibrated on that seed's scene, the cls bias shifted."""
    args = config["model"]["args"]
    cal = config["calibration"]
    params = seeded(ref.param_shapes(args), config["weight_seed"], device,
                    cal["head_scale"])
    net = ref.Net(params)
    net.calibrating = True
    with torch.no_grad():
        maps = ref.flagship_maps(net, _calibration_batch(
            config, config["weight_seed"], device), args)
    shift_cls_bias(params, maps["cls_preds"],
                   config["postprocess"]["target_args"]["score_threshold"],
                   cal["cls_candidates"])
    return params


STAGE1_TRAINED = ("backbone.deblocks.", "shrink_conv.", "cls_head.",
                  "reg_head.", "dir_head.", "unc_head.")


def stage1_weights(config: dict, device, trained: bool = True) -> dict:
    """The stage-1 detector's weights: pillar encoder and trunk seeded from
    the configuration's weight seed + 1 and their norms calibrated on that
    seed's scene; deblocks, shrink header and heads from the trained file
    (benchmark/train_stage1.py) where ``trained``, else seeded and
    calibrated too, with the cls bias shifted."""
    args = config["stage1_model"]["args"]
    cal = config["calibration"]
    seed = config["weight_seed"] + 1
    params = seeded(ref.param_shapes(args), seed, device, cal["head_scale"])
    net = ref.Net(params)
    net.calibrating = True
    with torch.no_grad():
        maps = ref.single_maps(net, _calibration_batch(config, seed, device),
                               args)
    if not (trained and config.get("stage1_weights")):
        shift_cls_bias(params, maps["cls_preds"],
                       config["postprocess"]["target_args"]["score_threshold"],
                       cal["cls_candidates"])
        return params
    saved = torch.load(os.path.join(REPO, config["stage1_weights"]),
                       map_location=device, weights_only=True)
    missing = sorted(k for k in params if k.startswith(STAGE1_TRAINED)
                     and k not in saved)
    if missing or set(saved) - set(params):
        extra = sorted(set(saved) - set(params))[:4]
        raise RuntimeError(f"stage-1 weights file: missing {missing[:4]}, "
                           f"unexpected {extra}")
    for k, v in saved.items():
        params[k] = v.to(torch.float32)
    return params


def program_model(core_method: str, args: dict, params: dict, device):
    """The program's model of ``core_method`` with the benchmark's weights
    (a strict load: every name and shape must be the reference's)."""
    from coalign_tpu_torch.models.zoo import build_model
    model = build_model({"core_method": core_method, "args": args},
                        device=device)
    state = dict(params)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = v
    model.load_state_dict(state, strict=True)
    return model.eval()


def reference_flagship(params: dict, batch: dict, config: dict, anchor_t,
                       lowp: bool = False) -> list:
    """The reference's detect() of the flagship on a host batch."""
    dev = anchor_t.device
    b = on_device(batch, dev)
    with torch.no_grad():
        maps = ref.flagship_maps(ref.Net(params, lowp), b,
                                 config["model"]["args"])
    return detect(maps, anchor_t, b["transformation_matrix"],
                  config["postprocess"], config["postprocess"]["max_num"])


def reference_stage1(params: dict, batch: dict, config: dict, anchor_t,
                     lowp: bool = False) -> list:
    """The reference's detect() of the stage-1 detector on every agent frame
    of a host batch (identity transforms, stage1_boxes kept an agent)."""
    dev = anchor_t.device
    b = on_device(batch, dev)
    with torch.no_grad():
        maps = ref.single_maps(ref.Net(params, lowp), b,
                               config["stage1_model"]["args"])
    n = maps["cls_preds"].shape[0]
    eye = torch.eye(4, device=dev).expand(n, 4, 4)
    return detect(maps, anchor_t, eye, config["postprocess"],
                  config["stage1_boxes"])


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
