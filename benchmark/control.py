"""The control of a cell's comparison: the reference put in the program's
place and computed one precision step down (TF32 for the configurations'
float32, reference/pointpillar.tf32), held against the full-precision
reference by the same numbers and limits that decide ``correct``. A sound
limit lets the program through and fails the control.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed it makes the cell's inputs as a run does, takes the requests
a run samples for its comparison (from the first pool cycle), and prints
one JSON line with ``correct`` as a run would judge it and each number's
largest value over the requests beside its limit. It runs no measured
window; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH_DIR)
sys.path.insert(0, REPO)

from benchmark.entries.coalign_two_pass import pose_gaps  # noqa: E402
from benchmark.reference.posegraph import (BoxAlignConfig,  # noqa: E402
                                           align_xyyaw)
from benchmark.yardstick import pillars as P  # noqa: E402
from benchmark.yardstick import scenes  # noqa: E402
from benchmark.yardstick.cell import Checks, Ctx  # noqa: E402
from benchmark.yardstick.checks import (flagship_numbers,  # noqa: E402
                                        limits_of, stage1_numbers)



def as_program_out(frame: dict, max_keep: int) -> dict:
    """A reference detect() frame's kept boxes in the program's output
    layout (B = 1, padded to max_keep)."""
    kept = frame["kept"]
    n = len(kept["scores"])
    corners = np.zeros((1, max_keep, 8, 3), np.float32)
    scores = np.zeros((1, max_keep), np.float32)
    mask = np.zeros((1, max_keep), bool)
    corners[0, :n] = kept["corners3d"].numpy()
    scores[0, :n] = kept["scores"].numpy()
    mask[0, :n] = True
    return {"corners3d": corners, "scores": scores, "mask": mask}


def as_stage1_out(frames: list, k: int) -> dict:
    """Reference stage-1 frames (one an agent) in make_stage1_fn's
    layout."""
    n_l = len(frames)
    out = {"box_poses": np.zeros((1, n_l, k, 3), np.float32),
           "boxes7": np.zeros((1, n_l, k, 7), np.float32),
           "scores": np.zeros((1, n_l, k), np.float32),
           "box_mask": np.zeros((1, n_l, k), bool),
           "uncertainty": np.zeros((1, n_l, k, 3), np.float32)}
    for a, f in enumerate(frames):
        kept = f["kept"]
        n = len(kept["scores"])
        b7 = kept["boxes7"].numpy()
        out["boxes7"][0, a, :n] = b7
        out["box_poses"][0, a, :n] = b7[:, [0, 1, 6]]
        out["scores"][0, a, :n] = kept["scores"].numpy()
        out["box_mask"][0, a, :n] = True
        out["uncertainty"][0, a, :n] = kept["uncertainty"].numpy()
    return out


def control_seed(ctx, device: str) -> Checks:
    config, traffic = ctx.config, ctx.traffic
    anchor_t = P.anchors(config, device)
    params = P.flagship_weights(config, device)
    frames, batches = P.pool(ctx.seed, traffic, config)
    rng = np.random.default_rng([ctx.seed % (1 << 64), 2])
    sample = rng.choice(len(batches), traffic["sample_requests"],
                        replace=False)
    checks, limits = Checks(), limits_of(ctx)
    two_pass = traffic["entry"] == "coalign_two_pass"
    if two_pass:
        s1_params = P.stage1_weights(config, device)
        noise = config["noise_setting"]["args"]
        table = scenes.noise_table(ctx.seed, traffic["noise_draws"],
                                   config["max_cav"], noise["pos_std"],
                                   noise["rot_std"])
        cfg = BoxAlignConfig(**config["box_align"]["args"])
    for i in sample:
        batch, s1_violations = batches[i], 0
        if two_pass:
            batch = scenes.with_poses(batch, batch["lidar_pose_clean"]
                                      + table[i][None]
                                      * batch["agent_mask"][..., None])
            low = P.reference_stage1(s1_params, batch, config, anchor_t, True)
            full = P.reference_stage1(s1_params, batch, config, anchor_t)
            s1 = as_stage1_out(low, config["stage1_boxes"])
            s1_violations = stage1_numbers(checks, s1, full, config, limits,
                                           batch["agent_mask"])
            t = {k: torch.as_tensor(v, device=device) for k, v in s1.items()}
            args = (t["box_poses"], t["box_mask"], t["uncertainty"],
                    torch.as_tensor(batch["lidar_pose"], device=device),
                    torch.as_tensor(batch["agent_mask"], device=device))
            low_pose = align_xyyaw(*args, cfg=cfg, lowp=True)["refined"]
            full_pose = align_xyyaw(*(a.double() if a.is_floating_point()
                                      else a for a in args),
                                    cfg=cfg)["refined"]
            for k, v in pose_gaps(low_pose.cpu().numpy(),
                                  full_pose.cpu().numpy(),
                                  batch["agent_mask"]).items():
                checks.add(k, v, limits[k])
            poses = batch["lidar_pose"].copy()
            poses[..., [0, 1, 4]] = low_pose.cpu().numpy()
            batch = scenes.with_poses(batch, poses)
        low = P.reference_flagship(params, batch, config, anchor_t, True)[0]
        full = P.reference_flagship(params, batch, config, anchor_t)[0]
        flagship_numbers(checks, as_program_out(low,
                                                config["postprocess"]
                                                ["max_num"]),
                         full, config, limits, violations=s1_violations)
    return checks


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Ctx.load(bench, args.workload, seed=seed, seconds=0.0,
                       trace=False, t_start=0.0, device=device)
        checks = control_seed(ctx, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": checks.correct(),
                          "control": checks.items}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
