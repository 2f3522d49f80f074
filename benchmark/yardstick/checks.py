"""The numbers that decide ``correct`` in the PointPillars cells, each
added beside its limit (benchmark/limits/<workload>.json)."""

from __future__ import annotations

import json
import os

import numpy as np

from benchmark.yardstick.cell import BENCH_DIR
from benchmark.yardstick.compare import box_set_numbers


def limits_of(ctx) -> dict:
    with open(os.path.join(BENCH_DIR, "limits",
                           ctx.workload["name"] + ".json")) as f:
        return json.load(f)["limits"]


def flagship_numbers(checks, prog: dict, ref_frame: dict, config: dict,
                     limits: dict, violations: int = 0):
    """One frame of the flagship: the program's kept boxes (host arrays of
    B = 1: corners3d, scores, mask) against the reference's candidates;
    ``violations`` found in the request's other box sets (its stage-1
    detections) count into its ``nms_violations``."""
    m = np.asarray(prog["mask"][0], bool)
    nums = box_set_numbers(np.asarray(prog["corners3d"][0])[m],
                           np.asarray(prog["scores"][0])[m],
                           ref_frame["candidates"], config["postprocess"],
                           config["postprocess"]["max_num"],
                           limits["score_gap"], limits["corner_gap_m"])
    nums["nms_violations"] += violations
    for k, v in nums.items():
        checks.add(k, v, limits[k])


def stage1_numbers(checks, prog: dict, ref_frames: list, config: dict,
                   limits: dict, agent_mask: np.ndarray) -> int:
    """The stage-1 detections of every real agent of a B = 1 request
    (host arrays: boxes7 (1, L, K, 7), scores, box_mask, uncertainty)
    against the reference's candidates and kept boxes of that agent.
    Returns the agents' nms_violations, which the request's flagship
    numbers count: a rare event apart, the control does not always find
    one in stage-1's short box lists."""
    from benchmark.reference.postprocess import corners_of
    import torch
    k = config["stage1_boxes"]
    violations = 0
    for a in np.flatnonzero(agent_mask[0]):
        m = np.asarray(prog["box_mask"][0, a], bool)
        boxes = torch.from_numpy(np.asarray(prog["boxes7"][0, a])[m])
        corners = corners_of(boxes).numpy()
        nums = box_set_numbers(corners, np.asarray(prog["scores"][0, a])[m],
                               ref_frames[a]["candidates"],
                               config["postprocess"], k,
                               limits["s1_score_gap"],
                               limits["s1_corner_gap_m"])
        violations += nums.pop("nms_violations")
        for name, v in nums.items():
            checks.add("s1_" + name, v, limits["s1_" + name])
        # each kept box's log-variances against the reference's for the
        # same box (the nearest kept reference box)
        ref_kept = ref_frames[a]["kept"]
        if len(corners) and len(ref_kept["scores"]):
            rc = ref_kept["corners3d"].numpy()
            unc = np.asarray(prog["uncertainty"][0, a])[m]
            gap = 0.0
            for c, u in zip(corners, unc):
                d = np.abs(rc - c[None]).max(axis=(1, 2))
                j = int(np.argmin(d))
                if d[j] < 0.05:
                    gap = max(gap, float(np.abs(
                        u - ref_kept["uncertainty"][j].numpy()).max()))
            checks.add("s1_unc_gap", gap, limits["s1_unc_gap"])
    return violations
