"""CoAlign's two-pass request, eager, one client, B = 1: the stage-1
detector on every agent frame (tools/stage1.make_stage1_fn), the
agent-object pose graph (tools/stage1.correct_batch_poses with the yaml's
box_align args), the flagship (inference.make_infer_fn) on the corrected
poses, the kept boxes to the host. Each request carries a fresh draw of
the yaml's pose noise on every agent but the ego.

The comparison follows the request step by step: the reference's stage-1
detector on the request's points; the reference's pose graph on the
program's own stage-1 detections; the reference's flagship on the
program's own corrected poses (PERF.md says why).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.posegraph import BoxAlignConfig, align_xyyaw
from benchmark.yardstick import pillars as P
from benchmark.yardstick import scenes
from benchmark.yardstick.cell import (Checks, Milestones, closed_loop,
                                      free_device_memory, log,
                                      sample_requests)
from benchmark.yardstick.checks import (flagship_numbers, limits_of,
                                        stage1_numbers)
from benchmark.yardstick.loader import load
from benchmark.yardstick.readers import Reading
from benchmark.yardstick.trace import profile

OUT_KEYS = ("corners3d", "scores", "mask")
STAGE1_KEYS = ("box_poses", "boxes7", "scores", "box_mask", "uncertainty")


def pose_gaps(got_xyyaw: np.ndarray, ref_xyyaw: np.ndarray, mask) -> dict:
    """Largest x, y (m) and yaw (degrees, wrapped) differences of the real
    agents' corrected poses (..., 3)."""
    d = np.abs(np.asarray(got_xyyaw, np.float64)
               - np.asarray(ref_xyyaw, np.float64))
    d[..., 2] = np.abs((d[..., 2] + 180.0) % 360.0 - 180.0)
    m = np.asarray(mask, bool)
    return {"pose_gap_m": float(d[..., :2][m].max()),
            "pose_gap_deg": float(d[..., 2][m].max())}


def run(ctx) -> dict:
    mark = Milestones(ctx.t_start)
    from coalign_tpu_torch.inference import make_infer_fn
    from coalign_tpu_torch.posegraph import BoxAlignConfig as ProgConfig
    from coalign_tpu_torch.tools.stage1 import (correct_batch_poses,
                                                make_stage1_fn)

    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    anchor_t = P.anchors(config, dev)
    anchor_np = anchor_t.cpu().numpy()
    params = P.flagship_weights(config, dev)
    s1_params = P.stage1_weights(config, dev)
    mark("weights")
    frames, batches = P.pool(ctx.seed, traffic, config)
    mark("pool")
    noise = config["noise_setting"]["args"]
    table = scenes.noise_table(ctx.seed, traffic["noise_draws"],
                               config["max_cav"], noise["pos_std"],
                               noise["rot_std"])

    def noisy(i):
        b = batches[i % len(batches)]
        return scenes.with_poses(b, b["lidar_pose_clean"]
                                 + table[i % len(table)][None]
                                 * b["agent_mask"][..., None])

    flagship = P.program_model(config["model"]["core_method"],
                               config["model"]["args"], params, dev)
    detector = P.program_model(config["stage1_model"]["core_method"],
                               config["stage1_model"]["args"], s1_params, dev)
    state = {
        "stage1": make_stage1_fn(detector, anchor_np, config["postprocess"],
                                 config["stage1_boxes"], device=dev),
        "infer": make_infer_fn(flagship, anchor_np, config["postprocess"],
                               device=dev),
        "cfg": ProgConfig.from_yaml(config["box_align"]["args"])}
    del flagship, detector
    mark("program")
    kept = {}                                   # request -> program's steps

    def request(i):
        batch = noisy(i)
        dets = state["stage1"](batch)
        corrected = correct_batch_poses(batch, dets, state["cfg"], device=dev)
        out = state["infer"](corrected)
        kept[i] = (dets, corrected["lidar_pose"])
        return {k: out[k].cpu().numpy() for k in OUT_KEYS}

    for i in range(traffic["warmup_requests"]):
        request(-1 - i)
    kept.clear()
    if dev == "cuda":
        torch.cuda.synchronize()
    mark("warm-up")
    mark.report()
    window = closed_loop(request, ctx.seconds)
    result = {"window": window,
              "metrics": {"frame_ms_p95": window.p95_ms(),
                          "frames_per_s": window.per_s()},
              "attempted": window.completed, "failed": 0}
    reading = None
    if ctx.trace:
        calls = traffic["profile_requests"]
        start = window.completed

        def traced():
            traced.i += 1
            with torch.profiler.record_function("bench/request"):
                return request(start + traced.i - 1)
        traced.i = 0
        trace = profile(traced, calls)
        count = load("flops", ctx.workload["config"])
        flops = [count.request_flops(config, f, dev)
                 + count.stage1_flops(config, f) for f in frames]
        reading = Reading(trace=trace, window=window, chips=1,
                          profiled=[start + k
                                                  for k in range(calls)],
                          flops=[flops[i % len(frames)]
                                 for i in range(window.completed)])
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if dev == "cuda" else 0)
    # the program's steps to the host, its state freed
    steps = {i: ({k: P.host(v) for k, v in d.items() if k in STAGE1_KEYS},
                 P.host(pose)) for i, (d, pose) in kept.items()}
    kept.clear()
    state.clear()
    if dev == "cuda":
        free_device_memory()

    # how many requests the pose graph corrected (an abandoned sample keeps
    # its noisy poses)
    corrected = sum(not np.allclose(pose[..., [0, 1, 4]],
                                    noisy(i)["lidar_pose"][..., [0, 1, 4]])
                    for i, (_, pose) in steps.items())
    log(f"pose graph: {corrected} of {len(steps)} requests corrected "
        f"({100.0 * corrected / max(len(steps), 1):.1f}% kept)")
    result["kept_share"] = corrected / max(len(steps), 1)

    checks = Checks()
    limits = limits_of(ctx)
    cfg = BoxAlignConfig(**config["box_align"]["args"])
    sample = sample_requests(ctx.seed, window, batches,
                             traffic["sample_requests"])
    cases = {}
    for i in sample + [i for i in (reading.profiled if reading else [])
                       if i not in sample]:
        batch = noisy(i)
        s1_prog, pose_prog = steps[i]
        s1_ref = P.reference_stage1(s1_params, batch, config, anchor_t)
        # the pose graph on the program's detections, in float64
        t = {k: torch.as_tensor(v, device=dev) for k, v in s1_prog.items()}
        ref_pose = align_xyyaw(
            t["box_poses"].double(), t["box_mask"],
            t["uncertainty"].double(),
            torch.as_tensor(batch["lidar_pose"], device=dev).double(),
            torch.as_tensor(batch["agent_mask"], device=dev), cfg)["refined"]
        # the flagship on the program's corrected poses
        fl_ref = P.reference_flagship(params, scenes.with_poses(batch,
                                                                pose_prog),
                                      config, anchor_t)[0]
        cases[i] = (s1_ref, fl_ref)
        if i not in sample:
            continue
        s1_violations = stage1_numbers(checks, s1_prog, s1_ref, config,
                                       limits, batch["agent_mask"])
        for k, v in pose_gaps(pose_prog[..., [0, 1, 4]], P.host(ref_pose),
                              batch["agent_mask"]).items():
            checks.add(k, v, limits[k])
        flagship_numbers(checks, window.outputs[i], fl_ref, config, limits,
                         violations=s1_violations)
    if reading is not None:
        # the NMS inputs of the profiled requests' two IoU launches
        reading.iou_cases = [
            torch.stack([f["nms_input"] for f in cases[i][0]])
            for i in reading.profiled] + [
            cases[i][1]["nms_input"][None] for i in reading.profiled]
    result["checks"] = checks
    result["reading"] = reading
    return result
