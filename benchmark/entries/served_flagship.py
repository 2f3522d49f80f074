"""The flagship's frame program as a deployment artifact: exported with
coalign_tpu_torch.serving.export_inference and replayed through
load_artifact's CUDA graph, one client, B = 1, the pool's clean frames.

The artifact is kept under benchmark/.cache/served/, keyed by the
configuration, the weight seed, the torch version and the program's
sources: the first run in a checkout exports it, later runs load it.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import torch

from benchmark.yardstick import pillars as P
from benchmark.yardstick.cell import (BENCH_DIR, Checks, Milestones,
                                      closed_loop, free_device_memory, log,
                                      sample_requests)
from benchmark.yardstick.checks import flagship_numbers, limits_of
from benchmark.yardstick.loader import load
from benchmark.yardstick.readers import Reading
from benchmark.yardstick.trace import profile

OUT_KEYS = ("corners3d", "scores", "mask")


def _artifact_key(config: dict) -> str:
    h = hashlib.sha256()
    h.update(json.dumps(config, sort_keys=True).encode())
    h.update(torch.__version__.encode())
    pkg = os.path.join(P.REPO, "coalign_tpu_torch")
    for root, dirs, files in sorted(os.walk(pkg)):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_build",
                                                              "__pycache__")))
        for name in sorted(files):
            if name.endswith((".py", ".cu", ".cpp")):
                with open(os.path.join(root, name), "rb") as f:
                    h.update(name.encode() + f.read())
    return h.hexdigest()[:24]


def load_served(config: dict, params: dict, example: dict, anchor_np,
                device: str):
    """The served model: the cached artifact, exported first if need be."""
    from coalign_tpu_torch.serving import export_inference, load_artifact
    cache = os.path.join(BENCH_DIR, ".cache", "served",
                         device + "-" + _artifact_key(config))
    if not os.path.exists(os.path.join(cache, "meta.json")):
        model = P.program_model(config["model"]["core_method"],
                                config["model"]["args"], params, device)
        tmp = cache + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        batch = {k: example[k] for k in ("points", "point_mask", "agent_mask",
                                         "pairwise_t_matrix",
                                         "transformation_matrix")}
        export_inference(model, batch, anchor_np, config["postprocess"], tmp,
                         platforms=(device,))
        os.replace(tmp, cache)
        del model
        log(f"exported the artifact to {os.path.relpath(cache, P.REPO)}")
    return load_artifact(cache, device=device)


def run(ctx) -> dict:
    mark = Milestones(ctx.t_start)
    config, traffic = ctx.config, ctx.traffic
    anchor_t = P.anchors(config, ctx.device)
    params = P.flagship_weights(config, ctx.device)
    mark("weights")
    frames, batches = P.pool(ctx.seed, traffic, config)
    mark("pool")
    state = {"served": load_served(config, params, batches[0],
                                   anchor_t.cpu().numpy(), ctx.device)}
    mark("artifact")

    def request(i):
        out = state["served"](batches[i % len(batches)])
        return {k: out[k].cpu().numpy() for k in OUT_KEYS}

    for i in range(traffic["warmup_requests"]):
        request(i)
    if ctx.device == "cuda":
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
            with torch.profiler.record_function("bench/served_call"):
                return request(start + traced.i - 1)
        traced.i = 0
        count = load("flops", ctx.workload["config"])
        flops = [count.request_flops(config, f, ctx.device) for f in frames]
        reading = Reading(trace=profile(traced, calls), window=window,
                          chips=1,
                          flops=[flops[i % len(frames)]
                                 for i in range(window.completed)],
                          profiled=[start + k for k in range(calls)])
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if ctx.device == "cuda" else 0)
    state.clear()
    if ctx.device == "cuda":
        free_device_memory()

    # the comparison, once the window has closed: a sample of the requests
    # drawn from the seed, the pool's largest frame among them
    checks = Checks()
    limits = limits_of(ctx)
    sample = sample_requests(ctx.seed, window, batches,
                             traffic["sample_requests"])
    for i in sample:
        ref_frame = P.reference_flagship(params, batches[i % len(batches)],
                                         config, anchor_t)[0]
        flagship_numbers(checks, window.outputs[i], ref_frame, config,
                         limits)
    if reading is not None:
        reading.iou_cases = [
            P.reference_flagship(params, batches[i % len(batches)], config,
                                 anchor_t)[0]["nms_input"][None]
            for i in reading.profiled]
    result["checks"] = checks
    result["reading"] = reading
    return result
