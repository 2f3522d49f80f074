"""The flagship's eager request (inference.make_infer_fn), one client,
B = 1, the pool's clean frames, the kept boxes to the host, held against
the reference's flagship."""

from __future__ import annotations

import torch

from benchmark.yardstick import pillars as P
from benchmark.yardstick.cell import (Checks, Milestones, closed_loop,
                                      free_device_memory,
                                      sample_requests)
from benchmark.yardstick.checks import flagship_numbers, limits_of
from benchmark.yardstick.loader import load
from benchmark.yardstick.readers import Reading
from benchmark.yardstick.trace import profile

OUT_KEYS = ("corners3d", "scores", "mask")


def run(ctx) -> dict:
    mark = Milestones(ctx.t_start)
    from coalign_tpu_torch.inference import make_infer_fn

    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    anchor_t = P.anchors(config, dev)
    params = P.flagship_weights(config, dev)
    mark("weights")
    frames, batches = P.pool(ctx.seed, traffic, config)
    mark("pool")
    model = P.program_model(config["model"]["core_method"],
                            config["model"]["args"], params, dev)
    state = {"infer": make_infer_fn(model, anchor_t.cpu().numpy(),
                                    config["postprocess"], device=dev)}
    del model
    mark("program")

    def request(i):
        out = state["infer"](batches[i % len(batches)])
        return {k: out[k].cpu().numpy() for k in OUT_KEYS}

    for i in range(traffic["warmup_requests"]):
        request(i)
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
        reading = Reading(trace=profile(traced, calls), window=window,
                          chips=1,
                          profiled=[start + k for k in range(calls)])
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if dev == "cuda" else 0)
    state.clear()
    if dev == "cuda":
        free_device_memory()

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
        count = load("flops", ctx.workload["config"])
        per_frame = [count.request_flops(config, f, dev) for f in frames]
        reading.flops = [per_frame[i % len(frames)]
                         for i in range(window.completed)]
    result["checks"] = checks
    result["reading"] = reading
    return result
