"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell is made of is found by name from BENCHMARK.json: the
configuration's file, benchmark/traffic/<traffic>.json (which names the
entry, benchmark/entries/<entry>.py, that drives the program), the limits
of its comparison (benchmark/limits/<cell>.json), the FLOP count
(benchmark/flops/<config>.py) and one reader a per-layer metric
(benchmark/metrics/<metric>.py).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device, breakdown (--trace 1) and the
numbers compared with their limits; the same numbers are the last lines
of standard error. Without as many CUDA devices as the cell asks for, or
with JAX or the JAX package loaded once the window has closed, it prints no
result and exits with another code than 0.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH_DIR)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# every build and kernel cache of the program inside the checkout, at fixed
# paths, so that only a checkout's first run builds
CACHE = os.path.join(BENCH_DIR, ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "coalign_tpu")
HOST_THREADS = 4


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: coalign_tpu_torch is the program)."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave no reading"


def cell_metrics(bench: dict, name: str, result: dict, trace: bool) -> dict:
    from benchmark.yardstick.loader import load
    ends = [m for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]
    if not trace:
        # a metric split by cell (frame_ms_p95.two_pass) takes the value the
        # entry reports under its first part
        return {m["name"]: {"value": result["metrics"][
            m["name"].split(".")[0]], "unit": m["unit"]} for m in ends}
    reported = {m["name"] for m in ends}
    out = {}
    for m in bench["per_layer"]:
        if (name not in m.get("workloads", [name])
                or m["moves"] not in reported):
            continue
        value = load("metrics", m["name"]).read(result["reading"])
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.yardstick.cell import Ctx, log
    from benchmark.yardstick.loader import load

    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    ctx = Ctx.load(bench, args.workload, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), t_start=T_START, device=device)
    if device == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < ctx.chips:
            log(f"the cell needs {ctx.chips} CUDA device(s); "
                f"{torch.cuda.device_count()} available")
            return 2
        log(f"card: {card_line()}")
    torch.set_num_threads(min(HOST_THREADS, len(os.sched_getaffinity(0))))
    # the configurations' precision: full float32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result = load("entries", ctx.traffic["entry"]).run(ctx)
    window = result["window"]
    result["metrics"]["setup_s"] = window.started_at - T_START

    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3

    checks = result["checks"]
    line = {"correct": checks.correct(), "attempted": result["attempted"],
            "failed": result["failed"],
            "metrics": cell_metrics(bench, args.workload, result,
                                    ctx.trace),
            "device": {"platform": "gpu" if device == "cuda" else device,
                       "kind": (torch.cuda.get_device_name(0)
                                if device == "cuda" else device),
                       "count": ctx.chips,
                       "memory_peak_bytes": int(result["memory_peak_bytes"])}}
    if ctx.trace:
        trace = result["reading"].trace
        line["device"]["busy_s"] = trace.busy_s()
        line["device"]["window_s"] = trace.window_s
        line["breakdown"] = {"device_ops": trace.top_kernels(10),
                             "idle_gaps": trace.idle_gaps(10)}
    line["checks"] = checks.items
    lat = sorted(window.latencies)
    log(f"window: {window.completed} requests in {window.seconds:.3f} s; "
        f"latency ms median {1e3 * lat[len(lat) // 2]:.2f}, "
        f"max {1e3 * lat[-1]:.2f}; "
        f"set-up {result['metrics']['setup_s']:.3f} s")
    for name, c in checks.items.items():
        log(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
