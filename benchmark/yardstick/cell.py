"""What every cell's run shares: its context, the closed loop that times the
window, the statistics taken from it and the record of the numbers
compared."""

from __future__ import annotations

import gc
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class Milestones:
    """Seconds since the process started at each named point of set-up,
    printed on one line of standard error."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.marks = []

    def __call__(self, name: str):
        self.marks.append((name, time.time() - self.t_start))

    def report(self):
        log("set-up (s since start): " + ", ".join(
            f"{n} {t:.2f}" for n, t in self.marks))


@dataclass
class Ctx:
    """One run of one cell: its BENCHMARK.json entry, configuration and
    traffic (the files the entry names), and the command's arguments."""
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float              # time.time() when the process started
    device: str = "cuda"
    chips: int = 1

    @classmethod
    def load(cls, bench: dict, workload: str, **kw) -> "Ctx":
        cell = next((w for w in bench["workloads"] if w["name"] == workload),
                    None)
        if cell is None:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
        with open(os.path.join(os.path.dirname(BENCH_DIR), conf["file"])) as f:
            config = json.load(f)
        with open(os.path.join(BENCH_DIR, "traffic",
                               cell["traffic"] + ".json")) as f:
            traffic = json.load(f)
        return cls(workload=cell, config=config, traffic=traffic,
                   chips=cell["chips"], **kw)


@dataclass
class Window:
    """The measured window of a closed loop: each request's latency (s),
    the window's length (first send to last answer, s) and the answers."""
    latencies: list
    seconds: float
    started_at: float             # time.time() at the first send
    outputs: dict = field(default_factory=dict)

    @property
    def completed(self) -> int:
        return len(self.latencies)

    def p95_ms(self) -> float:
        # the 95th percentile of every request completed in the window
        if len(self.latencies) < 2:
            return self.latencies[0] * 1e3
        return statistics.quantiles(self.latencies, n=20,
                                    method="inclusive")[18] * 1e3

    def per_s(self) -> float:
        return self.completed / self.seconds


def closed_loop(request, seconds: float) -> Window:
    """One client: request ``i`` is sent when the answer of ``i - 1`` is on
    the host, until ``seconds`` have passed; the request that is running
    then completes and counts. ``request(i)`` returns the host answer."""
    lat, outs = [], {}
    i = 0
    started_at = time.time()
    t_first = time.perf_counter()
    deadline = t_first + seconds
    while True:
        t0 = time.perf_counter()
        outs[i] = request(i)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        i += 1
        if t1 >= deadline:
            break
    return Window(latencies=lat, seconds=t1 - t_first, started_at=started_at,
                  outputs=outs)


def sample_requests(seed: int, window: Window, batches: list,
                    count: int) -> list:
    """The window's requests that the comparison checks: ``count`` drawn
    from the seed, and the first request of the pool's largest frame (the
    most points) where the window reached it."""
    import numpy as np
    rng = np.random.default_rng([seed % (1 << 64), 2])
    n = window.completed
    sample = set(rng.choice(n, min(count, n), replace=False).tolist())
    largest = int(np.argmax([b["point_mask"].sum() for b in batches]))
    if largest < n:
        sample.add(largest)
    return sorted(sample)


class Checks:
    """The numbers compared, each with its limit; ``correct`` when every
    number is within its limit (and every one is a number)."""

    def __init__(self):
        self.items = {}

    def add(self, name: str, value, limit):
        value = float(value)
        old = self.items.get(name)
        if old is None or not value <= old["value"]:
            self.items[name] = {"value": value, "limit": float(limit)}

    def correct(self) -> bool:
        return bool(self.items) and all(
            v["value"] <= v["limit"] for v in self.items.values())


def free_device_memory():
    import torch
    gc.collect()
    torch.cuda.empty_cache()
