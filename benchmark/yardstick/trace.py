"""The profiled stretch of a traced run, reduced to what the per-layer
readers of benchmark/metrics/ read.

torch.profiler (CPU and CUDA activities) records a few requests or steps
right after the measured window. From its events this keeps:
  * every device activity (kernels, copies, sets) with its start and
    duration; the device's busy time is the union of their intervals, so
    that kernels that overlap on two streams count once (chip_smoke.py's
    profile_calls summed them);
  * for each "stage/..." range of the program and "bench/..." range of the
    benchmark: how often it ran, the device time of the kernels launched
    inside it (the profiler's device_time_total, as profile_calls read it)
    and its host time.
The stretch's wall time is the host clock's from its first call to the
synchronize after its last.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

RANGE_PREFIXES = ("stage/", "bench/")


@dataclass
class TraceData:
    calls: int                      # requests or steps profiled
    window_s: float                 # wall time of the profiled stretch
    kernels: list = field(default_factory=list)   # (name, start_us, dur_us)
    copies: list = field(default_factory=list)    # (name, start_us, dur_us)
    ranges: dict = field(default_factory=dict)    # name -> dict

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (union of
        intervals)."""
        return _union_s(self.kernels + self.copies)

    def busy_in(self, range_name: str):
        """Seconds of device activity (union) that began inside the spans
        of ``range_name``: the work a call launched inside the range, a
        CUDA graph's replayed kernels included, where the profiler links
        them to no host operation. None when the range never ran."""
        spans = self.ranges.get(range_name, {}).get("spans")
        if not spans:
            return None
        return _union_s([k for k in self.kernels + self.copies
                         if any(a <= k[1] <= b for a, b in spans)])

    def kernel_us(self, pattern: str) -> list:
        return [d for name, _, d in self.kernels if pattern in name]

    def top_kernels(self, n: int = 10) -> list:
        by = {}
        for name, _, d in self.kernels + self.copies:
            by[name] = by.get(name, 0.0) + d
        top = sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:n]
        return [[name[:120], us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with no device activity, each named by the
        innermost range that was open on the host when it began."""
        spans = sorted((s, s + d) for _, s, d in self.kernels + self.copies)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s - end))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[1], reverse=True)
        out = []
        for start, dur in gaps[:n]:
            name = "outside any range"
            best = None
            for rname, r in self.ranges.items():
                for rs, re in r["spans"]:
                    if rs <= start <= re and (best is None or re - rs < best):
                        best, name = re - rs, rname
            out.append([name, dur / 1e6])
        return out


def _union_s(acts: list) -> float:
    """Seconds covered by the union of (name, start_us, dur_us)
    intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((s, s + d) for _, s, d in acts):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e6


def profile(fn, calls: int) -> TraceData:
    """Run ``fn`` ``calls`` times under torch.profiler after a synchronize,
    synchronize again, and reduce the trace."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        wall = time.perf_counter() - t0
    return reduce(prof, calls, wall)


def reduce(prof, calls: int, wall_s: float) -> TraceData:
    data = TraceData(calls=calls, window_s=wall_s)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        if e.device_type == cuda:
            span = (e.name, float(e.time_range.start),
                    float(e.time_range.end - e.time_range.start))
            low = e.name.lower()
            if low.startswith(("memcpy", "memset")):
                data.copies.append(span)
            elif not e.name.startswith(RANGE_PREFIXES):
                data.kernels.append(span)
            continue
        if e.name.startswith(RANGE_PREFIXES):
            r = data.ranges.setdefault(e.name, {"count": 0, "device_us": 0.0,
                                                "host_us": 0.0, "spans": []})
            r["count"] += 1
            r["device_us"] += float(e.device_time_total)
            r["host_us"] += float(e.cpu_time_total)
            r["spans"].append((float(e.time_range.start),
                               float(e.time_range.end)))
    return data
