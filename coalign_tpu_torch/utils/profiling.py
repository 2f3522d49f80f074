"""Tracing and profiling helpers.

Port of coalign_tpu/utils/profiling.py: a host-side stage timer that waits
for the device before it reads the clock, so that its numbers are wall time
and not the time to enqueue, and a device trace on torch.profiler (the JAX
package's jax.profiler trace) that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


def _synchronize(tree):
    """Wait for the CUDA devices of the tensors in ``tree`` (a tensor, or a
    dict, list or tuple of them); nothing for CPU tensors."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


class StageTimer:
    """Wall time per named stage, device-sync aware."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """``sync``: an optional tensor (or dict, list or tuple of them)
        whose CUDA device is synchronized before the clock is read."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {name: {"total_s": round(t, 6),
                       "count": self.counts[name],
                       "mean_ms": round(1e3 * t / max(self.counts[name], 1),
                                        3)}
                for name, t in sorted(self.totals.items())}

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
        return path


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler over the block, the host and, where a GPU is present,
    the CUDA device; the Chrome trace goes to ``logdir``/trace.json (open it
    in chrome://tracing or Perfetto). Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
