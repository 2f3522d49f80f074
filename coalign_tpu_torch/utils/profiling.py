"""Tracing and profiling helpers.

* :func:`stage`: the one way the port opens a ``stage/...`` range: a
  torch.profiler range, which also tags the nodes that torch.export traces
  inside it (``node.meta["custom"]["stage"]``), so that an exported
  program still knows its stages.
* Stage marks: timed CUDA events recorded at the stage boundaries of a
  captured CUDA graph (:class:`StageMarks`, placed by
  :func:`mark_positions`), and :data:`STAGE_LOG`, the bounded log of each
  replay's device ms by stage, read with :func:`read_stage_log`.
* :func:`device_trace`: a torch.profiler trace (the JAX package's
  jax.profiler trace) written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
from collections import deque

import torch
from torch.profiler import record_function

# the segment of a marked program's nodes that no stage tagged
UNTAGGED = "untagged"
STAGE_LOG_SIZE = 256


def stage(name: str):
    """A ``record_function(name)`` range while a profiler records. While
    torch.export traces the code, the nodes traced inside it also carry
    ``name`` as their ``meta["custom"]["stage"]``, which torch.export
    keeps through save and load when it runs under
    ``torch.fx.traceback.preserve_node_meta()``; torch.export itself drops
    the range. With no profiler on, no range is opened: it would record
    nothing and cost ~10 us of host time (H100 host, PERF.md §6)."""
    if torch.compiler.is_exporting():
        return _tagged(name)
    if not torch._C._autograd._profiler_enabled():
        return _NO_RANGE
    return record_function(name)


_NO_RANGE = contextlib.nullcontext()


@contextlib.contextmanager
def _tagged(name: str):
    with record_function(name), torch.fx.traceback.annotate({"stage": name}):
        yield


def node_stage(node) -> str | None:
    """The stage tag :func:`stage` left on an exported node, if any."""
    return node.meta.get("custom", {}).get("stage")


def mark_positions(tags: list) -> list:
    """[(index, segment name)] at which a program whose operations carry
    ``tags`` (a stage name, or None where untagged) starts a new segment:
    the first operation, and each change of tag. Untagged runs are their
    own segment, named UNTAGGED."""
    out, last = [], object()
    for i, tag in enumerate(tags):
        if tag != last:
            out.append((i, tag or UNTAGGED))
            last = tag
    return out


class StageMarks:
    """Timed CUDA events around each segment of a program: recorded once,
    inside a CUDA-graph capture (``external=True`` makes each an
    event-record node of the graph), they timestamp every replay on the
    device. ``record(i)`` records the boundary before segment ``i`` (and
    ``record(len(names))`` the end)."""

    def __init__(self, names: list):
        self.names = list(names)
        self.events = [torch.cuda.Event(enable_timing=True, external=True)
                       for _ in range(len(self.names) + 1)]

    def record(self, i: int):
        self.events[i].record()

    def done(self) -> bool:
        return self.events[-1].query()

    def wait(self):
        self.events[-1].synchronize()

    def durations(self) -> dict:
        """{segment name: device ms} of the last replay (segments of one
        name summed); call once it is done."""
        out = {}
        for name, a, b in zip(self.names, self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


class StageLog:
    """The device ms of each marked replay, by stage: a bounded log of
    {"request": call index, "stages": {name: ms}}, oldest first. A replay
    is submitted pending; its owner settles it before the next replay
    re-records the marks, without waiting (a replay not yet done then is
    counted in ``dropped``); a read settles every pending one, waiting."""

    def __init__(self, size: int = STAGE_LOG_SIZE):
        self.records = deque(maxlen=size)
        self.dropped = 0
        self._pending = []

    def submit(self, request: int, marks) -> tuple:
        """Hold ``marks`` (a StageMarks just replayed) as request
        ``request``'s; returns the token to settle it with."""
        token = (request, marks)
        self._pending.append(token)
        return token

    def settle(self, token: tuple, wait: bool = False):
        if token not in self._pending:
            return
        self._pending.remove(token)
        request, marks = token
        if wait:
            marks.wait()
        elif not marks.done():
            self.dropped += 1
            return
        self.records.append({"request": request,
                             "stages": marks.durations()})

    def read(self, last: int | None = None) -> list:
        for token in list(self._pending):
            self.settle(token, wait=True)
        records = list(self.records)
        return records if last is None else records[-last:]

    def clear(self):
        self.records.clear()
        self._pending.clear()
        self.dropped = 0


STAGE_LOG = StageLog()


def read_stage_log(last: int | None = None) -> list:
    """The stage-mark log's records (the last ``last`` of them), oldest
    first, once every pending replay is done: may wait for the device."""
    return STAGE_LOG.read(last)


def mean_stage_ms(name: str, last: int) -> float | None:
    """Mean device ms of stage ``name`` over the log's last ``last``
    records; None if the log holds fewer or one of them lacks the
    stage."""
    records = read_stage_log(last)
    if last <= 0 or len(records) < last:
        return None
    ms = [r["stages"].get(name) for r in records]
    if any(v is None for v in ms):
        return None
    return sum(ms) / last


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
