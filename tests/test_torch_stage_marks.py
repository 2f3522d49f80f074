"""The served program's stage marks and ranges, on the CPU:

  * the small-width flagship exported by export_inference carries its stage
    tags (utils/profiling.stage) through save and load, one segment a stage
    in the program's order, and the same operations as an export without
    them; such an untagged artifact (as written before the tags) loads and
    serves as one segment;
  * mark_positions on hand-made tag lists; the capture's interpreter
    records a mark before each segment and after the last, and computes
    what the program computes;
  * ServingModel.__call__ opens its three stage/serve_* ranges;
  * the stage-mark log: its bound, request ids, a pending replay dropped
    rather than waited for, resolution on read;
  * the benchmark's readers of the new per-layer metrics on a synthetic
    trace and log, and None where there is nothing to read.

No JAX here: tests/test_torch_cuda.py imports tiny_flagship from this file
on the card, where only PyTorch is installed.
"""

import contextlib

import numpy as np
import pytest
import torch

from benchmark.yardstick.loader import load
from benchmark.yardstick.readers import Reading
from benchmark.yardstick.trace import TraceData
from coalign_tpu_torch import serving
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
from coalign_tpu_torch.serving import (export_inference, load_artifact,
                                       stage_segments)
from coalign_tpu_torch.utils import profiling as P
from coalign_tpu_torch.utils.profiling import (UNTAGGED, StageLog,
                                               mark_positions)

from chip_smoke import TINY_ANCHORS, TINY_ARGS

torch.set_num_threads(1)

FLAGSHIP_STAGES = ["stage/pillar_encoder", "stage/backbone_encode",
                   "stage/fusion", "stage/decode_shrink_heads",
                   "stage/post_process"]
SERVE_RANGES = ["stage/serve_copy_in", "stage/serve_replay",
                "stage/serve_copy_out"]
POSTPROCESS = {"anchor_args": TINY_ANCHORS,
               "target_args": {"pos_threshold": 0.6, "neg_threshold": 0.45,
                               "score_threshold": 0.2},
               "order": "hwl", "max_num": 50, "nms_thresh": 0.15,
               "gt_range": TINY_ARGS["lidar_range"]}


def tiny_flagship(agents: int = 2, points: int = 256, seed: int = 0):
    """(model, batch, anchors, postprocess config): the CoAlign flagship at
    chip_smoke's tiny widths, seeded, and a batch of seeded points."""
    torch.manual_seed(seed)
    model = build_model({"core_method": "point_pillar_baseline_multiscale",
                         "args": TINY_ARGS}, device="cpu").eval()
    anchors = make_anchor_spec(TINY_ANCHORS, POSTPROCESS["target_args"],
                               "hwl").anchors
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-12.0, 12.0, (1, agents, points, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2.0, 0.0, (1, agents, points))
    batch = {"points": pts,
             "point_mask": np.ones((1, agents, points), bool),
             "agent_mask": np.ones((1, agents), bool),
             "pairwise_t_matrix": np.tile(np.eye(4, dtype=np.float32),
                                          (1, agents, agents, 1, 1)),
             "transformation_matrix": np.eye(4, dtype=np.float32)[None]}
    return model, batch, anchors, POSTPROCESS


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The tiny flagship exported for the CPU twice: as export_inference
    does, and with the node metadata not preserved (an artifact without
    stage tags, as exported before them)."""
    model, batch, anchors, post = tiny_flagship()
    tagged = str(tmp_path_factory.mktemp("tagged"))
    export_inference(model, batch, anchors, post, tagged, platforms=("cpu",))
    untagged = str(tmp_path_factory.mktemp("untagged"))
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.fx.traceback, "preserve_node_meta",
               contextlib.nullcontext)
    try:
        export_inference(model, batch, anchors, post, untagged,
                         platforms=("cpu",))
    finally:
        mp.undo()
    return tagged, untagged, batch


def _program(artifact_dir):
    return torch.export.load(f"{artifact_dir}/{serving.program_file('cpu')}")


def test_flagship_export_tags_each_stage_in_order(artifacts):
    tagged, _, _ = artifacts
    served = load_artifact(tagged, device="cpu")
    names = [name for _, name in stage_segments(served._fn.graph)]
    assert [n for n in names if n != UNTAGGED] == FLAGSHIP_STAGES
    # every stage has operations of its own
    tags = [P.node_stage(n) for n in served._fn.graph.nodes]
    for name in FLAGSHIP_STAGES:
        assert tags.count(name) > 0, name


def test_stage_tags_leave_the_exported_ops_unchanged(artifacts):
    tagged, untagged, _ = artifacts
    with_tags, without = _program(tagged), _program(untagged)
    assert with_tags.graph_module.code == without.graph_module.code
    assert ([str(n.target) for n in with_tags.graph.nodes]
            == [str(n.target) for n in without.graph.nodes])
    assert any(P.node_stage(n) for n in with_tags.graph.nodes)
    assert not any(P.node_stage(n) for n in without.graph.nodes)


def test_untagged_artifact_loads_and_serves_as_one_segment(artifacts):
    tagged, untagged, batch = artifacts
    old = load_artifact(untagged, device="cpu")
    assert [name for _, name in stage_segments(old._fn.graph)] == [UNTAGGED]
    got, want = old(batch), load_artifact(tagged, device="cpu")(batch)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("tags,want", [
    ([None, "a", "a", None, None, "b", "a"],
     [(0, UNTAGGED), (1, "a"), (3, UNTAGGED), (5, "b"), (6, "a")]),
    (["a", "a", "a"], [(0, "a")]),
    ([None, None], [(0, UNTAGGED)]),
    ([], []),
], ids=["untagged_runs", "single_stage", "no_tags", "no_ops"])
def test_mark_positions(tags, want):
    assert mark_positions(tags) == want


class _Recorder:
    """StageMarks' interface on the CPU: the order of its records."""

    def __init__(self, names):
        self.names = list(names)
        self.recorded = []

    def record(self, i):
        self.recorded.append(i)


def test_marked_run_records_each_segment_and_computes_the_program(
        artifacts, monkeypatch):
    tagged, _, batch = artifacts
    served = load_artifact(tagged, device="cpu")
    monkeypatch.setattr(serving, "StageMarks", _Recorder)
    marked = serving._MarkedRun(served._fn)
    inputs = serving.batch_inputs(batch, served.meta["batch_spec"], "cpu")
    with torch.no_grad():
        got = marked.run(served.params, inputs)
        want = served._fn(served.params, inputs)
    names = marked.marks.names
    assert [n for n in names if n != UNTAGGED] == FLAGSHIP_STAGES
    assert marked.marks.recorded == list(range(len(names) + 1))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_serving_model_opens_its_three_ranges(artifacts):
    tagged, _, batch = artifacts
    served = load_artifact(tagged, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        served(batch)
        served(batch)
    spans = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name.startswith("stage/serve_"))
    assert [name for _, name in spans] == SERVE_RANGES * 2
    assert served.calls == 2


class _Marks:
    """StageMarks' interface without a device: ``ms`` when done."""

    def __init__(self, ms: dict, done: bool = True):
        self.ms, self._done, self.waited = dict(ms), done, 0

    def done(self):
        return self._done

    def wait(self):
        self.waited += 1
        self._done = True

    def durations(self):
        return dict(self.ms)


def test_stage_log_keeps_its_last_records_by_request():
    log = StageLog(size=4)
    for i in range(6):
        log.settle(log.submit(i, _Marks({"stage/a": float(i)})))
    assert [r["request"] for r in log.read()] == [2, 3, 4, 5]
    assert log.read(last=2) == [{"request": 4, "stages": {"stage/a": 4.0}},
                                {"request": 5, "stages": {"stage/a": 5.0}}]
    assert log.dropped == 0


def test_stage_log_drops_a_pending_replay_rather_than_wait():
    log = StageLog()
    marks = _Marks({"stage/a": 1.0}, done=False)
    token = log.submit(7, marks)
    log.settle(token)
    assert marks.waited == 0 and log.dropped == 1
    assert log.read() == []
    log.settle(token)                   # settled once only
    assert log.dropped == 1


def test_stage_log_resolves_pending_replays_on_read():
    log = StageLog()
    log.settle(log.submit(0, _Marks({"stage/a": 1.0})))
    marks = _Marks({"stage/a": 2.0, UNTAGGED: 0.5}, done=False)
    log.submit(1, marks)
    records = log.read()
    assert marks.waited == 1
    assert records[-1] == {"request": 1,
                           "stages": {"stage/a": 2.0, UNTAGGED: 0.5}}
    assert log.read() == records        # resolved once


def _log_of(monkeypatch, stages: list) -> StageLog:
    log = StageLog()
    for i, ms in enumerate(stages):
        log.settle(log.submit(i, _Marks(ms)))
    monkeypatch.setattr(P, "STAGE_LOG", log)
    return log


def test_mean_stage_ms(monkeypatch):
    _log_of(monkeypatch, [{"stage/a": 9.0}, {"stage/a": 1.0},
                          {"stage/a": 3.0, "stage/b": 1.0}])
    assert P.mean_stage_ms("stage/a", 2) == 2.0
    assert P.mean_stage_ms("stage/a", 3) == pytest.approx(13.0 / 3)
    assert P.mean_stage_ms("stage/a", 4) is None     # fewer records
    assert P.mean_stage_ms("stage/b", 2) is None     # a record lacks it
    assert P.mean_stage_ms("stage/a", 0) is None


def _reading(trace: TraceData) -> Reading:
    return Reading(trace=trace, window=None, chips=1, profiled=[])


def _range(spans, host_us=0.0):
    return {"count": len(spans), "device_us": 0.0, "host_us": host_us,
            "spans": list(spans)}


def test_serve_copy_in_host_ms_reader():
    read = load("metrics", "serve_copy_in_host_ms").read
    trace = TraceData(calls=2, window_s=1.0, ranges={
        "stage/serve_copy_in": _range([(0, 300), (1000, 1500)], 800.0)})
    assert read(_reading(trace)) == pytest.approx(0.4)
    assert read(_reading(TraceData(calls=2, window_s=1.0))) is None


def test_serve_idle_ms_reader():
    read = load("metrics", "serve_idle_ms").read
    trace = TraceData(
        calls=1, window_s=1.0,
        kernels=[("k1", 20.0, 30.0), ("k2", 160.0, 100.0),
                 ("k3", 500.0, 10.0)],
        copies=[("Memcpy HtoD", 40.0, 20.0)],
        ranges={"stage/serve_copy_in": _range([(0.0, 100.0)]),
                "stage/serve_replay": _range([(100.0, 150.0)]),
                "stage/serve_copy_out": _range([(150.0, 200.0)]),
                "bench/served_call": _range([(0.0, 600.0)])})
    # copy-in 100 less 20-60 busy, the replay's 50 all idle, copy-out 50
    # less 160-200 busy: 60 + 50 + 10 us
    assert read(_reading(trace)) == pytest.approx(0.12)
    assert read(_reading(TraceData(calls=1, window_s=1.0))) is None


SERVED = {"served_pillar_encoder_ms": "stage/pillar_encoder",
          "served_backbone_encode_ms": "stage/backbone_encode",
          "served_fusion_ms": "stage/fusion",
          "served_heads_ms": "stage/decode_shrink_heads",
          "served_post_process_ms": "stage/post_process"}


@pytest.mark.parametrize("metric", sorted(SERVED))
def test_served_stage_reader(metric, monkeypatch):
    read = load("metrics", metric).read
    stage_name = SERVED[metric]
    other = {s: 1.0 for s in SERVED.values() if s != stage_name}
    _log_of(monkeypatch, [dict(other, **{stage_name: 5.0}),
                          dict(other, **{stage_name: 2.0}),
                          dict(other, **{stage_name: 4.0})])
    profiled = _reading(TraceData(calls=2, window_s=1.0))
    assert read(profiled) == pytest.approx(3.0)   # the last two calls
    assert read(_reading(TraceData(calls=4, window_s=1.0))) is None
    _log_of(monkeypatch, [other, other])
    assert read(profiled) is None
