"""CPU tests of the benchmark harness (python -m pytest benchmark/).

The end-to-end tests run a tiny copy of the benchmark: the repository's
benchmark/ copied into a temporary directory, with a tiny configuration, two
traffic mixes, their limits and a FLOP count added there as new files only,
and BENCHMARK.json naming the tiny cells. The harness runs them on the CPU
(its look for a CUDA device skipped) against the reference, in a subprocess
whose loaded modules are checked for JAX and the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, REPO)

from benchmark import run  # noqa: E402
from benchmark.reference import pointpillar as ref  # noqa: E402
from benchmark.yardstick import scenes  # noqa: E402
from benchmark.yardstick.compare import box_set_numbers  # noqa: E402
from benchmark.yardstick.iou import iou_ops  # noqa: E402

TINY_RANGE = [-12.8, -12.8, -3, 12.8, 12.8, 1]
TINY_TRAFFIC = {"pool_frames": 3, "agents": [2, 3], "vehicles": [2, 4],
                "points_per_agent": [300, 500], "pad_points": 600,
                "object_point_share": 0.4, "agent_spread_m": 4.0,
                "object_radius_m": 8.0, "warmup_requests": 1,
                "sample_requests": 2, "profile_requests": 1,
                "noise_draws": 8}
TINY_LIMITS = {"s1_score_gap": 1e-5, "s1_corner_gap_m": 1e-4,
               "s1_unc_gap": 1e-4,
               "pose_gap_m": 1e-4, "pose_gap_deg": 1e-3, "score_gap": 1e-5,
               "corner_gap_m": 1e-4, "nms_violations": 0}
CELLS = {"tiny_noisy": "coalign_two_pass", "tiny_served": "served_flagship",
         "tiny_eager": "eager_infer"}
# in the tiny noisy cell every CAV stands at the ego's pose and sees the
# ego's points: its seeded stage-1 boxes are then the ego's, so that the
# pose graph keeps frames and takes out the pose noise
EGO_COPIES = """
from benchmark.yardstick import scenes
_make = scenes.make_frame
def _copies(*a, **k):
    frame = _make(*a, **k)
    frame["agents"] = [frame["agents"][0]] * len(frame["agents"])
    return frame
scenes.make_frame = _copies
"""
SET_UP = {"tiny_noisy": EGO_COPIES}


def tiny_config() -> dict:
    with open(os.path.join(BENCH, "configs",
                           "pointpillar_coalign_opv2v.json")) as f:
        cfg = json.load(f)
    for key in ("model", "stage1_model"):
        a = cfg[key]["args"]
        a["lidar_range"] = TINY_RANGE
        a["base_bev_backbone"] = {
            "layer_nums": [1, 1, 1], "layer_strides": [2, 2, 2],
            "num_filters": [16, 32, 64], "upsample_strides": [1, 2, 4],
            "num_upsample_filter": [16, 16, 16]}
        a["shrink_header"] = {"kernal_size": [3], "stride": [1],
                              "padding": [1], "dim": [32], "input_dim": 48}
        if "att" in a:
            a["att"]["feat_dim"] = [16, 32, 64]
    cfg["postprocess"]["gt_range"] = TINY_RANGE
    cfg["postprocess"]["anchor_args"].update(cav_lidar_range=TINY_RANGE,
                                             W=64, H=64)
    cfg["stage1_weights"] = None
    cfg["calibration"]["cls_candidates"] = 40
    cfg["calibration"]["scene"].update(
        vehicles=[3, 3], points_per_agent=[400, 400], pad_points=600,
        agent_spread_m=4.0, object_radius_m=8.0)
    return cfg


def _digests(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            if "__pycache__" not in d:
                path = os.path.join(d, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = hashlib.sha256(
                        f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def tiny_repo(tmp_path_factory):
    """A copy of benchmark/ with the tiny cells added as new files."""
    root = str(tmp_path_factory.mktemp("tiny"))
    bench = os.path.join(root, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__", "weights"))
    before = _digests(bench)
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(tiny_config(), f)
    for cell, entry in CELLS.items():
        traffic = dict(TINY_TRAFFIC, entry=entry)
        if cell == "tiny_noisy":
            del traffic["agent_spread_m"]
            traffic.update(cav_range_m=8.0, vehicles=[7, 9],
                           object_radius_m=9.0)
        with open(os.path.join(bench, "traffic", cell + ".json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(bench, "limits", cell + ".json"), "w") as f:
            json.dump({"limits": TINY_LIMITS}, f)
    shutil.copy(os.path.join(BENCH, "flops", "pointpillar_coalign_opv2v.py"),
                os.path.join(bench, "flops", "tiny.py"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"] += [{"name": c, "config": "tiny", "traffic": c,
                           "chips": 1, "why": "test"} for c in CELLS]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c for c in CELLS if c != "tiny_noisy"]
    # the two-pass cell's metrics, kept aside while its cell is out
    with open(os.path.join(BENCH, "withdrawn", "coalign_noisy_b1.json")) as f:
        two_pass = json.load(f)
    for key in ("end_to_end", "per_layer"):
        spec[key] += [dict(m, workloads=["tiny_noisy"])
                      for m in two_pass[key]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    return root


def run_tiny(root: str, cell: str, trace: int = 0, fault: str = "") -> tuple:
    """The tiny cell run in a subprocess on the CPU: (exit code, the result
    line or None, standard error)."""
    code = f"""
import sys
sys.path[:0] = [{root!r}, {REPO!r}]
import torch
torch.set_num_threads(2)
{SET_UP.get(cell, "")}
{fault}
from benchmark import run
rc = run.main(["--workload", {cell!r}, "--seed", str(2 ** 31 + 11),
               "--seconds", "1", "--trace", "{trace}"], device="cpu")
sys.exit(rc)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900, cwd=root)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return proc.returncode, line, proc.stderr


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_end_to_end(tiny_repo, cell):
    rc, line, err = run_tiny(tiny_repo, cell, trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    # no CUDA kernels: nothing to read for the device's readers
    assert "launches_per_frame" not in line["metrics"]
    assert "idle_share" not in line["metrics"]
    mfu = "mfu.two_pass" if cell == "tiny_noisy" else "mfu.serve"
    assert 0 < line["metrics"][mfu]["value"]
    if cell == "tiny_noisy":
        # the faults to the corrected poses can show
        assert "pose graph: 0 of" not in err, err[-3000:]


# each planted in the program, where the answer is produced
FAULTS = {
    "tiny_noisy": {
        "box_moved": """
import coalign_tpu_torch.inference as I
_pp = I.post_process
def _moved(*a, **k):
    out = _pp(*a, **k)
    out["corners3d"] = out["corners3d"] + 0.3
    return out
I.post_process = _moved
""",
        "pose_moved": """
import coalign_tpu_torch.tools.stage1 as S
_ap = S.align_poses_batch
def _moved(*a, **k):
    out = _ap(*a, **k).clone()
    out[..., 1:, 0] += 0.05
    return out
S.align_poses_batch = _moved
""",
        "yaw_kept": """
import torch
import coalign_tpu_torch.tools.stage1 as S
_ap = S.align_poses_batch
def _kept(*a, **k):
    out = _ap(*a, **k).clone()
    out[..., 4] = torch.as_tensor(a[3]).to(out)[..., 4]
    return out
S.align_poses_batch = _kept
""",
        "stage1_score": """
import coalign_tpu_torch.tools.stage1 as S
_pp = S.post_process
def _lowered(*a, **k):
    out = _pp(*a, **k)
    out["scores"] = out["scores"] * 0.99
    return out
S.post_process = _lowered
""",
        "stage1_dropped": """
import coalign_tpu_torch.tools.stage1 as S
_pp = S.post_process
def _dropped(*a, **k):
    out = _pp(*a, **k)
    out["mask"] = out["mask"].clone()
    out["mask"][:, 0] = False
    return out
S.post_process = _dropped
"""},
    "tiny_served": {
        "box_dropped": """
import coalign_tpu_torch.serving as SV
_call = SV.ServingModel.__call__
def _dropped(self, batch):
    out = _call(self, batch)
    out["mask"][:, 0] = False
    return out
SV.ServingModel.__call__ = _dropped
"""},
    "tiny_eager": {
        "score_raised": """
import coalign_tpu_torch.inference as I
_pp = I.post_process
def _raised(*a, **k):
    out = _pp(*a, **k)
    out["scores"] = out["scores"] * 1.01
    return out
I.post_process = _raised
"""}}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in sorted(FAULTS[c])])
def test_fault_makes_it_incorrect(tiny_repo, cell, fault):
    rc, line, err = run_tiny(tiny_repo, cell, fault=FAULTS[cell][fault])
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_the_limits(tiny_repo, cell):
    """The reference at TF32 in the program's place fails a limit that the
    program (test_tiny_cell_end_to_end) meets."""
    code = f"""
import sys, json
sys.path[:0] = [{tiny_repo!r}, {REPO!r}]
import torch
torch.set_num_threads(2)
{SET_UP.get(cell, "")}
from benchmark import control
control.main(["--workload", {cell!r}, "--seeds", "5,6"], device="cpu")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900, cwd=tiny_repo)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 2
    for line in lines:
        got = json.loads(line)
        assert got["correct"] is False, got["control"]


def test_scenes_reproduce_from_the_seed():
    traffic = dict(TINY_TRAFFIC, points_per_agent=[2000, 3000],
                   pad_points=3000)
    big = 2 ** 31 + 12345
    a = scenes.make_frame(big, 3, traffic, TINY_RANGE)
    b = scenes.make_frame(big, 3, traffic, TINY_RANGE)
    c = scenes.make_frame(big + 1, 3, traffic, TINY_RANGE)
    assert np.array_equal(a["boxes"], b["boxes"])
    for x, y in zip(a["agents"], b["agents"]):
        assert np.array_equal(x["points"], y["points"])
        assert 2000 <= len(x["points"]) <= 3000
        p = x["points"]
        assert (p[:, 0] >= -12.8).all() and (p[:, 0] < 12.8).all()
    assert not np.array_equal(a["agents"][0]["points"][:10],
                              c["agents"][0]["points"][:10])
    n1 = scenes.noise_table(big, 4, 5, 0.2, 0.2)
    assert np.array_equal(n1, scenes.noise_table(big, 4, 5, 0.2, 0.2))
    assert (n1[:, 0] == 0).all() and n1[:, 1:, 0].std() > 0
    batch = scenes.assemble(a, 5, 3000, n1[0])
    # pairwise[b, i, j] = T_j<-i: the ego's points mapped into agent 1 and
    # back land where they were
    t = batch["pairwise_t_matrix"][0]
    assert np.allclose(t[0, 1] @ t[1, 0], np.eye(4), atol=1e-5)


def test_flop_count_by_hand():
    from benchmark.yardstick.loader import load
    count = load("flops", "pointpillar_coalign_opv2v")
    assert count.conv(64, 128, 3, 50, 176) == 2 * 64 * 128 * 9 * 50 * 176
    args = tiny_config()["model"]["args"]
    trunk, scales = count.trunk_scales(args)
    # one block a stage: conv1 (strided), conv2, the 1x1 downsample
    want = 0
    c_in, h, w = 64, 64, 64
    for c in (16, 32, 64):
        h, w = h // 2, w // 2
        want += 2 * h * w * (c_in * c * 9 + c * c * 9 + c_in * c)
        c_in = c
    assert trunk == want and scales[-1] == (64, 8, 8)
    with open(os.path.join(BENCH, "configs",
                           "pointpillar_coalign_opv2v.json")) as f:
        full = json.load(f)["model"]["args"]
    assert abs(count.trunk_scales(full)[0] / 1e9 - 81.1) < 0.5


def test_iou_ops_is_its_source():
    sys.path.insert(0, REPO)
    import chip_smoke
    gen = torch.Generator().manual_seed(3)
    boxes = torch.cat([torch.rand(2, 40, 2, generator=gen) * 20,
                       torch.full((2, 40, 1), -1.0),
                       torch.rand(2, 40, 3, generator=gen) * 3 + 1,
                       torch.rand(2, 40, 1, generator=gen) * 6], -1)
    from benchmark.reference.postprocess import corners_of
    c = corners_of(boxes)[..., :4, :2].float()
    assert iou_ops(c, c) == chip_smoke.iou_ops(c, c)


def test_box_set_numbers():
    post = tiny_config()["postprocess"]
    boxes = torch.tensor([[0.0, 0, -1, 1.5, 1.8, 4.0, 0.0],
                          [0.5, 0, -1, 1.5, 1.8, 4.0, 0.0],
                          [8.0, 3, -1, 1.5, 1.8, 4.0, 1.0]])
    from benchmark.reference.postprocess import corners_of
    corners = corners_of(boxes).numpy().astype(np.float32)
    cand = {"corners": corners, "scores": np.array([0.9, 0.8, 0.7],
                                                   np.float32),
            "valid": np.ones(3, bool)}
    keep = [0, 2]                                  # 1 is suppressed by 0
    eps = (1e-4, 1e-4)
    ok = box_set_numbers(corners[keep], cand["scores"][keep], cand, post, 100,
                         *eps)
    assert ok == {"score_gap": 0.0, "corner_gap_m": 0.0, "nms_violations": 0}
    missing = box_set_numbers(corners[[0]], cand["scores"][[0]], cand, post,
                              100, *eps)
    assert missing["nms_violations"] == 1
    both = box_set_numbers(corners, cand["scores"], cand, post, 100, *eps)
    assert both["nms_violations"] >= 1
    # a box at the score threshold may go either way
    cand["scores"][2] = post["target_args"]["score_threshold"] + 1e-6
    assert box_set_numbers(corners[[0]], cand["scores"][[0]], cand, post,
                           100, *eps)["nms_violations"] == 0


def test_import_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "coalign_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "coalign_tpu.models", object())
    assert run.forbidden_modules() == ["coalign_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import benchmark.reference.pointpillar, benchmark.reference.postprocess
import benchmark.reference.posegraph, benchmark.yardstick.scenes
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("coalign_tpu_torch", "coalign_tpu",
                                    "jax", "jaxlib", "flax"))
print(bad)
sys.exit(1 if bad else 0)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.14159265])
    y = ref.tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2 ** -10
    assert (y.view(torch.int32) & 0x1FFF == 0).all()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """A short run of each cell on the card (python -m pytest
    -m cuda benchmark/)."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]
                 if w["chips"] <= torch.cuda.device_count()]
    for cell in cells:
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell,
             "--seed", "7", "--seconds", "3", "--trace", "0"],
            capture_output=True, text=True, timeout=900, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
