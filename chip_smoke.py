"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:
  1. card    the GPU's name and power limit (nvidia-smi);
  2. build   nvcc builds the rotated-IoU kernel into coalign_tpu_torch/_build/
             and reports ptxas's registers, stack frame and spills;
  3. kernel  the kernel against its plain PyTorch version on the seeded
             cases of kernel_cases(), with the share of pairs that the
             kernel's separation cull clears;
  4. full    the CoAlign flagship at full width (200x704 canvas, 5 agents,
             ResNet [3,5,8] x [64,128,256], att fusion at 3 scales, K=512
             NMS prefilter) with the reference checkpoint, against the
             reference's own recording: head maps and the final box set;
             the main path's kernel launches are counted here;
  5. serve   20 timed requests of the full-width infer fn (CUDA events);
     profile torch.profiler over 5 more: device and host time per stage
             of the forward and post-processing, the device's busy share;
  6. ap      AP30/50/70 of the tiny flagship on the 10 recorded frames;
Then one JSON line describing each kernel, timed at three shapes (the main
path's NMS input; that input stacked 8 times, a B=8 batch's one launch; 8
frames of densely packed boxes) beside its bound and the time of one launch
that writes the same output (out.zero_()), the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Any failed check raises,
so the exit code is not 0. make_infer_fn runs float32 in full float32
(TF32 off) and lets cuDNN autotune (runtime.configure_cuda).

The goldens are read in place from tests/golden/; nothing of JAX or of the
coalign_tpu package is imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")

# The full-width flagship of tests/test_golden_fullscale.py (FULL_ARGS,
# ANCHOR_ARGS) and the tiny one of tests/test_golden_e2e.py (TINY_ARGS,
# ANCHOR_ARGS); those modules import JAX, so the dicts are repeated here.
FULL_ARGS = {
    "voxel_size": [0.4, 0.4, 4.0],
    "lidar_range": [-140.8, -40.0, -3.0, 140.8, 40.0, 1.0],
    "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [64],
                   "pad_parity": True},
    "point_pillar_scatter": {"num_features": 64},
    "base_bev_backbone": {"layer_nums": [3, 5, 8], "layer_strides": [2, 2, 2],
                          "num_filters": [64, 128, 256],
                          "upsample_strides": [1, 2, 4],
                          "num_upsample_filter": [128, 128, 128],
                          "resnet": True},
    "fusion_method": "att",
    "att": {"feat_dim": [64, 128, 256]},
    "shrink_header": {"kernal_size": [3], "stride": [1], "padding": [1],
                      "dim": [256], "input_dim": 384},
    "dir_args": {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]},
}
FULL_ANCHORS = {"W": 704, "H": 200, "l": 3.9, "w": 1.6, "h": 1.56,
                "r": [0, 90], "num": 2, "feature_stride": 2,
                "vw": 0.4, "vh": 0.4, "vd": 4.0,
                "cav_lidar_range": FULL_ARGS["lidar_range"]}
TINY_ARGS = {
    "voxel_size": [0.4, 0.4, 4.0],
    "lidar_range": [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0],
    "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [64],
                   "pad_parity": True},
    "point_pillar_scatter": {"num_features": 64},
    "base_bev_backbone": {"layer_nums": [2, 2], "layer_strides": [2, 2],
                          "num_filters": [32, 64], "upsample_strides": [1, 2],
                          "num_upsample_filter": [64, 64], "resnet": True},
    "shrink_header": {"kernal_size": [3], "stride": [1], "padding": [1],
                      "dim": [64], "input_dim": 128},
    "dir_args": {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]},
    "fusion_method": "att",
    "att": {"feat_dim": [32, 64]},
}
TINY_ANCHORS = {"W": 64, "H": 64, "l": 3.9, "w": 1.6, "h": 1.56,
                "r": [0, 90], "num": 2, "feature_stride": 2,
                "vw": 0.4, "vh": 0.4, "vd": 4.0,
                "cav_lidar_range": TINY_ARGS["lidar_range"]}

# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

T0 = time.time()


def phase(name: str, **fields):
    print(json.dumps({"phase": name, "elapsed_s": round(time.time() - T0, 3),
                      **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def seeded_corners(n: int, seed: int, spread: float = 10.0) -> np.ndarray:
    """(n, 4, 2) BEV corners of car-sized boxes with centres in
    [-spread, spread]^2; by default packed into 20 m x 20 m, so that many
    pairs overlap."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(-spread, spread, n), rng.uniform(-spread, spread, n)
    w, l = rng.uniform(1.5, 2.0, n), rng.uniform(3.5, 4.5, n)
    yaw = rng.uniform(-np.pi, np.pi, n)
    tmpl = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]]) / 2.0
    lx, ly = tmpl[None, :, 0] * l[:, None], tmpl[None, :, 1] * w[:, None]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    return np.stack([lx * c - ly * s + cx[:, None],
                     lx * s + ly * c + cy[:, None]], -1).astype(np.float32)


KERNEL_CASES = ("512x512", "40x150", "ragged", "all_cleared", "identical",
                "world140", "degenerate")


def degenerate_corners(seed: int) -> np.ndarray:
    """(64, 4, 2) degenerate boxes over x in [-140, 140], y in [20, 140]:
    16 collapsed to a point, 16 to a 4 m segment, 16 skewed (8
    parallelograms sheared 30 degrees, 8 kites) and 16 thin (0.05 m x
    4 m), each at a random yaw."""
    rng = np.random.default_rng(seed)
    shapes = np.concatenate([
        np.zeros((16, 4, 2)),
        np.tile([[-2.0, 0], [2, 0], [2, 0], [-2, 0]], (16, 1, 1)),
        np.tile([[-2.0, -0.9], [2, -0.9], [2 + 1.04, 0.9], [-2 + 1.04, 0.9]],
                (8, 1, 1)),
        np.tile([[-2.0, 0], [0, -0.5], [2, 0], [0, 0.5]], (8, 1, 1)),
        np.tile([[-2.0, -0.025], [2, -0.025], [2, 0.025], [-2, 0.025]],
                (16, 1, 1))])
    yaw = rng.uniform(-np.pi, np.pi, 64)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    x, y = shapes[..., 0], shapes[..., 1]
    centre = np.stack([rng.uniform(-140, 140, 64), rng.uniform(20, 140, 64)],
                      -1)[:, None]
    return (np.stack([x * c - y * s, x * s + y * c], -1)
            + centre).astype(np.float32)


def kernel_cases(name: str):
    """The kernel phase's inputs, (corners1, corners2) on the CPU:
    512x512, 40x150   seeded boxes packed into 20 m x 20 m;
    ragged            (3, 517) against (3, 131): neither a multiple of the
                      kernel's 32 x 32 tile;
    all_cleared       two 16 x 16 grids of cars, 50 m apart, the second
                      shifted by 25 m: every pair is cleared;
    identical         one box 256 times against itself: every IoU is 1;
    world140          512 cars over +-140 m against 256 jittered copies of
                      them and 256 others;
    degenerate        the 64 boxes of degenerate_corners, far from 256 cars
                      over x in [-140, 140], y in [-140, 0], against those
                      cars and themselves: the cull must clear none of
                      their pairs."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    if name in ("512x512", "40x150"):
        n, m, seed = (512, 512, 0) if name == "512x512" else (40, 150, 1)
        return t(seeded_corners(n, seed)), t(seeded_corners(m, seed + 100))
    if name == "ragged":
        return (t(seeded_corners(3 * 517, 2).reshape(3, 517, 4, 2)),
                t(seeded_corners(3 * 131, 3).reshape(3, 131, 4, 2)))
    if name == "all_cleared":
        grid = 50.0 * np.stack(np.meshgrid(np.arange(16), np.arange(16)),
                               -1).reshape(-1, 1, 2) - 375.0
        cars = seeded_corners(256, 4, spread=0.0)
        return t(cars + grid), t(cars[::-1] + grid + 25.0)
    if name == "identical":
        box = seeded_corners(1, 5, spread=30.0)
        return t(np.repeat(box, 256, 0)), t(np.repeat(box, 256, 0))
    if name == "world140":
        c1 = seeded_corners(512, 6, spread=140.0)
        jitter = np.random.default_rng(7).normal(0, 0.5, (256, 1, 2))
        return t(c1), t(np.concatenate(
            [c1[:256] + jitter, seeded_corners(256, 8, spread=140.0)]))
    if name == "degenerate":
        cars = seeded_corners(256, 9, spread=140.0)
        cy = cars[:, :, 1].mean(1, keepdims=True)
        cars[..., 1] += cy / 2 - 72.0 - cy       # centres into [-142, -2]
        odd = degenerate_corners(10)
        return t(odd), t(np.concatenate([cars, odd]))
    raise KeyError(name)


def check_degenerate(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The kernel (``got``) against its plain version (``want``) on
    kernel_cases("degenerate"), whose boxes the cull must never clear. The
    segments, skewed and thin boxes (rows 16-63) have a well-defined IoU:
    within 1e-4 of the plain version, and never exactly 0 where it is not.
    A point box's IoU with any box is a ratio of two rounding errors (every
    point lies "inside" it; the union cancels to a few ulp) in the kernel,
    in the plain version and in the JAX package alike, so which of its pairs
    come out 0 differs between them; a cull would make all of them 0, so
    the kernel must give at least half as many nonzero values as the plain
    version on rows 0-15."""
    err = (got[16:] - want[16:]).abs().max().item()
    zeroed = int(((got[16:] == 0) & (want[16:] != 0)).sum())
    point_nonzero = int((got[:16] != 0).sum())
    plain_point_nonzero = int((want[:16] != 0).sum())
    check(err <= 1e-4, f"kernel vs plain, degenerate boxes: {err:.2e}")
    check(zeroed == 0, f"kernel gives 0 on {zeroed} degenerate pairs")
    check(plain_point_nonzero > 0
          and point_nonzero >= plain_point_nonzero / 2,
          f"point boxes: {point_nonzero} nonzero IoUs in the kernel, "
          f"{plain_point_nonzero} in the plain version")
    return {"max_abs_diff": err, "point_nonzero": point_nonzero,
            "plain_point_nonzero": plain_point_nonzero}


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, name: str | None = None):
    """Device time per call of ``fn``, from the profiler's kernel records
    (CUPTI): the time of the kernels whose name contains ``name`` (all of
    them when None), summed over ``reps`` calls and divided by ``reps``.
    Unlike CUDA events around a loop of calls, this leaves out the host's
    launch overhead. None when the profiler recorded no such kernel."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and (name is None or name in e.key))
    return total_us / reps / 1e3 if total_us > 0 else None


def iou_ops(c1: torch.Tensor, c2: torch.Tensor) -> float:
    """The f32 operations that the rotated-IoU function needs on these boxes
    (a multiply-add counts 2, a divide, square root or comparison 1), each
    value computed once, whatever a kernel spends:
      per box  57: its 4 edge vectors (8) and its shoelace area (16); for
                the separation test its centre (8) and its reach, the
                largest centre-to-corner distance plus half the margin (25).
                The kernel's guard against degenerate boxes (the shortest
                edge, square corners) belongs to its cull's design, not to
                the function, and is not charged;
      per cleared pair 8: the separation test (the centre difference 2, its
                squared length 3, the reaches' sum and its square 2, the
                comparison 1); such a pair's IoU is 0 without more work;
      per surviving pair 356: the 16 vertex differences between the two
                quads (32); the 32 vertex-against-edge cross products (96),
                which decide the 8 point-in-quad tests (2 comparisons each,
                64) and are the numerators of the crossings' t and u; the 16
                edge-edge denominators (48) with their eps test (16); t and
                u (32 divides) with their range tests (64); the IoU from the
                areas (4);
      per valid crossing 4, for its point;
      per surviving pair with c >= 3 candidates 13c + log2(c!): the
                centroid (2c), the pseudo-angle keys (7c), the shoelace sum
                (4c), and the sort's comparisons, log2(c!) being the fewest
                any comparison sort needs on average.
    The cleared pairs come from separated_pairs, c and the valid crossings
    from the plain version's own tests in its frame, on these boxes."""
    from coalign_tpu_torch.utils.iou import (_points_in_quad,
                                             _segment_intersections,
                                             separated_pairs)
    n, m = c1.shape[-3], c2.shape[-3]
    origin = c1[..., :, None, 0:1, :]
    q1 = (c1[..., :, None, :, :] - origin).expand(c1.shape[:-3] + (n, m, 4, 2))
    q2 = c2[..., None, :, :, :] - origin
    xing = _segment_intersections(q1, q2)[1].sum(-1).double()
    cnt = (_points_in_quad(q1, q2).sum(-1) + _points_in_quad(q2, q1).sum(-1)
           + xing).double()
    sort = torch.lgamma(cnt + 1) / np.log(2.0)
    survivor = 356 + 4 * xing + torch.where(cnt >= 3, 13 * cnt + sort, 0.0)
    per_pair = torch.where(separated_pairs(c1, c2), 8.0, survivor)
    boxes = c1.shape[:-3].numel() * (n + m)
    return float(per_pair.sum()) + 57 * boxes


def time_shape(c: torch.Tensor) -> dict:
    """The kernel on ``c`` against itself: its device time, its bound, the
    share of pairs its cull clears, the device time of one launch that
    writes the same output (``out.zero_()``), its difference from the plain
    version and the plain version's device time."""
    from coalign_tpu_torch.kernels import rotated_iou as K
    from coalign_tpu_torch.utils.iou import rotated_iou_plain, separated_pairs
    got = K.rotated_iou(c, c)
    want = rotated_iou_plain(c, c)
    err = (got - want).abs().max().item()
    check(err <= 1e-4, f"kernel vs plain on {list(c.shape)}: {err:.2e}")
    ops = iou_ops(c, c)
    ops_ms = ops / PEAK_F32_OPS * 1e3
    bytes_ms = (c.numel() * 4 * 2 + got.numel() * 4) / PEAK_BYTES * 1e3
    kernel_ms = device_ms(lambda: K.rotated_iou(c, c), 100,
                          "rotated_iou_kernel")
    out = torch.empty_like(got)
    floor_ms = device_ms(out.zero_, 100)
    check(kernel_ms is not None and floor_ms is not None,
          "the profiler recorded no device time")
    bound = max(ops_ms, bytes_ms)
    check(bound <= kernel_ms, f"kernel on {list(c.shape)} faster than its "
          f"bound: {kernel_ms:.3e} < {bound:.3e} ms")
    return {"shape": list(c.shape), "pairs": got.numel(), "max_abs_err": err,
            "cleared_share": float(separated_pairs(c, c).double().mean()),
            "ops": ops, "kernel_ms": kernel_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "share": bound / kernel_ms, "write_floor_ms": floor_ms,
            "plain_ms": device_ms(lambda: rotated_iou_plain(c, c), 10)}


def profile_requests(infer, batch, reps: int = 5) -> dict:
    """Where one request's time goes: torch.profiler over ``reps`` requests.
    Per stage (the "stage/..." ranges of the model's forward and of
    make_infer_fn), the device time of the kernels launched inside it and
    the host time of the range, each per request; the device kernels' total
    per request and their share of the request's wall time; the five
    kernels with the most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    infer(batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            infer(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    events = prof.key_averages()
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    stages = {e.key[len("stage/"):]: {
        "device_ms": e.device_time_total / reps / 1e3,
        "host_ms": e.cpu_time_total / reps / 1e3}
        for e in events if e.device_type == cpu and e.key.startswith("stage/")}
    # a range can also appear on the device timeline under its own name
    kernels = sorted((e for e in events if e.device_type == gpu
                      and not e.key.startswith("stage/")),
                     key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    return {"requests": reps, "stages": stages,
            "request_wall_ms": wall_ms,
            "device_kernel_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "top_kernels": [[e.key[:72],
                             e.self_device_time_total / reps / 1e3,
                             e.count // reps] for e in kernels[:5]]}


def golden_batch(io, keys, pairwise, n_points: int) -> dict:
    """The padded B=1 batch of a recorded frame: one agent per point-cloud
    key of ``io``, padded to ``n_points``."""
    points = np.zeros((1, len(keys), n_points, 4), np.float32)
    pmask = np.zeros((1, len(keys), n_points), bool)
    for a, key in enumerate(keys):
        pts = io[key]
        points[0, a, :len(pts)] = pts
        pmask[0, a, :len(pts)] = True
    return {"points": points, "point_mask": pmask,
            "agent_mask": np.ones((1, len(keys)), bool),
            "pairwise_t_matrix": pairwise,
            "transformation_matrix": np.eye(4, dtype=np.float32)[None]}


def fullscale_batch():
    """The recorded full-width frame of fullscale_io.npz and its io."""
    io = np.load(os.path.join(GOLDEN, "fullscale_io.npz"))
    keys = [f"points_{a}" for a in range(io["pairwise"].shape[1])]
    n_points = max(len(io[k]) for k in keys)
    return golden_batch(io, keys, io["pairwise"], n_points), io


def match_box_sets(ours_c, ours_s, ref_c, ref_s):
    """Greedy 1:1 match of the reference boxes to ours (as in
    tests/test_golden_fullscale.py): same count, IoU > 0.95, score
    difference < 1e-3; raises AssertionError otherwise. Returns (min IoU,
    max score difference)."""
    from coalign_tpu_torch.utils.iou import rotated_iou_plain
    check(len(ours_c) == len(ref_c),
          f"box count {len(ours_c)} vs reference {len(ref_c)}")
    iou = rotated_iou_plain(torch.from_numpy(ref_c[:, :4, :2].copy()),
                            torch.from_numpy(ours_c[:, :4, :2].copy())).numpy()
    taken = np.zeros(len(ours_c), bool)
    worst_iou, worst_ds = 1.0, 0.0
    for i in range(len(ref_c)):
        masked = np.where(taken, -1.0, iou[i])
        j = int(np.argmax(masked))
        taken[j] = True
        worst_iou = min(worst_iou, float(masked[j]))
        worst_ds = max(worst_ds, abs(float(ref_s[i] - ours_s[j])))
    check(worst_iou > 0.95, f"unmatched box: best IoU {worst_iou:.4f}")
    check(worst_ds < 1e-3, f"score drift {worst_ds:.2e}")
    return worst_iou, worst_ds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    from coalign_tpu_torch.inference import evaluate, make_infer_fn, to_device
    from coalign_tpu_torch.kernels import rotated_iou as K
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.utils import nms as nms_module
    from coalign_tpu_torch.utils.iou import rotated_iou_plain, separated_pairs
    from coalign_tpu_torch.utils.weights import load_pth

    card = card_line()
    phase("card", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    # 2. build
    t = time.time()
    lib, log = K.build()
    phase("build", seconds=round(time.time() - t, 3), library=lib.name,
          ptxas=[ln.strip() for ln in log.splitlines() if "Used" in ln
                 or "spill" in ln])

    # 3. kernel against its plain version (1e-4: same f32 function; the
    # kernel keys its sort by a pseudo-angle instead of atan2 and nvcc
    # contracts multiply-adds, which moves results by a few ulp)
    dev = torch.device("cuda")
    cases = {}
    for name in KERNEL_CASES:
        c1, c2 = (c.to(dev) for c in kernel_cases(name))
        got = K.rotated_iou(c1, c2)
        torch.cuda.synchronize()
        cleared = separated_pairs(c1, c2)
        if name == "degenerate":
            check(not bool(cleared.any()), "a degenerate pair was cleared")
            cases[name] = {"shapes": [list(c1.shape), list(c2.shape)],
                           **check_degenerate(got, rotated_iou_plain(c1, c2))}
            continue
        self_iou = K.rotated_iou(c1, c1)
        err = (got - rotated_iou_plain(c1, c2)).abs().max().item()
        diag = (torch.diagonal(self_iou, dim1=-2, dim2=-1) - 1).abs().max()
        check(err <= 1e-4, f"kernel vs plain {name}: {err:.2e}")
        check(diag.item() <= 1e-4, f"self-IoU diagonal {name}: {diag:.2e}")
        check(bool((got[cleared] == 0).all()),
              f"{name}: a cleared pair is not exactly 0")
        if name == "all_cleared":
            check(bool(cleared.all()), "all_cleared: a pair was not cleared")
        if name == "identical":
            check((got - 1).abs().max().item() <= 1e-4,
                  "identical boxes: an IoU is not 1")
        cases[name] = {"shapes": [list(c1.shape), list(c2.shape)],
                       "max_abs_diff": err, "diag_err": diag.item(),
                       "cleared_share": float(cleared.double().mean()),
                       "overlapping_pairs": int((got > 0).sum())}
    phase("kernel", cases=cases)

    # 4. full width against the reference's recording
    batch, io = fullscale_batch()
    n_agents, n_points = batch["points"].shape[1:3]
    model = build_model({"core_method": "point_pillar_baseline_multiscale",
                         "args": FULL_ARGS})
    load_pth(model, os.path.join(GOLDEN, "fullscale_multiscale.pth"))
    cfg = {"target_args": {"score_threshold": float(io["score_threshold"])},
           "nms_thresh": float(io["nms_thresh"]),
           "gt_range": FULL_ARGS["lidar_range"],
           "dir_args": FULL_ARGS["dir_args"], "max_num": 100}
    infer = make_infer_fn(model, generate_anchor_box(FULL_ANCHORS), cfg)

    # the NMS input of this frame, kept to time the kernel on it below
    captured = []
    kernel_fn = nms_module.rotated_iou

    def capture(c1, c2):
        captured.append(c1.clone())
        return kernel_fn(c1, c2)

    nms_module.rotated_iou = capture
    try:
        infer(batch)
    finally:
        nms_module.rotated_iou = kernel_fn

    K.rotated_iou.launches = 0
    dets = infer(batch)                       # the main path, counted
    torch.cuda.synchronize()
    launches = K.rotated_iou.launches
    check(launches >= 1, "the main path launched no rotated_iou kernel")

    with torch.no_grad():
        maps = model(to_device(batch, dev))
    map_err = {}
    for key in ("cls_preds", "reg_preds", "dir_preds"):
        got = maps[key].float().cpu().numpy()
        check(np.isfinite(got).all(), f"{key} not finite")
        check(got.shape == io[key].shape, f"{key} shape {got.shape}")
        map_err[key] = float(np.abs(got - io[key]).max())
        check(map_err[key] < 2e-3, f"{key} max err {map_err[key]:.2e}")
    dets = {k: v.cpu().numpy() for k, v in dets.items()}
    keep = dets["mask"][0]
    worst_iou, worst_ds = match_box_sets(
        dets["corners3d"][0][keep], dets["scores"][0][keep],
        io["pred_corners"], io["pred_scores"])
    phase("full", map_max_abs_err=map_err, boxes=int(keep.sum()),
          min_matched_iou=worst_iou, max_score_diff=worst_ds,
          rotated_iou_launches=launches)

    # 5. serve a few requests
    per_call = event_ms(lambda: infer(batch), reps=20, warmup=3)
    phase("serve", requests=20, ms_per_frame=per_call,
          frames_per_s=1000.0 / per_call, points_per_agent=n_points,
          agents=n_agents, canvas=[200, 704], card=card)
    phase("profile", **profile_requests(infer, batch), card=card)

    # 6. AP of the tiny flagship on the 10 recorded frames
    io_ap = np.load(os.path.join(GOLDEN, "e2e_ap_io.npz"))
    tiny = build_model({"core_method": "point_pillar_baseline_multiscale",
                        "args": TINY_ARGS})
    load_pth(tiny, os.path.join(GOLDEN, "coalign_multiscale.pth"))
    cfg_ap = {"target_args": {"score_threshold":
                              float(io_ap["score_threshold"])},
              "nms_thresh": float(io_ap["nms_thresh"]),
              "gt_range": TINY_ARGS["lidar_range"],
              "dir_args": TINY_ARGS["dir_args"], "max_num": 100}
    infer_ap = make_infer_fn(tiny, generate_anchor_box(TINY_ANCHORS), cfg_ap)
    frames = []
    for i in range(int(io_ap["num_frames"])):
        frame = golden_batch(io_ap, (f"ego_points_{i}", f"cav_points_{i}"),
                             io_ap[f"pairwise_{i}"], 512)
        frame["gt_corners"] = [io_ap[f"gt_corners_{i}"]]
        frames.append(frame)
    ap = evaluate(infer_ap, frames)
    for key in ("ap30", "ap50", "ap70"):
        ref = float(io_ap[key])
        check(abs(ap[key] - ref) <= 0.005,
              f"{key}: {ap[key]:.4f} vs reference {ref:.4f}")
    phase("ap", **ap, reference={k: float(io_ap[k])
                                 for k in ("ap30", "ap50", "ap70")})

    # the kernel on the main path's own input (one frame's 512 boxes), on
    # that input stacked 8 times (the NMS of a B=8 batch, one launch) and on
    # 8 frames of boxes packed into 20 m x 20 m (the cull's worst case)
    c = captured[0]
    shapes = {"main_path": c,
              "batch8": c.expand(8, -1, -1, -1).contiguous(),
              "dense": torch.from_numpy(np.stack(
                  [seeded_corners(c.shape[1], s) for s in range(8)])).to(dev)}
    timed = {name: time_shape(x) for name, x in shapes.items()}
    # per call with CUDA events (host launch overhead included)
    kernel_call_ms = event_ms(lambda: K.rotated_iou(c, c), reps=200)
    plain_call_ms = event_ms(lambda: rotated_iou_plain(c, c), reps=20)
    main = timed["main_path"]
    print(json.dumps({"kernels": [{
        "name": "rotated_iou",
        "route": "cuda",
        "source": "coalign_tpu_torch/csrc/rotated_iou.cu",
        "replaces": "coalign_tpu/ops/pallas_iou.py:220",
        "tpu_kernel": "coalign_tpu/ops/pallas_iou.py:_iou_kernel",
        "shape": main["shape"],
        "launches": launches,
        "launches_per_frame": launches,
        "max_abs_err": main["max_abs_err"],
        "max_abs_diff": main["max_abs_err"],
        "ms": main["kernel_ms"],
        "kernel_ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        "ms_source": "profiler",
        "call_ms": kernel_call_ms,
        "plain_call_ms": plain_call_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "share": main["share"],
        "cleared_share": main["cleared_share"],
        "write_floor_ms": main["write_floor_ms"],
        "library_ms": None,
        "shapes": timed,
        "card": card,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
