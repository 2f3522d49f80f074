"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device and skip without one. They import neither
JAX nor the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from coalign_tpu_torch.kernels import rotated_iou as K
from coalign_tpu_torch.utils.iou import rotated_iou_plain, separated_pairs
from coalign_tpu_torch.utils.nms import nms_rotated

from chip_smoke import (FAR_LONG_BOXES, check_degenerate, kernel_cases,
                        seeded_corners)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _corners(shape, seed):
    """(*shape, 4, 2) car-sized boxes packed into 20 m x 20 m."""
    n = int(np.prod(shape))
    return torch.from_numpy(seeded_corners(n, seed).reshape(
        tuple(shape) + (4, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(512, 512), (40, 150), (1, 17)])
def test_kernel_matches_plain(cuda, n, m):
    # 1e-4: the same f32 function; the kernel sorts by a pseudo-angle and
    # nvcc contracts multiply-adds, a few ulp apart from the plain version
    c1, c2 = _corners((n,), 0).to(cuda), _corners((m,), 1).to(cuda)
    got = K.rotated_iou(c1, c2)
    torch.cuda.synchronize()
    assert got.shape == (n, m)
    torch.testing.assert_close(got, rotated_iou_plain(c1, c2), atol=1e-4,
                               rtol=0)
    diag = torch.diagonal(K.rotated_iou(c1, c1))
    torch.testing.assert_close(diag, torch.ones_like(diag), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ragged", "all_cleared", "identical",
                                  "identical_far", "world140"])
def test_kernel_matches_plain_on_the_smoke_cases(cuda, name):
    # chip_smoke.py's kernel-phase cases: a ragged tile edge, every pair
    # cleared by the cull (exactly 0), one box repeated (IoU 1), +-140 m
    c1, c2 = (c.to(cuda) for c in kernel_cases(name))
    got = K.rotated_iou(c1, c2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, rotated_iou_plain(c1, c2), atol=1e-4,
                               rtol=0)
    cleared = separated_pairs(c1, c2)
    assert (got[cleared] == 0).all()
    if name == "all_cleared":
        assert cleared.all()
    if name == "identical":
        torch.testing.assert_close(got, torch.ones_like(got), atol=1e-4,
                                   rtol=0)


@pytest.mark.cuda
def test_kernel_clears_no_degenerate_pair(cuda):
    # points, segments, skewed and thin boxes far from cars: the kernel must
    # compute every such pair, as the plain version does (see
    # chip_smoke.check_degenerate for why point boxes are counted)
    c1, c2 = (c.to(cuda) for c in kernel_cases("degenerate"))
    got = K.rotated_iou(c1, c2)
    torch.cuda.synchronize()
    assert not separated_pairs(c1, c2).any()
    check_degenerate(got, rotated_iou_plain(c1, c2))


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [10.0, 140.0])
def test_kernel_batch8_one_launch(cuda, spread):
    # B=8 frames of 512 boxes, dense (20 m x 20 m) and sparse (+-140 m)
    c = torch.from_numpy(np.stack([seeded_corners(512, s, spread)
                                   for s in range(8)])).to(cuda)
    before = K.rotated_iou.launches
    got = K.rotated_iou(c, c)
    assert K.rotated_iou.launches == before + 1
    torch.testing.assert_close(got, rotated_iou_plain(c, c), atol=1e-4,
                               rtol=0)
    diag = torch.diagonal(got, dim1=-2, dim2=-1)
    torch.testing.assert_close(diag, torch.ones_like(diag), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_kernel_batched_and_counted(cuda):
    c = _corners((3, 64), 2).to(cuda)
    before = K.rotated_iou.launches
    got = K.rotated_iou(c, c)
    assert K.rotated_iou.launches == before + 1
    torch.testing.assert_close(got, rotated_iou_plain(c, c), atol=1e-4,
                               rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    c = _corners((8,), 3).to(cuda)
    with pytest.raises(TypeError):
        K.rotated_iou(c.double(), c.double())
    with pytest.raises(ValueError):
        K.rotated_iou(c.transpose(1, 2).contiguous().transpose(1, 2), c)
    # an exported program calls the op itself, past the wrapper
    op = torch.ops.coalign_tpu_torch.rotated_iou
    with pytest.raises(ValueError):
        op(c.transpose(1, 2).contiguous().transpose(1, 2)[None], c[None])
    with pytest.raises(TypeError):
        op(c.double()[None], c.double()[None])


@pytest.mark.cuda
def test_nms_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(4)
    c = _corners((2, 96), 5)
    scores = torch.from_numpy(rng.uniform(0, 1, (2, 96)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(0, 1, (2, 96)) > 0.1)
    want = nms_rotated(c, scores, valid, 0.15)
    before = K.rotated_iou.launches
    got = nms_rotated(c.to(cuda), scores.to(cuda), valid.to(cuda), 0.15)
    assert K.rotated_iou.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_train_step_on_cuda_matches_cpu(cuda):
    # chip_smoke.py's train_parity: float32 loss terms and running
    # statistics within 1e-4, float64 loss terms, gradients and state
    # within 1e-6 (see its docstring for the bounds, and for why the
    # float32 gradients are not held)
    from chip_smoke import train_parity
    out = train_parity()
    assert set(out) == {"float32", "float64"}


@pytest.mark.cuda
def test_prefetch_copies_to_the_card_in_order(cuda):
    from coalign_tpu_torch.data.prefetch import prefetch
    batches = [{"x": np.full((64, 1000), i, np.float32),
                "m": np.arange(7) % 2 == i % 2} for i in range(6)]
    got = list(prefetch(iter(batches), size=2))
    assert len(got) == 6
    for i, b in enumerate(got):
        assert b["x"].device.type == "cuda" and b["m"].dtype == torch.bool
        assert bool((b["x"] == i).all())
        assert torch.equal(b["m"].cpu(), torch.from_numpy(batches[i]["m"]))


@pytest.mark.cuda
def test_stage1_on_cuda_matches_cpu(cuda):
    # chip_smoke.py's stage1 phase: the full-width stage-1 detector on the
    # recording's 5 agents, CUDA against the CPU (head maps within 2e-3,
    # box sets IoU > 0.95 and scores within 1e-3, log-variances within
    # 1e-3), one IoU launch at (5, 512)
    from chip_smoke import stage1_check
    fields, _, nms_input = stage1_check("test")
    assert fields["rotated_iou_launches"] == 1
    assert tuple(nms_input.shape) == (5, 512, 4, 2)


@pytest.mark.cuda
def test_late_and_early_requests_on_cuda_match_cpu(cuda):
    # chip_smoke.py's late and early phases: the recording's 5 agents at
    # full width, CUDA against the CPU (box sets at match_box_sets' bounds;
    # early head maps within 2e-3), 2 IoU launches a late request (the
    # joint NMS's held against the plain version), 1 an early one
    from chip_smoke import early_check, late_check
    late, joint, candidates = late_check("test")
    assert late["late"]["rotated_iou_launches"] == 2
    assert tuple(joint.shape) == (1, 500, 4, 2)
    assert late["late"]["boxes"] >= late["no"]["boxes"] > 0
    assert int(candidates.sum()) == late["late"]["candidates"]
    assert early_check("test")["rotated_iou_launches"] == 1


@pytest.mark.cuda
def test_joint_nms_with_dropped_slots_on_cuda_matches_cpu(cuda):
    # late fusion's joint NMS: slots post_process dropped hold zero boxes
    # (points at the origin), invalid, whose IoUs are rounding noise; the
    # kept boxes are the CPU's
    rng = np.random.default_rng(6)
    c = _corners((2, 300), 7)
    valid = torch.from_numpy(rng.uniform(0, 1, (2, 300)) > 0.4)
    c = torch.where(valid[..., None, None], c, 0.0)
    scores = torch.where(valid, torch.from_numpy(
        rng.uniform(0.2, 1, (2, 300)).astype(np.float32)), 0.0)
    want = nms_rotated(c, scores, valid, 0.15)
    got = nms_rotated(c.to(cuda), scores.to(cuda), valid.to(cuda), 0.15)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_stage1_step_on_cuda_matches_cpu(cuda):
    # chip_smoke.py's stage1_parity: the tiny stage-1 detector's step with
    # the uncertainty loss on a late train batch, train_parity's bounds
    from chip_smoke import (E2E_LOSS, E2E_STAGE1_ARGS, _tiny_stage1_batch,
                            train_parity)
    out = train_parity(
        _tiny_stage1_batch(),
        {"core_method": "point_pillar_uncertainty", "args": E2E_STAGE1_ARGS},
        {"core_method": "point_pillar_uncertainty_loss", "args": E2E_LOSS})
    assert "unc_loss" in out["float64"]["terms"]


@pytest.mark.cuda
def test_pose_graph_on_cuda_matches_cpu_without_a_sync(cuda):
    from chip_smoke import ORACLE_NOISE, oracle_stage1, pose_diff
    from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.posegraph import BoxAlignConfig
    from coalign_tpu_torch.posegraph.box_align import align_xyyaw
    rng = [-40, -40, -3, 40, 40, 1]
    scenes = SyntheticScenes(num_frames=3, num_agents=3, num_objects=10,
                             lidar_range=rng, agent_spread=10.0)
    frames = [scenes[i] for i in range(3)]
    batch = IntermediateFusionBatcher(
        max_cav=4, max_points=4000, max_objects=16, lidar_range=rng,
        **ORACLE_NOISE).assemble(frames)
    dets = oracle_stage1(frames, batch, 12)
    args = [dets["box_poses"], dets["box_mask"], dets["uncertainty"],
            batch["lidar_pose"], batch["agent_mask"]]
    cfg = BoxAlignConfig(abandon_hard_cases=False)
    on_card = [torch.as_tensor(a, device=cuda) for a in args]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = align_xyyaw(*on_card, cfg=cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = align_xyyaw(*[torch.as_tensor(a).double()
                         if torch.as_tensor(a).is_floating_point()
                         else torch.as_tensor(a) for a in args], cfg=cfg)
    dxy, dyaw = pose_diff(got["refined"], want["refined"])
    assert dxy <= 2e-3 and dyaw <= 2e-3, (dxy, dyaw)
    assert torch.equal(got["labels"].cpu(), want["labels"])
    assert torch.equal(got["abandoned"].cpu(), want["abandoned"])


def _trunk_tree(layer_nums, strides, filters, in_ch, seed):
    """A flax ResNetTrunk's variables (BasicBlock_0, 1, ... across its
    stages), seeded."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    g = 0
    for n, stride, out in zip(layer_nums, strides, filters):
        for pos in range(n):
            cin = in_ch if pos == 0 else out
            convs = [(3, cin), (3, out)]
            if pos == 0 and (stride != 1 or cin != out):
                convs.append((1, cin))
            block, block_stats = {}, {}
            for i, (k, c) in enumerate(convs):
                block[f"Conv_{i}"] = {"kernel": rng.normal(
                    0, 0.2, (k, k, c, out)).astype(np.float32)}
                block[f"MaskedBatchNorm_{i}"] = {
                    "scale": rng.uniform(0.5, 1.5, out).astype(np.float32),
                    "bias": rng.normal(0, 0.1, out).astype(np.float32)}
                block_stats[f"MaskedBatchNorm_{i}"] = {
                    "mean": rng.normal(0, 0.1, out).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, out).astype(np.float32)}
            params[f"BasicBlock_{g}"] = block
            stats[f"BasicBlock_{g}"] = block_stats
            in_ch = out
            g += 1
    return {"params": {"backbone": {"trunk": params}},
            "batch_stats": {"backbone": {"trunk": stats}}}


@pytest.mark.cuda
def test_stride1_stage_of_equal_width_loads_on_cuda(cuda):
    # the second stage neither strides nor widens, so none of its blocks
    # has a downsample conv: from_jax_params takes its start from
    # layer_nums
    from coalign_tpu_torch.models.layers import ResNetTrunk
    from coalign_tpu_torch.runtime import configure_cuda
    from coalign_tpu_torch.utils.weights import from_jax_params
    configure_cuda()                         # full float32 convolutions
    layer_nums, strides, filters = [1, 2], [2, 1], [16, 16]
    sd = from_jax_params(_trunk_tree(layer_nums, strides, filters, 8, 0),
                         layer_nums)
    prefix = "backbone.resnet."
    assert f"{prefix}layer1.1.conv2.weight" in sd
    trunks = {}
    for dev in ("cpu", cuda):
        trunk = ResNetTrunk(layer_nums, strides, filters, 8)
        trunk.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                              strict=True)
        trunks[str(dev)] = trunk.to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 8, 32, 32)).astype(np.float32))
    with torch.no_grad():
        want = trunks["cpu"](x)
        got = trunks["cuda"](x.to(cuda))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pointpillar_v2vnet", "pointpillar_v2xvit"])
def test_baselines_on_cuda_match_cpu(cuda, name):
    # chip_smoke.py's baselines phase without its timing: the yaml's model
    # at full width on the recording's agents, CUDA against the CPU (head
    # maps within 2e-3, box sets IoU > 0.95 and scores within 1e-3, at
    # least 10 boxes), one IoU launch a request
    import os

    from chip_smoke import (BASELINE_MIN_BOXES, GOLDEN, baseline_parity,
                            counted_call)
    state_dict = torch.load(os.path.join(GOLDEN, "fullscale_multiscale.pth"),
                            map_location="cpu", weights_only=True)
    fields, infer, batch = baseline_parity(name, state_dict)
    assert fields["boxes"] >= BASELINE_MIN_BOXES
    assert fields["seeded_fusion_tensors"] > 0
    assert counted_call(infer, batch)[1] == 1


@pytest.mark.cuda
def test_recorded_baselines_on_cuda(cuda):
    # chip_smoke.py's baseline_recordings: DiscoNet's and V2VNet's
    # reference checkpoints on CUDA reproduce their recordings within 2e-4
    from chip_smoke import baseline_recordings
    errs = baseline_recordings()
    assert set(errs) == {"disconet", "v2vnet"}


@pytest.mark.cuda
def test_native_data_plane_feeds_the_card(cuda, tmp_path):
    # the C++ reader and batcher on a fixture tree, the batches copied to
    # the card equal to the host's
    from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
    from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
    from coalign_tpu_torch.data.opv2v import OPV2VBaseDataset
    from coalign_tpu_torch.data.prefetch import prefetch
    from coalign_tpu_torch.data.synthetic import SyntheticScenes

    from chip_smoke import LATE_RANGE
    tree = write_opv2v_fixture(str(tmp_path / "tree"), SyntheticScenes(
        num_frames=2, num_agents=2, num_objects=3, lidar_range=LATE_RANGE,
        points_per_object=32, ground_points=300, seed=3),
        frames_per_scenario=2)
    base = OPV2VBaseDataset(tree, train=False)
    batcher = IntermediateFusionBatcher(max_cav=2, max_points=200,
                                        max_objects=8, lidar_range=LATE_RANGE)
    host = list(batcher.batches(base, 1, shuffle=False))
    for h, d in zip(host, prefetch(batcher.batches(base, 1, shuffle=False),
                                   device=cuda)):
        for key, value in h.items():
            assert torch.equal(d[key].cpu(), torch.as_tensor(value)), key


@pytest.mark.cuda
def test_device_cache_replays_on_the_card(cuda):
    from coalign_tpu_torch.data.device_cache import DeviceBatchCache
    source = [{"x": np.full(256, i, np.float32)} for i in range(4)]
    cache = DeviceBatchCache(max_bytes=3 * 1024, device=cuda)
    first = list(cache.epoch(source))
    second = list(cache.epoch(source))
    assert cache.num_cached == 3 and cache.cached_bytes == 3 * 1024
    assert all(b["x"].is_cuda for b in second)
    assert all(a["x"] is b["x"] for a, b in zip(first[:3], second[:3]))
    assert [int(b["x"][0]) for b in second] == [0, 1, 2, 3]


@pytest.mark.cuda
def test_pose_robust_steps_on_cuda_match_cpu(cuda):
    # chip_smoke.py's rest_parity for robust V2VNet (stage 1) and MASH:
    # train_parity's bounds
    from chip_smoke import rest_parity
    out = rest_parity()
    assert set(out) == {"robust", "mash", "where2comm", "kd"}
    assert "pose_loss" in out["robust"]["float64"]["terms"]
    assert "corr_entropy" in out["mash"]["float64"]["terms"]
    assert "kd_loss" in out["kd"]["float64"]["terms"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pointpillar_where2comm", "deform"])
def test_fusions_rest_on_cuda_match_cpu(cuda, name):
    # chip_smoke.py's fusions_rest phase without its timing
    import os

    from chip_smoke import GOLDEN, baseline_parity, counted_call, rest_config
    state_dict = torch.load(os.path.join(GOLDEN, "fullscale_multiscale.pth"),
                            map_location="cpu", weights_only=True)
    fields, infer, batch = baseline_parity(name, state_dict,
                                           rest_config(name))
    assert counted_call(infer, batch)[1] == 1
    if name == "pointpillar_where2comm":
        assert 0 < fields["sent_pixels"] <= fields["neighbor_pixels"]


@pytest.mark.cuda
def test_kd_step_on_cuda_matches_cpu(cuda):
    from chip_smoke import E2E_ARGS, E2E_LOSS, E2E_RANGE, E2E_SCENES
    from chip_smoke import train_parity
    from coalign_tpu_torch.data.batch import KDFusionBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    scenes = SyntheticScenes(**E2E_SCENES)
    batch = KDFusionBatcher(max_cav=3, max_points=2500, max_objects=16,
                            lidar_range=E2E_RANGE).assemble(
        [scenes[0], scenes[1]])
    args = {k: v for k, v in E2E_ARGS.items()
            if k not in ("fusion_method", "att")}
    out = train_parity(batch, {"core_method": "point_pillar_disconet",
                               "args": args},
                       {"core_method": "point_pillar_disconet_loss",
                        "args": {**E2E_LOSS, "kd": {"weight": 1.0}}},
                       {"core_method": "point_pillar_disconet_teacher",
                        "args": args})
    assert out["float64"]["terms"]["kd_loss"] > 0


@pytest.mark.cuda
def test_sparse_conv_ops_on_cuda_match_cpu(cuda):
    # the SECOND path's voxel ops on the card against the CPU: keys, valid
    # rows and rulebooks equal, features within 1e-5 (float32 sums in
    # another order), on 3 frames of 0.1 m voxels, one of them overflowing
    # its cap of 300 voxels
    from coalign_tpu_torch.ops import sparse_conv as S
    from coalign_tpu_torch.ops.voxels import VoxelSpec
    spec = VoxelSpec.from_config([-8.0, -8.0, -3.0, 8.0, 8.0, 1.0],
                                 [0.1, 0.1, 0.1])
    rng = np.random.default_rng(3)
    pts = np.zeros((3, 2000, 4), np.float32)
    pts[..., :3] = rng.uniform([-8, -8, -3], [8, 8, 1], (3, 2000, 3))
    pts[:2, 400:, :3] = rng.uniform([-1, -1, -2], [1, 1, -1.5], (2, 1600, 3))
    mask = rng.uniform(size=(3, 2000)) > 0.1
    w1 = torch.from_numpy(rng.normal(0, 0.1, (3, 3, 3, 4, 8)).astype(
        np.float32))
    w2 = torch.from_numpy(rng.normal(0, 0.1, (3, 3, 3, 8, 8)).astype(
        np.float32))

    def run(dev):
        g = S.sparse_mean_voxelize(torch.from_numpy(pts).to(dev),
                                   torch.from_numpy(mask).to(dev), spec, 300,
                                   pad_z=1)
        rb = S.subm_rulebook(g)
        x = S.subm_conv(g, w1.to(dev), rulebook=rb)
        s2 = S.downsample_active(x)
        y = S.strided_conv(x, w2.to(dev), s2)
        over = S.occupancy_overflow(torch.from_numpy(pts).to(dev),
                                    torch.from_numpy(mask).to(dev), spec, 300)
        return [t.cpu() for t in (g.keys, rb[0], rb[1], x.feats, s2.keys,
                                  y.feats, S.to_dense(y), over)]

    got, want = run(cuda), run("cpu")
    assert int(want[-1].max()) > 0                 # a frame overflows
    for i, (g, w) in enumerate(zip(got, want)):
        if g.is_floating_point():
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
        else:
            assert torch.equal(g, w), i


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["second_intermediate", "SECOND"])
def test_second_on_cuda_matches_cpu(cuda, name):
    # chip_smoke.py's second phase without its timing: the yaml's model at
    # full width, B = 1, 5 agents, CUDA against the CPU (head maps within
    # 2e-3 of max(1, the map's largest), the same box set), the IoU
    # launches of a request (2 for late fusion)
    from chip_smoke import second_parity
    fields, _, _, _ = second_parity(name, "test")
    assert fields["rotated_iou_launches"] == (
        2 if fields["fusion"] == "late" else 1)
    assert fields["seeded"]["boxes"][0] > 0


@pytest.mark.cuda
def test_second_recordings_on_cuda(cuda):
    # chip_smoke.py's second_recordings: second.pth and
    # second_intermediate.pth on CUDA, dense twin and sparse backbone,
    # within tests/test_ckpt_import.py's bounds
    from chip_smoke import second_recordings
    assert set(second_recordings()) == {
        "second_dense", "second_sparse", "second_intermediate_dense",
        "second_intermediate_sparse"}


@pytest.mark.cuda
def test_second_step_on_cuda_matches_cpu(cuda):
    # chip_smoke.py's second_parity: a tiny SECOND-SSFA's step on the
    # sparse backbone, CUDA against the CPU at train_parity's bounds
    from chip_smoke import second_step_parity
    assert set(second_step_parity()) == {"float32", "float64"}


@pytest.mark.cuda
def test_cell_indices_on_cuda_match_cpu(cuda):
    # voxel and pillar cells on the card equal the CPU's (IEEE division):
    # a Python-scalar divisor let CUDA multiply by its reciprocal, which
    # moved 10 of 150,000 coordinates of SECOND.yaml's scenes to the
    # neighbouring cell
    from coalign_tpu_torch.ops.pillars import PillarSpec, pillar_ids
    from coalign_tpu_torch.ops.voxels import VoxelSpec, voxel_ids
    rng = np.random.default_rng(5)
    lr = [-140.8, -40.0, -3.0, 140.8, 40.0, 1.0]
    pts = np.zeros((2, 500_000, 4), np.float32)
    pts[..., :3] = rng.uniform(lr[:3], lr[3:], (2, 500_000, 3))
    pts[1, :, 2] = -1.9                  # a plane on a 0.1 m cell boundary
    mask = np.ones((2, 500_000), bool)
    for ids_fn, spec in (
            (voxel_ids, VoxelSpec.from_config(lr, [0.1, 0.1, 0.1])),
            (pillar_ids, PillarSpec.from_config(lr, [0.4, 0.4, 4.0]))):
        got = ids_fn(torch.from_numpy(pts).to(cuda),
                     torch.from_numpy(mask).to(cuda), spec)
        want = ids_fn(torch.from_numpy(pts), torch.from_numpy(mask), spec)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_periods_and_direction_bins_on_cuda_match_cpu(cuda):
    # fault 10: limit_period and the direction bins divide by a tensor, so
    # that yaws at and one ulp beside k pi / 2 and k 2 pi, and 1M random
    # ones, wrap and bin on the card as on the CPU (chip_smoke's periods
    # phase)
    from chip_smoke import periods_check
    assert periods_check()["bins_equal"]


@pytest.mark.cuda
def test_far_long_boxes_keep_their_iou_with_themselves(cuda):
    # fault 11: with its point-in-quad edges taken from world coordinates,
    # the kernel gave these DAIR-V2X stage-1 boxes (10 m x 2.2 m at ~100 m)
    # an IoU with themselves of 0 and 1/3; the edges now come from the
    # translated corners, as the plain version's
    c = torch.from_numpy(FAR_LONG_BOXES).to(cuda)
    got = torch.diagonal(K.rotated_iou(c, c))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, torch.ones_like(got), atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_lss_cells_on_cuda_match_cpu(cuda):
    # fault 12: the splat's cells divide by a tensor, so that the
    # full-width LSS geometry (4.6M frustum points) and 1M points on and
    # one ulp beside cell boundaries land in the same cells on the card as
    # on the CPU (chip_smoke's lss_cells phase)
    from chip_smoke import lss_cells_check
    assert lss_cells_check()["equal"]


@pytest.mark.cuda
def test_lss_on_cuda_matches_cpu(cuda):
    # the tiny LSS (chip_smoke.LSS_TINY, att_ms, supervise_single) on
    # rendered views: float32 eval maps within 1e-4 of each map's largest;
    # under bfloat16 float32 heads, finite, within tests/test_bf16.py's
    # mean relative distance (0.15) of the CPU's bfloat16 maps; a train
    # step within train_parity's bounds
    from chip_smoke import (LSS_TINY, LSS_TINY_ANCHORS, LSS_TINY_LOSS,
                            _lss_tiny_batch, train_parity)
    from coalign_tpu_torch.inference import to_device
    from coalign_tpu_torch.models.layers import set_compute_dtype
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.runtime import configure_cuda
    configure_cuda()
    batch = _lss_tiny_batch()
    models = {dev: build_model(LSS_TINY, device=dev, seed=0)
              for dev in ("cpu", "cuda")}
    try:
        for policy in (None, torch.bfloat16):
            set_compute_dtype(policy)
            with torch.no_grad():
                want = models["cpu"](to_device(batch, "cpu"))
                got = models["cuda"](to_device(batch, cuda))
            for key, w in want.items():
                g = got[key].cpu()
                assert g.dtype == w.dtype == torch.float32, key
                assert torch.isfinite(g).all(), key
                if policy is None:
                    err = (g - w).abs().max()
                    assert err <= 1e-4 * w.abs().max(), (key, float(err))
                else:
                    dist = (g - w).abs().mean() / w.abs().mean()
                    assert dist < 0.15, (key, float(dist))
    finally:
        set_compute_dtype(None)
    train_parity(batch, LSS_TINY, LSS_TINY_LOSS, anchor_args=LSS_TINY_ANCHORS)
