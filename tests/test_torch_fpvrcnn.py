"""The two-stage models (FPV-RCNN, FVoxelRCNN) of the port against the JAX
package's, on the CPU, at tests/test_fpvrcnn.py's sizes (a 32 m square at
0.4 m, an 80 x 80 grid, 64 keypoints, 8 RoIs, 4 x 4 RoI grids): 2 agents in
3 slots (the third padded) with non-identity poses, seeded weights
(from_jax_params; norms seeded, the cls head rescaled so that stage-1
scores spread and boxes survive):

  * the eval-mode forward of both models: the stage-1 maps (``*_single``)
    and boxes, the RoIs (the matcher clusters the agents' boxes in their
    own frames, as the JAX package does, ROADMAP §3), ``roi_mask``,
    ``boxes_refined`` and ``roi_cls`` within 1e-4 of each tensor's largest,
    the masks equal;
  * FPV-RCNN's train-mode forward in float64 (the JAX package's float32
    pins patched to float64, as tests/test_torch_second.py does, the
    keypoint modules' too): outputs within 1e-8 of each tensor's largest,
    and every running statistic of the VSA and RoI-grid set abstractions
    after it within 1e-8 of the JAX batch_stats;
  * make_infer_fn's refined decode (post_process_refined) gives the JAX
    make_infer_fn's box set;
  * roi_stage2_loss and FpvRcnnLoss against the JAX functions within 1e-5,
    with zero-padded RoIs and gt (fault 4: the padding changes no term and
    no gradient, all finite); the RoI x gt IoU refuses boxes on the
    autograd graph.

tests/test_torch_fpvrcnn_train.py holds the train step and the CLI.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.inference import make_infer_fn as jax_make_infer_fn
from coalign_tpu.loss import build_loss as jax_build_loss
from coalign_tpu.loss.fpvrcnn_loss import roi_stage2_loss as jax_stage2
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.models import fpvrcnn as JFPV
from coalign_tpu.models import layers as JLAYERS
from coalign_tpu.models import matcher as JM
from coalign_tpu.models import vsa as JVSA
from coalign_tpu.ops import pointnet2 as JPN2
from coalign_tpu.ops import warp as JWARP
from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.inference import make_infer_fn
from coalign_tpu_torch.loss import build_loss
from coalign_tpu_torch.loss.fpvrcnn_loss import roi_box_iou, roi_stage2_loss
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
from coalign_tpu_torch.utils.weights import from_jax_params

from test_torch_flagship import _randomize_norms

torch.set_num_threads(2)
LIDAR_RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
VOXEL = [0.4, 0.4, 0.5]
ANCHOR_ARGS = {"W": 80, "H": 80, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
               "vw": 0.4, "vh": 0.4, "feature_stride": 8,
               "cav_lidar_range": LIDAR_RANGE}
BASE = {"voxel_size": VOXEL, "lidar_range": LIDAR_RANGE, "anchor_number": 2,
        "anchor_args": ANCHOR_ARGS,
        "stage1_postprocess": {"score_threshold": 0.1, "nms_thresh": 0.15,
                               "max_boxes": 8},
        "max_rois": 8, "roi_grid_size": 4, "roi_hidden": 64,
        "ssfa": {"feature_num": 64}}
VSA = {"vsa": {"enlarge_selection_boxes": True, "num_keypoints": 64,
               "num_out_features": 16,
               "features_source": ["bev", "raw_points"],
               "sa_layer": {"raw_points": {"mlps": [[8, 8], [8, 8]],
                                           "pool_radius": [0.4, 0.8],
                                           "n_sample": [8, 8]}}},
       "roi_head": {"roi_grid_pool": {"grid_size": 4,
                                      "mlps": [[16, 16], [16, 16]],
                                      "pool_radius": [0.8, 1.6],
                                      "n_sample": [8, 8]}}}
CONFIGS = {"fpvrcnn": {"core_method": "fpvrcnn", "args": {**BASE, **VSA}},
           "fvoxelrcnn": {"core_method": "fvoxelrcnn", "args": BASE}}
LOSS = {"core_method": "fpvrcnn_loss",
        "args": {"pos_cls_weight": 2.0,
                 "cls": {"alpha": 0.25, "gamma": 2.0, "weight": 2.0},
                 "reg": {"sigma": 3.0, "weight": 2.0},
                 "stage2": {"stage": 2, "cls_weight": 1.0,
                            "reg_weight": 1.0}}}


def make_batch(seed: int = 5) -> dict:
    """1 frame of 2 agents in 3 slots (the third padded), 512 points an
    agent, the agents' poses apart in place and heading."""
    scenes = SyntheticScenes(num_frames=1, num_agents=2, num_objects=3,
                             lidar_range=LIDAR_RANGE, points_per_object=48,
                             ground_points=128, seed=seed)
    batch = IntermediateFusionBatcher(
        max_cav=3, max_points=512, max_objects=8, lidar_range=LIDAR_RANGE,
        native=False).assemble([scenes[0]])
    tfm = batch["pairwise_t_matrix"][0, 1, 0]
    assert abs(tfm[0, 1]) > 0.1 and np.abs(tfm[:2, 3]).max() > 1.0
    assert batch["agent_mask"].tolist() == [[True, True, False]]
    return batch


def torch_batch(batch: dict, dtype=torch.float32) -> dict:
    return {k: (torch.from_numpy(np.array(v)).to(dtype)
                if np.issubdtype(np.asarray(v).dtype, np.floating)
                else torch.from_numpy(np.array(v)))
            for k, v in batch.items()}


def seeded_pair(name: str, batch: dict, key: int = 0):
    """(JAX model, its variables, the port model with the same weights):
    norms seeded, then the cls head rescaled so that each anchor's median
    logit is -5 and its 16th largest 0 (a seeded trunk's logits lie close
    together, and near-equal stage-1 scores would rank by rounding)."""
    cfg = CONFIGS[name]
    jmodel = jax_build_model(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(key), jbatch, train=False)),
        np.random.default_rng(key + 1))
    out = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables,
                                                                jbatch)
    logits = np.asarray(out["cls_preds_single"]).reshape(-1, 2)
    med, kth = np.median(logits, 0), np.sort(logits, 0)[-16]
    scale = 5.0 / np.maximum(kth - med, 1e-30)
    head = variables["params"]["DetectionHeads_0"]["cls_head"]
    head["kernel"] = (head["kernel"] * scale).astype(np.float32)
    head["bias"] = (head["bias"] * scale - 5.0 - scale * med).astype(
        np.float32)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(variables), strict=True)
    return jmodel, variables, model


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


KEYS = ("cls_preds_single", "reg_preds_single", "iou_preds_single",
        "stage1_boxes", "stage1_scores", "rois", "roi_scores",
        "boxes_refined", "roi_cls", "scores_refined")


def _hold(got: dict, want: dict, tol: float):
    for key in ("stage1_valid", "roi_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in KEYS:
        w = np.asarray(want[key])
        if w.ndim == 4:
            w = w.transpose(0, 3, 1, 2)
        _close(got[key].detach().numpy(), w, tol, key)


def _pair_and_outputs(name: str):
    """(batch, JAX model, variables, port model, JAX eval outputs)."""
    batch = make_batch()
    jmodel, variables, model = seeded_pair(name, batch)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, jmodel, variables, model, want


@pytest.fixture(scope="module")
def fpv():
    """FPV-RCNN's case, shared by the tests that only read it."""
    return _pair_and_outputs("fpvrcnn")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_models_match_jax(name, fpv):
    batch, _, _, model, want = (fpv if name == "fpvrcnn"
                                else _pair_and_outputs(name))
    with torch.no_grad():
        got = model(torch_batch(batch))
    assert got["rois"].shape == (1, 8, 7)
    # boxes of both agents survive, and the matcher fuses them
    valid = np.asarray(want["stage1_valid"]).reshape(3, 8)
    assert valid[0].any() and valid[1].any() and not valid[2].any()
    assert np.asarray(want["roi_mask"]).sum() >= 2
    _hold(got, want, 1e-4)


@pytest.fixture
def float64_jax(monkeypatch):
    """The JAX package's float32 pins read float64 for one test: its norms'
    statistics (models/layers.py), the warp's grid (ops/warp.py) and the
    keypoint modules' casts (models/vsa.py, ops/pointnet2.py,
    models/fpvrcnn.py); the matcher's greedy scan carries int32 cluster
    indices, which an x64 arange would widen, so its aranges stay int32
    (models/matcher.py). Nothing in the package changes."""
    patch_float64(monkeypatch)
    with jax.enable_x64(True):
        yield


def patch_float64(monkeypatch):
    """float64_jax's patches (the x64 context aside)."""
    import types
    jnp64 = types.ModuleType("jax.numpy")
    jnp64.__dict__.update(vars(jnp))
    jnp64.float32 = jnp.float64
    for mod in (JLAYERS, JWARP, JVSA, JPN2, JFPV):
        monkeypatch.setattr(mod, "jnp", jnp64)
    jnp_m = types.ModuleType("jax.numpy")
    jnp_m.__dict__.update(vars(jnp))
    jnp_m.arange = lambda *a, dtype=None, **k: jnp.arange(
        *a, dtype=dtype or jnp.int32, **k)
    monkeypatch.setattr(JM, "jnp", jnp_m)


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating)
        else jnp.asarray(a), tree)


def as_port(tree: dict, col: str = "params") -> dict:
    """A float64 flax collection as float64 port state-dict entries, read
    through from_jax_params (float32) as two parts, hi + lo."""
    hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    lo = jax.tree_util.tree_map(
        lambda a, h: (np.asarray(a, np.float64) - h).astype(np.float32),
        tree, hi)
    hi, lo = (from_jax_params({col: t}) for t in (hi, lo))
    return {k: hi[k].double() + lo[k].double() for k in hi
            if not k.endswith("num_batches_tracked")}


def test_train_forward_and_norms_match_jax_in_float64(fpv, float64_jax):
    batch, jmodel, variables, model, _ = fpv
    model = copy.deepcopy(model)
    want, upd = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=True, mutable=["batch_stats"]))(_float64(variables),
                                                    _float64(batch))
    assert np.asarray(want["rois"]).dtype == np.float64
    model = model.double().train()
    with torch.no_grad():
        got = model(torch_batch(batch, torch.float64))
    _hold(got, want, 1e-8)
    new = as_port(upd["batch_stats"], "batch_stats")
    state = model.state_dict()
    keys = [k for k in new if k.startswith(("vsa.", "roi_grid_pool."))]
    assert len(keys) == 2 * (1 + 4 + 4)
    for key in keys:
        _close(state[key].numpy(), new[key].numpy(), 1e-8, key)


def test_infer_fn_refined_decode_matches_jax(fpv):
    batch, jmodel, variables, model, _ = fpv
    post = {"target_args": {"score_threshold": 0.2}, "nms_thresh": 0.15,
            "gt_range": LIDAR_RANGE}
    anchors = generate_anchor_box(ANCHOR_ARGS)
    jinfer = jax_make_infer_fn(jmodel, anchors, post)
    want = {k: np.asarray(v) for k, v in jinfer(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}).items()}
    got = {k: v.numpy() for k, v in make_infer_fn(
        model, anchors, post, device="cpu")(batch).items()}
    assert got["corners3d"].shape == (1, 8, 8, 3)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert want["mask"].sum() >= 1
    m = want["mask"]
    np.testing.assert_allclose(got["scores"][m], want["scores"][m], atol=1e-5)
    np.testing.assert_allclose(got["corners3d"][m], want["corners3d"][m],
                               atol=1e-4)
    assert not got["corners3d"][~m].any()


def _stage2_case(pad: int):
    """RoIs (two padded, zero), refined boxes, confidences and gt (three
    padded, zero) of 2 frames, ``pad`` more zero RoIs and gt appended."""
    rng = np.random.default_rng(9)
    gt = np.concatenate([rng.uniform(-10, 10, (2, 5, 3)),
                         np.broadcast_to([1.5, 1.7, 4.0], (2, 5, 3)),
                         rng.uniform(-3, 3, (2, 5, 1))], -1)
    gt[:, 3:] = 0.0
    rois = np.concatenate([gt[:, :3] + rng.normal(0, 0.4, (2, 3, 7)),
                           gt[:, :3] + rng.normal(0, 1.5, (2, 3, 7)),
                           rng.uniform(-10, 10, (2, 2, 7)),
                           np.zeros((2, 2, 7))], 1)
    rois[:, :8, 3:6] = np.abs(rois[:, :8, 3:6]) + 0.5
    roi_mask = np.arange(10)[None].repeat(2, 0) < 8
    gt_mask = np.arange(5)[None].repeat(2, 0) < 3
    refined = rois + rng.normal(0, 0.2, rois.shape) * roi_mask[..., None]
    cls = rng.normal(0, 1.0, (2, 10))
    if pad:
        def zpad(a, axis_len):
            return np.concatenate([a, np.zeros(a.shape[:1] + (pad,)
                                               + a.shape[2:], a.dtype)], 1)
        rois, refined, cls, roi_mask = (zpad(a, 10) for a in
                                        (rois, refined, cls, roi_mask))
        gt, gt_mask = zpad(gt, 5), zpad(gt_mask, 5)
    f32 = np.float32
    return ({"rois": rois.astype(f32), "roi_mask": roi_mask,
             "roi_cls": cls.astype(f32), "boxes_refined": refined.astype(f32)},
            gt.astype(f32), gt_mask)


def test_stage2_loss_matches_jax_and_ignores_padding():
    outs, gt, gt_mask = _stage2_case(0)
    want = [float(v) for v in jax_stage2(
        {k: jnp.asarray(v) for k, v in outs.items()}, jnp.asarray(gt),
        jnp.asarray(gt_mask))]
    assert want[0] > 0 and want[1] > 0
    results = []
    for pad in (0, 4):
        outs, gt, gt_mask = _stage2_case(pad)
        t = {k: torch.from_numpy(v) for k, v in outs.items()}
        t["roi_cls"].requires_grad_(True)
        t["boxes_refined"].requires_grad_(True)
        cls_l, reg_l = roi_stage2_loss(t, torch.from_numpy(gt),
                                       torch.from_numpy(gt_mask))
        (cls_l + reg_l).backward()
        grads = [t[k].grad[:, :10].numpy() for k in ("roi_cls",
                                                     "boxes_refined")]
        assert all(np.isfinite(g).all() for g in grads)
        if pad:                            # padded RoIs get no gradient
            assert not t["roi_cls"].grad[:, 10:].any()
            assert not t["boxes_refined"].grad[:, 10:].any()
        results.append(([cls_l.item(), reg_l.item()], grads))
    np.testing.assert_allclose(results[0][0], want, rtol=1e-5)
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-6)
    for a, b in zip(results[0][1], results[1][1]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
    # the IoU takes no boxes on the autograd graph
    with pytest.raises(ValueError, match="detached"):
        roi_box_iou(t["boxes_refined"], torch.from_numpy(gt))


def test_fpvrcnn_loss_matches_jax(fpv):
    """FpvRcnnLoss on the model's outputs: stage 1 on per-agent labels
    (the labels' ``_single`` entries) and stage 2 on the gt, against the
    JAX loss; without gt only stage 1, without ``_single`` labels on a
    multi-agent batch stage 2 alone, as in the JAX package."""
    from coalign_tpu.postprocess import anchors as JANC
    from coalign_tpu_torch.postprocess.anchors import (
        assign_targets_per_agent, make_anchor_spec)
    batch, _, _, model, out = fpv
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    targets = {"pos_threshold": 0.6, "neg_threshold": 0.45}
    jspec = JANC.make_anchor_spec(ANCHOR_ARGS, targets)
    singles = jax.vmap(lambda g, m, p, a: JANC.assign_targets_per_agent(
        g, m, p, a, jspec))(jbatch["gt_boxes"], jbatch["gt_mask"],
                            jbatch["lidar_pose_clean"], jbatch["agent_mask"])
    tb = torch_batch(batch)
    got_singles = assign_targets_per_agent(
        tb["gt_boxes"], tb["gt_mask"], tb["lidar_pose_clean"],
        tb["agent_mask"], make_anchor_spec(ANCHOR_ARGS, targets))
    for key, value in singles.items():
        np.testing.assert_allclose(got_singles[key].numpy(), np.asarray(
            value).reshape(got_singles[key].shape), atol=1e-5, err_msg=key)
    assert got_singles["pos_equal_one"].sum() > 0
    jlabels = {k + "_single": np.asarray(v).reshape((-1,) + v.shape[2:])
               for k, v in singles.items()}
    with torch.no_grad():
        got_out = model(tb)
    loss, jloss = build_loss(LOSS), jax_build_loss(LOSS)
    gt = {"gt_boxes": batch["gt_boxes"], "gt_mask": batch["gt_mask"]}
    for labels in ({**jlabels, **gt}, jlabels, gt):
        _, want = jloss(out, {k: jnp.asarray(v) for k, v in labels.items()})
        _, got = loss(got_out, {k: torch.from_numpy(np.array(v))
                                for k, v in labels.items()})
        assert set(got) == set(want)
        for key, w in want.items():
            np.testing.assert_allclose(float(got[key]), float(w), rtol=1e-5,
                                       atol=1e-7, err_msg=key)
    # without "_single" labels stage 1 adds nothing on this 3-agent batch
    assert set(got) == {"stage2_cls", "stage2_reg", "total_loss"}
