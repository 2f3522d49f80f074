"""Late and early fusion and the stage-1 train step in the port against the
JAX package, on the CPU, at a narrow size: a 24 x 24 pillar canvas (0.8 m
pillars over +-9.6 m), so that each agent frame has 288 anchors and the
plain IoU of an NMS costs ~0.4 s a frame.

  * LateFusionBatcher's assemble, assemble_train and batches(train=True),
    and EarlyFusionBatcher's assemble, give the JAX batchers' batches for
    the same seed (integer and bool arrays equal, floats within 1e-6; the
    JAX batchers held to their numpy path, as tests/test_torch_data.py
    does);
  * late inference in the modes late, no and no_w_uncertainty, at B = 2
    with a padded agent slot in each frame: the JAX fn's boxes, corners
    within 1e-4 m, scores within 1e-5, masks equal; early fusion through
    make_infer_fn the same way;
  * AP of late and no fusion through make_fusion_infer_fn equals the JAX
    evaluate's;
  * one stage-1 train step (point_pillar_uncertainty, the uncertainty
    loss) on a late train batch against coalign_tpu.train.make_train_step
    from the same weights, at tests/test_torch_train.py's bounds.

The detector's weights come from 40 JAX steps on late train batches (as
tests/test_late_inference.py trains its model), so that real boxes come
out: each test asserts how many.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.data import batch as JBATCH
from coalign_tpu.data import SyntheticScenes as JaxScenes
from coalign_tpu.inference import evaluate as jax_evaluate
from coalign_tpu.inference import make_infer_fn as jax_make_infer_fn
from coalign_tpu.inference import make_late_infer_fn as jax_make_late_infer_fn
from coalign_tpu.loss import build_loss as jax_build_loss
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.postprocess import anchors as JANC
from coalign_tpu.train import TrainState
from coalign_tpu.train import build_optimizer as jax_build_optimizer
from coalign_tpu.train import create_train_state
from coalign_tpu.train import make_train_step as jax_make_train_step
from coalign_tpu_torch.data.batch import (EarlyFusionBatcher,
                                          IntermediateFusionBatcher,
                                          LateFusionBatcher)
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.inference import (evaluate, gt_corners,
                                         make_fusion_infer_fn, make_infer_fn,
                                         make_late_infer_fn)
from coalign_tpu_torch.loss import build_loss
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.postprocess.anchors import (generate_anchor_box,
                                                   make_anchor_spec)
from coalign_tpu_torch.train import make_train_step
from coalign_tpu_torch.utils.weights import from_jax_params

from test_torch_data import _assert_same
from test_torch_flagship import _randomize_norms
from test_torch_train import SGD_LR, _close_to_scale, _recording_sgd

torch.set_num_threads(1)

LR = [-9.6, -9.6, -3.0, 9.6, 9.6, 1.0]
DIR_ARGS = {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]}
ARGS = {
    "voxel_size": [0.8, 0.8, 4.0], "lidar_range": LR, "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [16]},
    "point_pillar_scatter": {"num_features": 16},
    "base_bev_backbone": {"layer_nums": [2, 2], "layer_strides": [2, 2],
                          "num_filters": [16, 32],
                          "upsample_strides": [1, 2],
                          "num_upsample_filter": [32, 32], "resnet": False},
    "dir_args": DIR_ARGS,
}
LAYER_NUMS = ARGS["base_bev_backbone"]["layer_nums"]
DETECTOR = {"core_method": "point_pillar", "args": ARGS}
STAGE1 = {"core_method": "point_pillar_uncertainty",
          "args": {**ARGS, "uncertainty_dim": 3}}
ANCHOR_ARGS = {"W": 24, "H": 24, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
               "vw": 0.8, "vh": 0.8, "feature_stride": 2,
               "cav_lidar_range": LR}
TARGETS = {"pos_threshold": 0.6, "neg_threshold": 0.45}
POST = {"target_args": {"score_threshold": 0.2}, "nms_thresh": 0.15,
        "gt_range": LR, "dir_args": DIR_ARGS, "max_num": 100}
LOSS = {"pos_cls_weight": 2.0,
        "cls": {"alpha": 0.25, "gamma": 2.0, "weight": 2.0},
        "reg": {"sigma": 3.0, "weight": 2.0},
        "dir": {"weight": 0.2, "args": DIR_ARGS}}
UNC_LOSS = {"core_method": "point_pillar_uncertainty_loss",
            "args": {**LOSS, "uncertainty": {"xy_loss_type": "l2"}}}
SCENES = dict(num_frames=4, num_agents=2, num_objects=4, lidar_range=LR,
              points_per_object=150, ground_points=300, agent_spread=3.0,
              object_spread=0.6, seed=9)
# max_cav 3: a padded agent slot in every 2-agent frame; 600 points:
# subsampled clouds; pose noise: the generator draws noise too
BATCHER = dict(max_cav=3, max_points=600, max_objects=8, lidar_range=LR,
               pos_std=0.3, rot_std=1.0, seed=5)


@pytest.fixture(autouse=True)
def jax_numpy_batcher(monkeypatch):
    monkeypatch.setattr(JBATCH, "_native", None)


def _assert_same_batch(got, want):
    assert set(got) == set(want)
    for key in want:
        _assert_same(got[key], want[key], key)


# ------------------------------------------------------------- batchers


def test_late_batcher_matches_jax():
    scenes, jscenes = SyntheticScenes(**SCENES), JaxScenes(**SCENES)
    frames = [scenes[i] for i in range(3)]
    got, want = LateFusionBatcher(**BATCHER, native=False), \
        JBATCH.LateFusionBatcher(**BATCHER)
    train = got.assemble_train(frames)
    _assert_same_batch(train, want.assemble_train(frames))
    assert train["points"].shape == (3, 1, 600, 4)
    assert train["pairwise_t_matrix"].shape == (3, 1, 1, 4, 4)
    # the picked agent's own frame: its gt differs from the ego's for a
    # frame whose non-ego agent was drawn
    test = got.assemble(frames)
    _assert_same_batch(test, want.assemble(frames))
    assert test["transformation_matrix"].shape == (3, 3, 4, 4)
    assert not np.allclose(test["transformation_matrix"][:, 1],
                           np.eye(4))                   # noisy, non-ego
    np.testing.assert_array_equal(test["transformation_matrix"][:, 2],
                                  np.tile(np.eye(4), (3, 1, 1)))  # padded
    picked_other = ~np.all(np.isclose(train["gt_boxes"], test["gt_boxes"]),
                           axis=(1, 2))
    assert picked_other.any()


def test_train_mode_batches_match_jax():
    scenes, jscenes = SyntheticScenes(**SCENES), JaxScenes(**SCENES)
    got = LateFusionBatcher(**BATCHER, train=True, native=False)
    want = JBATCH.LateFusionBatcher(**BATCHER, train=True)
    pairs = list(zip(got.batches(scenes, 2), want.batches(jscenes, 2)))
    assert len(pairs) == 2
    for bg, bw in pairs:
        _assert_same_batch(bg, bw)
        assert bg["agent_mask"].shape == (2, 1)
    # the train flag of the intermediate batcher changes nothing: it has no
    # assemble_train
    inter = IntermediateFusionBatcher(**BATCHER, train=True, native=False)
    jinter = JBATCH.IntermediateFusionBatcher(**BATCHER, train=True)
    for bg, bw in zip(inter.batches(scenes, 2), jinter.batches(jscenes, 2)):
        _assert_same_batch(bg, bw)
        assert bg["agent_mask"].shape == (2, 3)


def test_early_batcher_matches_jax():
    scenes = SyntheticScenes(**SCENES)
    frames = [scenes[i] for i in range(3)]
    got = EarlyFusionBatcher(**BATCHER, native=False).assemble(frames)
    want = JBATCH.EarlyFusionBatcher(**BATCHER).assemble(frames)
    _assert_same_batch(got, want)
    assert got["points"].shape == (3, 1, 1800, 4)
    assert (got["shipped_points"] > 0).all()
    # projection moved the non-ego points, not the ego's
    inter = IntermediateFusionBatcher(**BATCHER, native=False).assemble(
        frames)
    np.testing.assert_array_equal(got["points"][:, 0, :600],
                                  inter["points"][:, 0])
    assert not np.allclose(got["points"][:, 0, 600:1200],
                           inter["points"][:, 1])


# ------------------------------------------------- trained weights, models


@pytest.fixture(scope="module")
def trained():
    """The tiny detector after 40 JAX Adam steps (lr 3e-3) on a late train
    batch of the 4 scenes, in both packages."""
    scenes = JaxScenes(**SCENES)
    batcher = JBATCH.LateFusionBatcher(**BATCHER)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBATCH, "_native", None)
        train_batch = batcher.assemble_train([scenes[i] for i in range(4)])
    jbatch = {k: jnp.asarray(v) for k, v in train_batch.items()}
    jmodel = jax_build_model(DETECTOR)
    spec = JANC.make_anchor_spec(ANCHOR_ARGS, TARGETS, "hwl")
    state = create_train_state(jmodel, jbatch, jax_build_optimizer(
        {"lr": 3e-3, "args": {}}, None), jax.random.PRNGKey(0))
    step = jax_make_train_step(jmodel, jax_build_loss(LOSS), spec)
    for _ in range(40):
        state, metrics = step(state, jbatch)
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})
    model = build_model(DETECTOR, device="cpu")
    model.load_state_dict(from_jax_params(variables, LAYER_NUMS),
                          strict=True)
    return {"jmodel": jmodel, "variables": variables, "model": model,
            "anchors": generate_anchor_box(ANCHOR_ARGS),
            "loss": float(metrics["total_loss"])}


def _late_batch():
    scenes = SyntheticScenes(**SCENES)
    return LateFusionBatcher(**BATCHER).assemble([scenes[0], scenes[1]])


def _assert_same_dets(got, want, min_boxes):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want) == {"corners3d", "scores", "mask"}
    for key in want:
        assert got[key].shape == want[key].shape, key
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_allclose(got["corners3d"], want["corners3d"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    counts = want["mask"].sum(-1)
    assert (counts >= min_boxes).all(), counts
    return counts


@pytest.mark.parametrize("mode", ["late", "no", "no_w_uncertainty"])
def test_late_inference_matches_jax(trained, mode):
    batch = _late_batch()
    assert batch["agent_mask"].sum() == 4 and not batch["agent_mask"].all()
    want = jax_make_late_infer_fn(trained["jmodel"], trained["anchors"],
                                  POST, mode)(
        trained["variables"], {k: jnp.asarray(v) for k, v in batch.items()})
    # the port serves 'no_w_uncertainty' through the dispatch, as mode 'no'
    got = make_fusion_infer_fn(trained["model"], trained["anchors"], POST,
                               mode, device="cpu")(batch)
    assert got["corners3d"].shape == (2, 300, 8, 3)
    counts = _assert_same_dets(got, want, 2)
    if mode == "late":
        # both agents' boxes reach the joint NMS
        ego = make_late_infer_fn(trained["model"], trained["anchors"], POST,
                                 "no", device="cpu")(batch)
        assert (counts >= ego["mask"].sum(-1).numpy()).all()


def test_late_inference_broadcasts_one_transform_over_agents(trained):
    batch = _late_batch()
    infer = make_late_infer_fn(trained["model"], trained["anchors"], POST,
                               device="cpu")
    per_agent = dict(batch, transformation_matrix=np.tile(
        np.eye(4, dtype=np.float32), (2, 3, 1, 1)))
    shared = dict(batch, transformation_matrix=np.tile(
        np.eye(4, dtype=np.float32), (2, 1, 1)))
    want = infer(shared)
    for key, value in infer(per_agent).items():
        assert torch.equal(want[key], value), key


def test_early_inference_matches_jax(trained):
    scenes = SyntheticScenes(**SCENES)
    batch = EarlyFusionBatcher(**BATCHER).assemble([scenes[0], scenes[1]])
    want = jax_make_infer_fn(trained["jmodel"], trained["anchors"], POST)(
        trained["variables"], {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: want[k] for k in ("corners3d", "scores", "mask")}
    got = make_infer_fn(trained["model"], trained["anchors"], POST,
                        device="cpu")(batch)
    assert got["corners3d"].shape == (2, 100, 8, 3)
    _assert_same_dets({k: got[k] for k in want}, want, 2)


@pytest.mark.parametrize("fusion", ["late", "no"])
def test_ap_through_the_dispatch_matches_jax_evaluate(trained, fusion):
    batcher_args = dict(BATCHER, pos_std=0.0, rot_std=0.0)
    want = jax_evaluate(trained["jmodel"], trained["variables"],
                        JBATCH.LateFusionBatcher(**batcher_args),
                        JaxScenes(**SCENES), trained["anchors"], POST,
                        batch_size=2, fusion_method=fusion)
    frames = [dict(b, gt_corners=gt_corners(b)) for b in
              LateFusionBatcher(**batcher_args, native=False).batches(
                  SyntheticScenes(**SCENES), 2, shuffle=False,
                  drop_last=False)]
    got = evaluate(make_fusion_infer_fn(trained["model"], trained["anchors"],
                                        POST, fusion, device="cpu"), frames)
    assert got["frames"] == want["frames"] == 4
    for key in ("ap30", "ap50", "ap70"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert want["ap30"] > 0.05


def test_dispatch_picks_the_infer_fn(trained):
    batch = _late_batch()
    args = (trained["model"], trained["anchors"], POST)
    late = make_late_infer_fn(*args, "no", device="cpu")(batch)
    for fusion in ("single", "no_w_uncertainty"):
        ego = make_fusion_infer_fn(*args, fusion, device="cpu")(batch)
        for key, value in late.items():
            assert torch.equal(ego[key], value), (fusion, key)
    with pytest.raises(ValueError, match="late inference mode"):
        make_late_infer_fn(*args, "no_w_uncertainty", device="cpu")
    inter = make_fusion_infer_fn(*args, "early", device="cpu")(
        EarlyFusionBatcher(**BATCHER).assemble(
            [SyntheticScenes(**SCENES)[0]]))
    assert inter["corners3d"].shape == (1, 100, 8, 3)
    with pytest.raises(ValueError, match="fusion method"):
        make_fusion_infer_fn(*args, "v2vnet", device="cpu")


# ------------------------------------------------- one stage-1 train step


def _jax_labels(batch, jit: bool):
    spec = JANC.make_anchor_spec(ANCHOR_ARGS, TARGETS, "hwl")

    def labels(gt, mask):
        return jax.vmap(lambda g, m: JANC.assign_targets(g, m, spec))(gt,
                                                                      mask)
    return jax.tree_util.tree_map(np.asarray, (jax.jit(labels) if jit else
                                               labels)(
        jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["gt_mask"])))


def test_stage1_train_step_on_a_late_batch_matches_jax():
    # In float64 on both sides (the JAX step under jax.enable_x64, with
    # float64 weights and points; the gt boxes, and so the labels, float32
    # in both), where a ReLU input within rounding of 0 cannot move a
    # gradient as it can in float32 (tests/test_torch_train.py). The two
    # agree to ~3e-6 of each gradient's scale and ~1e-6 of each loss term:
    # each package keeps a few float32 constants.
    #
    # A gt box whose standup box contains two anchors' standup boxes has
    # the same IoU with both, and the argmax that assigns it an anchor
    # breaks that tie by rounding: the JAX package's jitted assignment (the
    # one its train step runs) and its eager one (which the port's equals,
    # tests/test_torch_train.py) pick different anchors on most batches of
    # this coarse grid. The batch here is one on which the two agree, so
    # that the step's comparison is about the step; the check says so.
    scenes = SyntheticScenes(**SCENES)
    batch = LateFusionBatcher(**dict(BATCHER, seed=6)).assemble_train(
        [scenes[0], scenes[1]])
    assert batch["agent_mask"].shape == (2, 1)
    eager, jitted = _jax_labels(batch, False), _jax_labels(batch, True)
    for key in ("pos_equal_one", "neg_equal_one"):
        np.testing.assert_array_equal(jitted[key], eager[key], err_msg=key)
    assert eager["pos_equal_one"].sum() == 8
    jmodel = jax_build_model(STAGE1)
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(3),
        {k: jnp.asarray(v) for k, v in batch.items()}, train=False)),
        np.random.default_rng(4))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                     variables)
        state = TrainState.create(apply_fn=jmodel.apply,
                                  params=v64["params"],
                                  batch_stats=v64["batch_stats"],
                                  tx=_recording_sgd(SGD_LR))
        jbatch = {k: jnp.asarray(v, jnp.float64)
                  if v.dtype == np.float32 and k != "gt_boxes"
                  else jnp.asarray(v) for k, v in batch.items()}
        new, metrics = jax_make_train_step(
            jmodel, jax_build_loss(UNC_LOSS),
            JANC.make_anchor_spec(ANCHOR_ARGS, TARGETS, "hwl"),
            donate=False)(state, jbatch)
        new = jax.tree_util.tree_map(np.asarray, new)
        metrics = {k: float(v) for k, v in metrics.items()}
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(
        new.opt_state)} == {np.dtype(np.float64)}

    model = build_model(STAGE1, device="cpu").double()
    model.load_state_dict(from_jax_params(variables, LAYER_NUMS),
                          strict=True)
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
    terms = make_train_step(model, build_loss(UNC_LOSS),
                            make_anchor_spec(ANCHOR_ARGS, TARGETS), opt,
                            device="cpu")(batch)
    assert terms["total_loss"].dtype == torch.float64
    assert set(terms) == set(metrics) and "unc_loss" in terms
    for key, want in metrics.items():
        np.testing.assert_allclose(float(terms[key]), want, rtol=1e-5,
                                   err_msg=key)
    assert float(terms["unc_loss"]) > 1e-3
    want_grads = from_jax_params({"params": new.opt_state}, LAYER_NUMS)
    grads = dict(model.named_parameters())
    assert set(want_grads) == set(grads)
    for key, want in want_grads.items():
        _close_to_scale(grads[key].grad.numpy(), want.numpy(), 1e-5,
                        f"grad {key}")
    assert np.abs(want_grads["unc_head.weight"].numpy()).max() > 0
    state_dict = model.state_dict()
    for key, want in from_jax_params({"params": new.params},
                                     LAYER_NUMS).items():
        np.testing.assert_allclose(state_dict[key].numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=key)
    stats = from_jax_params({"batch_stats": new.batch_stats}, LAYER_NUMS)
    moved = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert moved
    for key in moved:
        _close_to_scale(state_dict[key].numpy(), stats[key].numpy(), 1e-5,
                        key)


def test_smoke_configurations_equal_their_sources():
    # chip_smoke.py runs where JAX is not installed, so it carries copies
    # of the late, early and stage-1 yamls' sections and of
    # tests/test_late_inference.py's setup; they must not drift
    import os

    import chip_smoke as S
    import test_late_inference as L
    from coalign_tpu_torch.config.yaml_utils import load_yaml

    def yaml(name):
        return load_yaml(os.path.join(os.path.dirname(L.__file__), os.pardir,
                                      "coalign_tpu", "hypes_yaml", "opv2v",
                                      name))

    def with_resnet(model):
        # the smoke copies name the ResNet trunk (the yamls' default) and
        # leave out the grid size that the yaml's parser derives
        return {**model, "point_pillar_scatter": {"num_features": 64},
                "base_bev_backbone": {**model["base_bev_backbone"],
                                      "resnet": True}}

    for name in ("pointpillar_early.yaml", "pointpillar_late.yaml"):
        y = yaml(name)
        assert y["model"]["core_method"] == "point_pillar"
        assert S.EARLY_ARGS == with_resnet(y["model"]["args"])
        assert S.YAML_LOSS == y["loss"]["args"]
    unc = yaml("pointpillar_uncertainty.yaml")
    assert unc["fusion"]["core_method"] == "late"
    assert S.STAGE1_TRAIN_ARGS == with_resnet(unc["model"]["args"])
    assert S.YAML_UNC_LOSS == unc["loss"]
    assert S.YAML_OPTIMIZER == unc["optimizer"]
    assert S.YAML_SCHEDULER == unc["lr_scheduler"]
    assert S.YAML_TARGETS == unc["postprocess"]["target_args"]
    post = unc["postprocess"]
    assert S.LATE_POSTPROCESS == {
        "target_args": post["target_args"], "nms_thresh": post["nms_thresh"],
        "gt_range": post["gt_range"], "dir_args": post["dir_args"],
        "max_num": post["max_num"]}
    assert S.LATE_TINY_ARGS == L.ARGS
    assert S.LATE_TINY_POST == L.POST
