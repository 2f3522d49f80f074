"""The port's pose-robust baselines, robust V2VNet and MASH, against the JAX
package on the CPU, at a 24 x 24 canvas (0.8 m pillars; the fused map is
12 x 12), B = 2 frames of L = 3 agent slots with one padded, noisy poses.

Bounds, float32 throughout:
  * forwards from the same weights (a JAX init, batch norms and the pair
    nets' zero-started last Linear seeded): head maps within 1e-4;
    pose_corr, agent_scores, pose_corr_target and corr_vol within 1e-5;
  * pose3_to_tfm / tfm_to_pose3 round trip, global_consistency against the
    JAX solve (1e-5);
  * RobustLoss at stages 0 and 1 and MashLoss on the same maps and labels:
    each term within 1e-5 relative;
  * one training step of each model against coalign_tpu.train.
    make_train_step: tests/test_torch_train.py's bounds (loss terms 1e-5
    relative, running statistics 1e-5 of their scale, parameters after one
    SGD step rtol 2e-4, atol 2e-6);
  * the curriculum's stage masks: the parameters the JAX labels freeze,
    unchanged by a step, their batch-norm statistics moved;
  * the bilinear upsample and the tie-splitting max that MASH relies on.

torch runs on one thread: global_consistency's batched CPU LU fails with
more (ROADMAP §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from conftest import jit_init

from coalign_tpu.loss import build_loss as jax_build_loss
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.models.fuse import robust as JR
from coalign_tpu.postprocess import anchors as JANC
from coalign_tpu.tools.train_robust import stage_param_labels as jax_labels
from coalign_tpu.train import TrainState
from coalign_tpu.train import make_train_step as jax_make_train_step
from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.loss import build_loss
from coalign_tpu_torch.models.fuse import robust as TR
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.postprocess.anchors import (assign_targets,
                                                   make_anchor_spec)
from coalign_tpu_torch.tools.train_robust import (apply_stage,
                                                  stage_param_labels,
                                                  staged_optimizer)
from coalign_tpu_torch.train import make_train_step
from coalign_tpu_torch.utils.weights import from_jax_params

from test_torch_baselines import ANCHOR_ARGS, LAYER_NUMS, LR, TINY
from test_torch_flagship import _randomize_norms
from test_torch_train import SGD_LR, _close_to_scale, _recording_sgd

torch.set_num_threads(1)

CFGS = {
    "robust": {"core_method": "point_pillar_v2vnet_robust",
               "args": {**TINY, "robust": {"hidden": 16, "stage": 1,
                                           "downsample_rate": 2.0}}},
    "mash": {"core_method": "point_pillar_mash",
             "args": {**TINY, "mash": {"coarse_downsample": 2,
                                       "query_dim": 8}}},
}
DET_LOSS = {"pos_cls_weight": 2.0,
            "cls": {"alpha": 0.25, "gamma": 2.0, "weight": 2.0},
            "reg": {"sigma": 3.0, "weight": 2.0},
            "dir": {"weight": 0.2, "args": TINY["dir_args"]}}
LOSSES = {
    "robust": {"core_method": "point_pillar_v2v_robust_loss",
               "args": {**DET_LOSS, "robust": {"stage": 1}}},
    "mash": {"core_method": "point_pillar_mash_loss", "args": DET_LOSS},
}
TARGETS = {"pos_threshold": 0.3, "neg_threshold": 0.2}


def _batch(seed: int = 3) -> dict:
    """B = 2 frames, 3 agent slots (the second frame's last padded), 400
    points an agent, pose noise 0.3 m / 3 degrees, gt boxes."""
    scenes = SyntheticScenes(num_frames=2, num_agents=3, num_objects=4,
                             lidar_range=LR, points_per_object=80,
                             ground_points=200, agent_spread=4.0, seed=seed)
    frames = [scenes[0], scenes[1]]
    frames[1] = dict(frames[1], agents=frames[1]["agents"][:2])
    return IntermediateFusionBatcher(
        max_cav=3, max_points=400, max_objects=8, lidar_range=LR,
        pos_std=0.3, rot_std=3.0, seed=seed).assemble(frames)


def _seeded_variables(jmodel, batch, key: int = 0) -> dict:
    """A JAX init with its batch norms and zero-started kernels (the pair
    nets' last Dense) seeded, so no output is a constant."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(key), jbatch, train=False)),
        np.random.default_rng(key))
    rng = np.random.default_rng(key + 100)
    for net in ("pose_regression", "attention"):
        dense = variables["params"].get("fusion", {}).get(net, {}).get(
            "Dense_1")
        if dense is not None:
            dense["kernel"] = rng.normal(0, 0.05, dense["kernel"].shape
                                         ).astype(np.float32)
    return variables


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def seeded():
    cache = {}

    def get(name):
        if name not in cache:
            batch = _batch()
            jmodel = jax_build_model(CFGS[name])
            variables = _seeded_variables(jmodel, batch)
            model = build_model(CFGS[name], device="cpu")
            model.load_state_dict(from_jax_params(variables, LAYER_NUMS),
                                  strict=True)
            cache[name] = batch, jmodel, variables, model
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_matches_jax(name, seeded):
    batch, jmodel, variables, model = seeded(name)
    assert not batch["agent_mask"].all()
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = model(_tensors(batch))
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        if key.endswith("_preds"):
            np.testing.assert_allclose(got[key].numpy(),
                                       w.transpose(0, 3, 1, 2), atol=1e-4,
                                       err_msg=key)
        else:
            assert got[key].shape == w.shape, key
            np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                       atol=1e-5, err_msg=key)
    if name == "robust":
        assert set(want) >= {"pose_corr", "agent_scores", "pose_corr_target",
                             "pairwise_t_corrected"}
        assert np.abs(np.asarray(want["pose_corr"])).max() > 1e-2
        # the padded agent's pairs score 0
        assert (got["agent_scores"][1, 2] == 0).all()
    else:
        assert got["corr_vol"].shape == (2, 3, 36, 37)


def test_pose3_round_trip_and_matches_jax():
    p = np.array([[1.5, -2.0, 0.7], [0.0, 3.0, -2.9], [4.0, 1.0, 3.1]],
                 np.float32)
    t = TR.pose3_to_tfm(torch.from_numpy(p))
    np.testing.assert_allclose(t.numpy(), np.asarray(JR.pose3_to_tfm(
        jnp.asarray(p))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(TR.tfm_to_pose3(t).numpy(), p, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_global_consistency_matches_jax(masked):
    rng = np.random.default_rng(1)
    b, l = 3, 5
    abs_pose = np.zeros((b, l, 3), np.float32)
    abs_pose[:, 1:] = rng.normal(0, 1.0, (b, l - 1, 3))
    rel = abs_pose[:, None] - abs_pose[:, :, None]
    rel = (rel + rng.normal(0, 0.2, rel.shape)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (b, l, l)).astype(np.float32)
    mask = np.ones((b, l), bool)
    if masked:
        mask[1, 3:] = False
        mask[2, 1] = False
    got = TR.global_consistency(torch.from_numpy(rel), torch.from_numpy(w),
                                torch.from_numpy(mask))
    want = np.asarray(JR.global_consistency(jnp.asarray(rel), jnp.asarray(w),
                                            jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # exact measurements come back exactly
    exact = abs_pose[:, None] - abs_pose[:, :, None]
    back = TR.global_consistency(torch.from_numpy(exact),
                                 torch.from_numpy(w), torch.ones(b, l,
                                                                 dtype=bool))
    np.testing.assert_allclose(back.numpy(), exact, rtol=0, atol=1e-5)


def _jax_labels(batch):
    jspec = JANC.make_anchor_spec(ANCHOR_ARGS, TARGETS)
    return jax.tree_util.tree_map(np.asarray, jax.vmap(
        lambda g, m: JANC.assign_targets(g, m, jspec))(
        jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["gt_mask"])))


@pytest.mark.parametrize("loss", ["robust_stage0", "robust_stage1", "mash"])
def test_losses_match_jax(loss, seeded):
    name = loss.split("_")[0]
    batch, jmodel, variables, _ = seeded(name)
    out = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: jmodel.apply(v, b, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    cfg = dict(LOSSES[name])
    if name == "robust":
        cfg = {**cfg, "args": {**cfg["args"], "robust": {
            "stage": int(loss[-1])}}}
    labels = _jax_labels(batch)
    _, want = jax_build_loss(cfg)(
        jax.tree_util.tree_map(jnp.asarray, out), labels)
    port_out = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()
                                    if k.endswith("_preds") else v)
                for k, v in out.items()}
    _, got = build_loss(cfg)(port_out, _tensors(labels))
    assert set(got) == set(want)
    extra = {"robust_stage0": set(), "robust_stage1": {"pose_loss",
                                                       "score_loss"},
             "mash": {"corr_entropy"}}[loss]
    assert set(want) - {"cls_loss", "reg_loss", "dir_loss",
                        "total_loss"} == extra
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)


# ------------------------------------------------------- one train step


@pytest.fixture(scope="module", params=sorted(CFGS))
def jax_step(request, seeded):
    name = request.param
    batch, jmodel, variables, _ = seeded(name)
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=_recording_sgd(SGD_LR))
    jspec = JANC.make_anchor_spec(ANCHOR_ARGS, TARGETS)
    new, metrics = jax_make_train_step(
        jmodel, jax_build_loss(LOSSES[name]), jspec, donate=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    new = jax.tree_util.tree_map(np.asarray, new)
    return {"name": name, "batch": batch, "variables": variables,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": from_jax_params({"params": new.params}, LAYER_NUMS),
            "stats": from_jax_params({"batch_stats": new.batch_stats},
                                     LAYER_NUMS)}


def test_train_step_matches_jax(jax_step):
    name, batch = jax_step["name"], jax_step["batch"]
    # the two label assignments agree on this batch
    spec = make_anchor_spec(ANCHOR_ARGS, TARGETS)
    labels = assign_targets(torch.from_numpy(batch["gt_boxes"]),
                            torch.from_numpy(batch["gt_mask"]), spec)
    want_labels = _jax_labels(batch)
    for key in ("pos_equal_one", "neg_equal_one"):
        np.testing.assert_array_equal(labels[key].numpy(), want_labels[key])
    assert labels["pos_equal_one"].sum() > 0

    model = build_model(CFGS[name], device="cpu")
    model.load_state_dict(from_jax_params(jax_step["variables"], LAYER_NUMS),
                          strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, build_loss(LOSSES[name]), spec,
                           torch.optim.SGD(model.parameters(), lr=SGD_LR),
                           device="cpu")
    terms = step(batch)
    assert set(terms) == set(jax_step["metrics"])
    if name == "robust":
        assert "pose_loss" in terms
    for key, want in jax_step["metrics"].items():
        np.testing.assert_allclose(float(terms[key]), want, rtol=1e-5,
                                   err_msg=key)
    state = model.state_dict()
    stats = [k for k in jax_step["stats"]
             if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        _close_to_scale(state[key].numpy(), jax_step["stats"][key].numpy(),
                        1e-5, key)
        assert not torch.equal(state[key], before[key]), key
    assert set(jax_step["params"]) == {k for k, _ in
                                       model.named_parameters()}
    for key, want in jax_step["params"].items():
        np.testing.assert_allclose(state[key].numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=key)


# ------------------------------------------------------- the curriculum


def _jax_stage_mask(variables, stage):
    """The JAX labels of ``stage`` as a port state dict of ones (train) and
    zeros (freeze), through from_jax_params's key map."""
    labels = jax_labels(variables["params"], stage)
    tree = jax.tree_util.tree_map(
        lambda lab, p: np.full(np.shape(p), float(lab == "train"),
                               np.float32), labels, variables["params"])
    return from_jax_params({"params": tree}, LAYER_NUMS)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_stage_masks_freeze_what_jax_freezes(stage, seeded):
    batch, _, variables, _ = seeded("robust")
    model = build_model(CFGS["robust"], device="cpu")
    model.load_state_dict(from_jax_params(variables, LAYER_NUMS),
                          strict=True)
    want = _jax_stage_mask(variables, stage)
    labels = stage_param_labels(model, stage)
    assert set(labels) == set(want)
    for key, mask in want.items():
        assert bool((mask == 1).all()) or bool((mask == 0).all()), key
        assert labels[key] == ("train" if mask.flatten()[0] else "freeze"), \
            key
    frozen = {k for k, v in labels.items() if v == "freeze"}
    robust = {k for k in labels if k.startswith(
        ("fusion_net.pose_regression.", "fusion_net.attention."))
        or k == "fusion_net.alpha"}
    assert frozen == {0: robust, 1: set(labels) - robust, 2: set()}[stage]

    # one AdamW step with weight decay: the frozen parameters do not move,
    # every batch norm's statistics do, the trainable parameters move
    opt, _ = staged_optimizer(model, stage, {"lr": 1e-2, "args": {
        "weight_decay": 1e-2}})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, build_loss(LOSSES["robust"]),
                           make_anchor_spec(ANCHOR_ARGS, TARGETS), opt,
                           device="cpu")
    step(batch)
    after = model.state_dict()
    for key, value in after.items():
        if key in labels:
            moved = not torch.equal(value, before[key])
            assert moved == (labels[key] == "train"), key
        elif key.endswith(("running_mean", "running_var")):
            assert not torch.equal(value, before[key]), key
    assert [p for p in model.parameters() if p.requires_grad] == \
        apply_stage(model, stage)


# ------------------------------------------------------ MASH's primitives


def test_bilinear_upsample_matches_jax_resize():
    """jax.image.resize 'bilinear' upsampling (no antialias below scale 1)
    is F.interpolate(bilinear, align_corners=False), edges included."""
    x = np.random.default_rng(2).normal(size=(2, 3, 25, 88)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)),
                            (2, 100, 352, 3), "bilinear")
    got = F.interpolate(torch.from_numpy(x), size=(100, 352),
                        mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)


def test_max_splits_the_gradient_among_ties_as_jax():
    """On ReLU maps many values tie at 0: amax and maximum share the
    gradient among the tied entries as JAX's max does; max(dim=) would give
    it all to one."""
    x = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 2.0]], np.float32)
    y = np.array([0.0, 2.0], np.float32)
    w = np.array([1.0, 3.0], np.float32)

    def jax_f(x, y):
        return (jnp.maximum(jnp.max(x, axis=1), y) * w).sum()

    jx, jy = jax.grad(jax_f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    (torch.maximum(tx.amax(dim=1), ty) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), atol=0)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jy), atol=0)
    assert float(jx[0, 0]) == pytest.approx(1 / 6)
    tz = torch.from_numpy(x).requires_grad_()
    tz.max(dim=1).values.sum().backward()
    assert not np.allclose(tz.grad.numpy(), np.asarray(jax.grad(
        lambda x: jnp.max(x, axis=1).sum())(jnp.asarray(x))))


def test_jax_optax_zero_matches_a_frozen_parameter():
    """optax.set_to_zero, the JAX curriculum's freeze: no update, no decay,
    as a parameter left out of the torch optimizer."""
    tx = optax.multi_transform({"train": optax.adamw(1e-2, weight_decay=0.1),
                                "freeze": optax.set_to_zero()},
                               {"a": "train", "b": "freeze"})
    params = {"a": jnp.ones(3), "b": jnp.ones(3)}
    upd, _ = tx.update({"a": jnp.ones(3), "b": jnp.ones(3)},
                       tx.init(params), params)
    assert float(jnp.abs(upd["b"]).max()) == 0.0
    assert float(jnp.abs(upd["a"]).min()) > 0.0
