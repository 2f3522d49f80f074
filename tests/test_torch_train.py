"""The PyTorch port's training path against the JAX package's, at the tiny
size of tests/test_end2end.py (64 x 64 canvas, layer_nums [2, 2], widths
[32, 64], att fusion), on the CPU.

Bounds, float32 throughout:
  * labels: pos and neg equal, regression targets within 1e-5 (the same
    arithmetic on metres of order 10);
  * loss terms: within 1e-5 relative (sums of a few thousand terms in
    another order);
  * batch norms: outputs and running statistics within 1e-5 (moments of a
    few thousand values of order 1);
  * the scatter-max backward: equal (a gather and a compare, no
    arithmetic);
  * one flagship step from shared weights: loss terms within 1e-5
    relative, each gradient within 1e-4 of its tensor's largest magnitude
    (a backward pass through convolutions, grid_sample and batch norms,
    summed in another order), running statistics within 1e-5 of their
    tensor's largest magnitude, and parameters after one SGD step within
    the JAX remat test's bounds (rtol 2e-4, atol 2e-6;
    tests/test_end2end.py:143-147, whose note explains why the parameters
    are compared after SGD and the gradients on their own: Adam's first
    step is sign-like);
  * AdamW and the schedules: within 1e-6 of optax.

The batch norms follow the JAX package (mask, biased variance, momentum
0.01 = flax's 0.99), not ref resblock.py's BatchNorm2d defaults (momentum
0.1): the port is held to the JAX package, and the reference's momentum is
one of the places where the JAX package and the reference disagree.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import jit_init

from coalign_tpu.loss import build_loss as jax_build_loss
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.models import layers as JL
from coalign_tpu.ops import pillars as JP
from coalign_tpu.postprocess import anchors as JANC
from coalign_tpu.train import TrainState
from coalign_tpu.train import build_optimizer as jax_build_optimizer
from coalign_tpu.train import make_train_step as jax_make_train_step
from coalign_tpu.utils.iou import standup_iou as jax_standup_iou
from coalign_tpu_torch import runtime
from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.loss import build_loss
from coalign_tpu_torch.models import layers as TL
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.ops import pillars as TP
from coalign_tpu_torch.postprocess.anchors import (assign_targets,
                                                   make_anchor_spec)
from coalign_tpu_torch.utils.box_utils import (boxes_to_corners_3d,
                                               corners_to_standup_2d)
from coalign_tpu_torch.train import (build_optimizer, checkpoint_path,
                                     load_checkpoint, lr_factor,
                                     make_train_step, save_checkpoint,
                                     train_epochs, validate)
from coalign_tpu_torch.utils.iou import standup_iou
from coalign_tpu_torch.utils.weights import from_jax_params

from test_end2end import ANCHOR_ARGS, LOSS_ARGS, MODEL_ARGS, POSTPROCESS
from test_torch_flagship import _randomize_norms

torch.set_num_threads(1)

LIDAR_RANGE = MODEL_ARGS["lidar_range"]
TARGET_ARGS = POSTPROCESS["target_args"]
SGD_LR = 1e-2


def _flagship(pad_parity: bool) -> dict:
    args = dict(MODEL_ARGS, pillar_vfe={**MODEL_ARGS["pillar_vfe"],
                                        "pad_parity": pad_parity})
    return {"core_method": "point_pillar_baseline_multiscale", "args": args}


def _layer_nums(model_cfg: dict) -> list:
    return model_cfg["args"]["base_bev_backbone"]["layer_nums"]


def _scenes(n=4):
    return SyntheticScenes(num_frames=n, num_agents=2, num_objects=4,
                           lidar_range=LIDAR_RANGE, agent_spread=4.0,
                           points_per_object=220, ground_points=512,
                           object_spread=0.55, seed=7)


def _batcher():
    # max_cav 3 with 2-agent frames: a padded agent slot in every frame;
    # 2500 points: padded point slots in every agent
    return IntermediateFusionBatcher(max_cav=3, max_points=2500,
                                     max_objects=16, lidar_range=LIDAR_RANGE)


def _train_batch():
    scenes = _scenes()
    return _batcher().assemble([scenes[0], scenes[1]])


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close_to_scale(got, want, tol, where):
    """|got - want| <= tol * max|want|, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, where
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{where}: {err:.2e} of its largest magnitude"


# ---------------------------------------------------------------- labels


def _collision_gts():
    """B = 2 padded gt sets: the training batch's boxes, plus pairs of small
    boxes that force the same anchor (an identical pair and a shifted
    pair, each below the positive threshold), and padded slots."""
    gt = np.zeros((2, 10, 7), np.float32)
    mask = np.zeros((2, 10), bool)
    batch = _train_batch()
    for b in range(2):
        n = int(batch["gt_mask"][b].sum())
        gt[b, :n] = batch["gt_boxes"][b][batch["gt_mask"][b]]
        mask[b, :n] = True
    small = np.array([4.3, -5.1, -1.0, 1.5, 1.2, 2.0, 0.3], np.float32)
    gt[0, 6] = gt[0, 7] = small
    gt[1, 6], gt[1, 7] = small, small + np.array([0.05, 0.02, 0, 0, 0, 0, 0],
                                                 np.float32)
    mask[:, 6:8] = True
    return gt, mask


def test_standup_iou_matches_jax():
    rng = np.random.default_rng(0)
    lo = rng.uniform(-5, 5, (2, 30, 2)).astype(np.float32)
    a = np.concatenate([lo, lo + rng.uniform(0, 4, (2, 30, 2))], -1)
    lo = rng.uniform(-5, 5, (2, 7, 2)).astype(np.float32)
    q = np.concatenate([lo, lo + rng.uniform(0, 4, (2, 7, 2))], -1).astype(
        np.float32)
    for offset in (0.0, 1.0):
        got = standup_iou(torch.from_numpy(a), torch.from_numpy(q), offset)
        want = np.stack([np.asarray(jax_standup_iou(a[b], q[b], offset))
                         for b in range(2)])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert (want > 0).mean() > 0.1


def test_assign_targets_matches_jax_with_forced_collisions():
    gt, mask = _collision_gts()
    spec = make_anchor_spec(ANCHOR_ARGS, TARGET_ARGS)
    jspec = JANC.make_anchor_spec(ANCHOR_ARGS, TARGET_ARGS)
    np.testing.assert_array_equal(spec.standup, jspec.standup)
    np.testing.assert_array_equal(spec.diag, jspec.diag)
    got = assign_targets(torch.from_numpy(gt), torch.from_numpy(mask), spec)
    want = jax.vmap(lambda g, m: JANC.assign_targets(g, m, jspec))(
        jnp.asarray(gt), jnp.asarray(mask))
    for key in ("pos_equal_one", "neg_equal_one"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["targets"].numpy(),
                               np.asarray(want["targets"]), rtol=0, atol=1e-5)
    # in frame 1 the shifted pair forces one anchor below the positive
    # threshold, and the larger gt index wins it: its target encodes gt 7
    gt_standup = corners_to_standup_2d(boxes_to_corners_3d(
        torch.from_numpy(gt[1, 6:8]))[:, :4, :2])
    iou = standup_iou(torch.from_numpy(spec.standup), gt_standup, 1.0)
    best = torch.argmax(iou, dim=0)
    assert best[0] == best[1] and iou[best[0]].max() <= spec.pos_threshold
    k = int(best[1])
    assert got["pos_equal_one"].reshape(2, -1)[1, k] == 1
    anchor = spec.anchors.reshape(-1, 7)[k]
    np.testing.assert_allclose(
        float(got["targets"].reshape(2, -1, 7)[1, k, 0]),
        (gt[1, 7, 0] - anchor[0]) / spec.diag[k], rtol=1e-5)


# ------------------------------------------------------------------ loss


def test_loss_terms_match_jax():
    rng = np.random.default_rng(1)
    gt, mask = _collision_gts()
    jspec = JANC.make_anchor_spec(ANCHOR_ARGS, TARGET_ARGS)
    labels = jax.tree_util.tree_map(np.asarray, jax.vmap(
        lambda g, m: JANC.assign_targets(g, m, jspec))(
        jnp.asarray(gt), jnp.asarray(mask)))
    h, w = labels["pos_equal_one"].shape[1:3]
    maps = {"cls_preds": rng.normal(0, 2, (2, h, w, 2)),
            "reg_preds": rng.normal(0, 1, (2, h, w, 14)),
            "dir_preds": rng.normal(0, 1, (2, h, w, 4))}
    maps = {k: v.astype(np.float32) for k, v in maps.items()}
    jloss = jax_build_loss(LOSS_ARGS)
    loss = build_loss(LOSS_ARGS)
    for sample_mask in (None, np.array([True, False])):
        _, want = jloss({k: jnp.asarray(v) for k, v in maps.items()},
                        labels, sample_mask=sample_mask)
        _, got = loss({k: torch.from_numpy(v).permute(0, 3, 1, 2)
                       for k, v in maps.items()}, _tensors(labels),
                      sample_mask=None if sample_mask is None
                      else torch.from_numpy(sample_mask))
        assert set(got) == set(want) == {"cls_loss", "reg_loss", "dir_loss",
                                         "total_loss"}
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=key)
            assert float(want[key]) > 0


# ----------------------------------------------------------- batch norms


def _norm_case(case):
    """(jax module, its apply kwargs, NHWC-or-points input, port module,
    port input, port mask, state-dict prefix) for one norm of the
    flagship, with seeded weights and statistics."""
    rng = np.random.default_rng(2)
    if case == "pfn_masked":
        x = rng.normal(1.0, 2.0, (3, 200, 16)).astype(np.float32)
        mask = rng.uniform(size=(3, 200)) > 0.4
        jmod, tmod = JL.MaskedBatchNorm(), TL.MaskedBatchNorm(16)
        return (jmod, {"mask": jnp.asarray(mask)}, x, tmod,
                torch.from_numpy(x), torch.from_numpy(mask), None)
    x = rng.normal(0.5, 1.5, (3, 8, 8, 8)).astype(np.float32)
    agent_mask = np.array([True, True, False])
    if case in ("trunk_masked", "trunk_unmasked"):
        masked = case == "trunk_masked"
        jmod, tmod = JL.BasicBlock(16, 2), TL.BasicBlock(8, 16, stride=2)
        kw = {"mask": jnp.asarray(agent_mask)[:, None, None]} if masked \
            else {}
        return (jmod, kw, x, tmod, torch.from_numpy(x).permute(0, 3, 1, 2),
                torch.from_numpy(agent_mask) if masked else None,
                ("backbone", "trunk", "BasicBlock_0"))
    # deblock: unmasked after fusion; 2 maps of 8 x 8 give n = 128
    x = x[:2]
    jmod, tmod = JL.Deblock(16, 2), TL.deblock(8, 16, 2)
    return (jmod, {}, x, tmod, torch.from_numpy(x).permute(0, 3, 1, 2),
            None, ("backbone", "deblocks_0"))


def _port_state(variables, path):
    """A JAX submodule's variables -> the port's state dict of it."""
    if path is None:       # a bare norm: the leaves map one to one
        p, s = variables["params"], variables["batch_stats"]
        return {"weight": p["scale"], "bias": p["bias"],
                "running_mean": s["mean"], "running_var": s["var"],
                "num_batches_tracked": np.array(0)}

    def nest(tree):
        for key in reversed(path):
            tree = {key: tree}
        return tree
    sd = from_jax_params({"params": nest(variables["params"]),
                          "batch_stats": nest(variables["batch_stats"])},
                         layer_nums=[1])
    prefix = ("backbone.resnet.layer0.0." if "trunk" in path
              else "backbone.deblocks.0.")
    return {k[len(prefix):]: v for k, v in sd.items()}


@pytest.mark.parametrize("case", ["pfn_masked", "trunk_masked",
                                  "trunk_unmasked", "deblock"])
def test_training_norm_matches_jax(case):
    """Each repairs a fault of the port's first slice, which fails here:
    pfn_masked      MaskedBatchNorm had no training mode (it raised);
    trunk_masked    the trunk's BatchNorm2d took padded agents' maps into
                    its statistics (no mask);
    trunk_unmasked  the trunk's momentum was torch's 0.1, not 0.01;
    deblock         running_var moved towards the unbiased batch variance
                    (n / (n - 1) = 128 / 127 here), not the biased one."""
    jmod, kw, x, tmod, tx, tmask, path = _norm_case(case)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v: jmod.init(jax.random.PRNGKey(4), v, **kw))(jnp.asarray(x)))
    variables = _randomize_norms(variables, np.random.default_rng(5))
    want, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"], **kw)
    sd = {k: torch.as_tensor(np.asarray(v))
          for k, v in _port_state(variables, path).items()}
    tmod.load_state_dict(sd, strict=True)
    tmod.train()
    with torch.no_grad():
        got = tmod(tx, tmask) if tmask is not None else tmod(tx)
    if case == "pfn_masked":
        got = got[0]
    else:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    new = _port_state({"params": variables["params"],
                       "batch_stats": jax.tree_util.tree_map(
                           np.asarray, mutated["batch_stats"])}, path)
    state = tmod.state_dict()
    for key, value in new.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[key].numpy(), np.asarray(value),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
            # the move itself, momentum * (batch statistic - running),
            # within 1e-4 of its largest magnitude (a float32 difference of
            # nearly equal values, ~1e-6 here): sharp enough to tell the
            # biased variance from the unbiased one (n / (n - 1) at
            # n = 128 is 1.6e-3 of the largest move here)
            move, want_move = (state[key].numpy() - sd[key].numpy(),
                               np.asarray(value) - sd[key].numpy())
            assert np.abs(want_move).max() > 1e-4, key
            _close_to_scale(move, want_move, 1e-4, f"{key} move")


# ------------------------------------------------------------ scatter-max


def test_scatter_max_backward_matches_jax_on_ties():
    rng = np.random.default_rng(6)
    lidar_range, voxel = [-3.2, -1.6, -3.0, 3.2, 1.6, 1.0], [0.4, 0.4, 4.0]
    jspec = JP.PillarSpec.from_config(lidar_range, voxel)
    spec = TP.PillarSpec.from_config(lidar_range, voxel)
    f, n, c = 2, 300, 6
    points = np.zeros((f, n, 4), np.float32)
    # few pillars, many points each; coarse feature values: exact ties,
    # zeros among them (the canvas's own value)
    points[..., 0] = rng.integers(-3, 3, (f, n)) * 0.4 + 0.1
    points[..., 1] = rng.integers(-2, 2, (f, n)) * 0.4 + 0.1
    points[..., 2] = rng.uniform(-2.5, 0.5, (f, n))
    mask = rng.uniform(size=(f, n)) > 0.2
    ids, valid = TP.pillar_ids(torch.from_numpy(points),
                               torch.from_numpy(mask), spec)
    order = torch.argsort(ids, dim=1, stable=True)
    ids, valid = ids.gather(1, order), valid.gather(1, order)
    feats = (rng.integers(0, 3, (f, n, c)) * 0.5).astype(np.float32)
    # invalid points carry larger values, which must win nothing
    feats = np.where(valid.numpy()[..., None], feats, 5.0).astype(np.float32)
    g = rng.normal(size=(f, spec.ny * spec.nx, c)).astype(np.float32)

    x = torch.from_numpy(feats).requires_grad_(True)
    bev = TP.scatter_max_bev(x * valid[..., None], ids, valid, spec)
    bev.backward(torch.from_numpy(g))
    jids = jnp.asarray(ids.numpy().astype(np.int32))
    jvalid = jnp.asarray(valid.numpy())
    jbev, vjp = jax.vjp(lambda p: jax.vmap(
        lambda pi, ii, vi: JP.scatter_max_bev_cvjp(pi, ii, vi, jspec))(
        p, jids, jvalid), jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g.reshape(f, spec.ny, spec.nx, c)))
    np.testing.assert_array_equal(
        bev.detach().numpy(), np.asarray(jbev).reshape(f, -1, c))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    # ties: points that share their pillar's maximum each take the whole
    # cotangent, including where the maximum is 0
    took = (x.grad.numpy() != 0)
    assert took.sum() > 2 * bev.detach().gt(0).sum().item()


# ------------------------------------------------------- one flagship step


def _recording_sgd(lr):
    """SGD whose state is the gradient it was last given, so that
    make_train_step's gradients can be read back exactly."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(lambda g: -lr * g, grads), grads
    return optax.GradientTransformation(init, update)


# Two float32 implementations of the step agree to ~1e-5 of each gradient's
# scale unless a ReLU input lies within rounding of 0: there one element's
# gradient switches between 0 and its whole value, and every gradient
# upstream of it moves by up to ~1e-2. At this size about half the seeds
# put some ReLU input there, on one side or the other, in one of the two
# configurations; the weights' seed is one that puts none there in either,
# and the test checks that on the port's side (its float32 gradients agree
# with its float64 ones within 1e-5), so the comparison measures the port.
WEIGHTS_KEY = 9


@pytest.fixture(scope="module", params=[True, False],
                ids=["pad_parity", "no_pad_parity"])
def jax_step(request):
    """One JAX make_train_step from seeded weights, with batch norms whose
    scales, biases and statistics are seeded too."""
    flagship = _flagship(request.param)
    batch = _train_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model(flagship)
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(WEIGHTS_KEY), jbatch, train=False)),
        np.random.default_rng(8))
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=_recording_sgd(SGD_LR))
    jspec = JANC.make_anchor_spec(ANCHOR_ARGS, TARGET_ARGS)
    new, metrics = jax_make_train_step(jmodel, jax_build_loss(LOSS_ARGS),
                                       jspec, donate=False)(state, jbatch)
    new = jax.tree_util.tree_map(np.asarray, new)
    layers = _layer_nums(flagship)
    return {"flagship": flagship, "batch": batch, "variables": variables,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": from_jax_params({"params": new.opt_state}, layers),
            "params": from_jax_params({"params": new.params}, layers),
            "stats": from_jax_params({"batch_stats": new.batch_stats},
                                     layers)}


def _float64_grads(flagship, variables, batch):
    model = build_model(flagship, device="cpu")
    model.load_state_dict(from_jax_params(variables, _layer_nums(flagship)),
                          strict=True)
    model.double().train()
    b = {k: v.double() if v.is_floating_point() else v
         for k, v in _tensors(batch).items()}
    labels = assign_targets(b["gt_boxes"].float(), b["gt_mask"],
                            make_anchor_spec(ANCHOR_ARGS, TARGET_ARGS))
    build_loss(LOSS_ARGS)(model(b), labels)[0].backward()
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


def test_flagship_step_matches_jax(jax_step):
    batch = jax_step["batch"]
    assert not batch["agent_mask"].all()            # a padded agent slot
    assert not batch["point_mask"][batch["agent_mask"]].all()
    model = build_model(jax_step["flagship"], device="cpu")
    model.load_state_dict(from_jax_params(
        jax_step["variables"], _layer_nums(jax_step["flagship"])),
        strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
    step = make_train_step(model, build_loss(LOSS_ARGS),
                           make_anchor_spec(ANCHOR_ARGS, TARGET_ARGS), opt,
                           device="cpu")
    terms = step(batch)
    assert model.training
    assert set(terms) == set(jax_step["metrics"])
    for key, want in jax_step["metrics"].items():
        np.testing.assert_allclose(float(terms[key]), want, rtol=1e-5,
                                   err_msg=key)
    grads = dict(model.named_parameters())
    exact = _float64_grads(jax_step["flagship"], jax_step["variables"],
                           batch)
    assert set(grads) == set(jax_step["grads"]) == set(exact)
    for key, want in jax_step["grads"].items():
        _close_to_scale(grads[key].grad.numpy(), exact[key], 1e-5,
                        f"float32 against float64 grad {key}")
        _close_to_scale(grads[key].grad.numpy(), want.numpy(), 1e-4,
                        f"grad {key}")
    state = model.state_dict()
    stats = [k for k in jax_step["stats"]
             if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 13                  # every norm of the model
    for key in stats:
        _close_to_scale(state[key].numpy(), jax_step["stats"][key].numpy(),
                        1e-5, key)
        assert not torch.equal(state[key], before[key]), key
    for key, want in jax_step["params"].items():
        np.testing.assert_allclose(state[key].numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=key)


def test_initialization_follows_flax_defaults():
    # same distributions, not the same draws: per tensor, the standard
    # deviation within 10% of the JAX init's (every tensor here has at
    # least 64 values), the same truncation at 2 standard deviations of the
    # untruncated normal, zero biases, batch norms at scale 1, bias 0,
    # mean 0, variance 1
    flagship = _flagship(False)
    jbatch = {k: jnp.asarray(v) for k, v in _train_batch().items()}
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jit_init(
        jax_build_model(flagship), jax.random.PRNGKey(0), jbatch,
        train=False)), _layer_nums(flagship))
    got = build_model(flagship, device="cpu", seed=0).state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        g, w = got[key].double(), w.double()
        if key.endswith(("running_mean", "running_var", "bias",
                         "num_batches_tracked")) or w.std() == 0:
            assert torch.equal(g, w), key
            continue
        assert g.numel() >= 64, key
        np.testing.assert_allclose(float(g.std()), float(w.std()), rtol=0.1,
                                   err_msg=key)
        # fan_in: all but the output axis (axis 1 of a transposed conv)
        fan_in = w.numel() // w.shape[1 if ".deblocks." in key else 0]
        bound = 2 * (1 / fan_in) ** 0.5 / 0.87962566103423978
        assert float(g.abs().max()) <= bound * (1 + 1e-6), key
        assert float(w.abs().max()) <= bound * (1 + 1e-6), key
    assert not torch.equal(got["cls_head.weight"], build_model(
        flagship, device="cpu", seed=1).state_dict()["cls_head.weight"])


# ------------------------------------------------- optimizer and schedule


def test_adamw_and_multistep_match_optax_across_a_boundary():
    opt_cfg = {"lr": 2e-3, "args": {"eps": 1e-10, "weight_decay": 1e-2}}
    sched_cfg = {"core_method": "multistep", "gamma": 0.1, "step_size": [1]}
    rng = np.random.default_rng(9)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    # steps_per_epoch 2: the boundary at count 2, the third step's
    tx = jax_build_optimizer(opt_cfg, sched_cfg, steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt, sched = build_optimizer(list(tp.values()), opt_cfg, sched_cfg,
                                 steps_per_epoch=2)
    assert isinstance(opt, torch.optim.AdamW)
    lrs = []
    for g in grads:
        updates, js = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
        jp = optax.apply_updates(jp, updates)
        lrs.append(opt.param_groups[0]["lr"])
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lrs, [2e-3, 2e-3, 2e-4], rtol=1e-12)


@pytest.mark.parametrize("sched_cfg", [
    {"core_method": "multistep", "gamma": 0.1, "step_size": [2, 3]},
    {"core_method": "step", "gamma": 0.5, "step_size": 2},
    {"core_method": "exponential", "gamma": 0.9},
    None], ids=["multistep", "step", "exponential", "constant"])
def test_schedules_match_optax_step_by_step(sched_cfg):
    # optax's boundary convention, read off the schedule itself: the
    # update with step count c takes schedule(c)
    tx = jax_build_optimizer({"lr": 1.0, "args": {}}, sched_cfg,
                             steps_per_epoch=3)
    p = {"w": jnp.zeros(())}
    adam_state, sched_state = tx.init(p)
    factor = lr_factor(sched_cfg, steps_per_epoch=3)
    first = None
    for count in range(14):
        # a unit gradient on a fresh Adam state gives the same Adam step at
        # every count, scaled by -lr(c), c the schedule's own step count
        state = (adam_state, sched_state._replace(
            count=jnp.asarray(count, jnp.int32))) \
            if isinstance(sched_state, optax.ScaleByScheduleState) \
            else (adam_state, sched_state)
        upd, _ = tx.update({"w": jnp.ones(())}, state, p)
        first = first if first is not None else float(upd["w"])
        np.testing.assert_allclose(float(upd["w"]) / first, factor(count),
                                   rtol=1e-6, err_msg=f"count {count}")
    if sched_cfg is not None:
        assert factor(13) < factor(0)


# ----------------------------------------------- checkpoints and the loop


def _tiny_training(device="cpu"):
    model = build_model(_flagship(False), device=device, seed=3)
    spec = make_anchor_spec(ANCHOR_ARGS, TARGET_ARGS)
    return model, build_loss(LOSS_ARGS), spec


def test_checkpoint_saves_loads_strictly_and_resumes_the_same_step(tmp_path):
    batch = _train_batch()
    model, loss, spec = _tiny_training()
    opt, _ = build_optimizer(model.parameters(), {"lr": 3e-3, "args": {}})
    step = make_train_step(model, loss, spec, opt, device="cpu")
    step(batch)
    step(batch)
    path = save_checkpoint(model, str(tmp_path), 2)
    assert path == checkpoint_path(str(tmp_path), 2) == str(
        tmp_path / "net_epoch2.pth")
    best = save_checkpoint(model, str(tmp_path), 1, bestval=True)
    save_checkpoint(model, str(tmp_path), 2, bestval=True)
    assert not os.path.exists(best)
    assert sorted(os.listdir(tmp_path)) == ["net_epoch2.pth",
                                            "net_epoch_bestval_at2.pth"]

    resumed, _, _ = _tiny_training()
    load_checkpoint(resumed, path)
    for key, value in model.state_dict().items():
        assert torch.equal(resumed.state_dict()[key], value), key
    out = []
    for m in (model, resumed):
        sgd = torch.optim.SGD(m.parameters(), lr=SGD_LR)
        out.append((make_train_step(m, loss, spec, sgd, device="cpu")(batch),
                    m.state_dict()))
    for key, value in out[0][0].items():
        assert torch.equal(out[1][0][key], value), key
    for key, value in out[0][1].items():
        assert torch.equal(out[1][1][key], value), key


def test_train_epochs_validates_and_keeps_the_best(tmp_path):
    model, loss, spec = _tiny_training()
    opt, sched = build_optimizer(model.parameters(),
                                 {"lr": 3e-3, "args": {"eps": 1e-10}})
    scenes = _scenes()
    before = validate(model, loss, spec, _batcher(), scenes, 2,
                      device="cpu")
    assert not model.training
    history = train_epochs(model, loss, spec, opt, sched, _batcher(), scenes,
                           epochs=4, batch_size=2, log_every=2,
                           ckpt_dir=str(tmp_path), save_freq=2,
                           val_dataset=scenes, eval_freq=2, start_epoch=2,
                           device="cpu")
    steps = [h for h in history if "total_loss" in h]
    vals = [h["val_loss"] for h in history if "val_loss" in h]
    assert [h["step"] for h in steps] == [2, 4, 6, 8]
    assert len(vals) == 2 and vals[-1] < before
    assert all(np.isfinite(h["total_loss"]) for h in steps)
    names = sorted(os.listdir(tmp_path))
    assert names[:2] == ["net_epoch4.pth", "net_epoch6.pth"]
    assert len(names) == 3 and names[2].startswith("net_epoch_bestval_at")


def test_train_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, loss, spec = _tiny_training()
    opt, _ = build_optimizer(model.parameters(), {"lr": 1e-3})
    for call in (lambda: make_train_step(model, loss, spec, opt),
                 lambda: validate(model, loss, spec, _batcher(), _scenes(), 2),
                 lambda: train_epochs(model, loss, spec, opt, None,
                                      _batcher(), _scenes(), epochs=1,
                                      batch_size=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_smoke_training_configurations_equal_their_sources():
    # chip_smoke.py runs where JAX is not installed, so it carries copies
    # of tests/test_end2end.py's setup, of the flagship yaml's training
    # sections and of bench.py's train scale; they must not drift
    import bench
    import chip_smoke as S
    from coalign_tpu_torch.config.yaml_utils import load_yaml

    import test_end2end as E
    assert S.E2E_ARGS == E.MODEL_ARGS
    assert S.E2E_ANCHORS == E.ANCHOR_ARGS
    assert S.E2E_POSTPROCESS == E.POSTPROCESS
    assert S.E2E_LOSS == E.LOSS_ARGS
    yaml = load_yaml(os.path.join(os.path.dirname(E.__file__), os.pardir,
                                  "coalign_tpu", "hypes_yaml", "opv2v",
                                  "pointpillar_coalign.yaml"))
    assert S.YAML_TARGETS == yaml["postprocess"]["target_args"]
    assert S.YAML_LOSS == yaml["loss"]["args"]
    assert S.YAML_OPTIMIZER == yaml["optimizer"]
    assert S.YAML_SCHEDULER == yaml["lr_scheduler"]
    assert S.TRAIN_BATCH == yaml["train_params"]["batch_size"]
    # FULL_ARGS names the ResNet trunk (the yaml's default) and leaves out
    # the grid size that the yaml's parser derives
    model = yaml["model"]["args"]
    assert S.TRAIN_FULL_ARGS == {
        **model, "point_pillar_scatter": {"num_features": 64},
        "base_bev_backbone": {**model["base_bev_backbone"], "resnet": True}}
    assert S.TRAIN_BATCHER == dict(
        max_cav=bench.MAX_CAV, max_points=bench.POINTS_PER_AGENT,
        max_objects=100, comm_range=70.0, lidar_range=bench.LIDAR_RANGE)
    assert S.YAML_LOSS == bench.LOSS_CFG
