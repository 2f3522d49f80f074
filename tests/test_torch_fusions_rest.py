"""The port's Where2comm and deformable fusion against the JAX package on
the CPU, at tests/test_torch_baselines.py's size (24 x 24 canvas, B = 2
frames of L = 3 agent slots with one padded).

  * Where2comm's forward from the same weights (a JAX init with its norms
    seeded and its single cls head set so that the confidence straddles
    the 0.01 threshold): fused and ``*_single`` maps within 1e-4,
    ``comm_rate`` within 1e-6, the transmission mask equal pixel for pixel
    (the pixels within 1e-6 of the threshold are counted and named if any
    disagree);
  * make_infer_fn's boxes and comm_rate, and evaluate_dataset's AP and
    bandwidth (scaled by comm_rate) against the JAX infer fn and evaluate;
  * one Where2comm train step against coalign_tpu.train.make_train_step
    on the yaml's loss: with SGD, every parameter within
    tests/test_torch_train.py's bounds (rtol 2e-4, atol 2e-6); with the
    yaml's AdamW (weight decay 1e-4), the single heads, which the loss
    does not reach, decayed as optax decays them, and the other
    parameters' elements whose gradient sign is settled within those
    bounds;
  * the deformable fusion's forward (its zero-started head seeded) within
    1e-4, build_fusion("deform"), and its sampler against the JAX
    package's 4-tap bilinear gather.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coalign_tpu.data import IntermediateFusionBatcher as JaxBatcher
from coalign_tpu.data import SyntheticScenes as JaxScenes
from coalign_tpu.inference import evaluate as jax_evaluate
from coalign_tpu.inference import make_infer_fn as jax_make_infer_fn
from coalign_tpu.loss import build_loss as jax_build_loss
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.models.fuse import where2comm as JW
from coalign_tpu.ops.warp import _bilinear_gather
from coalign_tpu.postprocess import anchors as JANC
from coalign_tpu.train import TrainState
from coalign_tpu.train import build_optimizer as jax_build_optimizer
from coalign_tpu.train import make_train_step as jax_make_train_step
from coalign_tpu_torch.config.yaml_utils import load_yaml
from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.inference import evaluate_dataset, make_infer_fn
from coalign_tpu_torch.loss import build_loss
from coalign_tpu_torch.models.fuse import where2comm as TW
from coalign_tpu_torch.models.fuse.deform import (DeformableFusion,
                                                  bilinear_sample)
from coalign_tpu_torch.models.fuse.fusion import build_fusion
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.postprocess.anchors import (assign_targets,
                                                   generate_anchor_box,
                                                   make_anchor_spec)
from coalign_tpu_torch.train import build_optimizer, make_train_step
from coalign_tpu_torch.utils.weights import from_jax_params

from test_torch_baselines import (ANCHOR_ARGS, HEAD_GAINS, LAYER_NUMS, LR,
                                  POST, TINY, _batch, _jax_and_port,
                                  _same_dets)
from test_torch_pose_robust import TARGETS, _seeded_variables
from test_torch_pose_robust import _batch as _train_batch
from test_torch_train import SGD_LR, _close_to_scale, _recording_sgd

torch.set_num_threads(1)

W2C = {"core_method": "point_pillar_where2comm",
       "args": {**TINY, "fusion_method": "att",
                "where2comm": {"agg_operator": {"mode": "ATTEN"}}}}
DEFORM = {"core_method": "point_pillar_deform_transformer",
          "args": {**TINY, "deform": {"num_points": 4, "num_agents": 3}}}
THRESHOLD = 0.01
W2C_YAML = os.path.join(os.path.dirname(__file__), os.pardir, "coalign_tpu",
                        "hypes_yaml", "opv2v", "pointpillar_where2comm.yaml")


def _straddle(variables, seed=0):
    """Single cls head logits spread around logit(0.01): some of each
    agent's pixels are sent, some are not."""
    rng = np.random.default_rng(seed)
    head = variables["params"]["single_heads"]["cls_head"]
    head["kernel"] = rng.normal(0, 0.1, head["kernel"].shape).astype(
        np.float32)
    head["bias"] = np.full(head["bias"].shape, -4.6, np.float32)
    return variables


def _with_straddle(jmodel, variables, model):
    variables = _straddle(variables)
    model.load_state_dict(from_jax_params(variables, LAYER_NUMS),
                          strict=True)
    return variables


@pytest.fixture(scope="module")
def where2comm():
    batch = _batch()
    jmodel, variables, jbatch, model = _jax_and_port(W2C, batch)
    variables = _with_straddle(jmodel, variables, model)
    return batch, jmodel, variables, jbatch, model


def test_where2comm_forward_matches_jax(where2comm):
    batch, jmodel, variables, jbatch, model = where2comm
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == {
        "cls_preds", "reg_preds", "dir_preds", "comm_rate", "cls_preds_single",
        "reg_preds_single", "dir_preds_single"}
    for key in want:
        if key == "comm_rate":
            continue
        assert got[key].shape[0] == (6 if key.endswith("_single") else 2)
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]).transpose(0, 3, 1, 2),
            atol=1e-4, err_msg=key)
    rate = float(want["comm_rate"])
    assert 0.05 < rate < 0.95, rate          # the mask is not trivial
    assert abs(float(got["comm_rate"]) - rate) <= 1e-6


def test_where2comm_mask_matches_jax_pixel_for_pixel(where2comm):
    batch, jmodel, variables, jbatch, model = where2comm
    with torch.no_grad():
        logits = model({k: torch.from_numpy(v) for k, v in batch.items()})[
            "cls_preds_single"]
    b, l = batch["agent_mask"].shape
    logits = logits.reshape((b, l) + logits.shape[1:])
    agent_mask = torch.from_numpy(batch["agent_mask"])
    got, rate = TW.Communication()(logits, agent_mask)
    jlogits = jnp.asarray(logits.numpy().transpose(0, 1, 3, 4, 2))
    comm = JW.Communication()
    want, jrate = comm.apply({}, jlogits, jnp.asarray(batch["agent_mask"]))
    want = np.asarray(want)[..., 0]
    got = got.numpy()[:, :, 0]
    # the smoothed confidence, to count the pixels at the threshold
    conf = torch.nn.functional.conv2d(
        torch.sigmoid(logits).amax(2).reshape(b * l, 1, *logits.shape[-2:]),
        torch.from_numpy(TW.gaussian_kernel())[None, None], padding=2)
    near = int((conf - THRESHOLD).abs().le(1e-6).sum())
    differ = np.argwhere(got != want)
    assert not len(differ), (f"{len(differ)} pixels differ, {near} within "
                             f"1e-6 of the threshold: {differ[:5]}")
    assert got[:, 0].min() == 1                 # the ego always sends
    assert abs(float(rate) - float(jrate)) <= 1e-6
    np.testing.assert_allclose(TW.gaussian_kernel(), JW.gaussian_kernel(),
                               rtol=0, atol=0)


def test_where2comm_infer_fn_and_bandwidth_match_jax():
    batch = _batch(1)
    jmodel, variables, jbatch, model = _jax_and_port(W2C, batch, 1,
                                                     HEAD_GAINS)
    variables = _with_straddle(jmodel, variables, model)
    anchors = generate_anchor_box(ANCHOR_ARGS)
    want = jax_make_infer_fn(jmodel, anchors, POST)(variables, jbatch)
    got = make_infer_fn(model, anchors, POST, device="cpu")(batch)
    assert abs(float(got["comm_rate"]) - float(want["comm_rate"])) <= 1e-6
    _same_dets(got, want, ("corners3d", "boxes7", "scores", "mask"), 10)

    # evaluate_dataset's AP and its bandwidth, scaled by comm_rate
    scenes = dict(num_frames=2, num_agents=3, num_objects=4, lidar_range=LR,
                  points_per_object=60, ground_points=150, agent_spread=4.0,
                  seed=4)
    bargs = dict(max_cav=3, max_points=300, max_objects=8, lidar_range=LR)
    post = {**POST, "anchor_args": ANCHOR_ARGS}
    want = jax_evaluate(jmodel, variables, JaxBatcher(**bargs),
                        JaxScenes(**scenes), anchors, post, batch_size=1)
    got = evaluate_dataset(model, IntermediateFusionBatcher(**bargs),
                           SyntheticScenes(**scenes), anchors, post,
                           device="cpu")
    assert got["frames"] == 2
    for key in ("ap30", "ap50", "ap70"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert got["bandwidth_mb_per_frame"] == pytest.approx(
        want["bandwidth_mb_per_frame"], rel=1e-5)
    full = evaluate_dataset(build_model({**W2C, "core_method":
                                         "point_pillar_baseline"},
                                        device="cpu"),
                            IntermediateFusionBatcher(**bargs),
                            SyntheticScenes(**scenes), anchors, post,
                            device="cpu")
    assert got["bandwidth_mb_per_frame"] < full["bandwidth_mb_per_frame"]


@pytest.fixture(scope="module")
def where2comm_train():
    """The train batch of tests/test_torch_pose_robust.py (gt boxes, pose
    noise), Where2comm's seeded JAX variables with the straddling single
    cls head, and the yaml's loss and optimizer."""
    batch = _train_batch()
    jmodel = jax_build_model(W2C)
    variables = _straddle(_seeded_variables(jmodel, batch))
    y = load_yaml(W2C_YAML)
    return batch, jmodel, variables, y["loss"], y["optimizer"]


@pytest.mark.parametrize("optimizer", ["sgd", "yaml_adamw"])
def test_where2comm_train_step_matches_jax(optimizer, where2comm_train):
    """One step of each package's make_train_step from the same weights.
    The single heads make the mask and are not in point_pillar_loss: both
    packages give them a zero gradient, so SGD leaves them as they were
    and AdamW decays them (p * (1 - lr * wd), a change of 2e-7 relative,
    1 to 4 float32 ulps: the port's within 3e-7 of the JAX value, and
    every nonzero element moved on both sides). AdamW's first step moves
    each other element by lr * g / (|g| + eps), its gradient's sign when
    |g| >> eps: the elements whose |g| is at least 1e-2 of their tensor's
    largest and 1e-6 are held within tests/test_torch_train.py's bounds;
    below that, rounding can flip the sign."""
    batch, jmodel, variables, loss_cfg, opt_cfg = where2comm_train
    jspec = JANC.make_anchor_spec(ANCHOR_ARGS, TARGETS)
    spec = make_anchor_spec(ANCHOR_ARGS, TARGETS)
    labels = assign_targets(torch.from_numpy(batch["gt_boxes"]),
                            torch.from_numpy(batch["gt_mask"]), spec)
    assert labels["pos_equal_one"].sum() > 0
    tx = (_recording_sgd(SGD_LR) if optimizer == "sgd"
          else jax_build_optimizer(opt_cfg, None))
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"],
                              batch_stats=variables["batch_stats"], tx=tx)
    new, metrics = jax_make_train_step(
        jmodel, jax_build_loss(loss_cfg), jspec, donate=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    new = jax.tree_util.tree_map(np.asarray, new)
    want = from_jax_params({"params": new.params}, LAYER_NUMS)
    want_stats = from_jax_params({"batch_stats": new.batch_stats},
                                 LAYER_NUMS)

    model = build_model(W2C, device="cpu")
    model.load_state_dict(from_jax_params(variables, LAYER_NUMS),
                          strict=True)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = (torch.optim.SGD(model.parameters(), lr=SGD_LR)
           if optimizer == "sgd"
           else build_optimizer(model.parameters(), opt_cfg)[0])
    assert (type(opt).__name__, opt.defaults["weight_decay"]) == (
        ("SGD", 0) if optimizer == "sgd" else ("AdamW", 1e-4))
    terms = make_train_step(model, build_loss(loss_cfg), spec, opt,
                            device="cpu")(batch)
    assert set(terms) == set(metrics)
    for key, value in metrics.items():
        np.testing.assert_allclose(float(terms[key]), float(value),
                                   rtol=1e-5, err_msg=key)
    state = model.state_dict()
    stats = [k for k in want_stats if k.endswith(("running_mean",
                                                  "running_var"))]
    assert stats
    for key in stats:
        _close_to_scale(state[key].numpy(), want_stats[key].numpy(), 1e-5,
                        key)
    single = {k for k in want if k.startswith("single_heads.")}
    assert single and set(want) == {k for k, _ in model.named_parameters()}
    held = total = 0
    for key, ref in want.items():
        got, ref, old = state[key].numpy(), ref.numpy(), before[key].numpy()
        if key in single:
            if optimizer == "sgd":
                np.testing.assert_array_equal(got, old, err_msg=key)
                np.testing.assert_array_equal(ref, old, err_msg=key)
            else:
                np.testing.assert_allclose(got, ref, rtol=3e-7, atol=0,
                                           err_msg=key)
                moved = int((old != 0).sum())
                assert moved and int((got != old).sum()) == moved == int(
                    (ref != old).sum()), key
            continue
        grad = model.get_parameter(key).grad.abs().numpy()
        settled = (np.ones(grad.shape, bool) if optimizer == "sgd" else
                   (grad >= 1e-2 * grad.max()) & (grad >= 1e-6))
        held, total = held + int(settled.sum()), total + grad.size
        np.testing.assert_allclose(got[settled], ref[settled], rtol=2e-4,
                                   atol=2e-6, err_msg=key)
    assert held >= 0.5 * total, (held, total)


def test_deform_forward_matches_jax():
    batch = _batch()
    jmodel, variables, jbatch, model = _jax_and_port(DEFORM, batch)
    head = variables["params"]["fusion"]["Dense_0"]
    head["kernel"] = np.random.default_rng(5).normal(
        0, 0.1, head["kernel"].shape).astype(np.float32)
    model.load_state_dict(from_jax_params(variables, LAYER_NUMS),
                          strict=True)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"cls_preds", "reg_preds", "dir_preds"}
    for key in want:
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]).transpose(0, 3, 1, 2),
            atol=1e-4, err_msg=key)


def test_build_fusion_deform_and_its_sampler():
    fusion = build_fusion("deform", {"deform": {"num_points": 2,
                                                "num_agents": 3}}, 8)
    assert isinstance(fusion, DeformableFusion)
    assert fusion.head.weight.shape == (3 * 2 * 3, 8)
    with pytest.raises(ValueError, match="3 agents"):
        fusion(torch.zeros(1, 2, 8, 6, 6), torch.zeros(1, 2, 2, 2, 3),
               torch.ones(1, 2, dtype=torch.bool))
    # the head starts at zero: every sample on its own pixel, uniform
    # weights over the valid agents, plus the ego's map
    model = build_model(DEFORM, device="cpu", seed=3)
    assert model.fusion_net.head.weight.abs().max() == 0
    rng = np.random.default_rng(7)
    src = rng.normal(size=(2, 5, 7, 9)).astype(np.float32)
    fx = rng.uniform(-3, 12, (2, 7, 9, 4)).astype(np.float32)
    fy = rng.uniform(-3, 10, (2, 7, 9, 4)).astype(np.float32)
    got = bilinear_sample(torch.from_numpy(src), torch.from_numpy(fx),
                          torch.from_numpy(fy))
    want = jax.vmap(_bilinear_gather)(jnp.asarray(src.transpose(0, 2, 3, 1)),
                                      jnp.asarray(fx), jnp.asarray(fy))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want).transpose(0, 4, 1, 2, 3), rtol=0,
        atol=1e-5)


@pytest.mark.parametrize("name", ["pointpillar_where2comm",
                                  "pointpillar_mash",
                                  "pointpillar_v2vnet_robust"])
def test_run_train_takes_the_yaml(tmp_path, name):
    """tools/run.py train on the repo's yaml (its widths, its loss), cut to
    +-12.8 m on a fixture tree, on the CPU: one epoch, the checkpoint, and
    the end-of-train eval through the yaml's fusion protocol."""
    from coalign_tpu_torch.tools import run
    from test_torch_cli import CPU, _tiny_yaml, _tree

    cfg = _tiny_yaml(tmp_path / "tiny.yaml", name, _tree(tmp_path / "opv2v",
                                                         seed=5))
    model_dir = str(tmp_path / "run")
    model, res = run.main(["train", "-y", cfg, "--model_dir", model_dir,
                           "--epochs", "1", "--eval_frames", "2", *CPU])
    assert type(model).__name__ == {
        "pointpillar_where2comm": "PointPillarWhere2comm",
        "pointpillar_mash": "PointPillarMash",
        "pointpillar_v2vnet_robust": "PointPillarV2VNetRobust"}[name]
    assert res["frames"] == 2 and np.isfinite(res["ap30"])
    assert os.path.exists(os.path.join(model_dir, "net_epoch1.pth"))
    assert res["bandwidth_mb_per_frame"] > 0
