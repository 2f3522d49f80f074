"""Training the seven OPV2V intermediate-fusion baselines in the port,
against the JAX package's make_train_step, at a tiny size on the CPU.

The yamls pointpillar_{fcooper,selfatt,selfatt_singlescale,disconet,
v2vnet,v2xvit,when2comm} each train with point_pillar_loss and AdamW
(lr 0.002, eps 1e-10, weight decay 1e-4). Here each model is cut to a
64 x 64 canvas, a plain backbone of [1, 1] blocks and L = 3 agent slots
(the third padded), with seeded weights and norms, and takes one step of
its yaml's loss and optimizer (coalign_tpu_torch.train.make_train_step
against coalign_tpu.train.make_train_step), held as
tests/test_torch_kd.py holds the KD step:

  * float64, where rounding lies far below the bounds: the loss terms
    within 1e-9 relative (both packages compute the anchor targets from
    the float64 gt boxes and cast them to float32); each gradient within 1e-7 of its tensor's
    largest value (plus 1e-12: DiscoNet's conv biases before a norm have a
    zero gradient in exact arithmetic) of the JAX step's (read from
    optax.adamw's first moment, mu = (1 - b1) g); the parameters after
    the AdamW step within 1e-9 where the gradient is settled (at least
    1e-2 of its tensor's largest and 1e-6: AdamW's first step moves an
    element by lr * g / (|g| + eps), its sign, which rounding can flip
    where |g| is tiny). The JAX package's float32 step is not the
    reference: at this size its rounding lies farther from its own float64
    step than tests/test_torch_train.py's bounds (ROADMAP item 2);
  * float32: the loss terms within 1e-5 of the float64 step's, and the
    settled parameters after the step within tests/test_torch_train.py's
    bounds (rtol 2e-4, atol 2e-6) of the port's float64 step's.

DiscoNet's pixel-weight norms and When2comm's cbr_units train as the JAX
norms do (test_fusion_norms_train_as_jax): unmasked statistics over every
agent frame, padded ones included, momentum 0.01 (flax's 0.99), eps 1e-3.
The periods and direction bins of fault 10 are held to the JAX package on
boundary yaws (test_periods_and_direction_bins_match_jax).
"""

import copy
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.loss import build_loss as jax_build_loss
from coalign_tpu.loss.point_pillar_loss import PointPillarLoss as JLoss
from coalign_tpu.loss.point_pillar_loss import PointPillarLossCfg as JLossCfg
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.models import layers as JLAYERS
from coalign_tpu.ops import warp as JWARP
from coalign_tpu.postprocess import anchors as JANC
from coalign_tpu.train import TrainState
from coalign_tpu.train import build_optimizer as jax_build_optimizer
from coalign_tpu.train import make_train_step as jax_make_train_step
from coalign_tpu.utils.common import limit_period as jax_limit_period
from coalign_tpu_torch.config.yaml_utils import load_yaml
from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.loss import build_loss
from coalign_tpu_torch.loss.point_pillar_loss import (PointPillarLoss,
                                                      PointPillarLossCfg)
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
from coalign_tpu_torch.train import build_optimizer, make_train_step
from coalign_tpu_torch.utils.common import limit_period
from coalign_tpu_torch.utils.weights import from_jax_params

from chip_smoke import HYPES, boundary_yaws
from test_torch_baselines import TINY, TINY_V2XVIT
from test_torch_flagship import _randomize_norms

torch.set_num_threads(1)
LR = [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0]
ARGS = {**TINY, "voxel_size": [0.4, 0.4, 4.0], "lidar_range": LR}
LAYER_NUMS = ARGS["base_bev_backbone"]["layer_nums"]
ANCHOR_ARGS = {"W": 64, "H": 64, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
               "vw": 0.4, "vh": 0.4, "feature_stride": 2,
               "cav_lidar_range": LR}
TARGETS = {"pos_threshold": 0.3, "neg_threshold": 0.2}
# each yaml's model and fusion at the tiny widths of tests/test_torch_
# baselines.py
BASELINES = {
    "pointpillar_fcooper": {"fusion_method": "max"},
    "pointpillar_selfatt": {"fusion_method": "att"},
    "pointpillar_selfatt_singlescale": {"fusion_method": "att"},
    "pointpillar_disconet": {"fusion_method": "disconet"},
    "pointpillar_v2vnet": {"fusion_method": "v2vnet", "v2vnet": {
        "num_iteration": 2, "agg_operator": "avg",
        "conv_gru": {"kernel_size": [[3, 3]]}}},
    "pointpillar_v2xvit": {"fusion_method": "v2xvit", "v2xvit": TINY_V2XVIT},
    "pointpillar_when2comm": {"fusion_method": "when2comm", "when2comm": {
        "query_size": 8, "key_size": 16}},
}


def _yaml(name: str) -> dict:
    return load_yaml(f"{HYPES}/{name}.yaml")


def _model_cfg(name: str) -> dict:
    return {"core_method": _yaml(name)["model"]["core_method"],
            "args": {**ARGS, **BASELINES[name]}}


@pytest.fixture(scope="module")
def batch():
    """1 frame of 2 agents in L = 3 slots (the third padded), 512 points
    an agent, tests/test_kd.py's first scene (one frame: the JAX float64
    step of When2comm's 512-channel convs takes ~11 s a frame on the
    CPU)."""
    scenes = SyntheticScenes(num_frames=1, num_agents=2, num_objects=3,
                             lidar_range=LR, points_per_object=32,
                             ground_points=64, seed=4)
    return IntermediateFusionBatcher(
        max_cav=3, max_points=512, max_objects=8, lidar_range=LR,
        native=False).assemble([scenes[0]])


def seeded_pair(cfg: dict, batch: dict, key: int, layer_nums=LAYER_NUMS):
    """The JAX model with seeded variables (norms randomized) and the
    port's model with the same weights, on the CPU."""
    jmodel = jax_build_model(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(key), jbatch, train=False)),
        np.random.default_rng(key))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(variables, layer_nums),
                          strict=True)
    return jmodel, variables, model


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating)
        else jnp.asarray(a), tree)


def jax_step_float64(monkeypatch, jmodel, variables, loss_cfg, spec,
                     opt_cfg, batch, layer_nums=LAYER_NUMS):
    """One coalign_tpu.train.make_train_step in float64 under the yaml's
    optimizer (optax.adamw): (loss terms, gradients, parameters after the
    step), the last two as port state-dict tensors in float64. The JAX
    package pins its batch norms' statistics and the warp's sampling grid
    to float32 (models/layers.py, ops/warp.py); for this run those two
    modules see float64 where they name float32. The gradient is the
    first moment over (1 - b1)."""
    jnp64 = types.ModuleType("jax.numpy")
    jnp64.__dict__.update(vars(jnp))
    jnp64.float32 = jnp.float64
    with monkeypatch.context() as patch, jax.enable_x64(True):
        patch.setattr(JLAYERS, "jnp", jnp64)
        patch.setattr(JWARP, "jnp", jnp64)
        v64 = _float64(variables)
        state = TrainState.create(apply_fn=jmodel.apply,
                                  params=v64["params"],
                                  batch_stats=v64["batch_stats"],
                                  tx=jax_build_optimizer(opt_cfg, None))
        new, metrics = jax_make_train_step(
            jmodel, jax_build_loss(loss_cfg), spec, donate=False)(
            state, _float64(batch))
        new = jax.tree_util.tree_map(np.asarray, new)
    mu = new.opt_state[0].mu
    assert jax.tree_util.tree_leaves(mu)[0].dtype == np.float64

    def as_port(tree):
        # from_jax_params casts to float32: convert the float64 values as
        # two float32 parts, hi + lo, summed back in float64
        hi = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
        lo = jax.tree_util.tree_map(lambda a, h: (a - h).astype(np.float32),
                                    tree, hi)
        hi, lo = (from_jax_params({"params": t}, layer_nums)
                  for t in (hi, lo))
        return {k: hi[k].double() + lo[k].double() for k in hi}

    grads = as_port(jax.tree_util.tree_map(lambda m: m / (1 - 0.9), mu))
    return ({k: float(v) for k, v in metrics.items()}, grads,
            as_port(new.params))


def port_step(model, batch, loss_cfg, spec, opt_cfg, dtype):
    """A copy of ``model`` after one make_train_step in ``dtype`` under the
    yaml's optimizer: (loss terms, gradients, parameters), float64."""
    model = copy.deepcopy(model).to(dtype)
    opt = build_optimizer(model.parameters(), opt_cfg)[0]
    terms = make_train_step(model, build_loss(loss_cfg), spec, opt,
                            device="cpu")(batch)
    return ({k: float(v) for k, v in terms.items()},
            {k: p.grad.detach().double() for k, p in model.named_parameters()},
            {k: p.detach().double() for k, p in model.named_parameters()})


def settled(grad: torch.Tensor) -> torch.Tensor:
    """The elements whose AdamW first step is their gradient's sign
    whatever the rounding: |g| at least 1e-2 of the tensor's largest and
    1e-6."""
    g = grad.abs()
    return (g >= 1e-2 * g.max()) & (g >= 1e-6)


def hold_step(monkeypatch, jmodel, variables, model, batch, loss_cfg,
              anchor_args, targets, opt_cfg, layer_nums=LAYER_NUMS,
              spec=None, jspec=None, frozen=()):
    """The module docstring's bounds on one step; returns the worst
    gradient error as a share of its bound. Parameters whose names start
    with one of ``frozen`` (a frozen encoder's: zero gradient by design,
    held exactly by the caller) stay out of the share of settled
    elements."""
    spec = spec or make_anchor_spec(anchor_args, targets)
    jspec = jspec or JANC.make_anchor_spec(anchor_args, targets)
    metrics, want_grads, want_params = jax_step_float64(
        monkeypatch, jmodel, variables, loss_cfg, jspec, opt_cfg, batch,
        layer_nums)
    terms64, grads64, params64 = port_step(model, batch, loss_cfg, spec,
                                           opt_cfg, torch.float64)
    assert set(terms64) == set(metrics)
    for key, want in metrics.items():
        np.testing.assert_allclose(terms64[key], want, rtol=1e-9,
                                   err_msg=key)
    assert set(want_grads) == set(grads64) == {
        k for k, _ in model.named_parameters()}
    worst = 0.0
    for key, want in want_grads.items():
        bound = 1e-7 * float(want.abs().max()) + 1e-12
        err = float((grads64[key] - want).abs().max())
        assert err <= bound, (key, err, bound)
        worst = max(worst, err / bound)
        ok = settled(want)
        torch.testing.assert_close(params64[key][ok], want_params[key][ok],
                                   rtol=1e-9, atol=1e-12, msg=key)
    terms32, _, params32 = port_step(model, batch, loss_cfg, spec, opt_cfg,
                                     torch.float32)
    for key, want in terms64.items():
        np.testing.assert_allclose(terms32[key], want, rtol=1e-5,
                                   err_msg=key)
    held = total = 0
    for key, want in params64.items():
        ok = settled(grads64[key])
        if not key.startswith(tuple(frozen)):
            held, total = held + int(ok.sum()), total + ok.numel()
        np.testing.assert_allclose(params32[key][ok].numpy(),
                                   want[ok].numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=key)
    assert held >= 0.5 * total, (held, total)
    return worst


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_step_matches_jax(name, batch, monkeypatch):
    y = _yaml(name)
    assert y["loss"]["core_method"] == "point_pillar_loss"
    assert y["optimizer"]["args"]["weight_decay"] == 1e-4
    cfg = _model_cfg(name)
    jmodel, variables, model = seeded_pair(cfg, batch, key=3)
    assert not batch["agent_mask"].all()            # a padded agent slot
    worst = hold_step(monkeypatch, jmodel, variables, model, batch,
                      y["loss"], ANCHOR_ARGS, TARGETS, y["optimizer"])
    print(f"{name}: float64 gradient, worst {worst:.3g} of the bound")


@pytest.mark.parametrize("name", ["pointpillar_disconet",
                                  "pointpillar_when2comm"])
def test_fusion_norms_train_as_jax(name, batch):
    """A train-mode forward of the whole model from the same weights: every
    running statistic of the fusion's norms (DiscoNet's bn1_1..3,
    When2comm's cbr_unit norms) moves as the JAX package's (within 1e-5 of
    its tensor's largest magnitude, the move itself within 1e-4 of its
    largest), and the outputs agree within 1e-4 of their largest."""
    cfg = _model_cfg(name)
    jmodel, variables, model = seeded_pair(cfg, batch, key=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, mutated = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=True, mutable=["batch_stats"]))(variables, jbatch)
    new = from_jax_params({"params": variables["params"],
                           "batch_stats": jax.tree_util.tree_map(
                               np.asarray, mutated["batch_stats"])},
                          LAYER_NUMS)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    with torch.no_grad():
        got = model({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()})
    for key in ("cls_preds", "reg_preds"):
        g = got[key].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[key])
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), key
    state = model.state_dict()
    stats = [k for k in new if k.startswith("fusion_net.")
             and k.endswith(("running_mean", "running_var"))]
    assert len(stats) == (6 if name.endswith("disconet") else 2 * 7)
    for key in stats:
        w = new[key].numpy()
        move, want_move = (state[key].numpy() - before[key].numpy(),
                           w - before[key].numpy())
        assert np.abs(state[key].numpy() - w).max() <= 1e-5 * np.abs(w).max()
        assert np.abs(move - want_move).max() <= 1e-4 * np.abs(
            want_move).max(), key
        assert np.abs(want_move).max() > 0, key


def test_periods_and_direction_bins_match_jax():
    """Fault 10: limit_period and the direction bins divide by a tensor.
    On yaws at and one float32 ulp beside k pi / 2 and k 2 pi and on
    100,000 random ones, the wrapped values (period 2 pi, offset 0.5; the
    decode's period pi, offset 0) equal the JAX package's exactly, and so
    do the loss's direction bins (dir_offset 0, anchor yaws 0, so that the
    yaw itself is binned)."""
    yaws = boundary_yaws(100_000)
    t = torch.from_numpy(yaws)
    for offset, period in ((0.5, 2 * math.pi), (0.0, math.pi)):
        want = np.asarray(jax_limit_period(jnp.asarray(yaws), offset, period))
        np.testing.assert_array_equal(limit_period(t, offset, period).numpy(),
                                      want)
    cfg = dict(dir_offset=0.0, num_bins=2, anchor_yaw_deg=(0.0, 0.0))
    reg = np.zeros((1, len(yaws), 7), np.float32)
    reg[0, :, 6] = yaws
    got = PointPillarLoss(PointPillarLossCfg(**cfg))._direction_targets(
        torch.from_numpy(reg))
    want = JLoss(JLossCfg(**cfg))._direction_targets(jnp.asarray(reg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got[..., 1].mean()) < 1
