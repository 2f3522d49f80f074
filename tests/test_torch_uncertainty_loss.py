"""The port's stage-1 loss (coalign_tpu_torch/loss/uncertainty_loss.py)
against the JAX package's (coalign_tpu/loss/uncertainty_loss.py) on the
CPU, on the same head maps and labels.

Bounds:
  * the total and unc_loss within 1e-5 relative in float32 (sums of a few
    thousand terms in another order), for l1 / l2 xy losses, von-Mises / l2
    angle losses, limit_period on and off, with and without a sample mask;
  * the gradients with respect to every head map within 1e-8 in float64
    (the same arithmetic; the JAX side under jax.enable_x64);
  * the angular term elementwise over log-variances in [-7, 7] within
    1e-6 * (1 + kappa), kappa = exp(-s): it is a difference of terms of
    size kappa (up to e^7 = 1097, where float32's ulp is 1.2e-4), and near
    s = +7, kappa = exp(-7) and log(i0e(kappa)) + kappa cancels in float32
    (torch gives 2.31e-7, JAX 5.18e-8, the true value 2.08e-7), so a bound
    relative to the term's own value would measure float32 rounding;
  * the yaml's own ``loss`` subtree builds the same loss in both packages,
    with the weight 1.0 that both read from ``loss.args.uncertainty``
    (the yaml writes its 0.5 under ``kl``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coalign_tpu.config.yaml_utils import load_yaml as jax_load_yaml
from coalign_tpu.loss import build_loss as jax_build_loss
from coalign_tpu.loss import uncertainty_loss as JU
from coalign_tpu.postprocess import anchors as JANC
from coalign_tpu_torch.config.yaml_utils import load_yaml
from coalign_tpu_torch.loss import build_loss
from coalign_tpu_torch.loss import uncertainty_loss as TU

from test_end2end import ANCHOR_ARGS, LOSS_ARGS, POSTPROCESS

torch.set_num_threads(1)

YAML = os.path.join(os.path.dirname(__file__), "..", "coalign_tpu",
                    "hypes_yaml", "opv2v", "pointpillar_uncertainty.yaml")


def _labels():
    """JAX labels of a B = 2 batch of seeded gt boxes (numpy)."""
    rng = np.random.default_rng(0)
    gt = np.zeros((2, 8, 7), np.float32)
    gt[..., :2] = rng.uniform(-12, 12, (2, 8, 2))
    gt[..., 2] = -1.0
    gt[..., 3:6] = [1.6, 1.8, 4.2]
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (2, 8))
    mask = np.zeros((2, 8), bool)
    mask[0, :6] = mask[1, :4] = True
    spec = JANC.make_anchor_spec(ANCHOR_ARGS, POSTPROCESS["target_args"])
    labels = jax.vmap(lambda g, m: JANC.assign_targets(g, m, spec))(
        jnp.asarray(gt), jnp.asarray(mask))
    labels = jax.tree_util.tree_map(np.asarray, labels)
    assert labels["pos_equal_one"].sum() >= 10
    return labels


def _maps(h, w, dtype=np.float32):
    """NHWC head maps; log-variances of scale 4, so that the clamp at +-7
    is reached."""
    rng = np.random.default_rng(1)
    maps = {"cls_preds": rng.normal(0, 2, (2, h, w, 2)),
            "reg_preds": rng.normal(0, 1, (2, h, w, 14)),
            "dir_preds": rng.normal(0, 1, (2, h, w, 4)),
            "unc_preds": rng.normal(0, 4, (2, h, w, 6))}
    assert (np.abs(maps["unc_preds"]) > 7).any()
    return {k: v.astype(dtype) for k, v in maps.items()}


def _nchw(maps, requires_grad=False):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2).requires_grad_(
        requires_grad) for k, v in maps.items()}


def _args(xy, angle, limit_period):
    return dict(LOSS_ARGS, uncertainty={
        "xy_loss_type": xy, "angle_loss_type": angle,
        "limit_period": limit_period, "weight": 0.7, "angle_weight": 1.3})


CASES = [("l2", "von-mise", True), ("l2", "von-mise", False),
         ("l1", "von-mise", True), ("l1", "von-mise", False),
         ("l2", "l2", True), ("l1", "l2", False)]


@pytest.mark.parametrize("xy,angle,limit_period", CASES)
def test_loss_matches_jax(xy, angle, limit_period):
    labels = _labels()
    maps = _maps(*labels["pos_equal_one"].shape[1:3])
    args = _args(xy, angle, limit_period)
    jloss, loss = JU.build_uncertainty_loss(args), build_loss(
        {"core_method": "point_pillar_uncertainty_loss", "args": args})
    assert isinstance(loss, TU.PointPillarUncertaintyLoss)
    assert loss.unc == TU.UncertaintyCfg(*jloss.unc)
    for sample_mask in (None, np.array([True, False])):
        _, want = jloss({k: jnp.asarray(v) for k, v in maps.items()},
                        labels, sample_mask=sample_mask)
        _, got = loss(_nchw(maps), {k: torch.from_numpy(v.copy())
                                    for k, v in labels.items()},
                      sample_mask=None if sample_mask is None
                      else torch.from_numpy(sample_mask))
        assert set(got) == set(want) == {"cls_loss", "reg_loss", "dir_loss",
                                         "unc_loss", "total_loss"}
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=key)
        assert abs(float(want["unc_loss"])) > 1e-2


@pytest.mark.parametrize("xy,angle,limit_period", CASES[:3] + CASES[4:5])
def test_loss_gradients_match_jax_in_float64(xy, angle, limit_period):
    labels = {k: v.astype(np.float64) for k, v in _labels().items()}
    maps = _maps(*labels["pos_equal_one"].shape[1:3], dtype=np.float64)
    args = _args(xy, angle, limit_period)
    with jax.enable_x64(True):
        jloss = JU.build_uncertainty_loss(args)
        jlabels = {k: jnp.asarray(v) for k, v in labels.items()}
        want = jax.grad(lambda m: jloss(m, jlabels)[0])(
            {k: jnp.asarray(v) for k, v in maps.items()})
        want = {k: np.asarray(v) for k, v in want.items()}
    assert all(v.dtype == np.float64 for v in want.values())
    tmaps = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in maps.items()}
    total, _ = TU.build_uncertainty_loss(args)(
        {k: v.permute(0, 3, 1, 2) for k, v in tmaps.items()},
        {k: torch.from_numpy(v) for k, v in labels.items()})
    total.backward()
    for key, w in want.items():
        got = tmaps[key].grad.numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-8, err_msg=key)
        assert np.abs(w).max() > 1e-6, key
    # the log-variances beyond the clamp carry no gradient
    clamped = np.abs(maps["unc_preds"]) > 7
    assert (tmaps["unc_preds"].grad.numpy()[clamped] == 0).all()


@pytest.mark.parametrize("limit_period", [True, False])
def test_angular_term_matches_jax_elementwise(limit_period):
    s = np.linspace(-7.0, 7.0, 281, dtype=np.float32)[:, None]
    diff = np.linspace(-4.0, 4.0, 17, dtype=np.float32)[None, :]
    s, diff = np.broadcast_arrays(s, diff)
    want = np.asarray(JU.kl_loss_angular(jnp.asarray(diff), jnp.asarray(s),
                                         0.001, 1.0, limit_period))
    got = TU.kl_loss_angular(torch.from_numpy(diff.copy()),
                             torch.from_numpy(s.copy()), 0.001, 1.0,
                             limit_period).numpy()
    err = np.abs(got - want) / (1.0 + np.exp(-s.astype(np.float64)))
    assert err.max() <= 1e-6, err.max()


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_xy_term_matches_jax_elementwise(kind):
    rng = np.random.default_rng(2)
    diff = rng.normal(0, 2, 500).astype(np.float32)
    s = rng.uniform(-7, 7, 500).astype(np.float32)
    want = np.asarray(JU.kl_loss_xy(jnp.asarray(diff), jnp.asarray(s), kind))
    got = TU.kl_loss_xy(torch.from_numpy(diff), torch.from_numpy(s),
                        kind).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_the_yaml_builds_the_same_loss_with_weight_one():
    loss_cfg = load_yaml(YAML)["loss"]
    jcfg = jax_load_yaml(YAML)["loss"]
    assert loss_cfg == jcfg
    assert loss_cfg["core_method"] == "point_pillar_uncertainty_loss"
    assert loss_cfg["args"]["kl"]["weight"] == 0.5
    loss, jloss = build_loss(loss_cfg), jax_build_loss(jcfg)
    assert loss.unc.weight == jloss.unc.weight == 1.0
    labels = _labels()
    maps = _maps(*labels["pos_equal_one"].shape[1:3])
    want, _ = jloss({k: jnp.asarray(v) for k, v in maps.items()}, labels)
    got, terms = loss(_nchw(maps), {k: torch.from_numpy(v.copy())
                                    for k, v in labels.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert "unc_loss" in terms
    # the alias of the reference's registry
    alias = build_loss({"core_method": "point_pillar_unc_loss",
                        "args": loss_cfg["args"]})
    assert alias.unc == loss.unc and alias.cfg == loss.cfg
