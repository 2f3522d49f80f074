"""The port's single-agent PointPillars (``point_pillar``,
``point_pillar_uncertainty``) against the reference recordings and the JAX
package.

  * point_pillar_{resnet,base}.pth and point_pillar_uncertainty.pth load
    with strict=True and reproduce the reference's recorded head maps at
    tests/test_ckpt_import.py's bounds (1e-4; rtol 2e-3 / atol 1e-3 for the
    3-scale uncertainty model, whose activations reach O(100));
  * JAX variables -> from_jax_params -> strict load give the JAX model's
    maps within 1e-4 at tiny widths, B = 2 frames of L = 2 agents with one
    padded agent, for both backbones, with an extra deblock and the
    uncertainty head, in eval and in training mode;
  * from_jax_params splits a ResNet trunk into stages by the model's
    layer_nums, so a stride-1 stage of equal width loads.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.utils.weights import from_jax_params, load_pth

from test_torch_flagship import _randomize_norms

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# tests/test_ckpt_import.py's TINY_ARGS (that module's fixtures are not
# imported, so the dict is repeated)
CKPT_ARGS = {
    "voxel_size": [0.4, 0.4, 4.0],
    "lidar_range": [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0],
    "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [64],
                   "pad_parity": True},
    "point_pillar_scatter": {"num_features": 64},
    "base_bev_backbone": {"layer_nums": [2, 2], "layer_strides": [2, 2],
                          "num_filters": [32, 64], "upsample_strides": [1, 2],
                          "num_upsample_filter": [64, 64]},
    "shrink_header": {"kernal_size": [3], "stride": [1], "padding": [1],
                      "dim": [64], "input_dim": 128},
    "dir_args": {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]},
}
# tests/test_ckpt_import.py:311-320, the uncertainty golden's model
UNC_ARGS = {**{k: v for k, v in CKPT_ARGS.items() if k != "shrink_header"},
            "uncertainty_dim": 3,
            "base_bev_backbone": {
                "layer_nums": [2, 2, 2], "layer_strides": [2, 2, 2],
                "num_filters": [64, 128, 256], "upsample_strides": [1, 2, 4],
                "num_upsample_filter": [128, 128, 128], "resnet": False}}

# the tiny widths of the JAX comparison: 32 x 32 canvas, 2 scales
TINY = {
    "voxel_size": [0.5, 0.5, 4.0],
    "lidar_range": [-8.0, -8.0, -3.0, 8.0, 8.0, 1.0],
    "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [16]},
    "point_pillar_scatter": {"num_features": 16},
    "dir_args": {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]},
}


def _tiny_cfg(backbone: str, variant: str) -> dict:
    bb = {"layer_nums": [1, 2], "layer_strides": [2, 2],
          "num_filters": [16, 32], "upsample_strides": [1, 2],
          "num_upsample_filter": [8, 8], "resnet": backbone == "resnet"}
    args = dict(TINY, base_bev_backbone=bb)
    if variant == "uncertainty_extra_deblock":
        bb["upsample_strides"] = [1, 2, 2]
        return {"core_method": "point_pillar_uncertainty", "args": args}
    args["shrink_header"] = {"kernal_size": [3], "stride": [1],
                             "padding": [1], "dim": [16], "input_dim": 16}
    return {"core_method": "point_pillar", "args": args}


def _golden_batch(points, n=512):
    batch = {"points": np.zeros((1, 1, n, 4), np.float32),
             "point_mask": np.zeros((1, 1, n), bool),
             "agent_mask": np.ones((1, 1), bool)}
    batch["points"][0, 0, :len(points)] = points
    batch["point_mask"][0, 0, :len(points)] = True
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _tiny_batch(seed=0):
    """B = 2 frames of L = 2 agent slots, the second frame's second agent
    padded; 300 points per agent slot, the last 60 padded."""
    rng = np.random.default_rng(seed)
    points = np.zeros((2, 2, 300, 4), np.float32)
    points[..., :2] = rng.uniform(-7.5, 7.5, (2, 2, 300, 2))
    points[..., 2] = rng.uniform(-2.5, 0.5, (2, 2, 300))
    points[..., 3] = rng.uniform(0, 1, (2, 2, 300))
    pmask = np.ones((2, 2, 300), bool)
    pmask[..., 240:] = False
    agent_mask = np.array([[True, True], [True, False]])
    pmask &= agent_mask[..., None]
    points *= pmask[..., None]
    return {"points": points, "point_mask": pmask, "agent_mask": agent_mask}


@pytest.mark.parametrize("tag,resnet", [("resnet", True), ("base", False)])
def test_reference_checkpoint_reproduces_recorded_maps(tag, resnet):
    io = np.load(os.path.join(GOLDEN, f"point_pillar_{tag}_io.npz"))
    args = {**CKPT_ARGS, "base_bev_backbone": {
        **CKPT_ARGS["base_bev_backbone"], "resnet": resnet}}
    model = build_model({"core_method": "point_pillar", "args": args},
                        device="cpu")
    load_pth(model, os.path.join(GOLDEN, f"point_pillar_{tag}.pth"))
    with torch.no_grad():
        out = model(_golden_batch(io["points"]))
    assert set(out) == {"cls_preds", "reg_preds", "dir_preds"}
    for key in out:
        np.testing.assert_allclose(out[key].numpy(), io[key], atol=1e-4,
                                   err_msg=key)


def test_uncertainty_checkpoint_reproduces_recorded_maps():
    io = np.load(os.path.join(GOLDEN, "point_pillar_uncertainty_io.npz"))
    model = build_model({"core_method": "point_pillar_uncertainty",
                         "args": UNC_ARGS}, device="cpu")
    load_pth(model, os.path.join(GOLDEN, "point_pillar_uncertainty.pth"))
    with torch.no_grad():
        out = model(_golden_batch(io["points"]))
    assert out["unc_preds"].shape == (1, 6, 32, 32)
    for key in ("cls_preds", "reg_preds", "dir_preds", "unc_preds"):
        np.testing.assert_allclose(out[key].numpy(), io[key], rtol=2e-3,
                                   atol=1e-3, err_msg=key)


def _jax_and_port(cfg: dict, batch: dict, key: int):
    jmodel = jax_build_model(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(key), jbatch, train=False)),
        np.random.default_rng(key))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(
        variables, cfg["args"]["base_bev_backbone"]["layer_nums"]),
        strict=True)
    return jmodel, variables, jbatch, model


@pytest.mark.parametrize("variant", ["point_pillar",
                                     "uncertainty_extra_deblock"])
@pytest.mark.parametrize("backbone", ["resnet", "base"])
@pytest.mark.parametrize("train", [False, True])
def test_matches_jax_at_tiny_widths(backbone, variant, train):
    cfg = _tiny_cfg(backbone, variant)
    batch = _tiny_batch()
    jmodel, variables, jbatch, model = _jax_and_port(cfg, batch, 3)
    if train:
        want, _ = jax.jit(lambda v, b: jmodel.apply(
            v, b, train=True, mutable=["batch_stats"]))(variables, jbatch)
        model.train()
    else:
        want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, jbatch)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    keys = {"cls_preds", "reg_preds", "dir_preds"}
    if variant != "point_pillar":
        keys.add("unc_preds")
    assert set(got) == set(want) == keys
    for key in keys:
        mine = got[key].numpy()
        assert mine.shape[0] == 4                       # B * L frames
        np.testing.assert_allclose(
            mine, np.asarray(want[key]).transpose(0, 3, 1, 2), rtol=0,
            atol=1e-4, err_msg=key)


def test_stride1_stage_of_equal_width_loads_from_jax():
    # a second ResNet stage that neither strides nor widens has no block
    # with a downsample conv: its blocks are told from the first stage's
    # only by the backbone's layer_nums
    cfg = _tiny_cfg("resnet", "point_pillar")
    cfg["args"]["base_bev_backbone"].update(
        layer_nums=[1, 2], layer_strides=[2, 1], num_filters=[16, 16],
        upsample_strides=[1, 1])
    batch = _tiny_batch(1)
    jmodel, variables, jbatch, model = _jax_and_port(cfg, batch, 4)
    assert "backbone.resnet.layer1.1.conv2.weight" in model.state_dict()
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in got:
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]).transpose(0, 3, 1, 2),
            rtol=0, atol=1e-4, err_msg=key)


def test_trunk_without_layer_nums_is_refused():
    cfg = _tiny_cfg("resnet", "point_pillar")
    batch = {k: jnp.asarray(v) for k, v in _tiny_batch().items()}
    variables = jax.tree_util.tree_map(np.asarray, jit_init(
        jax_build_model(cfg), jax.random.PRNGKey(0), batch, train=False))
    with pytest.raises(ValueError, match="layer_nums"):
        from_jax_params(variables)


def test_iou_head_is_not_ported():
    """The IoU head, refused until the SECOND family came, is
    ported: a point_pillar with ``use_iou_head`` gives the JAX model's
    iou_preds beside its other maps (1e-4), its weights through
    from_jax_params."""
    cfg = _tiny_cfg("base", "point_pillar")
    cfg["args"]["use_iou_head"] = True
    batch = _tiny_batch(2)
    jmodel, variables, jbatch, model = _jax_and_port(cfg, batch, 5)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"cls_preds", "reg_preds", "dir_preds",
                                     "iou_preds"}
    for key in got:
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]).transpose(0, 3, 1, 2),
            rtol=0, atol=1e-4, err_msg=key)
