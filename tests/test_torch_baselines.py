"""The port's intermediate-fusion baselines (point_pillar_baseline with every
ported fusion, point_pillar_intermediate, point_pillar_disconet, the
flagship's compression path) against the reference recordings and the JAX
package, on the CPU.

  * baseline_{disconet,v2vnet,when2comm,v2xvit}.pth load with strict=True
    and reproduce the reference's recorded head maps at
    tests/test_ckpt_import.py's bound (2e-4), the models built with that
    test's args;
  * naive_compressor.pth reproduces naive_compressor_io.npz (1e-5);
  * JAX variables (seeded, norms randomized) -> from_jax_params -> strict
    load give the JAX model's maps within 1e-4 (float32) at a 24 x 24
    canvas, B = 2 frames of L = 3 agent slots with one padded: the
    fused map is 12 x 12, no multiple of V2X-ViT's windows of 8 and 16;
  * a tiny baseline through make_infer_fn gives the JAX infer fn's boxes;
  * a model without a direction head resolves its boxes' heading as the
    JAX infer fns do, with zero direction logits (make_infer_fn,
    make_late_infer_fn);
  * the JAX package's options that no published yaml sets raise
    NotImplementedError.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.inference import make_infer_fn as jax_make_infer_fn
from coalign_tpu.inference import make_late_infer_fn as jax_make_late_infer_fn
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.utils import transforms as JT
from coalign_tpu_torch.inference import make_infer_fn, make_late_infer_fn
from coalign_tpu_torch.models.layers import NaiveCompressor
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
from coalign_tpu_torch.utils.weights import from_jax_params, load_pth

from test_torch_flagship import _randomize_norms
from test_torch_pointpillar import CKPT_ARGS

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
sys.path.insert(0, GOLDEN)
from generate_fixtures import V2XVIT_ARGS  # noqa: E402

# tests/test_ckpt_import.py:140-308: the recordings' models, each a
# point_pillar_baseline on the plain backbone with its fusion's args
RECORDED = {
    "disconet": {"fusion_method": "disconet", "disconet": {"feat_dim": 64}},
    "v2vnet": {"fusion_method": "v2vnet", "v2vnet": {
        "in_channels": 64, "num_iteration": 2, "gru_flag": True,
        "agg_operator": "avg", "conv_gru": {
            "H": 32, "W": 32, "kernel_size": [[3, 3]], "num_layers": 1}}},
    "when2comm": {"fusion_method": "when2comm", "when2comm": {
        "in_channels": 64, "H": 32, "W": 32, "query_size": 32,
        "key_size": 256}},
    "v2xvit": {"fusion_method": "v2xvit", "v2xvit": V2XVIT_ARGS,
               "shrink_header": {"kernal_size": [3], "stride": [1],
                                 "padding": [1], "dim": [256],
                                 "input_dim": 128}},
}

# the JAX comparison: a 24 x 24 canvas of 0.8 m pillars, the plain
# backbone, a shrink to 32 channels; the fused map is 12 x 12
LR = [-9.6, -9.6, -3.0, 9.6, 9.6, 1.0]
DIR_ARGS = {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]}
TINY = {
    "voxel_size": [0.8, 0.8, 4.0], "lidar_range": LR, "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [16]},
    "point_pillar_scatter": {"num_features": 16},
    "base_bev_backbone": {"layer_nums": [1, 1], "layer_strides": [2, 2],
                          "num_filters": [16, 32],
                          "upsample_strides": [1, 2],
                          "num_upsample_filter": [16, 16], "resnet": False},
    "shrink_header": {"kernal_size": [3], "stride": [1], "padding": [1],
                      "dim": [32], "input_dim": 32},
    "dir_args": DIR_ARGS,
}
LAYER_NUMS = TINY["base_bev_backbone"]["layer_nums"]
TINY_V2XVIT = {"transformer": {"encoder": {
    "num_blocks": 1, "depth": 2,
    "cav_att_config": {"dim": 32, "use_hetero": True, "heads": 2,
                       "dim_head": 8},
    "pwindow_att_config": {"dim": 32, "heads": [2, 2, 1],
                           "dim_head": [8, 8, 16], "window_size": [4, 8, 16],
                           "relative_pos_embedding": True,
                           "fusion_method": "split_attn"},
    "feed_forward": {"mlp_dim": 48}}}}
# (core_method, args on top of TINY)
CASES = {
    "baseline_max": ("point_pillar_baseline", {"fusion_method": "max"}),
    "baseline_att": ("point_pillar_baseline", {"fusion_method": "att"}),
    "baseline_mean": ("point_pillar_baseline", {"fusion_method": "mean"}),
    "baseline_max_compressed": ("point_pillar_baseline",
                                {"fusion_method": "max", "compression": 4}),
    "baseline_disconet": ("point_pillar_baseline",
                          {"fusion_method": "disconet"}),
    "baseline_v2vnet_avg": ("point_pillar_baseline", {
        "fusion_method": "v2vnet",
        "v2vnet": {"num_iteration": 2, "agg_operator": "avg",
                   "conv_gru": {"kernel_size": [[3, 3]]}}}),
    "baseline_v2vnet_max": ("point_pillar_baseline", {
        "fusion_method": "v2vnet",
        "v2vnet": {"num_iteration": 2, "agg_operator": "max"}}),
    "baseline_when2comm": ("point_pillar_baseline",
                           {"fusion_method": "when2comm",
                            "when2comm": {"query_size": 8, "key_size": 16}}),
    "baseline_v2xvit": ("point_pillar_baseline", {"fusion_method": "v2xvit",
                                                  "v2xvit": TINY_V2XVIT}),
    # plain agent attention (use_hetero: false)
    "baseline_v2xvit_cav": ("point_pillar_baseline", {
        "fusion_method": "v2xvit", "v2xvit": {"transformer": {"encoder": {
            **TINY_V2XVIT["transformer"]["encoder"], "depth": 1,
            "cav_att_config": {"dim": 32, "use_hetero": False, "heads": 2,
                               "dim_head": 8}}}}}),
    "intermediate": ("point_pillar_intermediate", {}),
    "disconet": ("point_pillar_disconet", {}),
    # the reference compresses the 64-channel pillar canvas
    "multiscale_compressed": ("point_pillar_baseline_multiscale", {
        "fusion_method": "att", "compression": 4,
        "pillar_vfe": {**TINY["pillar_vfe"], "num_filters": [64]},
        "point_pillar_scatter": {"num_features": 64}}),
}
ANCHOR_ARGS = {"W": 24, "H": 24, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
               "vw": 0.8, "vh": 0.8, "feature_stride": 2,
               "cav_lidar_range": LR}


def _cfg(case: str) -> dict:
    core, extra = CASES[case]
    return {"core_method": core, "args": {**TINY, **extra}}


def _batch(seed: int = 0) -> dict:
    """B = 2 frames of L = 3 agent slots, the second frame's last slot
    padded; 200 points an agent, the last 40 padded; agents within 3 m and
    25 degrees of the ego."""
    rng = np.random.default_rng(seed)
    b, l, n = 2, 3, 200
    points = np.zeros((b, l, n, 4), np.float32)
    points[..., :2] = rng.uniform(-9.0, 9.0, (b, l, n, 2))
    points[..., 2] = rng.uniform(-2.5, 0.5, (b, l, n))
    points[..., 3] = rng.uniform(0, 1, (b, l, n))
    agent_mask = np.array([[True, True, True], [True, True, False]])
    pmask = np.ones((b, l, n), bool)
    pmask[..., 160:] = False
    pmask &= agent_mask[..., None]
    points *= pmask[..., None]
    poses = np.zeros((b, l, 6), np.float32)
    poses[:, 1:, :2] = rng.uniform(-3, 3, (b, l - 1, 2))
    poses[:, 1:, 4] = rng.uniform(-25, 25, (b, l - 1))
    pairwise = np.asarray(JT.get_pairwise_transformation(poses, agent_mask))
    return {"points": points, "point_mask": pmask, "agent_mask": agent_mask,
            "pairwise_t_matrix": pairwise.astype(np.float32),
            "transformation_matrix": np.tile(np.eye(4, dtype=np.float32),
                                             (b, 1, 1))}


def _jax_and_port(cfg: dict, batch: dict, key: int = 0,
                  head_gains: dict | None = None):
    """The JAX model with seeded variables (batch norms and layer norms
    randomized, each head's kernel in ``head_gains`` times its gain) and
    the port's model with the same weights."""
    jmodel = jax_build_model(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(key), jbatch, train=False)),
        np.random.default_rng(key))
    for head, gain in (head_gains or {}).items():
        variables["params"]["heads"][head]["kernel"] *= gain
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(variables, LAYER_NUMS),
                          strict=True)
    return jmodel, variables, jbatch, model


@pytest.fixture(scope="module")
def seeded():
    """_jax_and_port of a case of CASES on _batch(), built once a module."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _jax_and_port(_cfg(case), _batch())
        return cache[case]
    return get


def _recorded_run(fusion: str, reference_numerics: bool = False):
    """The recording of baseline_{fusion} and the port's maps from its
    checkpoint on the recorded inputs. ``reference_numerics`` puts back
    the two places where the JAX package, and so the port, departs from
    the reference: DiscoNet's pixel-weight norms take eps 1e-5 (not
    1e-3), V2X-ViT's feed-forward the exact GELU (not the tanh one)."""
    io = np.load(os.path.join(GOLDEN, f"baseline_{fusion}_io.npz"))
    args = {**CKPT_ARGS, **RECORDED[fusion], "base_bev_backbone": {
        **CKPT_ARGS["base_bev_backbone"], "resnet": False}}
    model = build_model({"core_method": "point_pillar_baseline",
                         "args": args}, device="cpu")
    load_pth(model, os.path.join(GOLDEN, f"baseline_{fusion}.pth"))
    if reference_numerics:
        for module in model.fusion_net.modules():
            if isinstance(module, torch.nn.GELU):
                module.approximate = "none"
            if isinstance(module, torch.nn.BatchNorm2d):
                module.eps = 1e-5
    points = np.zeros((1, 2, 512, 4), np.float32)
    pmask = np.zeros((1, 2, 512), bool)
    for a, key in enumerate(("ego_points", "cav_points")):
        points[0, a, :len(io[key])] = io[key]
        pmask[0, a, :len(io[key])] = True
    batch = {"points": torch.from_numpy(points),
             "point_mask": torch.from_numpy(pmask),
             "agent_mask": torch.ones(1, 2, dtype=torch.bool),
             "pairwise_t_matrix": torch.from_numpy(io["pairwise"])}
    with torch.no_grad():
        return io, model(batch)


@pytest.mark.parametrize("fusion", sorted(RECORDED))
def test_reference_checkpoint_reproduces_recorded_maps(fusion):
    io, out = _recorded_run(fusion)
    assert set(out) == {"cls_preds", "reg_preds", "dir_preds"}
    for key in out:
        np.testing.assert_allclose(out[key].numpy(), io[key], atol=2e-4,
                                   err_msg=key)


@pytest.mark.parametrize("fusion", ["disconet", "v2xvit"])
def test_reference_numerics_leave_a_tenth_of_the_bound(fusion):
    """With the reference's eps and GELU the recordings hold at 2e-5, a
    tenth of the bound above (3.1e-6 and 1.05e-5 on the CPU): the rest of
    those two readings, 1.8e-4 each, is the JAX package's departure, and a
    fidelity fault of the port larger than 2e-5 shows here."""
    io, out = _recorded_run(fusion, reference_numerics=True)
    for key in out:
        np.testing.assert_allclose(out[key].numpy(), io[key], atol=2e-5,
                                   err_msg=key)


def test_naive_compressor_reproduces_recording():
    io = np.load(os.path.join(GOLDEN, "naive_compressor_io.npz"))
    model = NaiveCompressor(16, 4)
    load_pth(model, os.path.join(GOLDEN, "naive_compressor.pth"))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(io["x"]))
    np.testing.assert_allclose(got.numpy(), io["y"], atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_weights_give_the_same_maps(case, seeded):
    batch = _batch()
    jmodel, variables, jbatch, model = seeded(case)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    keys = {"cls_preds", "reg_preds", "dir_preds"}
    if case == "disconet":
        keys.add("feature")
    assert set(got) == set(want) == keys
    for key in keys:
        # float32 on both sides; the JAX maps are NHWC
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]).transpose(0, 3, 1, 2),
            atol=1e-4, err_msg=key)


def test_from_jax_params_fills_what_the_jax_package_has_not(seeded):
    """Zeros for the reference's conv biases before a batch norm and for
    the weights its forward never reads; V2X-ViT's type-1 HGT linears and
    When2comm's CHW-flattened fc.0 come from the flax tree."""
    zeros = {
        "baseline_when2comm": [
            "fusion_net.query_key_net.conv1.cbr_unit.0.bias",
            "fusion_net.key_net.conv1.cbr_unit.0.bias",
            "fusion_net.attention_net.linear_out.weight",
            "fusion_net.attention_net.linear_out.bias"],
        "baseline_v2xvit": ["fusion_net.fusion_net.encoder.prior_feed.weight",
                            "fusion_net.fusion_net.encoder.prior_feed.bias"],
        "baseline_disconet": [
            "fusion_net.pixel_weight_layer.conv1_3.bias"],
        "baseline_max_compressed": ["naive_compressor.encoder.0.bias",
                                    "naive_compressor.decoder.3.bias"]}
    trees = {}
    for case, keys in zeros.items():
        _, variables, _, _ = seeded(case)
        sd = from_jax_params(variables, LAYER_NUMS)
        for key in keys:
            assert sd[key].abs().max() == 0, key
        trees[case] = variables["params"], sd
    params, sd = trees["baseline_v2xvit"]
    np.testing.assert_array_equal(
        sd["fusion_net.fusion_net.encoder.layers.1.0.layers.0.0.fn."
           "k_linears.1.weight"].numpy(),
        params["fusion"]["HGTCavAttention_1"]["k_w"][1].T)
    params, sd = trees["baseline_when2comm"]
    kernel = params["fusion"]["key_fc1"]["kernel"]       # (HWC rows, out)
    got = sd["fusion_net.key_net.fc.0.weight"].numpy()   # (out, CHW)
    for c, y, x in ((0, 0, 1), (5, 3, 4), (127, 4, 6)):
        np.testing.assert_array_equal(got[:, (c * 5 + y) * 7 + x],
                                      kernel[(y * 7 + x) * 128 + c])


def _same_dets(got: dict, want: dict, keys, min_boxes: int):
    got = {k: got[k].numpy() for k in keys}
    want = {k: np.asarray(want[k]) for k in keys}
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for key in keys:
        assert got[key].shape == want[key].shape, key
        if key != "mask":
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-5 if key == "scores" else 1e-4,
                                       err_msg=key)
    counts = want["mask"].sum(-1)
    assert (counts >= min_boxes).all(), counts
    return got


# the seeded heads give scores within 0.05 of 0.5 and boxes far from their
# anchors, which the size and range filters drop: a cls kernel 30 times as
# large spreads the scores (no near ties in the ranking), a reg kernel a
# tenth as large keeps the boxes near their anchors; 22-34 boxes a frame
# are kept
POST = {"target_args": {"score_threshold": 0.2}, "nms_thresh": 0.15,
        "gt_range": LR, "dir_args": DIR_ARGS, "max_num": 100}
HEAD_GAINS = {"cls_head": 30.0, "reg_head": 0.1}


@pytest.mark.parametrize("case", ["baseline_v2vnet_avg", "disconet"])
def test_infer_fn_gives_the_jax_boxes(case):
    batch = _batch(1)
    jmodel, variables, jbatch, model = _jax_and_port(_cfg(case), batch, 1,
                                                     HEAD_GAINS)
    anchors = generate_anchor_box(ANCHOR_ARGS)
    want = jax_make_infer_fn(jmodel, anchors, POST)(variables, jbatch)
    got = make_infer_fn(model, anchors, POST, device="cpu")(batch)
    assert got["corners3d"].shape == (2, 100, 8, 3)
    _same_dets(got, want, ("corners3d", "boxes7", "scores", "mask"), 10)


@pytest.mark.parametrize("fusion", ["intermediate", "late"])
def test_heading_without_a_direction_head_matches_jax(fusion):
    """A model without ``dir_args`` has no direction head; the JAX infer
    fns feed it zero direction logits, which move a heading into the
    direction bin 0, and so does post_process: boxes7 yaw within 1e-5,
    corners (whose order follows the yaw) within 1e-4 m."""
    args = {k: v for k, v in TINY.items() if k != "dir_args"}
    if fusion == "late":
        cfg = {"core_method": "point_pillar", "args": args}
    else:
        cfg = {"core_method": "point_pillar_baseline",
               "args": {**args, "fusion_method": "max"}}
    post = {k: v for k, v in POST.items() if k != "dir_args"}
    batch = _batch(2)
    jmodel, variables, jbatch, model = _jax_and_port(cfg, batch, 2,
                                                     HEAD_GAINS)
    anchors = generate_anchor_box(ANCHOR_ARGS)
    if fusion == "late":
        want = jax_make_late_infer_fn(jmodel, anchors, post)(variables,
                                                             jbatch)
        got = make_late_infer_fn(model, anchors, post, device="cpu")(batch)
        _same_dets(got, want, ("corners3d", "scores", "mask"), 10)
        return
    want = jax_make_infer_fn(jmodel, anchors, post)(variables, jbatch)
    got = _same_dets(make_infer_fn(model, anchors, post, device="cpu")(batch),
                     want, ("corners3d", "boxes7", "scores", "mask"), 10)
    np.testing.assert_allclose(got["boxes7"][..., 6],
                               np.asarray(want["boxes7"])[..., 6], rtol=0,
                               atol=1e-5)


def test_smoke_configurations_equal_their_sources():
    # chip_smoke.py runs where JAX is not installed, so it carries copies
    # of the recorded baselines' args, which tests/test_ckpt_import.py
    # builds in Python; they must not drift. The seven full-width models
    # and their post-processing it reads from the yamls themselves.
    import chip_smoke as S

    assert S.RECORDED_ARGS == {**CKPT_ARGS, "base_bev_backbone": {
        **CKPT_ARGS["base_bev_backbone"], "resnet": False}}
    for fusion, extra in S.RECORDED_BASELINES.items():
        assert extra == RECORDED[fusion]
    fusions = set()
    for name in S.BASELINES:
        model_cfg, post = S.baseline_yaml(name)
        assert model_cfg["core_method"] in ("point_pillar_baseline",
                                            "point_pillar_intermediate")
        assert post["max_num"] == 100 and post["dir_args"], name
        fusions.add(model_cfg["args"]["fusion_method"])
    assert fusions == {"max", "att", "disconet", "v2vnet", "when2comm",
                       "v2xvit"}


# options of the JAX package that no published yaml sets; the port refuses
# them until a config needs them
UNPORTED = {
    "v2vnet_without_gru": {"fusion_method": "v2vnet",
                           "v2vnet": {"gru_flag": False}},
    "v2xvit_absolute_positions": {"fusion_method": "v2xvit", "v2xvit": {
        "transformer": {"encoder": {
            **TINY_V2XVIT["transformer"]["encoder"], "pwindow_att_config": {
                **TINY_V2XVIT["transformer"]["encoder"]["pwindow_att_config"],
                "relative_pos_embedding": False}}}}},
    "v2xvit_naive_pyramid": {"fusion_method": "v2xvit", "v2xvit": {
        "transformer": {"encoder": {
            **TINY_V2XVIT["transformer"]["encoder"], "pwindow_att_config": {
                **TINY_V2XVIT["transformer"]["encoder"]["pwindow_att_config"],
                "fusion_method": "naive"}}}}},
}


@pytest.mark.parametrize("option", sorted(UNPORTED))
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model({"core_method": "point_pillar_baseline",
                     "args": {**TINY, **UNPORTED[option]}}, device="cpu")
