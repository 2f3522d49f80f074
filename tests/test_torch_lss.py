"""The port's LSS camera family (ops/lss.py, models/camera_trunks.py,
models/camera.py, loss/depth_loss.py, from_jax_params and load_pth of the
family) against the JAX package and the reference recordings, on the CPU,
at tests/test_lss.py's tiny sizes (64 x 96 images, a 40 x 40 BEV at 0.4 m,
8 UD depth bins).

Bounds:
  * depth bins, the frustum and bin_depths equal the JAX package's
    exactly; get_geometry within 1e-5 m (a 3x3 product chain, float32);
  * the splat's cells equal the JAX voxel_pool's exactly on points at and
    one float32 ulp beside every cell boundary (its occupancy counts), the
    pooled features within 1e-5 (fault 12: the cells come from
    ops/voxels.cell_index);
  * the corner-aligned upsample (F.interpolate) within 1e-6 of the JAX
    package's interpolation matrices;
  * both models with the same weights (from_jax_params, norms seeded),
    and each trunk inside them: outputs within 1e-4 of each map's
    largest;
  * lss_{efficientnet,resnet101,intermediate}.pth loaded strictly (their
    dead keys dropped) against their recordings at
    tests/test_ckpt_import.py's 2e-3;
  * the float64 train step: tests/test_torch_lss_train.py;
  * the depth supervision loss within 1e-6 of the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.loss.depth_loss import \
    depth_supervision_loss as jax_depth_loss
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.models.camera_trunks import \
    upsample_align_corners as jax_upsample
from coalign_tpu.ops import lss as JLSS
from coalign_tpu_torch.loss.depth_loss import depth_supervision_loss
from coalign_tpu_torch.models.camera_trunks import upsample_align_corners
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.ops import lss as L
from coalign_tpu_torch.utils.weights import from_jax_params, load_pth

from test_torch_flagship import _randomize_norms

torch.set_num_threads(4)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GRID = {"xbound": [-8, 8, 0.4], "ybound": [-8, 8, 0.4],
        "zbound": [-10, 10, 20.0], "ddiscr": [2, 10, 8], "mode": "UD"}
AUG = {"final_dim": [64, 96]}
SPEC = L.LSSSpec.from_config(GRID, AUG)
JSPEC = JLSS.LSSSpec.from_config(GRID, AUG)
DIR_ARGS = {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]}
SHRINK = {"kernal_size": [3], "stride": [2], "padding": [1], "dim": [64],
          "input_dim": 64}
# the LSS models of the checks below: (core_method, extra args, L); the
# EfficientNet encoder is the yamls' default, the ResNet-101 one is cheaper
# for the JAX package to compile
R101 = {"camera_encoder": "Resnet101"}
MODELS = {
    "single_efficientnet": ("lift_splat_shoot", {"shrink_header": SHRINK},
                            1),
    "single_resnet101": ("lift_splat_shoot", R101, 1),
    "single_gt_depth": ("lift_splat_shoot", {**R101, "use_gt_depth": True},
                        1),
    "intermediate_att_ms": ("lift_splat_shoot_intermediate",
                            {"supervise_single": True}, 2),
    "intermediate_att": ("lift_splat_shoot_intermediate", {**R101,
        "fusion_args": {"core_method": "att", "att": {"feat_dim": 64}}}, 2),
    "intermediate_v2vnet": ("lift_splat_shoot_intermediate", {
        **R101, "supervise_single": True, "fusion_args": {
            "core_method": "v2vnet", "args": {"v2vnet": {
                "num_iteration": 1, "in_channels": 256,
                "agg_operator": "max",
                "conv_gru": {"kernel_size": [[3, 3]]}}}}}, 2),
}


def lss_args(extra=None) -> dict:
    a = {"grid_conf": GRID, "data_aug_conf": AUG, "img_features": 32,
         "anchor_number": 2, "bev_out_channels": 64, "dir_args": DIR_ARGS,
         "fusion_args": {"core_method": "att_ms", "att": {"feat_dim": 64}}}
    a.update(extra or {})
    return a


def camera_batch(b=1, l=2, n=2, seed=0, depth=False) -> dict:
    """tests/test_lss.py's camera batch: seeded images, cameras at the
    agent's origin looking along +x (focal 50), each agent of a frame a few
    metres from the ego."""
    rng = np.random.default_rng(seed)
    h, w = AUG["final_dim"]
    eye3 = np.tile(np.eye(3, dtype=np.float32), (b, l, n, 1, 1))
    intrins = eye3.copy()
    intrins[..., 0, 0] = intrins[..., 1, 1] = 50.0
    intrins[..., 0, 2], intrins[..., 1, 2] = (w - 1) / 2, (h - 1) / 2
    rot = np.array([[0, 0, 1.0], [-1.0, 0, 0], [0, -1.0, 0]], np.float32)
    pair = np.tile(np.eye(4, dtype=np.float32), (b, l, l, 1, 1))
    pair[..., 0, 3] = rng.uniform(-2, 2, (b, l, l))
    pair[:, np.arange(l), np.arange(l), 0, 3] = 0.0
    batch = {
        "agent_mask": np.ones((b, l), bool),
        "pairwise_t_matrix": pair,
        "image_inputs": {
            "imgs": rng.normal(size=(b, l, n, h, w, 3)).astype(np.float32),
            "rots": np.tile(rot, (b, l, n, 1, 1)),
            "trans": rng.uniform(-0.5, 0.5, (b, l, n, 3)).astype(np.float32),
            "intrins": intrins,
            "post_rots": eye3,
            "post_trans": np.zeros((b, l, n, 3), np.float32)}}
    if depth:
        batch["image_inputs"]["depth_map"] = rng.uniform(
            1.0, 11.0, (b, l, n, h, w)).astype(np.float32)
    return batch


def jax_tree(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def port_tree(batch):
    return {k: port_tree(v) if isinstance(v, dict) else torch.from_numpy(
        np.asarray(v)) for k, v in batch.items()}


def seeded_lss_pair(name: str, batch: dict, key: int = 0):
    """(JAX model, its seeded variables, the port's model with the same
    weights) of MODELS[name]."""
    core, extra, _ = MODELS[name]
    cfg = {"core_method": core, "args": lss_args(extra)}
    jmodel = jax_build_model(cfg)
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(key), jax_tree(batch), train=False)),
        np.random.default_rng(key))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(variables), strict=True)
    return jmodel, variables, model


def assert_maps_close(got: torch.Tensor, want, tol=1e-4, what=""):
    """NCHW port map against an NHWC JAX map, within ``tol`` of the
    JAX map's largest value."""
    want = np.asarray(want)
    got = got.detach().numpy()
    if want.ndim == 4:
        want = want.transpose(0, 3, 1, 2)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def test_depth_bins_frustum_and_bin_depths_match_jax():
    for mode in ("UD", "LID"):
        for args in ((2, 10, 8), (2, 50, 48)):
            np.testing.assert_array_equal(
                L.depth_discretization(*args, mode),
                JLSS.depth_discretization(*args, mode))
    lid = L.LSSSpec.from_config({**GRID, "ddiscr": [2, 50, 48],
                                 "mode": "LID"}, {"final_dim": [480, 640]})
    jlid = JLSS.LSSSpec.from_config({**GRID, "ddiscr": [2, 50, 48],
                                     "mode": "LID"}, {"final_dim": [480, 640]})
    np.testing.assert_array_equal(lid.frustum(), jlid.frustum())
    assert lid.frustum().shape == (48, 60, 80, 3)
    rng = np.random.default_rng(1)
    centers = L.depth_discretization(2, 50, 48, "LID").astype(np.float32)
    depth = np.concatenate([
        rng.uniform(0.0, 60.0, 20_000), centers,
        np.nextafter(centers, -np.inf), np.nextafter(centers, np.inf),
        [np.nan, np.inf, -1.0]]).astype(np.float32)
    for mode, dmax, nbins in (("UD", 10, 8), ("LID", 50, 48),
                              ("SID", 50, 48)):
        got = L.bin_depths(torch.from_numpy(depth), mode, 2, dmax,
                           nbins).numpy()
        want = np.asarray(JLSS.bin_depths(jnp.asarray(depth), mode, 2, dmax,
                                          nbins))
        np.testing.assert_array_equal(got[:20_000], want[:20_000],
                                      err_msg=mode)
        # at the bin edges the JAX package's float32 sqrt can round the
        # other way (XLA's CPU sqrt is not correctly rounded: 4224.9995
        # gives 65.0); there the port must give the float64 value's bin
        exact = L.bin_depths(torch.from_numpy(depth.astype(np.float64)),
                             mode, 2, dmax, nbins).numpy()
        off = np.nonzero(got != want)[0]
        assert len(off) <= 2, (mode, depth[off])
        np.testing.assert_array_equal(got[off], exact[off], err_msg=mode)


def test_geometry_matches_jax():
    batch = camera_batch(b=1, l=2, n=3, seed=2)["image_inputs"]
    rng = np.random.default_rng(3)
    post = np.tile(np.eye(3, dtype=np.float32), (1, 2, 3, 1, 1))
    post[..., 0, 0] = post[..., 1, 1] = rng.uniform(0.8, 1.2, (1, 2, 3))
    ptrans = rng.uniform(-5, 5, (1, 2, 3, 3)).astype(np.float32)
    args = [batch[k] for k in ("rots", "trans", "intrins")] + [post, ptrans]
    got = L.get_geometry(torch.from_numpy(SPEC.frustum()),
                         *[torch.from_numpy(a[0]) for a in args])
    want = jax.vmap(lambda *a: JLSS.get_geometry(
        jnp.asarray(JSPEC.frustum()), *a))(*[jnp.asarray(a[0]) for a in args])
    assert got.shape == (2, 3, 8, 8, 12, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def boundary_points(spec, n_random: int, seed: int) -> np.ndarray:
    """(n_random + 3 * grid lines, 3) float32 points: random ones over the
    grid and a margin, and points at and one ulp beside every x, y and z
    cell boundary (a plane of points on a boundary: fault 12)."""
    rng = np.random.default_rng(seed)
    lo = np.array([spec.xbound[0], spec.ybound[0], spec.zbound[0]])
    hi = np.array([spec.xbound[1], spec.ybound[1], spec.zbound[1]])
    pts = [rng.uniform(lo - 2, hi + 2, (n_random, 3))]
    for axis, bound in enumerate((spec.xbound, spec.ybound, spec.zbound)):
        edges = np.float32(bound[0]) + np.arange(
            int(round((bound[1] - bound[0]) / bound[2])) + 1,
            dtype=np.float32) * np.float32(bound[2])
        for e in (edges, np.nextafter(edges, -np.inf),
                  np.nextafter(edges, np.inf)):
            p = rng.uniform(lo, hi, (len(e), 3))
            p[:, axis] = e
            pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def test_splat_cells_and_pool_match_jax():
    """Fault 12: the splat's cells at and beside every cell boundary are
    the JAX voxel_pool's: one frame's occupancy counts equal exactly."""
    spec = L.LSSSpec.from_config({**GRID, "zbound": [-3.0, 1.0, 1.0]}, AUG)
    jspec = JLSS.LSSSpec.from_config({**GRID, "zbound": [-3.0, 1.0, 1.0]},
                                     AUG)
    pts = boundary_points(spec, 20_000, 4)
    geom = pts.reshape(1, 1, 1, 1, -1, 3)
    rng = np.random.default_rng(5)
    feats = np.concatenate([np.ones((len(pts), 1)), rng.normal(
        size=(len(pts), 2))], axis=1).astype(np.float32).reshape(
        1, 1, 1, 1, -1, 3)
    got = L.voxel_pool(torch.from_numpy(geom), torch.from_numpy(feats), spec)
    want = np.asarray(JLSS.voxel_pool(jnp.asarray(geom[0]),
                                      jnp.asarray(feats[0]), jspec))
    # JAX (ny, nx, nz*C) -> (nz*C, ny, nx); channel z*C + c in both
    want = want.transpose(2, 0, 1)
    assert got.shape == (1, spec.nz * 3, spec.ny, spec.nx)
    np.testing.assert_array_equal(got[0, 0::3].numpy(), want[0::3])
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=0)
    assert int(want[0::3].sum()) < len(pts)      # some points fell outside


def test_splat_frames_stay_apart():
    """Two agent frames' points land in their own frame's grid."""
    pts = boundary_points(SPEC, 2_000, 6)
    geom = np.stack([pts, pts[::-1]]).reshape(2, 1, 1, 1, -1, 3)
    feats = np.random.default_rng(7).normal(size=geom.shape[:-1] + (4,))
    feats = torch.from_numpy(feats.astype(np.float32))
    both = L.voxel_pool(torch.from_numpy(geom), feats, SPEC)
    for f in range(2):
        alone = L.voxel_pool(torch.from_numpy(geom[f:f + 1]), feats[f:f + 1],
                             SPEC)
        torch.testing.assert_close(both[f:f + 1], alone)


def test_upsample_matches_jax_interpolation_matrices():
    x = np.random.default_rng(8).normal(size=(2, 5, 7, 3)).astype(np.float32)
    for scale in (2, 4):
        got = upsample_align_corners(torch.from_numpy(
            x.transpose(0, 3, 1, 2)), scale)
        want = np.asarray(jax_upsample(jnp.asarray(x), scale))
        np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_and_trunks_match_jax(name):
    """Both LSS models, each option of the yamls: maps within 1e-4 of each
    map's largest, the depth logits too, and the outputs of each trunk on
    the way: the camera encoder (EfficientNet-b0 and its Up blocks, or
    ResNet-101; context and depth logits) and the BEV encoder (ResNet-18
    layers, decode, the fusion)."""
    _, _, l = MODELS[name]
    batch = camera_batch(b=1, l=l, n=2, seed=10,
                         depth=name == "single_gt_depth")
    jmodel, variables, model = seeded_lss_pair(name, batch)
    want, state = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name in (
            "camencode", "bevencode")))(variables, jax_tree(batch))
    trunks = {}
    for name_ in ("camencode", "bevencode"):
        getattr(model, name_).register_forward_hook(
            lambda mod, args, out, key=name_: trunks.__setitem__(key, out))
    with torch.no_grad():
        got = model(port_tree(batch))
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, w in want.items():
        if key == "depth_logits":       # JAX (F, N, fH, fW, D)
            w = np.asarray(w).transpose(0, 1, 4, 2, 3)
        assert_maps_close(got[key], w, what=f"{name} {key}")
    for key, out in trunks.items():
        ref = state["intermediates"][key]["__call__"][0]
        out, ref = ((out, ref) if isinstance(out, tuple)
                    else ((out,), (ref,)))
        assert len(out) == len(ref)
        for i, (g, w) in enumerate(zip(out, ref)):
            assert (g is None) == (w is None), (key, i)
            if g is not None:
                assert_maps_close(g, w, what=f"{name} {key} {i}")


LSS_REC_GRID = {"xbound": [-12.8, 12.8, 0.4], "ybound": [-12.8, 12.8, 0.4],
                "zbound": [-10.0, 10.0, 20.0], "ddiscr": [2, 10, 8],
                "mode": "UD"}
RECORDINGS = {
    "lss_efficientnet": ("lift_splat_shoot", {"shrink_header": SHRINK}, 2, 1),
    "lss_resnet101": ("lift_splat_shoot", {"camera_encoder": "Resnet101"},
                      2, 1),
    "lss_intermediate": ("lift_splat_shoot_intermediate", {
        "supervise_single": True, "bevout_feature": 128, "fusion_args": {
            "core_method": "att_ms", "args": {
                "voxel_size": [0.4, 0.4, 20.0], "in_channels": 32}}}, 1, 2),
}


def recorded_lss(tag: str):
    """(model with ``<tag>.pth`` loaded strictly, its recorded batch, the
    recording) as tests/test_ckpt_import.py's _lss_import_parity builds
    them."""
    core, extra, b, l = RECORDINGS[tag]
    args = {"anchor_number": 2, "grid_conf": LSS_REC_GRID,
            "data_aug_conf": AUG, "dir_args": DIR_ARGS, "img_downsample": 8,
            "img_features": 32, "bevout_feature": 64,
            "camera_encoder": "EfficientNet", "supervise_single": False,
            **extra}
    model = build_model({"core_method": core, "args": args}, device="cpu")
    load_pth(model, os.path.join(GOLDEN, f"{tag}.pth"))
    io = np.load(os.path.join(GOLDEN, f"{tag}_io.npz"))
    n = io["imgs"].shape[1]
    imgs = io["imgs"].transpose(0, 1, 3, 4, 2)

    def r(a):
        return a.reshape((b, l) + a.shape[1:])

    batch = {"agent_mask": np.ones((b, l), bool), "image_inputs": {
        "imgs": np.ascontiguousarray(imgs.reshape((b, l, n) + imgs.shape[2:])),
        **{k: r(io[k]) for k in ("rots", "trans", "intrins", "post_rots",
                                 "post_trans")}}}
    if "pairwise" in io:
        batch["pairwise_t_matrix"] = io["pairwise"]
    return model, batch, io


@pytest.mark.parametrize("tag", sorted(RECORDINGS))
def test_recording_holds(tag):
    model, batch, io = recorded_lss(tag)
    with torch.no_grad():
        out = model(port_tree(batch))
    keys = [k for k in io.files if k.endswith(("_preds", "_preds_single"))]
    assert len(keys) == (6 if tag == "lss_intermediate" else 3)
    for key in keys:
        ref = io[key]
        rel = np.abs(out[key].numpy() - ref).max() / max(np.abs(ref).max(),
                                                         1e-6)
        assert rel < 2e-3, (tag, key, rel)


def test_dead_reference_keys_are_dropped_not_missing():
    """load_pth drops only the keys the model names dead: a checkpoint
    without them loads too, and one missing a live key does not."""
    model, _, _ = recorded_lss("lss_resnet101")
    sd = torch.load(os.path.join(GOLDEN, "lss_resnet101.pth"),
                    weights_only=True)
    assert any(k.startswith("camencode.up1.") for k in sd)
    assert not any(k.startswith("camencode.up1.")
                   for k in model.state_dict())
    live = {k: v for k, v in sd.items() if not k.startswith(
        model.STATE_DICT_DEAD)}
    model.load_state_dict(live, strict=True)
    live.pop("camencode.conv1.weight")
    with pytest.raises(RuntimeError, match="Missing"):
        model.load_state_dict(live, strict=True)


def test_depth_loss_matches_jax():
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(2, 3, 8, 8, 12)).astype(np.float32)
    depth = rng.uniform(0.0, 12.0, (2, 3, 64, 96)).astype(np.float32)
    want = float(jax_depth_loss(jnp.asarray(logits.transpose(0, 1, 3, 4, 2)),
                                jnp.asarray(depth), (2, 10, 8), "UD"))
    got = float(depth_supervision_loss(torch.from_numpy(logits),
                                       torch.from_numpy(depth), (2, 10, 8),
                                       "UD"))
    assert abs(got - want) <= 1e-6 * abs(want)
