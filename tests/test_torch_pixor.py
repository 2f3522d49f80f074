"""The port's PIXOR family (ops/bev_raster.py, models/pixor.py,
postprocess/dense_bev.py, loss/pixor_loss.py, the dense branches of
make_infer_fn and make_train_step, tools/run.py's DenseBevSpec) against
the JAX package and the reference recordings, on the CPU, at a 48 x 48
raster (+-9.6 m at 0.4 m, 10 z slabs; labels 12 x 12).

Bounds:
  * the raster equals the JAX raster exactly, points on cell boundaries
    included (the port's cells come from ops/voxels.cell_index);
  * label maps within 1e-5 (the same float32 arithmetic), the first valid
    box winning where boxes overlap; decode: the same boxes (within 1e-4
    m and rad), scores (1e-6) and masks; the loss within 1e-6 relative;
  * both models through from_jax_params in eval mode, the JAX side at
    full float32 precision: maps within 1e-4 of each map's largest;
    flax's initialization of the heads (cls bias -4.595, reg kernel 0);
  * pixor.pth and pixor_inter.pth through load_pth(strict=True) on their
    recorded rasters: tests/test_ckpt_import.py's bound (2e-3 of each
    map's largest);
  * make_infer_fn's boxes: those of the JAX infer fn (corners within
    1e-4, scores within 2e-4, the same masks);
  * a train step of pixor_intermediate.yaml's loss and AdamW: held as
    tests/test_torch_baselines_train.py holds the baselines' steps;
  * tools/run.py trains and infers pixor_intermediate.yaml from an OPV2V
    fixture tree (the JAX test_pixor.py CLI round trip, on the port).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from conftest import jit_init

from coalign_tpu.inference import make_infer_fn as jax_make_infer_fn
from coalign_tpu.loss.pixor_loss import PixorLoss as JPixorLoss
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.ops.bev_raster import BevSpec as JBevSpec
from coalign_tpu.ops.bev_raster import rasterize_bev as jax_rasterize
from coalign_tpu.postprocess import dense_bev as JD
from coalign_tpu_torch.config.yaml_utils import load_yaml
from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.inference import make_infer_fn
from coalign_tpu_torch.loss.pixor_loss import PixorLoss
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.ops.bev_raster import BevSpec, rasterize_bev
from coalign_tpu_torch.postprocess.dense_bev import (DenseBevSpec,
                                                     assign_dense_targets,
                                                     decode_dense_map)
from coalign_tpu_torch.tools import run
from coalign_tpu_torch.utils.weights import from_jax_params, load_pth

from chip_smoke import HYPES
from test_torch_baselines_train import hold_step
from test_torch_flagship import _randomize_norms

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GEOM = {"L1": -9.6, "L2": 9.6, "W1": -9.6, "W2": 9.6, "H1": -3.0, "H2": 1.0,
        "res": 0.4, "downsample_rate": 4}
LR = [-9.6, -9.6, -3.0, 9.6, 9.6, 1.0]
SPEC = BevSpec.from_config(GEOM)
DSPEC = DenseBevSpec(bev=SPEC)
JDSPEC = JD.DenseBevSpec(bev=JBevSpec.from_config(GEOM))
CASES = {"pixor": ("pixor", True), "pixor_intermediate":
         ("pixor_intermediate", True), "pixor_no_bn": ("pixor", False)}


def _cfg(case: str) -> dict:
    core, use_bn = CASES[case]
    return {"core_method": core, "args": {"geometry_param": GEOM,
                                          "use_bn": use_bn,
                                          "fusion_method": "att"}}


def _batch(seed: int = 5, frames: int = 2) -> dict:
    """``frames`` frames of 2 agents in L = 3 slots (the third padded),
    512 points an agent, 3 cars a frame."""
    scenes = SyntheticScenes(num_frames=frames, num_agents=2, num_objects=3,
                             lidar_range=LR, points_per_object=48,
                             ground_points=128, seed=seed)
    return IntermediateFusionBatcher(
        max_cav=3, max_points=512, max_objects=8, lidar_range=LR,
        native=False).assemble([scenes[i] for i in range(frames)])


def _pair(case: str, batch: dict, key: int = 0):
    """The JAX model with seeded variables (norms and biases randomized,
    the reg head's kernel drawn) and the port's with the same weights."""
    cfg = _cfg(case)
    jmodel = jax_build_model(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(key), jbatch, train=False))
    if "batch_stats" in variables:
        variables = _randomize_norms(variables, np.random.default_rng(key))
    rng = np.random.default_rng(key + 1)
    reg = variables["params"]["header"]["reghead"]
    reg["kernel"] = rng.normal(0, 0.05, reg["kernel"].shape).astype(
        np.float32)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(variables), strict=True)
    return jmodel, variables, jbatch, model


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.2e} of its largest"


def test_raster_matches_jax_exactly():
    rng = np.random.default_rng(0)
    pts = rng.uniform([-10.5, -10.5, -3.5, 0], [10.5, 10.5, 1.5, 1],
                      (3, 4000, 4)).astype(np.float32)
    # planes on cell boundaries: z = -1.4 (slab 4 from -3 m at 0.4 m),
    # x = -9.6 + 0.4 * 7, y = 0.4 * 3
    pts[1, :1500, 2] = -1.4
    pts[2, :1000, 0] = np.float32(-9.6 + 0.4 * 7)
    pts[2, 1000:2000, 1] = np.float32(0.4 * 3)
    mask = rng.random((3, 4000)) > 0.1
    got = rasterize_bev(torch.from_numpy(pts), torch.from_numpy(mask), SPEC)
    assert got.shape == (3, SPEC.nz + 1, SPEC.nx, SPEC.ny)
    jspec = JBevSpec.from_config(GEOM)
    want = np.stack([np.asarray(jax_rasterize(jnp.asarray(p), jnp.asarray(m),
                                              jspec))
                     for p, m in zip(pts, mask)]).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(got[:, :-1].numpy())) == {0.0, 1.0}


def _gt():
    """2 frames of padded gt: overlapping boxes (the first valid wins),
    a padded row, a box of zero width."""
    gt = np.zeros((2, 5, 7), np.float32)
    gt[0, 0] = [3.0, 2.0, -1.0, 1.56, 3.0, 4.4, 0.4]
    gt[0, 1] = [4.0, 2.5, -1.0, 1.56, 2.8, 4.8, -1.2]    # overlaps box 0
    gt[0, 2] = [-6.0, -5.0, -1.0, 1.56, 2.8, 4.8, 2.9]
    gt[0, 3] = [-2.0, 6.0, -1.0, 1.56, 0.0, 4.0, 0.0]    # zero width
    gt[1, 0] = [0.0, 0.0, -1.0, 1.56, 2.0, 4.5, 1.0]
    gt[1, 1] = [5.0, -4.0, -1.0, 1.56, 2.2, 5.0, -0.3]   # padded below
    mask = np.array([[1, 1, 1, 1, 0], [1, 0, 0, 0, 0]], bool)
    return gt, mask


def test_dense_targets_match_jax():
    gt, mask = _gt()
    got = assign_dense_targets(torch.from_numpy(gt), torch.from_numpy(mask),
                               DSPEC).numpy()
    want = np.stack([np.asarray(JD.assign_dense_targets(
        jnp.asarray(g), jnp.asarray(m), JDSPEC)) for g, m in zip(gt, mask)])
    assert got.shape == (2, 12, 12, 7)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert 0 < got[..., 0].sum() < got[..., 0].size


def _maps(seed: int = 0):
    """Maps decoding to the gt of _gt() plus noise, and a score spread."""
    gt, mask = _gt()
    label = assign_dense_targets(torch.from_numpy(gt), torch.from_numpy(mask),
                                 DSPEC).numpy()
    rng = np.random.default_rng(seed)
    cls = np.where(label[..., :1] > 0, 4.0, -4.0) + rng.normal(
        0, 2.0, label[..., :1].shape)
    reg = label[..., 1:] + rng.normal(0, 0.1, label[..., 1:].shape)
    return cls.astype(np.float32), reg.astype(np.float32)


def test_decode_matches_jax():
    cls, reg = _maps()
    got = decode_dense_map(torch.from_numpy(cls).permute(0, 3, 1, 2),
                           torch.from_numpy(reg).permute(0, 3, 1, 2), DSPEC,
                           score_threshold=0.25, nms_threshold=0.15,
                           max_keep=20, pre_top_k=64)
    decode = jax.jit(lambda c, r: JD.decode_dense_map(
        c, r, JDSPEC, score_threshold=0.25, nms_threshold=0.15, max_keep=20,
        pre_top_k=64))
    for i in range(2):
        want = decode(jnp.asarray(cls[i]), jnp.asarray(reg[i]))
        valid = np.asarray(want["valid"])
        assert 2 <= valid.sum() < 20
        np.testing.assert_array_equal(got["valid"][i].numpy(), valid)
        np.testing.assert_allclose(got["boxes"][i].numpy()[valid],
                                   np.asarray(want["boxes"])[valid],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["scores"][i].numpy(),
                                   np.asarray(want["scores"]), rtol=0,
                                   atol=1e-6)


def test_loss_matches_jax():
    gt, mask = _gt()
    label = assign_dense_targets(torch.from_numpy(gt), torch.from_numpy(mask),
                                 DSPEC)
    cls, reg = _maps(1)
    got, terms = PixorLoss(1.0, 2.0)(
        {"cls_map": torch.from_numpy(cls).permute(0, 3, 1, 2),
         "reg_map": torch.from_numpy(reg).permute(0, 3, 1, 2)},
        {"label_map": label})
    want, metrics = JPixorLoss(1.0, 2.0)(
        {"cls_map": jnp.asarray(cls), "reg_map": jnp.asarray(reg)},
        {"label_map": jnp.asarray(label.numpy())})
    assert set(terms) == set(metrics)
    for key in metrics:
        np.testing.assert_allclose(float(terms[key]), float(metrics[key]),
                                   rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_models_match_jax(case):
    batch = _batch()
    jmodel, variables, jbatch, model = _pair(case, batch)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, jbatch)
    with torch.no_grad():
        got = model(_tensors(batch))
    frames = 2 * (3 if CASES[case][0] == "pixor" else 1)
    for key, ch in (("cls_map", 1), ("reg_map", 6)):
        assert got[key].shape == (frames, ch, 12, 12)
        _close(got[key].permute(0, 2, 3, 1).numpy(), want[key], 1e-4,
               f"{case} {key}")


def test_heads_start_as_flax_initializes_them():
    for core in ("pixor", "pixor_intermediate"):
        model = build_model(_cfg(core), device="cpu")
        assert torch.all(model.header.clshead.bias == -4.595)
        assert torch.all(model.header.reghead.weight == 0)
        assert torch.all(model.header.reghead.bias == 0)
        assert model.header.clshead.weight.std() > 0
        norms = [m for m in model.modules()
                 if isinstance(m, torch.nn.BatchNorm2d)]
        assert norms and all(m.eps == 1e-5 for m in norms)
    flat = jax.tree_util.tree_map(np.asarray, jit_init(
        jax_build_model(_cfg("pixor")), jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in _batch(frames=1).items()},
        train=False))["params"]["header"]
    np.testing.assert_array_equal(flat["clshead"]["bias"], np.float32(-4.595))
    assert not flat["reghead"]["kernel"].any()


@pytest.mark.parametrize("tag", ["pixor", "pixor_inter"])
def test_recordings_load_strictly_and_hold(tag):
    io = np.load(os.path.join(GOLDEN, f"{tag}_io.npz"))
    bev = torch.from_numpy(io["bev"])
    # the recording's raster has 8 channels: a grid of 7 z slabs
    geom = dict(GEOM, H2=GEOM["H1"] + 7 * GEOM["res"])
    core = "pixor" if tag == "pixor" else "pixor_intermediate"
    model = build_model({"core_method": core, "args": {
        "geometry_param": geom, "use_bn": True}}, device="cpu")
    load_pth(model, os.path.join(GOLDEN, f"{tag}.pth"))
    with torch.no_grad():
        if tag == "pixor":
            feat = model.backbone(bev)
        else:
            from coalign_tpu_torch.models.pixor import attentive_agent_fusion
            mask = torch.ones(1, 2, dtype=torch.bool)
            feat = model.backbone.decode(*[attentive_agent_fusion(c, mask)
                                           for c in model.backbone.encode(
                                               bev)])
        cls, reg = model.header(feat)
    _close(cls.numpy(), io["cls"], 2e-3, f"{tag} cls")
    _close(reg.numpy(), io["reg"], 2e-3, f"{tag} reg")


def test_infer_fn_boxes_match_jax():
    """pixor_intermediate with its cls head's kernel scaled by 30 and bias
    0, so that a spread of pixels clears the 0.25 threshold."""
    batch = _batch()
    jmodel, variables, jbatch, model = _pair("pixor_intermediate", batch)
    head = variables["params"]["header"]["clshead"]
    head["kernel"] = head["kernel"] * 30.0
    head["bias"] = np.zeros_like(head["bias"])
    model.load_state_dict(from_jax_params(variables), strict=True)
    post = {"target_args": {"score_threshold": 0.25}, "nms_thresh": 0.15,
            "gt_range": LR}
    with jax.default_matmul_precision("highest"):
        want = jax.tree_util.tree_map(np.asarray, jax_make_infer_fn(
            jmodel, JDSPEC, post)(variables, jbatch))
    got = {k: v.numpy() for k, v in make_infer_fn(
        model, DSPEC, post, device="cpu")(batch).items()}
    assert set(got) == set(want) == {"corners3d", "boxes7", "scores", "mask"}
    assert 5 <= want["mask"].sum(), want["mask"].sum(-1)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    # the maps agree within 1e-4 of their largest (~5 here): a score
    # within a quarter of that
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(got["corners3d"], want["corners3d"], rtol=0,
                               atol=1e-4)


def test_train_step_matches_jax(monkeypatch):
    """pixor_intermediate.yaml's pixor_loss and AdamW on the tiny grid, the
    dense label maps assigned in the step."""
    y = load_yaml(os.path.join(HYPES, "pixor_intermediate.yaml"))
    assert y["optimizer"]["args"]["weight_decay"] == 1e-4
    batch = _batch()
    jmodel, variables, _, model = _pair("pixor_intermediate", batch, key=2)
    label = assign_dense_targets(torch.from_numpy(batch["gt_boxes"]),
                                 torch.from_numpy(batch["gt_mask"]), DSPEC)
    assert label[..., 0].sum() > 0
    worst = hold_step(monkeypatch, jmodel, variables, model, batch,
                      y["loss"], None, None, y["optimizer"], layer_nums=None,
                      spec=DSPEC, jspec=JDSPEC)
    print(f"pixor_intermediate: float64 gradient, worst {worst:.3g} of "
          "the bound")


def test_cli_train_inference_round_trip(tmp_path):
    """tests/test_pixor.py's CLI round trip on the port: build_all gives a
    DenseBevSpec, the step assigns dense label maps, evaluate decodes with
    decode_dense_map."""
    lr = [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0]
    scenes = SyntheticScenes(num_frames=2, num_agents=2, num_objects=3,
                             lidar_range=lr, points_per_object=32,
                             ground_points=64, seed=3)
    root = write_opv2v_fixture(str(tmp_path / "opv2v"), scenes,
                               frames_per_scenario=2)
    base = load_yaml(os.path.join(HYPES, "pixor_intermediate.yaml"))
    base.update(root_dir=root, validate_dir=root)
    base["train_params"].update(batch_size=2, epoches=1, max_cav=2)
    base["noise_setting"] = {"add_noise": False}
    base["preprocess"]["cav_lidar_range"] = lr
    base["postprocess"]["gt_range"] = lr
    base["model"]["args"]["geometry_param"].update(
        L1=lr[0], L2=lr[3], W1=lr[1], W2=lr[4])
    cfg = str(tmp_path / "pixor.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(base, f)
    model_dir = str(tmp_path / "run")
    cpu = ["--device", "cpu"]
    model, res = run.main(["train", "-y", cfg, "--model_dir", model_dir,
                           "--epochs", "1", "--eval_frames", "1", *cpu])
    assert type(model).__name__ == "PixorIntermediate"
    assert np.isfinite(res["ap30"])
    assert os.path.exists(os.path.join(model_dir, "net_epoch1.pth"))
    res2 = run.main(["inference", "--model_dir", model_dir,
                     "--eval_frames", "1", *cpu])
    assert np.isfinite(res2["ap30"])
    assert np.isfinite(res2["bandwidth_mb_per_frame"])


def test_intermediate_fuses_in_the_agents_own_frames():
    """PixorIntermediate fuses c3/c4/c5 with no warp, and the JAX package
    never reads the yaml's proj_first: each agent's raster stays in its
    own frame (the intermediate batch's points are), so the fused maps do
    not move when the pairwise transforms do, in either package (ROADMAP
    §3, a place where the JAX package departs from the reference)."""
    batch = _batch(frames=1)
    jmodel, variables, jbatch, model = _pair("pixor_intermediate", batch)
    moved = dict(batch, pairwise_t_matrix=batch["pairwise_t_matrix"] * 0.5)
    with torch.no_grad():
        a, b = (model(_tensors(x))["cls_map"] for x in (batch, moved))
    assert torch.equal(a, b)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False)["cls_map"])
    np.testing.assert_array_equal(
        np.asarray(apply(variables, jbatch)),
        np.asarray(apply(variables, {k: jnp.asarray(v)
                                     for k, v in moved.items()})))
