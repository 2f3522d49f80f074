"""The PyTorch port's CoAlign flagship against the JAX package and the
reference recordings, at the tiny golden size (64 x 64 canvas, 2 agents).

  * JAX variables (random, seeded) -> from_jax_params -> strict load: the
    same head maps (1e-4, the ckpt-import tests' bound) and the same box
    sets through make_infer_fn;
  * coalign_multiscale.pth loaded strictly reproduces the reference's
    recorded head maps (2e-4, tests/test_ckpt_import.py's bound);
  * the 10 recorded frames of e2e_ap_io.npz give the reference's boxes and
    AP30/50/70 within 0.005 (tests/test_golden_e2e.py's bounds);
  * the pillar canvas and the fusions match their JAX modules (1e-5 on
    float32 features of order 1; index_add_ sums in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.inference import make_infer_fn as jax_make_infer_fn
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.models.fuse import fusion as JF
from coalign_tpu.models.pillar_encoder import PillarEncoder as JaxPillarEncoder
from coalign_tpu.ops.pillars import PillarSpec as JaxPillarSpec
from coalign_tpu.postprocess.anchors import generate_anchor_box as jax_anchors
from coalign_tpu.utils import transforms as JT
from coalign_tpu_torch.inference import evaluate, make_infer_fn
from coalign_tpu_torch.kernels.rotated_iou import rotated_iou
from coalign_tpu_torch.models.fuse import fusion as TF
from coalign_tpu_torch.models.pillar_encoder import PillarEncoder
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.ops.pillars import PillarSpec
from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
from coalign_tpu_torch.utils.weights import from_jax_params, load_pth

from chip_smoke import TINY_ANCHORS as ANCHOR_ARGS
from chip_smoke import TINY_ARGS, golden_batch, match_box_sets

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

FLAGSHIP = {"core_method": "point_pillar_baseline_multiscale",
            "args": TINY_ARGS}


def _two_agent_batch(io):
    return golden_batch(io, ("ego_points", "cav_points"), io["pairwise"], 512)


def _randomize_norms(variables, rng):
    """Seeded values for every batch-norm leaf, so that eval-mode BN is not
    the identity it is after init."""
    def walk(tree, stats):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats)
                continue
            v = np.asarray(v)
            if k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "bias" or (stats and k == "mean"):
                v = rng.normal(0.0, 0.1, v.shape)
            elif stats and k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            out[k] = v.astype(np.float32)
        return out
    return {"params": walk(variables["params"], False),
            "batch_stats": walk(variables["batch_stats"], True)}


def test_jax_weights_give_the_same_maps_and_boxes():
    io = np.load(os.path.join(GOLDEN, "coalign_multiscale_io.npz"))
    batch = _two_agent_batch(io)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model(FLAGSHIP)
    variables = jit_init(jmodel, jax.random.PRNGKey(0), jbatch, train=False)
    variables = _randomize_norms(
        jax.tree_util.tree_map(np.asarray, variables),
        np.random.default_rng(0))

    model = build_model(FLAGSHIP, device="cpu")
    model.load_state_dict(from_jax_params(
        variables, TINY_ARGS["base_bev_backbone"]["layer_nums"]), strict=True)
    cfg = {"target_args": {"score_threshold": 0.3}, "nms_thresh": 0.15,
           "gt_range": TINY_ARGS["lidar_range"],
           "dir_args": TINY_ARGS["dir_args"], "max_num": 100}
    anchors = generate_anchor_box(ANCHOR_ARGS)
    jinfer = jax_make_infer_fn(jmodel, jax_anchors(ANCHOR_ARGS), cfg)
    want = jax.tree_util.tree_map(np.asarray, jinfer(variables, jbatch))
    got = {k: v.numpy() for k, v in
           make_infer_fn(model, anchors, cfg, device="cpu")(batch).items()}

    jmaps = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    with torch.no_grad():
        maps = model({k: torch.as_tensor(v) for k, v in batch.items()})
    for key in ("cls_preds", "reg_preds", "dir_preds"):
        np.testing.assert_allclose(
            maps[key].numpy(), np.asarray(jmaps[key]).transpose(0, 3, 1, 2),
            atol=1e-4, err_msg=key)
    keep_t, keep_j = got["mask"][0], want["mask"][0]
    assert keep_j.sum() > 3
    match_box_sets(got["corners3d"][0][keep_t], got["scores"][0][keep_t],
                   want["corners3d"][0][keep_j], want["scores"][0][keep_j])


def test_reference_checkpoint_reproduces_recorded_maps():
    io = np.load(os.path.join(GOLDEN, "coalign_multiscale_io.npz"))
    batch = _two_agent_batch(io)
    model = load_pth(build_model(FLAGSHIP, device="cpu"),
                     os.path.join(GOLDEN, "coalign_multiscale.pth"))
    with torch.no_grad():
        out = model({k: torch.as_tensor(v) for k, v in batch.items()})
    for key in ("cls_preds", "reg_preds", "dir_preds"):
        np.testing.assert_allclose(out[key].numpy(), io[key], atol=2e-4,
                                   err_msg=key)


def test_recorded_frames_give_reference_boxes_and_ap():
    io = np.load(os.path.join(GOLDEN, "e2e_ap_io.npz"))
    model = load_pth(build_model(FLAGSHIP, device="cpu"),
                     os.path.join(GOLDEN, "coalign_multiscale.pth"))
    cfg = {"target_args": {"score_threshold": float(io["score_threshold"])},
           "nms_thresh": float(io["nms_thresh"]),
           "gt_range": TINY_ARGS["lidar_range"],
           "dir_args": TINY_ARGS["dir_args"], "max_num": 100}
    infer = make_infer_fn(model, generate_anchor_box(ANCHOR_ARGS), cfg,
                          device="cpu")
    frames = []
    for i in range(int(io["num_frames"])):
        frame = golden_batch(io, (f"ego_points_{i}", f"cav_points_{i}"),
                             io[f"pairwise_{i}"], 512)
        frame["gt_corners"] = [io[f"gt_corners_{i}"]]
        frames.append(frame)
    seen = []

    def recording(frame):
        seen.append(infer(frame))
        return seen[-1]

    res = evaluate(recording, frames)
    assert res["frames"] == len(seen) == int(io["num_frames"])
    for i, dets in enumerate(seen):
        keep = dets["mask"][0].numpy()
        match_box_sets(dets["corners3d"][0].numpy()[keep],
                       dets["scores"][0].numpy()[keep],
                       io[f"pred_corners_{i}"], io[f"pred_scores_{i}"])
    for key in ("ap30", "ap50", "ap70"):
        assert abs(res[key] - float(io[key])) <= 0.005, key


@pytest.mark.parametrize("pad_parity,with_distance,use_absolute_xyz", [
    (True, False, True), (False, False, True), (False, True, False)])
def test_pillar_canvas_matches_jax_encoder(pad_parity, with_distance,
                                           use_absolute_xyz):
    rng = np.random.default_rng(21)
    lidar_range, voxel = [-12.8, -6.4, -3.0, 12.8, 6.4, 1.0], [0.4, 0.4, 4.0]
    f, n = 3, 700
    points = np.zeros((f, n, 4), np.float32)
    # half the points in a few dense pillars, some outside the range
    points[..., 0] = rng.uniform(-14, 14, (f, n))
    points[..., 1] = rng.uniform(-7, 7, (f, n))
    points[:, : n // 2, :2] = rng.integers(-3, 3, (f, n // 2, 2)) * 0.4 + 0.1
    points[..., 2] = rng.uniform(-3.5, 1.5, (f, n))
    points[..., 3] = rng.uniform(0, 1, (f, n))
    mask = rng.uniform(size=(f, n)) > 0.1
    kw = dict(num_filters=(16,), with_distance=with_distance,
              use_absolute_xyz=use_absolute_xyz, pad_parity=pad_parity)
    jenc = JaxPillarEncoder(spec=JaxPillarSpec.from_config(lidar_range, voxel),
                            **kw)
    variables = jax.jit(jenc.init)(jax.random.PRNGKey(1), jnp.asarray(points),
                                   jnp.asarray(mask))
    variables = _randomize_norms(
        jax.tree_util.tree_map(np.asarray, variables),
        np.random.default_rng(2))
    want = np.asarray(jax.jit(lambda v, p, m: jenc.apply(v, p, m))(
        variables, jnp.asarray(points), jnp.asarray(mask)))

    enc = PillarEncoder(PillarSpec.from_config(lidar_range, voxel), **kw)
    sd = {k[len("pillar_vfe."):]: v
          for k, v in from_jax_params({
              "params": {"encoder": variables["params"]},
              "batch_stats": {"encoder": variables["batch_stats"]}}).items()}
    enc.load_state_dict(sd, strict=True)
    enc.eval()
    with torch.no_grad():
        got = enc(torch.from_numpy(points), torch.from_numpy(mask))
    assert got.shape == (f, 16, 32, 64)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)
    assert (want > 0).any(axis=-1).sum() > 50


@pytest.mark.parametrize("method", ["att", "max", "mean"])
def test_fusion_matches_jax(method):
    rng = np.random.default_rng(22)
    b, l, h, w, c = 2, 3, 10, 16, 8
    feats = rng.normal(size=(b, l, h, w, c)).astype(np.float32)
    poses = np.zeros((b, l, 3), np.float32)
    poses[..., :2] = rng.uniform(-1.5, 1.5, (b, l, 2))
    poses[..., 2] = rng.uniform(-30, 30, (b, l))
    mask = np.array([[1, 1, 0], [1, 1, 1]], bool)
    aff = np.asarray(JT.normalize_pairwise_tfm(
        JT.get_pairwise_transformation(poses, mask), h, w, 0.4))
    jmod = JF.build_fusion(method, {}, c)
    want = np.asarray(jmod.apply({}, jnp.asarray(feats), jnp.asarray(aff),
                                 jnp.asarray(mask)))
    got = TF.build_fusion(method, {}, c)(
        torch.from_numpy(feats).permute(0, 1, 4, 2, 3), torch.from_numpy(aff),
        torch.from_numpy(mask))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-4)


def test_inference_on_cpu_never_launches_the_kernel():
    io = np.load(os.path.join(GOLDEN, "coalign_multiscale_io.npz"))
    batch = _two_agent_batch(io)
    model = build_model(FLAGSHIP, device="cpu")
    cfg = {"target_args": {"score_threshold": 0.2}, "nms_thresh": 0.15,
           "gt_range": TINY_ARGS["lidar_range"], "max_num": 100}
    before = rotated_iou.launches
    dets = make_infer_fn(model, generate_anchor_box(ANCHOR_ARGS), cfg,
                         device="cpu")(batch)
    assert rotated_iou.launches == before
    assert dets["corners3d"].shape == (1, 100, 8, 3)
    assert dets["boxes7"].shape == (1, 100, 7)
    assert dets["scores"].shape == dets["mask"].shape == (1, 100)
    assert torch.isfinite(dets["corners3d"]).all()


def test_smoke_configurations_equal_the_golden_tests():
    # chip_smoke.py runs where JAX is not installed, so it carries copies of
    # the golden tests' configurations; they must not drift from them
    import chip_smoke as S
    import test_golden_e2e as E
    import test_golden_fullscale as F
    assert S.FULL_ARGS == F.FULL_ARGS
    assert S.FULL_ANCHORS == F.ANCHOR_ARGS
    assert S.TINY_ARGS == E.TINY_ARGS
    assert S.TINY_ANCHORS == E.ANCHOR_ARGS


@pytest.mark.parametrize("train", [False, True])
def test_supervise_single_heads_match_jax(train, monkeypatch):
    """The multiscale model's ``supervise_single`` heads (coalign_tpu/
    models/zoo.py:184-208): each agent's unfused scales decoded, shrunk and
    through ``single_heads``, the ``*_single`` maps on (B*L, ...), beside
    the fused maps. Eval in float32 within 1e-4; train mode (batch
    statistics, the fused decode's norms moving before the single one's)
    in float64 within 1e-8 of each map's largest (test_torch_second's
    float64 helpers)."""
    from test_torch_second import _jax_train_float64, _port_train
    io = np.load(os.path.join(GOLDEN, "coalign_multiscale_io.npz"))
    batch = _two_agent_batch(io)
    cfg = {**FLAGSHIP, "args": {**TINY_ARGS, "supervise_single": True}}
    jmodel = jax_build_model(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomize_norms(jax.tree_util.tree_map(
        np.asarray, jit_init(jmodel, jax.random.PRNGKey(2), jbatch,
                             train=False)), np.random.default_rng(2))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(
        variables, TINY_ARGS["base_bev_backbone"]["layer_nums"]), strict=True)
    inputs = {k: torch.as_tensor(v) for k, v in batch.items()}
    if train:
        want, _ = _jax_train_float64(monkeypatch, lambda v, b: jmodel.apply(
            v, b, train=True, mutable=["batch_stats"]), variables, batch)
        _, got, _ = _port_train(model, inputs)
        tol = 1e-8
    else:
        want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, jbatch)
        with torch.no_grad():
            got = model(inputs)
        tol = 1e-4
    assert set(got) == set(want) and "cls_preds_single" in got
    for key, w in want.items():
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert got[key].shape[0] == (2 if key.endswith("_single") else 1)
        err = float(np.abs(got[key].numpy() - w).max())
        assert err <= tol * float(np.abs(w).max()), (key, err)
