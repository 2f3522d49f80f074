"""The port's SECOND family (coalign_tpu_torch/models/voxel_backbone.py,
second_family.py, the IoU head, post_process's IoU rescoring, VoxelNetLoss,
the train step and the CLI) against the JAX package and the reference
recordings, on the CPU.

Inputs come from numpy seeds. Bounds:
  * each of the seven models through from_jax_params (and second_ssfa on
    the sparse backbone): eval mode in float32, head maps within 1e-4 of
    each map's largest magnitude; train mode in float64
    (_jax_train_float64), within 1e-8, and the port's float32 maps within
    1e-4 of its float64 ones (the 3D backbones and SSFA alone:
    tests/test_torch_voxel_backbone.py);
  * the three recordings through load_pth(strict=True), on the dense twin
    and on the sparse path: tests/test_ckpt_import.py's bounds (rtol 2e-3,
    atol 1e-3; rtol 5e-3 for second_intermediate and second_ssfa);
  * post_process with iou_preds against post_process_frame: the same boxes
    (corners within 1e-4, scores within 1e-6, masks equal);
  * VoxelNetLoss against the JAX loss: 1e-5 relative;
  * train steps of second_ssfa and voxel_net against
    coalign_tpu.train.make_train_step: tests/test_torch_train.py's bounds.
"""

import copy
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.models import layers as JLAYERS
from coalign_tpu.ops import sparse_conv as JS
from coalign_tpu.ops import warp as JWARP
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.ops import sparse_conv as S
from coalign_tpu_torch.utils.weights import from_jax_params, load_pth

from test_torch_flagship import _randomize_norms

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
sys.path.insert(0, GOLDEN)
from generate_fixtures import SECOND_ARGS, SSFA_ARGS  # noqa: E402

DIR_ARGS = {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]}
LR = [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0]
# the models' grid: 32 x 32 x 8 (0.8 m, 0.5 m)
MODEL_VOXEL = [0.8, 0.8, 0.5]
BB = {"layer_nums": [1, 1], "layer_strides": [1, 2], "num_filters": [16, 32],
      "upsample_strides": [1, 2], "num_upsample_filter": [16, 16]}


def _args(extra=None) -> dict:
    a = {"voxel_size": MODEL_VOXEL, "lidar_range": LR, "anchor_number": 2,
         "base_bev_backbone": BB, "backbone_3d": {"num_features_out": 16},
         "ssfa": {"feature_num": 16}, "dir_args": DIR_ARGS}
    a.update(extra or {})
    return a


# (core_method, args on top of _args())
MODELS = {
    "second": ("second", {}),
    "second_intermediate": ("second_intermediate", {"fusion_method": "att"}),
    "ciassd": ("ciassd", {}),
    "second_ssfa": ("second_ssfa", {}),
    "second_ssfa_sparse": ("second_ssfa", {"backbone_3d": {
        "num_features_out": 16, "sparse": True, "max_voxels": 512}}),
    "second_ssfa_uncertainty": ("second_ssfa_uncertainty", {}),
    "voxel_net": ("voxel_net", {}),
    "voxel_net_intermediate": ("voxel_net_intermediate",
                               {"fusion_method": "att"}),
}


def _points(frames: int, n: int, seed: int, lr=LR) -> tuple:
    """(F, N, 4) points and (F, N) mask: a ground plane, three clusters
    (cars) and uniform clutter, some outside the range, the last tenth of
    each frame padded."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((frames, n, 4), np.float32)
    k = n // 3
    pts[:, :k, :2] = rng.uniform(lr[0], lr[3], (frames, k, 2))
    pts[:, :k, 2] = rng.uniform(-2.0, -1.8, (frames, k))
    centres = rng.uniform(np.array(lr[:2]) + 3, np.array(lr[3:5]) - 3,
                          (frames, 3, 2))
    pts[:, k:2 * k, :2] = (centres[:, rng.integers(0, 3, k)]
                           + rng.uniform(-2, 2, (frames, k, 2)))
    pts[:, k:2 * k, 2] = rng.uniform(-1.8, 0.0, (frames, k))
    pts[:, 2 * k:, :3] = rng.uniform(np.array(lr[:3]) - 1,
                                     np.array(lr[3:]) + 1,
                                     (frames, n - 2 * k, 3))
    pts[..., 3] = rng.uniform(0, 1, (frames, n))
    mask = np.ones((frames, n), bool)
    mask[:, n - n // 10:] = False
    return pts * mask[..., None], mask


def _batch(b: int = 2, l: int = 2, n: int = 300, seed: int = 0) -> dict:
    """B frames of L agent slots, the last frame's last slot padded, and
    pairwise transforms of small seeded rotations and shifts."""
    pts, mask = _points(b * l, n, seed)
    agent = np.ones((b, l), bool)
    agent[-1, -1] = False
    mask = mask.reshape(b, l, n) & agent[..., None]
    rng = np.random.default_rng(seed + 1)
    pose = np.zeros((b, l, 3))
    pose[:, 1:] = rng.uniform([-4, -4, -0.2], [4, 4, 0.2], (b, l - 1, 3))
    t = np.tile(np.eye(4), (b, l, 1, 1))
    t[..., 0, 0] = t[..., 1, 1] = np.cos(pose[..., 2])
    t[..., 0, 1], t[..., 1, 0] = -np.sin(pose[..., 2]), np.sin(pose[..., 2])
    t[..., :2, 3] = pose[..., :2]
    pair = np.einsum("bjxy,biyz->bijxz", np.linalg.inv(t), t)
    return {"points": (pts.reshape(b, l, n, 4) * mask[..., None]),
            "point_mask": mask, "agent_mask": agent,
            "pairwise_t_matrix": pair.astype(np.float32),
            "transformation_matrix": np.tile(np.eye(4, dtype=np.float32),
                                             (b, 1, 1))}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got, want, tol, what):
    """|got - want| within ``tol`` of want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _stats(sd: dict) -> dict:
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _float64(tree):
    """``tree``'s float arrays as float64 (inside jax.enable_x64); a
    SparseGrid's features only (its shape is static)."""
    if isinstance(tree, JS.SparseGrid):
        return tree._replace(feats=jnp.asarray(tree.feats, jnp.float64))
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating)
        else jnp.asarray(a), tree)


def _jit(fn, variables, inputs):
    """jax.jit(fn)(variables, inputs), a SparseGrid's static shape kept out
    of the trace."""
    if isinstance(inputs, JS.SparseGrid):
        shape = inputs.shape
        return jax.jit(lambda v, k, f, m: fn(v, JS.SparseGrid(k, f, m, shape)))(
            variables, *inputs[:3])
    return jax.jit(fn)(variables, inputs)


def _jax_train_float64(monkeypatch, apply, variables, inputs):
    """A train-mode JAX apply (outputs, updated batch_stats) in float64.
    In train mode the JAX package's float32 rounding alone lies ~2e-4 of
    the dense twin's largest output from the float64 result (its norms'
    statistics over grids of mostly empty cells), where the port's float32
    lies within 3e-6; so train mode is held in float64. The JAX package
    pins float32 in its norms' statistics (models/layers.py), the warp's
    sampling grid (ops/warp.py) and the sparse conv's accumulation
    (ops/sparse_conv.py): for this run those modules see float64 where
    they name float32, as tests/test_torch_kd.py does."""
    jnp64 = types.ModuleType("jax.numpy")
    jnp64.__dict__.update(vars(jnp))
    jnp64.float32 = jnp.float64
    with monkeypatch.context() as patch, jax.enable_x64(True):
        for mod in (JLAYERS, JWARP, JS):
            patch.setattr(mod, "jnp", jnp64)
        out, upd = _jit(apply, _float64(variables), _float64(inputs))
        leaf = jax.tree_util.tree_leaves(upd)[0]
        assert leaf.dtype == jnp.float64
        return jax.tree_util.tree_map(np.asarray, (out, upd))


def _port_train(model, inputs):
    """(float32 outputs, float64 outputs, the float64 model) of one
    train-mode forward of ``model`` and of a float64 copy."""
    model64 = copy.deepcopy(model).double().train()
    model.train()

    def double(x):
        if isinstance(x, S.SparseGrid):
            return x._replace(feats=x.feats.double())
        if isinstance(x, dict):
            return {k: double(v) for k, v in x.items()}
        return x.double() if x.is_floating_point() else x

    with torch.no_grad():
        return model(inputs), model64(double(inputs)), model64


def _held_in_float64(got32, got64, want64, what):
    """The port's float64 output within 1e-8 of the JAX float64 one (of its
    largest magnitude), and its float32 output within 1e-4 of its
    float64 one."""
    _close(got64, want64, 1e-8, f"{what} float64")
    _close(got32, got64, 1e-4, f"{what} float32 against float64")


# ------------------------------------------------------------------ models


def _jax_and_port(name: str, seed: int = 0):
    core, extra = MODELS[name]
    cfg = {"core_method": core, "args": _args(extra)}
    batch = _batch(seed=seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model(cfg)
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(seed + 7), jbatch, train=False)),
        np.random.default_rng(seed + 8))
    heads = variables["params"]["DetectionHeads_0"]
    if "iou_head" in heads and "ssfa" in cfg["args"]:
        # CIA-SSD's IoU head has no bias in the reference; the JAX one's
        # starts at 0 and no loss reaches it
        heads["iou_head"]["bias"] = np.zeros_like(heads["iou_head"]["bias"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(variables, BB["layer_nums"]),
                          strict=True)
    return cfg, batch, jbatch, jmodel, variables, model


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_models_match_jax(name, train, monkeypatch):
    """Head maps of each model against the JAX model's: eval mode in
    float32 (1e-4), train mode in float64 (_held_in_float64)."""
    cfg, batch, jbatch, jmodel, variables, model = _jax_and_port(name)
    frames = 2 if "intermediate" in name else 4
    if train:
        want, _ = _jax_train_float64(
            monkeypatch, lambda v, b: jmodel.apply(
                v, b, train=True, mutable=["batch_stats"]), variables, batch)
        got32, got64, _ = _port_train(model, _torch(batch))
    else:
        want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, jbatch)
        with torch.no_grad():
            got32 = model(_torch(batch))
    assert set(got32) == set(want)
    for key in got32:
        assert got32[key].shape[0] == frames
        w = np.asarray(want[key]).transpose(0, 3, 1, 2)
        assert float(np.abs(w).max()) > 1e-3, key
        if train:
            _held_in_float64(got32[key].numpy(), got64[key].numpy(), w,
                             f"{name} {key}")
        else:
            _close(got32[key].numpy(), w, 1e-4, f"{name} {key}")
    if "ssfa" in name or name == "ciassd":
        assert "iou_preds" in got32
        assert model.head.conv_iou.bias is None


# -------------------------------------------------------------- recordings


def _recorded_batch(io, keys, n=512) -> dict:
    points = np.zeros((len(keys), 1, n, 4), np.float32)
    pmask = np.zeros((len(keys), 1, n), bool)
    for f, key in enumerate(keys):
        pts = io[key]
        points[f, 0, :len(pts)] = pts
        pmask[f, 0, :len(pts)] = True
    return {"points": points, "point_mask": pmask,
            "agent_mask": np.ones((len(keys), 1), bool),
            "pairwise_t_matrix": np.tile(np.eye(4, dtype=np.float32),
                                         (len(keys), 1, 1, 1, 1))}


RECORDINGS = {
    # name: (core_method, args, point keys, outputs, rtol)
    "second": ("second", SECOND_ARGS, ("points",),
               ("cls_preds", "reg_preds"), 2e-3),
    "second_intermediate": ("second_intermediate",
                            dict(SECOND_ARGS, fusion_method="att"),
                            ("points0", "points1"),
                            ("cls_preds", "reg_preds"), 5e-3),
    "second_ssfa": ("second_ssfa", SSFA_ARGS, ("points",),
                    ("cls_preds", "reg_preds", "dir_preds", "iou_preds"),
                    5e-3),
}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("name", list(RECORDINGS))
def test_recordings_load_strictly_and_hold(name, sparse):
    core, args, keys, outputs, rtol = RECORDINGS[name]
    # 4096 rows a frame: the recordings' 400 points and their strided
    # outputs (at most 8 each) overflow no table
    args = dict(args, backbone_3d=dict(args["backbone_3d"], sparse=sparse,
                                       max_voxels=4096))
    model = build_model({"core_method": core, "args": args}, device="cpu")
    assert model.use_sparse == sparse
    load_pth(model, os.path.join(GOLDEN, f"{name}.pth"))
    io = np.load(os.path.join(GOLDEN, f"{name}_io.npz"))
    with torch.no_grad():
        out = model(_torch(_recorded_batch(io, keys)))
    for key in outputs:
        np.testing.assert_allclose(out[key].numpy(), io[key], rtol=rtol,
                                   atol=1e-3, err_msg=key)


# --------------------------------------------------- post-processing, loss


def test_post_process_iou_rescoring_matches_jax():
    """post_process(iou_preds=) against post_process_frame(iou_preds=) on
    seeded maps of two frames: the same boxes, scores and masks; the
    rescoring moves the result (the same maps without it keep another
    set)."""
    from coalign_tpu.postprocess.decode import post_process_frame
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.postprocess.decode import post_process
    lr = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
    anchors = generate_anchor_box(
        {"W": 80, "H": 80, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
         "vw": 0.4, "vh": 0.4, "feature_stride": 4, "cav_lidar_range": lr})
    h, w, a = anchors.shape[:3]
    rng = np.random.default_rng(21)
    maps = {"cls": rng.normal(-1.0, 2.0, (2, a, h, w)),
            "reg": rng.normal(0.0, 0.3, (2, 7 * a, h, w)),
            "dir": rng.normal(0.0, 1.0, (2, 2 * a, h, w)),
            "iou": rng.normal(0.0, 2.0, (2, a, h, w))}
    maps = {k: v.astype(np.float32) for k, v in maps.items()}
    kw = dict(score_threshold=0.2, nms_threshold=0.15, gt_range=lr)
    t = {k: torch.from_numpy(v) for k, v in maps.items()}
    got = post_process(t["cls"], t["reg"], torch.from_numpy(anchors),
                       torch.eye(4).expand(2, 4, 4), t["dir"],
                       iou_preds=t["iou"], **kw)
    plain = post_process(t["cls"], t["reg"], torch.from_numpy(anchors),
                         torch.eye(4).expand(2, 4, 4), t["dir"], **kw)
    jax_post = jax.jit(lambda c, r, d, i: post_process_frame(
        c, r, anchors, np.eye(4, dtype=np.float32), d, iou_preds=i, **kw))
    for f in range(2):
        want = jax_post(*(maps[k][f].transpose(1, 2, 0)
                          for k in ("cls", "reg", "dir", "iou")))
        mask = got["mask"][f].numpy()
        np.testing.assert_array_equal(mask, np.asarray(want["mask"]))
        assert mask.sum() > 10
        np.testing.assert_allclose(got["corners3d"][f].numpy(),
                                   np.asarray(want["corners3d"]), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got["scores"][f].numpy(),
                                   np.asarray(want["scores"]), rtol=0,
                                   atol=1e-6)
    assert not torch.equal(got["scores"], plain["scores"])


def test_infer_fns_ignore_iou_preds_as_jax():
    """The JAX infer fns never pass iou_preds (coalign_tpu/inference.py:
    98-102, 143-147): CIA-SSD serves without rescoring there, and so does
    the port (ROADMAP §3). A second_ssfa's boxes through make_infer_fn and
    make_late_infer_fn equal post_process's without iou_preds."""
    from coalign_tpu_torch.inference import make_infer_fn, make_late_infer_fn
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.postprocess.decode import post_process
    cfg, batch, _, _, _, model = _jax_and_port("second_ssfa")
    anchors = generate_anchor_box(
        {"W": 32, "H": 32, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
         "vw": 0.8, "vh": 0.8, "feature_stride": 8, "cav_lidar_range": LR})
    with torch.no_grad():
        maps = model.eval()(_torch(batch))
    # the seeded maps' scores all lie near 0.5: a threshold that keeps
    # some of them
    post = {"target_args": {"score_threshold": 0.4}, "nms_thresh": 0.15,
            "gt_range": LR, "dir_args": DIR_ARGS}
    kw = dict(score_threshold=0.4, nms_threshold=0.15, gt_range=tuple(LR))
    want = post_process(maps["cls_preds"], maps["reg_preds"],
                        torch.from_numpy(anchors), torch.eye(4).expand(4, 4, 4),
                        maps["dir_preds"], **kw)
    rescored = post_process(maps["cls_preds"], maps["reg_preds"],
                            torch.from_numpy(anchors),
                            torch.eye(4).expand(4, 4, 4), maps["dir_preds"],
                            iou_preds=maps["iou_preds"], **kw)
    assert not torch.equal(want["scores"], rescored["scores"])
    late = make_late_infer_fn(model, anchors, post, "no", device="cpu")
    got = late(dict(batch, transformation_matrix=np.tile(
        np.eye(4, dtype=np.float32), (2, 2, 1, 1))))
    ego = want["scores"].reshape(2, 2, -1)[:, 0]
    np.testing.assert_allclose(
        np.sort(got["scores"].numpy(), axis=1)[:, ::-1][:, :ego.shape[1]],
        np.sort(ego.numpy(), axis=1)[:, ::-1], rtol=0, atol=1e-6)
    single = {k: v[:, :1] if k != "pairwise_t_matrix" else v[:, :1, :1]
              for k, v in batch.items() if k != "transformation_matrix"}
    single["transformation_matrix"] = batch["transformation_matrix"]
    dets = make_infer_fn(model, anchors, post, device="cpu")(single)
    np.testing.assert_allclose(dets["scores"].numpy(),
                               want["scores"].reshape(2, 2, -1)[:, 0].numpy(),
                               rtol=0, atol=1e-6)


def test_voxelnet_loss_matches_jax():
    from coalign_tpu.loss import build_loss as jax_build_loss
    from coalign_tpu_torch.loss import build_loss
    rng = np.random.default_rng(11)
    b, h, w, a = 2, 6, 6, 2
    psm = rng.normal(0, 2, (b, h, w, a)).astype(np.float32)
    rm = rng.normal(0, 1, (b, h, w, a * 7)).astype(np.float32)
    pos = (rng.random((b, h, w, a)) < 0.1).astype(np.float32)
    neg = ((rng.random((b, h, w, a)) < 0.7) * (1 - pos)).astype(np.float32)
    tgt = rng.normal(0, 1, (b, h, w, a * 7)).astype(np.float32)
    cfg = {"core_method": "voxel_net_loss",
           "args": {"alpha": 1.5, "beta": 1.0, "reg": 2.0}}
    labels = {"pos_equal_one": pos, "neg_equal_one": neg, "targets": tgt}
    want_total, want = jax_build_loss(cfg)(
        {"cls_preds": jnp.asarray(psm), "reg_preds": jnp.asarray(rm)},
        {k: jnp.asarray(v) for k, v in labels.items()})
    total, got = build_loss(cfg)(
        {"cls_preds": torch.from_numpy(psm).permute(0, 3, 1, 2),
         "reg_preds": torch.from_numpy(rm).permute(0, 3, 1, 2)},
        {k: torch.from_numpy(v) for k, v in labels.items()})
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)


# -------------------------------------------------------------- train step

STEP_TARGETS = {"pos_threshold": 0.3, "neg_threshold": 0.2}
PP_LOSS = {"core_method": "point_pillar_loss", "args": {
    "pos_cls_weight": 2.0, "cls": {"alpha": 0.25, "gamma": 2.0,
                                   "weight": 2.0},
    "reg": {"sigma": 3.0, "weight": 2.0},
    "dir": {"weight": 0.2, "args": DIR_ARGS}}}
VOXELNET_LOSS = {"core_method": "voxel_net_loss",
                 "args": {"alpha": 1.5, "beta": 1.0, "reg": 2.0}}
# name: (MODELS entry, the yaml's loss, the heads' feature stride);
# second_ssfa on the sparse backbone, which its yamls' grids take
STEP_CASES = {"second_ssfa": ("second_ssfa_sparse", PP_LOSS, 8),
              "voxel_net": ("voxel_net", VOXELNET_LOSS, 1)}


def _step_case(name: str):
    """(config, loss config, anchor args, a B = 2 batch of one agent a
    frame with gt boxes on anchors of its head grid)."""
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    key, loss_cfg, stride = STEP_CASES[name]
    core, extra = MODELS[key]
    anchor_args = {"W": 32, "H": 32, "l": 3.9, "w": 1.6, "h": 1.56,
                   "r": [0, 90], "vw": 0.8, "vh": 0.8,
                   "feature_stride": stride, "cav_lidar_range": LR}
    anchors = generate_anchor_box(anchor_args)
    rng = np.random.default_rng(31)
    batch = _batch(b=2, l=1, seed=4)
    cells = anchors.reshape(-1, 7)
    gt = np.zeros((2, 6, 7), np.float32)
    for f in range(2):
        pick = rng.choice(len(cells), 4, replace=False)
        gt[f, :4] = cells[pick]
        gt[f, :4, :2] += rng.uniform(-0.3, 0.3, (4, 2))
    batch.update(gt_boxes=gt, gt_mask=np.arange(6)[None].repeat(2, 0) < 4)
    return ({"core_method": core, "args": _args(extra)}, loss_cfg,
            anchor_args, batch)


def _jax_step_float64(monkeypatch, cfg, loss_cfg, anchor_args, batch,
                      variables):
    """One JAX make_train_step in float64 (_jax_train_float64's patches):
    (metrics, gradients, running statistics, parameters after SGD), the
    arrays as port state-dict entries in float64 (read back through
    from_jax_params as two float32 parts, hi + lo)."""
    from coalign_tpu.loss import build_loss as jax_build_loss
    from coalign_tpu.postprocess import anchors as JANC
    from coalign_tpu.train import TrainState
    from coalign_tpu.train import make_train_step as jax_make_train_step
    from test_torch_train import SGD_LR, _recording_sgd
    jmodel = jax_build_model(cfg)
    jnp64 = types.ModuleType("jax.numpy")
    jnp64.__dict__.update(vars(jnp))
    jnp64.float32 = jnp.float64
    with monkeypatch.context() as patch, jax.enable_x64(True):
        for mod in (JLAYERS, JWARP, JS):
            patch.setattr(mod, "jnp", jnp64)
        v64 = _float64(variables)
        state = TrainState.create(apply_fn=jmodel.apply,
                                  params=v64["params"],
                                  batch_stats=v64["batch_stats"],
                                  tx=_recording_sgd(SGD_LR))
        new, metrics = jax_make_train_step(
            jmodel, jax_build_loss(loss_cfg),
            JANC.make_anchor_spec(anchor_args, STEP_TARGETS),
            donate=False)(state, _float64(batch))
        new = jax.tree_util.tree_map(np.asarray, new)
    assert new.params["DetectionHeads_0"]["cls_head"]["kernel"].dtype == \
        np.float64

    def port(col, tree):
        hi = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
        lo = jax.tree_util.tree_map(lambda a, h: (a - h).astype(np.float32),
                                    tree, hi)
        hi, lo = (from_jax_params({col: t}, BB["layer_nums"])
                  for t in (hi, lo))
        return {k: hi[k].double() + lo[k].double() for k in hi
                if not k.endswith("num_batches_tracked")}

    return ({k: float(v) for k, v in metrics.items()},
            port("params", new.opt_state),
            port("batch_stats", new.batch_stats),
            port("params", new.params))


def _port_step(cfg, loss_cfg, anchor_args, batch, variables, dtype):
    """One port make_train_step with SGD in ``dtype``: (terms, gradients,
    state dict after the step)."""
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
    from coalign_tpu_torch.train import make_train_step
    from test_torch_train import SGD_LR
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(variables, BB["layer_nums"]),
                          strict=True)
    model.to(dtype)
    step = make_train_step(model, build_loss(loss_cfg),
                           make_anchor_spec(anchor_args, STEP_TARGETS),
                           torch.optim.SGD(model.parameters(), lr=SGD_LR),
                           device="cpu")
    terms = step(batch)
    assert model.training
    return ({k: float(v) for k, v in terms.items()},
            {k: p.grad.double() for k, p in model.named_parameters()},
            {k: v.double() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")})


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_step_matches_jax(name, monkeypatch):
    """One train step of second_ssfa (point_pillar_loss) and of voxel_net
    (voxel_net_loss) against coalign_tpu.train.make_train_step, held in
    float64 as tests/test_torch_kd.py holds the KD step (the JAX float32
    step's own rounding exceeds tests/test_torch_train.py's bounds, as the
    train-mode forward's does, _jax_train_float64): loss terms within 1e-9
    relative; each gradient within 1e-7 of its tensor's largest value plus
    1e-12 (a gradient 0 in exact arithmetic); running statistics and the
    parameters after one SGD step within 1e-9 of their tensor's largest.
    The port's float32 step against its float64 step at
    tests/test_torch_train.py's bounds: terms 1e-5 relative, gradients
    1e-4 of their largest, parameters rtol 2e-4 / atol 2e-6 plus the
    learning rate times that gradient bound."""
    from coalign_tpu.postprocess import anchors as JANC
    from coalign_tpu_torch.postprocess.anchors import (assign_targets,
                                                       make_anchor_spec)
    from test_torch_train import SGD_LR
    cfg, loss_cfg, anchor_args, batch = _step_case(name)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # labels of both packages agree on this batch (ROADMAP §3: label ties)
    jspec = JANC.make_anchor_spec(anchor_args, STEP_TARGETS)
    want_labels = jax.vmap(lambda g, m: JANC.assign_targets(g, m, jspec))(
        jbatch["gt_boxes"], jbatch["gt_mask"])
    got_labels = assign_targets(torch.from_numpy(batch["gt_boxes"]),
                                torch.from_numpy(batch["gt_mask"]),
                                make_anchor_spec(anchor_args, STEP_TARGETS))
    for key in ("pos_equal_one", "neg_equal_one"):
        np.testing.assert_array_equal(got_labels[key].numpy(),
                                      np.asarray(want_labels[key]))
    assert got_labels["pos_equal_one"].sum() >= 4
    jmodel = jax_build_model(cfg)
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(12), jbatch, train=False)),
        np.random.default_rng(13))
    heads = variables["params"]["DetectionHeads_0"]
    if "iou_head" in heads:
        heads["iou_head"]["bias"] = np.zeros_like(heads["iou_head"]["bias"])
    metrics, grads, stats, params = _jax_step_float64(
        monkeypatch, cfg, loss_cfg, anchor_args, batch, variables)
    terms64, grads64, state64 = _port_step(cfg, loss_cfg, anchor_args, batch,
                                           variables, torch.float64)
    assert set(terms64) == set(metrics)
    for key, want in metrics.items():
        np.testing.assert_allclose(terms64[key], want, rtol=1e-9,
                                   err_msg=key)
    # CIA-SSD's IoU head: no loss reaches it, its gradient is 0
    assert set(grads) == set(grads64)
    for key, want in grads.items():
        err = float((grads64[key] - want).abs().max())
        assert err <= 1e-7 * float(want.abs().max()) + 1e-12, (key, err)
    assert float(grads64["backbone_2d.blocks.0.1.weight" if name ==
                         "voxel_net" else "head.conv_cls.weight"].abs().max()) > 0
    for key, want in {**stats, **params}.items():
        _close(state64[key].numpy(), want.numpy(), 1e-9, key)
    terms32, grads32, state32 = _port_step(cfg, loss_cfg, anchor_args, batch,
                                           variables, torch.float32)
    for key, want in terms64.items():
        np.testing.assert_allclose(terms32[key], want, rtol=1e-5,
                                   err_msg=key)
    for key, want in grads64.items():
        _close(grads32[key].numpy(), want.numpy(), 1e-4, f"grad {key}")
    for key, want in params.items():
        # the step moves a parameter by SGD_LR x its gradient, which float32
        # rounds within the gradient bound above; the 3D blocks' kernels
        # read raw coordinates of up to 12.8 m, and their gradients reach
        # values where that exceeds tests/test_torch_train.py's atol 2e-6
        # alone
        atol = 2e-6 + SGD_LR * 1e-4 * float(grads64[key].abs().max())
        np.testing.assert_allclose(state32[key].numpy(), want.numpy(),
                                   rtol=2e-4, atol=atol, err_msg=key)


# --------------------------------------------------------------------- CLI


def test_second_cli_train_late_inference_and_precalc(tmp_path):
    """The run CLI on SECOND.yaml (late fusion, second_ssfa) cut to a
    +-8 m range of 0.5 m voxels on a written OPV2V tree, as
    tests/test_second_family.py:223 runs the JAX CLI: train one epoch (the
    end-of-train eval follows the late protocol), the checkpoint reloaded
    strictly by inference, and precalc.yaml's SECOND stage-1 detector
    writing its json for the tree."""
    import json

    import yaml

    from coalign_tpu_torch.config.yaml_utils import load_yaml
    from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.tools.run import main as run_main

    lr = [-8.0, -8.0, -3.0, 8.0, 8.0, 1.0]
    scenes = SyntheticScenes(num_frames=2, num_agents=2, num_objects=2,
                             lidar_range=lr, points_per_object=24,
                             ground_points=48, seed=3)
    root = write_opv2v_fixture(str(tmp_path / "opv2v"), scenes,
                               frames_per_scenario=2)
    hypes = os.path.join(os.path.dirname(__file__), "..", "coalign_tpu",
                         "hypes_yaml", "opv2v")

    def cut(name: str) -> str:
        base = load_yaml(os.path.join(hypes, name))
        base.update(root_dir=root, validate_dir=root, test_dir=None)
        base["train_params"].update(batch_size=2, epoches=1, max_cav=2)
        base["preprocess"]["cav_lidar_range"] = lr
        base["preprocess"]["args"]["voxel_size"] = [0.5, 0.5, 0.5]
        base["postprocess"]["gt_range"] = lr
        base["postprocess"]["anchor_args"]["cav_lidar_range"] = lr
        for args in (base["model"]["args"],
                     base.get("box_align_pre_calc", {}).get(
                         "stage1_model_config", {})):
            if args:
                args.update(lidar_range=lr, voxel_size=[0.5, 0.5, 0.5])
        path = str(tmp_path / name)
        with open(path, "w") as f:
            yaml.safe_dump(base, f)
        return path

    cpu = ["--device", "cpu"]
    model_dir = str(tmp_path / "run")
    model, res = run_main(["train", "-y", cut("SECOND.yaml"), "--model_dir",
                           model_dir, "--epochs", "1", "--eval_frames", "1",
                           *cpu])
    assert type(model).__name__ == "SecondSSFA" and not model.use_sparse
    assert res["frames"] == 1 and np.isfinite(res["ap30"])
    res2 = run_main(["inference", "--model_dir", model_dir,
                     "--fusion_method", "late", "--eval_frames", "1", *cpu])
    assert res2["frames"] == 1 and np.isfinite(res2["ap30"])
    written = run_main(["precalc", "-y", cut("precalc.yaml"), "--model_dir",
                        str(tmp_path / "precalc"), *cpu])
    assert [os.path.basename(os.path.dirname(p)) for p in written] == \
        ["train", "val"]
    with open(written[0]) as f:
        assert len(json.load(f)) == 2                   # one entry a frame
