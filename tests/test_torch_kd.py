"""DiscoNet's knowledge distillation in the port against the JAX package,
on the CPU at tests/test_kd.py's size (64 x 64 canvas, widths [32, 64]).

  * KDFusionBatcher's batches equal the JAX batcher's (the numpy path;
    tests/test_torch_native.py holds both paths);
  * the teacher's forward on the merged cloud from the same weights:
    teacher_feature and the teacher maps within 1e-4;
  * channel_kl and DiscoNetLoss (with and without decoder_kd) on the same
    maps: within 1e-5 relative;
  * one make_kd_train_step against the JAX one: loss terms within 1e-5
    relative; in float64, the student's gradient within 1e-7 of each
    tensor's largest value of the JAX step's float64 gradient (a bound at
    which the KD term's own gradient shows); in float32, the parameters
    after one SGD step within tests/test_torch_train.py's bounds (rtol
    2e-4, atol 2e-6) of the float64 step's; the teacher untouched;
  * the KD command line on a fixture tree, with a seeded teacher and with
    tests/golden/point_pillar_base.pth as the reference teacher, loaded
    strictly.
"""

import copy
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from conftest import jit_init

from coalign_tpu.data import batch as JBATCH
from coalign_tpu.loss import build_loss as jax_build_loss
from coalign_tpu.loss.disconet_loss import channel_kl as jax_channel_kl
from coalign_tpu.models import layers as JLAYERS
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.ops import warp as JWARP
from coalign_tpu.postprocess import anchors as JANC
from coalign_tpu.tools.train_kd import make_kd_train_step as jax_kd_step
from coalign_tpu.train import TrainState
from coalign_tpu_torch.data.batch import KDFusionBatcher
from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.loss import build_loss
from coalign_tpu_torch.loss.disconet_loss import channel_kl
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
from coalign_tpu_torch.tools import train_kd
from coalign_tpu_torch.utils.weights import from_jax_params, load_pth

from test_kd import ARGS, LIDAR_RANGE, _kd_cfg
from test_torch_flagship import _randomize_norms
from test_torch_train import SGD_LR, _recording_sgd

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
LAYER_NUMS = ARGS["base_bev_backbone"]["layer_nums"]
ANCHOR_ARGS = {"W": 64, "H": 64, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
               "vw": 0.4, "vh": 0.4, "feature_stride": 2,
               "cav_lidar_range": LIDAR_RANGE}
TARGETS = {"pos_threshold": 0.3, "neg_threshold": 0.2}
KD_LOSS = {"core_method": "point_pillar_disconet_loss",
           "args": {"pos_cls_weight": 2.0,
                    "cls": {"alpha": 0.25, "gamma": 2.0, "weight": 2.0},
                    "reg": {"sigma": 3.0, "weight": 2.0},
                    "kd": {"weight": 1.0}}}
SCENES = dict(num_frames=2, num_agents=2, num_objects=3,
              lidar_range=LIDAR_RANGE, points_per_object=32,
              ground_points=64, seed=4)


def _kd_batch():
    """tests/test_kd.py's batch: 2 frames of 2 agents, 512 points each."""
    scenes = SyntheticScenes(**SCENES)
    return KDFusionBatcher(max_cav=2, max_points=512, max_objects=8,
                           lidar_range=LIDAR_RANGE, native=False).assemble(
        [scenes[0], scenes[1]])


def _seeded(core: str, batch: dict, key: int):
    cfg = {"core_method": core, "args": ARGS}
    jmodel = jax_build_model(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(key), jbatch, train=False)),
        np.random.default_rng(key))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(variables, LAYER_NUMS),
                          strict=True)
    return jmodel, variables, jbatch, model


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_kd_batcher_matches_jax(monkeypatch):
    monkeypatch.setattr(JBATCH, "_native", None)
    got = _kd_batch()
    scenes = SyntheticScenes(**SCENES)
    want = JBATCH.KDFusionBatcher(max_cav=2, max_points=512, max_objects=8,
                                  lidar_range=LIDAR_RANGE).assemble(
        [scenes[0], scenes[1]])
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["teacher_points"].shape == (2, 1, 1024, 4)
    assert got["teacher_point_mask"].sum() >= got["point_mask"][:, 0].sum()


def test_teacher_forward_matches_jax():
    batch = _kd_batch()
    jmodel, variables, jbatch, model = _seeded(
        "point_pillar_disconet_teacher", batch, 1)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    with torch.no_grad():
        got = model(_tensors(batch))
    assert set(got) == set(want) == {"teacher_feature", "teacher_cls_preds",
                                     "teacher_reg_preds"}
    for key in want:
        assert got[key].shape[0] == 2                    # B merged frames
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]).transpose(0, 3, 1, 2),
            atol=1e-4, err_msg=key)


@pytest.mark.parametrize("decoder_kd", [False, True])
def test_disconet_loss_matches_jax(decoder_kd):
    rng = np.random.default_rng(2)
    maps = {"feature": rng.normal(0, 2, (2, 32, 32, 64)),
            "teacher_feature": rng.normal(0, 2, (2, 32, 32, 64)),
            "cls_preds": rng.normal(0, 2, (2, 32, 32, 2)),
            "reg_preds": rng.normal(0, 1, (2, 32, 32, 14)),
            "teacher_cls_preds": rng.normal(0, 2, (2, 32, 32, 2)),
            "teacher_reg_preds": rng.normal(0, 1, (2, 32, 32, 14))}
    maps = {k: v.astype(np.float32) for k, v in maps.items()}
    np.testing.assert_allclose(
        float(channel_kl(torch.from_numpy(maps["feature"]).permute(0, 3, 1, 2),
                         torch.from_numpy(maps["teacher_feature"]).permute(
                             0, 3, 1, 2))),
        float(jax_channel_kl(jnp.asarray(maps["feature"]),
                             jnp.asarray(maps["teacher_feature"]))),
        rtol=1e-5)
    gt = np.zeros((2, 4, 7), np.float32)
    gt[:, :2] = [[2.0, 1.0, -1.0, 1.6, 1.6, 3.9, 0.3],
                 [-4.0, 3.0, -1.0, 1.6, 1.6, 3.9, 1.4]]
    mask = np.zeros((2, 4), bool)
    mask[:, :2] = True
    jspec = JANC.make_anchor_spec(ANCHOR_ARGS, TARGETS)
    labels = jax.tree_util.tree_map(np.asarray, jax.vmap(
        lambda g, m: JANC.assign_targets(g, m, jspec))(
        jnp.asarray(gt), jnp.asarray(mask)))
    cfg = {**KD_LOSS, "args": {**KD_LOSS["args"], "kd": {
        "weight": 0.5, "decoder_kd": decoder_kd}}}
    _, want = jax_build_loss(cfg)({k: jnp.asarray(v) for k, v in
                                   maps.items()}, labels)
    _, got = build_loss(cfg)({k: torch.from_numpy(v).permute(0, 3, 1, 2)
                              for k, v in maps.items()}, _tensors(labels))
    assert set(got) == set(want) == {"cls_loss", "reg_loss", "kd_loss",
                                     "total_loss"}
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)


def _float64(tree):
    """``tree``'s float arrays as float64 (inside jax.enable_x64)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating)
        else jnp.asarray(a), tree)


def _jax_kd_grads_float64(monkeypatch, jstudent, jteacher, s_vars, t_vars,
                          batch):
    """The JAX KD step's gradient of the student in float64. The JAX
    package pins two things to float32 whatever the input dtype: the batch
    norms' statistics (models/layers.py MaskedBatchNorm) and the warp's
    sampling grid (ops/warp.py warp_affine). For this run those two
    modules see float64 where they name float32, so that the whole step
    is float64; the computation is otherwise the package's own."""
    jnp64 = types.ModuleType("jax.numpy")
    jnp64.__dict__.update(vars(jnp))
    jnp64.float32 = jnp.float64
    with monkeypatch.context() as patch, jax.enable_x64(True):
        patch.setattr(JLAYERS, "jnp", jnp64)
        patch.setattr(JWARP, "jnp", jnp64)
        variables = _float64(s_vars)
        state = TrainState.create(apply_fn=jstudent.apply,
                                  params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  tx=_recording_sgd(SGD_LR))
        new, metrics = jax_kd_step(
            jstudent, jteacher, _float64(t_vars), jax_build_loss(KD_LOSS),
            JANC.make_anchor_spec(ANCHOR_ARGS, TARGETS))(
            state, _float64(batch))
        new = jax.tree_util.tree_map(np.asarray, new)
        assert new.opt_state["heads"]["cls_head"]["kernel"].dtype == \
            np.float64
    # from_jax_params casts to float32: read the float64 gradient back as
    # two float32 parts, hi + lo, and sum them in float64
    hi = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                new.opt_state)
    lo = jax.tree_util.tree_map(lambda a, h: (a - h).astype(np.float32),
                                new.opt_state, hi)
    hi, lo = (from_jax_params({"params": t}, LAYER_NUMS) for t in (hi, lo))
    return ({k: float(v) for k, v in metrics.items()},
            {k: hi[k].double() + lo[k].double() for k in hi})


def _port_step(student, teacher, batch, s_vars, dtype, loss_cfg=KD_LOSS):
    """A copy of the student after one SGD step of ``loss_cfg`` in
    ``dtype`` beside a copy of the teacher: (loss terms, gradients,
    parameters after the step)."""
    student = copy.deepcopy(student).to(dtype)
    teacher = copy.deepcopy(teacher).to(dtype).eval()
    student.load_state_dict(from_jax_params(s_vars, LAYER_NUMS), strict=True)
    step = train_kd.make_kd_train_step(
        student, teacher, build_loss(loss_cfg),
        make_anchor_spec(ANCHOR_ARGS, TARGETS),
        torch.optim.SGD(student.parameters(), lr=SGD_LR), device="cpu")
    terms = step(batch)
    return ({k: float(v) for k, v in terms.items()},
            {k: p.grad.detach().double() for k, p in
             student.named_parameters()},
            {k: p.detach().double() for k, p in student.named_parameters()})


def test_kd_train_step_matches_jax(monkeypatch):
    """The JAX step is the reference in float64, where rounding lies far
    below the bound: the port's float64 gradient of the student within
    1e-7 of each tensor's largest value (plus 1e-12 for the conv biases
    before a batch norm, whose gradient is 0 in exact arithmetic) of the
    JAX step's float64 gradient. Without the KD
    term the gradient moves by more than 1e3 times that bound, so a
    missing or detached KD gradient fails here. In float32, the loss terms
    within 1e-5 of the JAX float32 step's, and the parameters after one SGD
    step within tests/test_torch_train.py's bounds (rtol 2e-4, atol 2e-6)
    of the float64 step's. The JAX float32 step lies farther than those
    bounds from its own float64 step at this size (ROADMAP item 2), so its
    float32 parameters are not the reference."""
    batch = _kd_batch()
    _, t_vars, _, teacher = _seeded("point_pillar_disconet_teacher", batch, 1)
    # a teacher whose map is 4 times as large: the KL (1.1e-3, not 5e-4)
    # is less a difference of two close distributions, whose rounding
    # reaches 1e-5 of it
    t_vars["params"]["shrink"]["Conv_1"]["kernel"] *= 4.0
    teacher.load_state_dict(from_jax_params(t_vars, LAYER_NUMS), strict=True)
    jteacher = jax_build_model({"core_method":
                                "point_pillar_disconet_teacher",
                                "args": ARGS})
    jstudent, s_vars, jbatch, student = _seeded("point_pillar_disconet",
                                                batch, 8)
    state = TrainState.create(apply_fn=jstudent.apply,
                              params=s_vars["params"],
                              batch_stats=s_vars["batch_stats"],
                              tx=_recording_sgd(SGD_LR))
    jspec = JANC.make_anchor_spec(ANCHOR_ARGS, TARGETS)
    new, metrics = jax_kd_step(jstudent, jteacher, t_vars,
                               jax_build_loss(KD_LOSS), jspec)(state, jbatch)
    jax_grads32 = from_jax_params({"params": jax.tree_util.tree_map(
        np.asarray, new.opt_state)}, LAYER_NUMS)
    metrics64, want_grads = _jax_kd_grads_float64(
        monkeypatch, jstudent, jteacher, s_vars, t_vars, batch)

    terms64, grads64, exact = _port_step(student, teacher, batch, s_vars,
                                         torch.float64)
    assert set(want_grads) == set(grads64) == {
        k for k, _ in student.named_parameters()}
    for key, want in metrics64.items():
        np.testing.assert_allclose(terms64[key], want, rtol=1e-9,
                                   err_msg=key)
    no_kd = {**KD_LOSS, "args": {**KD_LOSS["args"], "kd": {"weight": 0.0}}}
    _, grads_no_kd, _ = _port_step(student, teacher, batch, s_vars,
                                   torch.float64, no_kd)
    kd_share = worst = 0.0
    for key, want in want_grads.items():
        scale = float(want.abs().max())
        bound = 1e-7 * scale + 1e-12
        err = float((grads64[key] - want).abs().max())
        assert err <= bound, (key, err, scale)
        worst = max(worst, err / bound)
        kd_share = max(kd_share, float(
            (grads_no_kd[key] - grads64[key]).abs().max()) / bound)
    assert kd_share > 1e3, kd_share
    print(f"float64 gradient: worst {worst:.3g} of the bound; the KD "
          f"term's own {kd_share:.3g} times it")

    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    step = train_kd.make_kd_train_step(
        student, teacher, build_loss(KD_LOSS),
        make_anchor_spec(ANCHOR_ARGS, TARGETS),
        torch.optim.SGD(student.parameters(), lr=SGD_LR), device="cpu")
    terms = step(batch)
    assert student.training and not teacher.training
    assert set(terms) == set(metrics) == set(metrics64) >= {"kd_loss"}
    for key in metrics:
        np.testing.assert_allclose(float(terms[key]), float(metrics[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(terms["kd_loss"]) > 1e-3
    state = student.state_dict()
    for key, ref in exact.items():
        np.testing.assert_allclose(state[key].double().numpy(), ref.numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=key)
    for key, value in teacher.state_dict().items():
        assert torch.equal(value, t_before[key]), key
    assert all(p.grad is None for p in teacher.parameters())
    # reported, not held: each float32 gradient's distance from the JAX
    # float64 one, over each tensor's largest (the zero-gradient biases
    # left out)
    off = {name: max(float((g[k].double() - w).abs().max()) / float(
        w.abs().max()) for k, w in want_grads.items()
        if float(w.abs().max()) > 1e-12)
        for name, g in (("JAX", jax_grads32), ("port", {
            k: p.grad for k, p in student.named_parameters()}))}
    print("float32 gradients from the float64 one: " + ", ".join(
        f"{name} {v:.3g}" for name, v in off.items()))


def _write_cfg(tmp_path, model_args):
    root = write_opv2v_fixture(str(tmp_path / "opv2v"),
                               SyntheticScenes(**SCENES),
                               frames_per_scenario=2)
    path = str(tmp_path / "kd.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(_kd_cfg(root, model_args), f)
    return path


def test_kd_cli_trains_from_a_seeded_teacher(tmp_path, capsys):
    path = _write_cfg(tmp_path, ARGS)
    model_dir = str(tmp_path / "kd_run")
    student, history = train_kd.main(["-y", path, "--model_dir", model_dir,
                                       "--epochs", "2", "--device", "cpu"])
    assert len(history) == 2 and np.isfinite(history[-1]["total_loss"])
    assert history[-1]["kd_loss"] > 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["epoch"] for x in lines] == [0, 1]
    assert sorted(os.listdir(model_dir)) == ["config.yaml", "net_epoch2.pth"]
    # the checkpoint loads strictly into the yaml's model
    load_pth(build_model({"core_method": "point_pillar_disconet",
                          "args": ARGS}, device="cpu"),
             os.path.join(model_dir, "net_epoch2.pth"))
    if not torch.cuda.is_available():      # CUDA unless the CPU is named
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_kd.main(["-y", path, "--model_dir", model_dir])


def test_kd_cli_with_the_reference_teacher(tmp_path, capsys):
    """tests/test_kd.py::test_train_kd_cli_reference_torch_teacher in the
    port: point_pillar_base.pth, a reference point_pillar checkpoint, is the
    frozen teacher, loaded strictly with the reference's pad semantics."""
    args64 = {**ARGS,
              "pillar_vfe": {**ARGS["pillar_vfe"], "num_filters": [64]},
              "point_pillar_scatter": {"num_features": 64},
              "dir_args": {"dir_offset": 0.7853, "num_bins": 2,
                           "anchor_yaw": [0, 90]}}
    teacher_dir = tmp_path / "ref_teacher"
    teacher_dir.mkdir()
    shutil.copy(os.path.join(GOLDEN, "point_pillar_base.pth"),
                teacher_dir / "net_epoch1.pth")
    teacher, found = train_kd.load_teacher(args64, str(teacher_dir), "cpu")
    assert found.endswith("net_epoch1.pth")
    assert teacher.pillar_vfe.pad_parity
    ref = torch.load(os.path.join(GOLDEN, "point_pillar_base.pth"),
                     map_location="cpu", weights_only=True)
    for key, value in teacher.state_dict().items():
        assert torch.equal(value, ref[key]), key
    path = _write_cfg(tmp_path, args64)
    _, history = train_kd.main(["-y", path, "--model_dir",
                                str(tmp_path / "run"), "--epochs", "1",
                                "--teacher_dir", str(teacher_dir),
                                "--device", "cpu"])
    assert history and np.isfinite(history[-1]["total_loss"])
    assert "imported_reference_teacher" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="from_jax_params"):
        train_kd.load_teacher(args64, str(tmp_path / "opv2v"), "cpu")
