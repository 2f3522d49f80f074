"""The port's data parallelism (parallel/distributed.py, parallel/mesh.py,
the global sums of models/layers._masked_moments and loss/, the
data-parallel train step and cmd_train) at 2 gloo ranks on the CPU.

The worker processes start as tests/test_multihost.py starts its own, through
chip_smoke.launch and chip_smoke.wait (a free local port, each rank's output
in a file, every rank killed past its time limit); one group of 2 runs every
in-process check, while the parent computes the single-process references.
The workers sum over the group only inside a global_sums block, as the
data-parallel step does.

Bounds:
  * detect_env equals the JAX package's under each environment case;
  * init_distributed_mode, get_dist_info and an all-reduce at 2 ranks (the
    counterpart of test_two_process_psum): exact; global_sum is the
    identity outside a global_sums block while the group is open;
  * _masked_moments at 2 ranks, one of them with no valid row, equals the
    whole batch's, and so does its gradient (float64, 1e-10);
  * every loss of loss/ at 2 ranks on halves of a random batch: the whole
    batch's value and its gradient with respect to the inputs (float64,
    1e-10). A rank's gradient is the world times its slice of the whole
    batch's: its backward sums every rank's copy of the global loss, which
    the train step's mean divides out (train.py's docstring);
  * the tiny flagship's and pixor_intermediate's data-parallel steps
    (B = 2, the yamls' losses and AdamW, float64) leave the parameters and
    running statistics of the single-process step on the whole batch
    within 1e-10, the same on both ranks; their loss within rtol 1e-4 of
    coalign_tpu.train.make_train_step's (float32) on the same weights, the
    JAX mesh test's bound
    (tests/test_end2end.py::test_train_step_runs_on_mesh);
  * ``run train`` under WORLD_SIZE=2 on a fixture tree writes one
    net_epoch1.pth, from rank 0 alone, within 1e-5 of the single-process
    run's (float32; the run's AdamW takes eps 1e-3, so that a gradient
    within rounding of 0 cannot flip a parameter by 2 lr);
  * WORLD_SIZE=2 with an address the process cannot open raises, and
    nothing trains as one process.
"""

import os
import socket
import sys

import numpy as np
import pytest
import torch
import yaml

from coalign_tpu_torch.loss import build_loss
from coalign_tpu_torch.models.layers import _masked_moments
from coalign_tpu_torch.parallel import distributed as D

from chip_smoke import launch, wait

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2

WORKER = r"""
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from coalign_tpu_torch.loss import build_loss
from coalign_tpu_torch.models.layers import _masked_moments
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.parallel import (get_dist_info, init_distributed_mode,
                                        make_mesh, replicate, shard_batch)
from coalign_tpu_torch.parallel.distributed import global_sum, global_sums
from coalign_tpu_torch.train import build_optimizer, make_train_step

job = torch.load(sys.argv[1], weights_only=False)
info = init_distributed_mode(device="cpu")
rank, world = get_dist_info()
mesh = make_mesh()
t = torch.tensor([rank + 1.0])
dist.all_reduce(t)
out = {"info": info, "dist_info": (rank, world), "psum": float(t),
       "outside": float(global_sum(torch.tensor([rank + 1.0])))}


def leaf(v, grad):
    return v.clone().requires_grad_(grad) if torch.is_tensor(v) else v


for case, (x, mask, cdim, c1, c2) in job["moments"].items():
    xs = shard_batch({"x": x}, mesh)["x"].clone().requires_grad_()
    ms = None if mask is None else shard_batch({"m": mask}, mesh)["m"]
    with global_sums(mesh):
        mean, var = _masked_moments(xs, ms, cdim)
    ((mean * c1).sum() + (var * c2).sum()).backward()
    out[("moments", case)] = (mean.detach(), var.detach(), xs.grad)

for name, (cfg, outputs, labels, grads, kwargs) in job["losses"].items():
    outs = {k: leaf(v, k in grads)
            for k, v in shard_batch(outputs, mesh).items()}
    with global_sums(mesh):
        total, terms = build_loss(cfg)(outs, shard_batch(labels, mesh),
                                       **shard_batch(kwargs, mesh))
    total.backward()
    out[("loss", name)] = ({k: float(v.detach()) for k, v in terms.items()},
                           {k: outs[k].grad for k in grads})

for name, spec in job["steps"].items():
    model = build_model(spec["cfg"], device="cpu")
    model.load_state_dict(spec["state"], strict=True)
    if rank:
        # replicate must give every rank rank 0's weights
        for p in model.parameters():
            p.data.add_(1.0)
    replicate(model.double(), mesh)
    opt = build_optimizer(model.parameters(), spec["opt"])[0]
    step = make_train_step(model, build_loss(spec["loss"]), spec["spec"],
                           opt, device="cpu", mesh=mesh)
    terms = step(shard_batch(spec["batch"], mesh))
    out[("step", name)] = ({k: float(v) for k, v in terms.items()},
                           model.state_dict())
torch.save(out, f"{job['out']}.{rank}")
dist.destroy_process_group()
print(f"RANK{rank} OK")
"""

# --------------------------------------------------------------- the cases

PP_ARGS = {"pos_cls_weight": 2.0,
           "cls": {"alpha": 0.25, "gamma": 2.0, "weight": 2.0},
           "reg": {"sigma": 3.0, "weight": 2.0},
           "dir": {"weight": 0.2, "args": {"dir_offset": 0.7853,
                                           "num_bins": 2,
                                           "anchor_yaw": [0, 90]}}}
B, L, A, H, W = 4, 2, 2, 6, 5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _anchor_maps(rng, b=B, suffix=""):
    pos = rng.random((b, H, W, A)) < 0.15
    neg = ~pos & (rng.random((b, H, W, A)) < 0.7)
    outputs = {f"cls_preds{suffix}": _t(rng.normal(0, 1, (b, A, H, W))),
               f"reg_preds{suffix}": _t(rng.normal(0, 1, (b, 7 * A, H, W))),
               f"dir_preds{suffix}": _t(rng.normal(0, 1, (b, 2 * A, H, W)))}
    labels = {f"pos_equal_one{suffix}": _t(pos), f"neg_equal_one{suffix}":
              _t(neg), f"targets{suffix}": _t(rng.normal(0, 1,
                                                         (b, H, W, 7 * A)))}
    return outputs, labels


def _loss_cases():
    """{name: (loss cfg, outputs, labels, keys with a gradient, kwargs)} of
    every loss class of loss/, B = 4 samples (B * L rows for the
    per-agent ones)."""
    rng = np.random.default_rng(17)
    cases = {}
    out, lab = _anchor_maps(rng)
    maps = list(out)
    cases["point_pillar"] = ({"core_method": "point_pillar_loss",
                              "args": PP_ARGS}, out, lab, maps, {})
    cases["point_pillar_sample_mask"] = (
        {"core_method": "point_pillar_loss", "args": PP_ARGS}, out, lab,
        maps, {"sample_mask": torch.tensor([True, False, True, False])})
    unc = dict(out, unc_preds=_t(rng.normal(0, 1, (B, 3 * A, H, W))))
    cases["uncertainty"] = ({"core_method": "point_pillar_uncertainty_loss",
                             "args": dict(PP_ARGS, uncertainty={"dim": 3})},
                            unc, lab, maps + ["unc_preds"], {})
    kd = dict(out, feature=_t(rng.normal(0, 1, (B, 8, H, W))),
              teacher_feature=_t(rng.normal(0, 1, (B, 8, H, W))),
              teacher_reg_preds=_t(rng.normal(0, 1, (B, 7 * A, H, W))),
              teacher_cls_preds=_t(rng.normal(0, 1, (B, A, H, W))))
    cases["disconet"] = ({"core_method": "disconet_loss", "args": dict(
        PP_ARGS, kd={"weight": 0.5, "decoder_kd": True})}, kd, lab,
        maps + ["feature"], {})
    robust = dict(out, pose_corr=_t(rng.normal(0, 1, (B, L, L, 3))),
                  pose_corr_target=_t(rng.normal(0, 1, (B, L, L, 3))),
                  agent_scores=_t(rng.uniform(0.05, 0.95, (B, L, L))))
    cases["robust"] = ({"core_method": "robust_loss", "args": dict(
        PP_ARGS, robust={"stage": 1})}, robust, lab,
        maps + ["pose_corr", "agent_scores"], {})
    mash = dict(out, corr_vol=_t(rng.normal(0, 2, (B, L, 5, 6))))
    cases["mash"] = ({"core_method": "mash_loss", "args": PP_ARGS}, mash,
                     lab, maps + ["corr_vol"], {})
    cases["voxelnet"] = ({"core_method": "voxelnet_loss", "args": {}},
                         {k: out[k] for k in ("cls_preds", "reg_preds")},
                         lab, ["cls_preds", "reg_preds"], {})
    label_map = rng.normal(0, 1, (B, H, W, 7))
    label_map[..., 0] = rng.random((B, H, W)) < 0.2
    cases["pixor"] = ({"core_method": "pixor_loss", "args": {}},
                      {"cls_map": _t(rng.normal(0, 1, (B, 1, H, W))),
                       "reg_map": _t(rng.normal(0, 1, (B, 6, H, W)))},
                      {"label_map": _t(label_map)}, ["cls_map", "reg_map"],
                      {})
    cam = dict(out, depth_logits=_t(rng.normal(0, 1, (B * L, 2, 48, 2, 3))))
    depth = rng.uniform(0, 70, (B * L, 2, 16, 24))
    depth[:4] = 80.0                 # the first 2 samples: nothing in range
    cases["camera"] = ({"core_method": "camera_loss", "args": dict(
        PP_ARGS, depth={"weight": 0.7})}, cam, dict(lab, depth_map=_t(depth)),
        maps + ["depth_logits"], {})
    single, single_lab = _anchor_maps(rng, B * L, "_single")
    gt = np.zeros((B, 4, 7))
    gt[..., :3] = rng.uniform(-5, 5, (B, 4, 3))
    gt[..., 3:6] = rng.uniform(1.5, 4, (B, 4, 3))
    gt[..., 6] = rng.uniform(-3, 3, (B, 4))
    gt_mask = rng.random((B, 4)) < 0.8
    rois = np.repeat(gt, 2, axis=1) + rng.normal(0, 0.3, (B, 8, 7))
    fpv = dict(single, rois=_t(rois), roi_mask=torch.from_numpy(
        rng.random((B, 8)) < 0.85), roi_cls=_t(rng.normal(0, 1, (B, 8))),
        boxes_refined=_t(rois + rng.normal(0, 0.2, (B, 8, 7))))
    cases["fpvrcnn"] = ({"core_method": "fpvrcnn_loss", "args": PP_ARGS},
                        fpv, dict(single_lab, gt_boxes=_t(gt),
                                  gt_mask=torch.from_numpy(gt_mask)),
                        list(single) + ["roi_cls", "boxes_refined"], {})
    return cases


def _moment_cases():
    """(x, mask, channel dim, c1, c2): channel-last rows whose second half
    (rank 1's) has no valid row; NCHW maps with an agent mask; no mask."""
    rng = np.random.default_rng(18)
    rows = _t(rng.normal(0, 2, (8, 3)))
    row_mask = torch.tensor([1, 0, 1, 1, 0, 0, 0, 0], dtype=torch.bool)
    maps = _t(rng.normal(1, 1, (4, 3, 5, 6)))
    c = (_t(rng.normal(0, 1, (1, 3))), _t(rng.normal(0, 1, (1, 3))))
    c4 = tuple(t.reshape(1, 3, 1, 1) for t in c)
    return {"rows": (rows, row_mask, -1) + c,
            "maps": (maps, torch.tensor([True, True, False, True])[
                :, None, None], 1) + c4,
            "unmasked": (maps, None, 1) + c4}


def _whole_loss(case):
    cfg, outputs, labels, grads, kwargs = case
    outs = {k: v.clone().requires_grad_(k in grads) if torch.is_tensor(v)
            else v for k, v in outputs.items()}
    total, terms = build_loss(cfg)(outs, labels, **kwargs)
    total.backward()
    return {k: float(v.detach()) for k, v in terms.items()}, \
        {k: outs[k].grad for k in grads}


def _halves(t, rank):
    k = len(t) // WORLD
    return t[rank * k:(rank + 1) * k]


def _step_cases():
    """The tiny flagship (tests/test_torch_train.py's batch, weights and
    loss) and pixor_intermediate (tests/test_torch_pixor.py's), each with
    its JAX model and variables for the float32 JAX step."""
    from coalign_tpu_torch.config.yaml_utils import load_yaml
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec

    import test_torch_pixor as TPX
    import test_torch_train as TT
    from chip_smoke import HYPES
    from test_end2end import ANCHOR_ARGS, LOSS_ARGS

    import jax
    from conftest import jit_init
    from coalign_tpu.models import build_model as jax_build_model
    from coalign_tpu.postprocess import anchors as JANC
    from coalign_tpu_torch.utils.weights import from_jax_params

    flagship = TT._flagship(False)
    batch = TT._train_batch()
    jmodel = jax_build_model(flagship)
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    variables = TT._randomize_norms(jax.tree_util.tree_map(
        np.asarray, jit_init(jmodel, jax.random.PRNGKey(TT.WEIGHTS_KEY),
                             jbatch, train=False)), np.random.default_rng(8))
    coalign = load_yaml(os.path.join(HYPES, "pointpillar_coalign.yaml"))
    pixor = load_yaml(os.path.join(HYPES, "pixor_intermediate.yaml"))
    pbatch = TPX._batch()
    pj, pvars, _, pmodel = TPX._pair("pixor_intermediate", pbatch, key=2)
    return {
        "flagship": {
            "cfg": flagship, "batch": batch, "loss": LOSS_ARGS,
            "opt": coalign["optimizer"],
            "state": from_jax_params(variables, TT._layer_nums(flagship)),
            "spec": make_anchor_spec(ANCHOR_ARGS, TT.TARGET_ARGS),
            "jax": (jmodel, variables,
                    JANC.make_anchor_spec(ANCHOR_ARGS, TT.TARGET_ARGS))},
        "pixor_intermediate": {
            "cfg": TPX._cfg("pixor_intermediate"), "batch": pbatch,
            "loss": pixor["loss"], "opt": pixor["optimizer"],
            "state": pmodel.state_dict(), "spec": TPX.DSPEC,
            "jax": (pj, pvars, TPX.JDSPEC)}}


def _jax_loss(jmodel, variables, jspec, loss_cfg, batch) -> float:
    import jax
    import optax

    from coalign_tpu.loss import build_loss as jax_build_loss
    from coalign_tpu.train import TrainState
    from coalign_tpu.train import make_train_step as jax_make_train_step

    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=optax.sgd(1e-3))
    _, metrics = jax_make_train_step(jmodel, jax_build_loss(loss_cfg), jspec,
                                     donate=False)(
        state, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    return float(metrics["total_loss"])


def _single_step(spec):
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.train import build_optimizer, make_train_step

    model = build_model(spec["cfg"], device="cpu")
    model.load_state_dict(spec["state"], strict=True)
    model.double()
    opt = build_optimizer(model.parameters(), spec["opt"])[0]
    terms = make_train_step(model, build_loss(spec["loss"]), spec["spec"],
                            opt, device="cpu")(spec["batch"])
    return {k: float(v) for k, v in terms.items()}, model.state_dict()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    steps = _step_cases()
    job = {"moments": _moment_cases(), "losses": _loss_cases(),
           "steps": {k: {f: v for f, v in s.items() if f != "jax"}
                     for k, s in steps.items()},
           "out": str(work / "out")}
    torch.save(job, str(work / "job.pt"))
    ranks = launch(WORLD, [sys.executable, "-c", WORKER,
                           str(work / "job.pt")], str(work / "logs"),
                   env={"PYTHONPATH": os.pathsep.join([REPO] + sys.path),
                        "OMP_NUM_THREADS": "1"})
    try:
        # the single-process references, while the workers run
        refs = {"losses": {k: _whole_loss(c)
                           for k, c in job["losses"].items()},
                "steps": {k: _single_step(s) for k, s in steps.items()},
                "jax": {k: _jax_loss(*s["jax"], s["loss"], s["batch"])
                        for k, s in steps.items()}}
    finally:
        results = wait(ranks, timeout_s=240)
    for rank, (code, out) in enumerate(results):
        assert code == 0, f"rank {rank} failed ({code}):\n{out[-3000:]}"
        assert f"RANK{rank} OK" in out
    outs = [torch.load(f"{job['out']}.{r}", weights_only=False)
            for r in range(WORLD)]
    return {"job": job, "outs": outs, "refs": refs}


# ------------------------------------------------------------------- tests


ENV_CASES = {
    "none": {},
    "torchrun": {"RANK": "1", "WORLD_SIZE": "4", "MASTER_ADDR": "10.0.0.2",
                 "MASTER_PORT": "29500"},
    "rank_defaults": {"RANK": "0", "WORLD_SIZE": "2"},
    "slurm": {"SLURM_PROCID": "3", "SLURM_NTASKS": "8"},
    "slurm_one_task": {"SLURM_PROCID": "0"},
    "coordinator": {"RANK": "2", "WORLD_SIZE": "3",
                    "COORDINATOR_ADDRESS": "host:1234",
                    "MASTER_ADDR": "ignored"},
    "rank_without_world": {"RANK": "1"},
}


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_detect_env_matches_jax(case, monkeypatch):
    from coalign_tpu.parallel.distributed import detect_env as jax_detect

    for var in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS",
                "COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    for var, value in ENV_CASES[case].items():
        monkeypatch.setenv(var, value)
    assert D.detect_env() == jax_detect()
    if case == "none":
        assert D.init_distributed_mode() == {
            "rank": 0, "world_size": 1, "distributed": False}
        assert D.get_dist_info() == (0, 1) and D.summing_mesh() is None


def test_two_process_init_and_all_reduce(group):
    for rank, out in enumerate(group["outs"]):
        assert out["info"] == {"rank": rank, "world_size": 2,
                               "distributed": True}
        assert out["dist_info"] == (rank, 2)
        assert out["psum"] == 3.0
        assert out["outside"] == rank + 1.0


@pytest.mark.parametrize("case", ["rows", "maps", "unmasked"])
def test_masked_moments_are_the_whole_batch(case, group):
    x, mask, cdim, c1, c2 = group["job"]["moments"][case]
    xw = x.clone().requires_grad_()
    mean, var = _masked_moments(xw, mask, cdim)
    ((mean * c1).sum() + (var * c2).sum()).backward()
    if case == "rows":
        assert not mask[4:].any()           # rank 1 has no valid row
    for rank, out in enumerate(group["outs"]):
        got_mean, got_var, got_grad = out[("moments", case)]
        np.testing.assert_allclose(got_mean, mean.detach(), rtol=1e-10)
        np.testing.assert_allclose(got_var, var.detach(), rtol=1e-10)
        np.testing.assert_allclose(got_grad / WORLD, _halves(xw.grad, rank),
                                   rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("name", sorted(_loss_cases()))
def test_loss_at_two_ranks_is_the_whole_batch_loss(name, group):
    want_terms, want_grads = group["refs"]["losses"][name]
    assert want_terms["total_loss"] != 0
    for rank, out in enumerate(group["outs"]):
        terms, grads = out[("loss", name)]
        assert set(terms) == set(want_terms)
        for key, want in want_terms.items():
            np.testing.assert_allclose(terms[key], want, rtol=1e-10,
                                       err_msg=key)
        for key, want in want_grads.items():
            assert want.abs().max() > 0, key
            np.testing.assert_allclose(grads[key] / WORLD, _halves(
                want, rank), rtol=1e-10, atol=1e-14, err_msg=key)


@pytest.mark.parametrize("name", ["flagship", "pixor_intermediate"])
def test_data_parallel_step_is_the_single_process_step(name, group):
    want_terms, want_state = group["refs"]["steps"][name]
    init = group["job"]["steps"][name]["state"]
    moved = 0
    for out in group["outs"]:
        terms, state = out[("step", name)]
        assert set(state) == set(want_state)
        for key, want in want_terms.items():
            np.testing.assert_allclose(terms[key], want, rtol=1e-10,
                                       err_msg=key)
        for key, want in want_state.items():
            np.testing.assert_allclose(state[key].double(), want.double(),
                                       rtol=1e-10, atol=1e-10, err_msg=key)
            moved += not torch.equal(want.float(), init[key].float())
    stats = [k for k in want_state if k.endswith("running_var")]
    assert stats and moved >= len(want_state)
    np.testing.assert_allclose(want_terms["total_loss"],
                               group["refs"]["jax"][name], rtol=1e-4)


def _cli_yaml(tmp_path, tree, batch_size=2):
    from chip_smoke import LATE_RANGE, hypes_at

    params = hypes_at("pointpillar_coalign", tree, LATE_RANGE)
    params.pop("box_align", None)
    params["noise_setting"] = {"add_noise": False}
    params["train_params"].update(batch_size=batch_size, epoches=1,
                                  max_cav=2, eval_freq=1)
    params["optimizer"]["args"]["eps"] = 1e-3
    # one block a stage: the yaml's path at a third of its CPU time
    params["model"]["args"]["base_bev_backbone"]["layer_nums"] = [1, 1, 1]
    path = str(tmp_path / "dp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(params, f)
    return path


def _tree(tmp_path):
    from chip_smoke import LATE_RANGE
    from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
    from coalign_tpu_torch.data.synthetic import SyntheticScenes

    scenes = SyntheticScenes(num_frames=2, num_agents=2, num_objects=3,
                             lidar_range=LATE_RANGE, points_per_object=32,
                             ground_points=64, seed=3)
    return write_opv2v_fixture(str(tmp_path / "opv2v"), scenes,
                               frames_per_scenario=2)


def test_run_train_at_two_ranks_writes_the_single_process_checkpoint(
        tmp_path):
    from coalign_tpu_torch.tools import run

    cfg = _cli_yaml(tmp_path, _tree(tmp_path))
    dp_dir = str(tmp_path / "dp")
    args = ["--epochs", "1", "--eval_frames", "1", "--device", "cpu"]
    # the CLI's main with tensorflow hidden: TensorBoard's writer then
    # takes its own stub instead of importing tensorflow (~15 s here)
    main = ("import sys; sys.modules['tensorflow'] = None; "
            "from coalign_tpu_torch.tools.run import main; main()")
    ranks = launch(WORLD, [sys.executable, "-c", main, "train", "-y", cfg,
                           "--model_dir", dp_dir] + args,
                   str(tmp_path / "logs"),
                   env={"PYTHONPATH": os.pathsep.join([REPO] + sys.path),
                        "OMP_NUM_THREADS": "1"})
    try:
        one_dir = str(tmp_path / "one")
        with pytest.MonkeyPatch.context() as patch:
            patch.setitem(sys.modules, "tensorflow", None)
            run.main(["train", "-y", cfg, "--model_dir", one_dir] + args)
    finally:
        results = wait(ranks, timeout_s=240)
    for rank, (code, out) in enumerate(results):
        assert code == 0, f"rank {rank} failed ({code}):\n{out[-3000:]}"
    saved = [out.count('"saved"') for _, out in results]
    assert saved == [1, 0]                       # rank 0 alone writes
    assert sum('"eval"' in out for _, out in results) == 1
    assert sum('"val_loss"' in out for _, out in results) == 1
    ckpts = sorted(f for f in os.listdir(dp_dir) if f.endswith(".pth"))
    assert ckpts == sorted(f for f in os.listdir(one_dir)
                           if f.endswith(".pth"))
    assert "net_epoch1.pth" in ckpts
    got = torch.load(os.path.join(dp_dir, "net_epoch1.pth"))
    want = torch.load(os.path.join(one_dir, "net_epoch1.pth"))
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].double(), value.double(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_failed_init_raises_and_trains_nothing(tmp_path, monkeypatch):
    from coalign_tpu_torch.tools import run

    cfg = _cli_yaml(tmp_path, _tree(tmp_path))
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen(1)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(busy.getsockname()[1]))
    model_dir = str(tmp_path / "run")
    try:
        with pytest.raises(Exception, match="address already in use"):
            run.main(["train", "-y", cfg, "--model_dir", model_dir,
                      "--epochs", "1", "--device", "cpu"])
    finally:
        busy.close()
    assert not os.path.exists(model_dir)
    assert not torch.distributed.is_initialized()
