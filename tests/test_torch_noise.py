"""Pose noise and the noise sweep in the port (coalign_tpu_torch/utils/
pose_noise.py, tools/noise_sweep.py) against the JAX package's, on the CPU.

  * pose noise: a torch.Generator cannot repeat jax.random's draws, so the
    samplers are held to each other's statistics: per kind (gaussian,
    laplace, von_mises), the mean and standard deviation of 200,000 draws
    of x, y and yaw within 2% of the JAX sampler's (the standard error of
    either is below 0.3% at this count); zero standard deviations return
    the input; masked agents keep their poses; z, roll and pitch stay
    clean; a seed repeats its draws;
  * noise_sweep: the AP of each level equals the JAX noise_sweep's on the
    same batcher factory, without and with the stage-1 correction. The
    fusion model is the narrow intermediate-fusion flagship of
    tests/test_torch_late.py's size after 40 JAX steps, so that real boxes
    come out (AP30 > 0.05 without noise); the stage-1 detections are
    oracle boxes (the ego-frame gt in each agent's clean frame), the same
    in both packages, so that the pose graph has landmarks to solve on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coalign_tpu.data import batch as JBATCH
from coalign_tpu.data import SyntheticScenes as JaxScenes
from coalign_tpu.loss import build_loss as jax_build_loss
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.posegraph import BoxAlignConfig as JaxAlignConfig
from coalign_tpu.postprocess import anchors as JANC
from coalign_tpu.tools.noise_sweep import noise_sweep as jax_noise_sweep
from coalign_tpu.train import build_optimizer as jax_build_optimizer
from coalign_tpu.train import create_train_state
from coalign_tpu.train import make_train_step as jax_make_train_step
from coalign_tpu.utils import pose_noise as JN
from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.posegraph import BoxAlignConfig
from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
from coalign_tpu_torch.tools.noise_sweep import NOISE_LEVELS, noise_sweep
from coalign_tpu_torch.utils import pose_noise as TN
from coalign_tpu_torch.utils.transforms import x1_to_x2_tfm
from coalign_tpu_torch.utils.weights import from_jax_params

from test_torch_late import (ANCHOR_ARGS, ARGS, LAYER_NUMS, LOSS, POST,
                             SCENES, TARGETS)

torch.set_num_threads(1)

KINDS = ("gaussian", "laplace", "von_mises")
STATS = dict(pos_std=0.2, rot_std=2.0, pos_mean=0.5, rot_mean=1.0)


# ------------------------------------------------------------ pose noise


@pytest.mark.parametrize("kind", KINDS)
def test_noise_statistics_match_jax(kind):
    n = 200_000
    got = TN.generate_pose_noise(torch.Generator().manual_seed(0), (n,),
                                 kind=kind, **STATS).numpy()
    want = np.asarray(JN.generate_pose_noise(jax.random.PRNGKey(0), (n,),
                                             kind=kind, **STATS))
    assert got.shape == want.shape == (n, 6) and got.dtype == np.float32
    for col, name in ((0, "x"), (1, "y"), (4, "yaw")):
        for stat in (np.mean, np.std):
            np.testing.assert_allclose(
                stat(got[:, col]), stat(want[:, col]), rtol=0.02,
                err_msg=f"{kind} {name} {stat.__name__}")
    # the distributions' own parameters: std of x is pos_std for a normal,
    # sqrt(2) pos_std for a Laplace; the yaw's is rot_std degrees either way
    # for a normal and the narrow von Mises, sqrt(2) rot_std for a Laplace
    scale = np.sqrt(2.0) if kind == "laplace" else 1.0
    np.testing.assert_allclose(got[:, 0].std(), scale * 0.2, rtol=0.02)
    np.testing.assert_allclose(got[:, 4].std(), scale * 2.0, rtol=0.02)


@pytest.mark.parametrize("kind", KINDS)
def test_noise_leaves_z_roll_pitch_clean_and_repeats_by_seed(kind):
    draw = [TN.generate_pose_noise(torch.Generator().manual_seed(seed),
                                   (3, 5), 0.4, 3.0, kind=kind)
            for seed in (7, 7, 8)]
    assert draw[0].shape == (3, 5, 6)
    assert (draw[0][..., [2, 3, 5]] == 0).all()
    assert (draw[0][..., [0, 1, 4]] != 0).all()
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])


def test_add_pose_noise_zero_std_and_mask():
    rng = np.random.default_rng(1)
    poses = torch.from_numpy(rng.normal(0, 20, (2, 4, 6)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    assert TN.add_pose_noise(gen, poses, pos_std=0.0, rot_std=0.0) is poses
    want = JN.add_pose_noise(jax.random.PRNGKey(0), jnp.asarray(poses),
                             pos_std=0.0, rot_std=0.0)
    np.testing.assert_array_equal(np.asarray(want), poses.numpy())
    mask = torch.tensor([[True, True, False, True], [True, False, False,
                                                     False]])
    for kind in KINDS:
        noisy = TN.add_pose_noise(gen, poses, mask, 0.3, 2.0, kind=kind)
        assert torch.equal(noisy[~mask], poses[~mask]), kind
        moved = noisy[mask] - poses[mask]
        assert (moved[:, [0, 1, 4]] != 0).all(), kind
        assert (moved[:, [2, 3, 5]] == 0).all(), kind
        # the JAX package's rule, on its own draws
        jnoisy = np.asarray(JN.add_pose_noise(
            jax.random.PRNGKey(1), jnp.asarray(poses), jnp.asarray(mask),
            0.3, 2.0, kind=kind))
        np.testing.assert_array_equal(jnoisy[~mask.numpy()],
                                      poses.numpy()[~mask.numpy()])
    with pytest.raises(ValueError, match="unknown noise kind"):
        TN.generate_pose_noise(gen, (2,), 0.1, 0.1, kind="uniform")


# ------------------------------------------------------------ noise sweep


FLAGSHIP = {"core_method": "point_pillar_baseline_multiscale",
            "args": {**ARGS, "fusion_method": "att",
                     "att": {"feat_dim": [16, 32]}}}
# 2-agent frames in 2 slots: no padded agent
SWEEP_BATCHER = dict(max_cav=2, max_points=600, max_objects=8,
                     lidar_range=ARGS["lidar_range"], seed=303)
LEVELS = (NOISE_LEVELS[0], NOISE_LEVELS[2])          # (0, 0), (0.4, 0.4)


def oracle_from_batch(batch, k: int = 24) -> dict:
    """Oracle stage-1 detections from a batch alone: its first ``k``
    ego-frame gt boxes moved into each agent's clean frame (x, y, yaw in
    radians), log-variance -3."""
    b, l = batch["agent_mask"].shape
    poses = np.zeros((b, l, k, 3), np.float32)
    mask = np.zeros((b, l, k), bool)
    for bi in range(b):
        gt = batch["gt_boxes"][bi][batch["gt_mask"][bi]][:k]
        xyz1 = np.concatenate([gt[:, :3], np.ones((len(gt), 1))], -1)
        clean = batch["lidar_pose_clean"][bi]
        for a in np.flatnonzero(batch["agent_mask"][bi]):
            local = xyz1 @ x1_to_x2_tfm(clean[0], clean[a]).T
            poses[bi, a, :len(gt)] = np.stack(
                [local[:, 0], local[:, 1],
                 gt[:, 6] + np.deg2rad(clean[0, 4] - clean[a, 4])], -1)
            mask[bi, a, :len(gt)] = True
    return {"box_poses": poses, "box_mask": mask,
            "uncertainty": np.full((b, l, k, 3), -3.0, np.float32)}


@pytest.fixture(scope="module")
def flagship():
    """The narrow flagship after 40 JAX Adam steps (lr 3e-3) on a clean
    intermediate batch of the 4 scenes, in both packages."""
    scenes = JaxScenes(**SCENES)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBATCH, "_native", None)
        batch = JBATCH.IntermediateFusionBatcher(**SWEEP_BATCHER).assemble(
            [scenes[i] for i in range(4)])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model(FLAGSHIP)
    state = create_train_state(jmodel, jbatch, jax_build_optimizer(
        {"lr": 3e-3, "args": {}}, None), jax.random.PRNGKey(0))
    step = jax_make_train_step(jmodel, jax_build_loss(LOSS),
                               JANC.make_anchor_spec(ANCHOR_ARGS, TARGETS,
                                                     "hwl"))
    for _ in range(40):
        state, _ = step(state, jbatch)
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})
    model = build_model(FLAGSHIP, device="cpu")
    model.load_state_dict(from_jax_params(variables, LAYER_NUMS),
                          strict=True)
    return {"jmodel": jmodel, "variables": variables, "model": model}


@pytest.mark.parametrize("corrected", [False, True],
                         ids=["noisy", "stage1_corrected"])
def test_noise_sweep_matches_jax(flagship, corrected, monkeypatch):
    monkeypatch.setattr(JBATCH, "_native", None)
    anchors = generate_anchor_box(ANCHOR_ARGS)
    cfg = {"abandon_hard_cases": False}
    calls = []

    def jax_oracle(variables, batch):
        calls.append(1)
        return {k: jnp.asarray(v) for k, v in oracle_from_batch(
            {k: np.asarray(v) for k, v in batch.items()}).items()}

    def oracle(batch):
        return {k: torch.from_numpy(v)
                for k, v in oracle_from_batch(batch).items()}

    want = jax_noise_sweep(
        flagship["jmodel"], flagship["variables"],
        lambda p, r: JBATCH.IntermediateFusionBatcher(
            **SWEEP_BATCHER, pos_std=p, rot_std=r),
        JaxScenes(**SCENES), anchors, POST,
        stage1=jax_oracle if corrected else None,
        align_cfg=JaxAlignConfig(**cfg), levels=LEVELS, batch_size=2)
    got = noise_sweep(
        flagship["model"],
        lambda p, r: IntermediateFusionBatcher(**SWEEP_BATCHER, pos_std=p,
                                               rot_std=r, native=False),
        SyntheticScenes(**SCENES), anchors, POST,
        stage1=oracle if corrected else None,
        align_cfg=BoxAlignConfig(**cfg), levels=LEVELS, batch_size=2,
        device="cpu")
    assert set(got) == set(want) == set(LEVELS)
    assert len(calls) == (2 if corrected else 0)      # noisy level only
    for level in LEVELS:
        assert got[level]["frames"] == 4
        for key in ("ap30", "ap50", "ap70"):
            assert got[level][key] == pytest.approx(want[level][key],
                                                    abs=1e-12), (level, key)
    assert got[LEVELS[0]]["ap30"] > 0.05


def test_noise_sweep_stops_after_max_frames(flagship):
    seen = []

    def factory(p, r):
        batcher = IntermediateFusionBatcher(**SWEEP_BATCHER, pos_std=p,
                                            rot_std=r)
        assemble = batcher.assemble

        def counted(frames):
            seen.append(len(frames))
            return assemble(frames)
        batcher.assemble = counted
        return batcher

    got = noise_sweep(flagship["model"], factory, SyntheticScenes(**SCENES),
                      generate_anchor_box(ANCHOR_ARGS), POST,
                      levels=LEVELS[:1], batch_size=2, max_frames=1,
                      device="cpu")
    assert seen == [2] and got[LEVELS[0]]["frames"] == 2
