"""CoAlign's first pass in the port (coalign_tpu_torch/tools) against the
JAX package's (coalign_tpu/tools) on the CPU, with the tiny uncertainty
model of tests/test_stage1_uncertainty.py and shared weights.

  * make_stage1_fn: the same box_mask; box_poses and uncertainty within
    1e-4 (the two float32 programs agree to ~2e-5 on these weights);
  * correct_batch_poses on the same detections: lidar_pose and
    pairwise_t_matrix within 1e-4;
  * oracle detections recover the clean pairwise transforms (corrected
    error < 0.3 x noisy error, tests/test_stage1_uncertainty.py's bound);
  * the stage-1 json round trip and its truncation;
  * relative_pose_errors and summarize exactly, evaluate_pose_graph's
    "before" exactly and "after" within 1e-3;
  * evaluate with the CoAlign hook gives the AP of evaluate on batches
    corrected beforehand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.data import IntermediateFusionBatcher as JaxBatcher
from coalign_tpu.data import SyntheticScenes as JaxScenes
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.posegraph import BoxAlignConfig as JaxConfig
from coalign_tpu.postprocess.anchors import make_anchor_spec as jax_spec
from coalign_tpu.tools import pose_graph_eval as JE
from coalign_tpu.tools import stage1 as JS
from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.inference import evaluate, gt_corners, make_infer_fn
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.posegraph import BoxAlignConfig
from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
from coalign_tpu_torch.tools import pose_graph_eval as TE
from coalign_tpu_torch.tools.stage1 import (correct_batch_poses,
                                            correct_batch_poses_from_json,
                                            dump_stage1_json,
                                            load_stage1_json,
                                            make_stage1_fn,
                                            stage1_content_to_arrays)
from coalign_tpu_torch.utils.weights import from_jax_params

from chip_smoke import E2E_ARGS, oracle_stage1, pairwise_error
from test_torch_flagship import _randomize_norms

torch.set_num_threads(1)

# tests/test_stage1_uncertainty.py:17-43
LIDAR_RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
MODEL_ARGS = {
    "voxel_size": [0.5, 0.5, 4.0],
    "lidar_range": LIDAR_RANGE,
    "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [16]},
    "point_pillar_scatter": {"num_features": 16},
    "base_bev_backbone": {
        "layer_nums": [2, 2], "layer_strides": [2, 2],
        "num_filters": [16, 32], "upsample_strides": [1, 2],
        "num_upsample_filter": [16, 16],
    },
    "dir_args": {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]},
}
ANCHOR_ARGS = {"W": 64, "H": 64, "l": 4.2, "w": 1.8, "h": 1.6, "r": [0, 90],
               "vw": 0.5, "vh": 0.5, "feature_stride": 2,
               "cav_lidar_range": LIDAR_RANGE}
POSTPROCESS = {
    "anchor_args": ANCHOR_ARGS,
    "target_args": {"pos_threshold": 0.6, "neg_threshold": 0.45,
                    "score_threshold": 0.25},
    "order": "hwl", "max_num": 100, "nms_thresh": 0.15,
    "gt_range": LIDAR_RANGE,
    "dir_args": {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]},
}
STAGE1 = {"core_method": "point_pillar_uncertainty", "args": MODEL_ARGS}
SCENES = dict(num_frames=4, num_agents=2, num_objects=4,
              lidar_range=LIDAR_RANGE, agent_spread=4.0, object_spread=0.5)
BATCHER = dict(max_cav=3, max_points=2000, max_objects=16,
               lidar_range=LIDAR_RANGE, pos_std=0.4, rot_std=2.0)
KEYS = ("box_poses", "box_mask", "uncertainty")
# the dataset-level tests: 2 frames of 2 agents without a padded slot (the
# plain IoU of a stage-1 NMS costs ~1.5 s an agent frame on one CPU thread)
SMALL_SCENES = dict(SCENES, num_frames=2)
SMALL_BATCHER = dict(BATCHER, max_cav=2)


@pytest.fixture(scope="module")
def shared():
    """The tiny stage-1 model with the same seeded weights (batch norms
    randomized) in both packages, a B = 2 batch of 2 agents in 3 slots
    with pose noise, and each package's detections on it."""
    scenes = SyntheticScenes(**SCENES)
    batch = IntermediateFusionBatcher(**BATCHER).assemble(
        [scenes[0], scenes[1]])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model(STAGE1)
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(0), jbatch, train=False)),
        np.random.default_rng(0))
    model = build_model(STAGE1, device="cpu")
    model.load_state_dict(from_jax_params(
        variables, MODEL_ARGS["base_bev_backbone"]["layer_nums"]),
        strict=True)
    jfn = JS.make_stage1_fn(jmodel, jax_spec(
        ANCHOR_ARGS, POSTPROCESS["target_args"], "hwl").anchors, POSTPROCESS)
    want = {k: np.asarray(v) for k, v in jfn(variables, jbatch).items()}
    fn = make_stage1_fn(model, generate_anchor_box(ANCHOR_ARGS), POSTPROCESS,
                        device="cpu")
    return {"batch": batch, "jbatch": jbatch, "model": model,
            "variables": variables, "jmodel": jmodel, "jfn": jfn, "fn": fn,
            "want": want, "got": {k: v.numpy() for k, v in fn(batch).items()}}


def test_stage1_detections_match_jax(shared):
    got, want = shared["got"], shared["want"]
    assert got["box_poses"].shape == (2, 3, 24, 3)
    assert got["uncertainty"].shape == (2, 3, 24, 3)
    np.testing.assert_array_equal(got["box_mask"], want["box_mask"])
    assert got["box_mask"][:, :2].sum() > 20          # real detections
    assert not got["box_mask"][:, 2].any()            # the padded slot
    for key in ("box_poses", "uncertainty"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4,
                                   err_msg=key)
    kept = got["box_mask"]
    np.testing.assert_array_equal(
        got["box_poses"], np.concatenate([got["boxes7"][..., :2],
                                          got["boxes7"][..., 6:]], -1))
    assert (got["scores"][kept] > POSTPROCESS["target_args"]
            ["score_threshold"]).all()


def test_stage1_runs_one_nms_over_every_agent_frame(shared, monkeypatch):
    from coalign_tpu_torch.utils import nms as nms_module
    shapes = []
    kernel = nms_module.rotated_iou

    def spy(c1, c2):
        shapes.append(tuple(c1.shape))
        return kernel(c1, c2)
    monkeypatch.setattr(nms_module, "rotated_iou", spy)
    shared["fn"](shared["batch"])
    assert shapes == [(6, 512, 4, 2)]                # B * L = 2 * 3 frames


@pytest.mark.parametrize("dets", ["stage1", "oracle"])
def test_correct_batch_poses_matches_jax(shared, dets):
    batch, jbatch = shared["batch"], shared["jbatch"]
    if dets == "stage1":
        d = {k: np.array(shared["want"][k]) for k in KEYS}
    else:
        scenes = SyntheticScenes(**SCENES)
        d = oracle_stage1([scenes[0], scenes[1]], batch)
    cfg = {"abandon_hard_cases": dets == "stage1"}
    want = JS.correct_batch_poses(jbatch, {k: jnp.asarray(v)
                                           for k, v in d.items()},
                                  JaxConfig(**cfg))
    got = correct_batch_poses(batch, d, BoxAlignConfig(**cfg), device="cpu")
    for key in ("lidar_pose", "pairwise_t_matrix"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(got["points"], batch["points"])
    if dets == "oracle":
        assert not np.allclose(got["lidar_pose"].numpy(), batch["lidar_pose"])


def test_oracle_detections_recover_the_clean_transforms():
    # tests/test_stage1_uncertainty.py::test_correct_batch_poses_improves_
    # pairwise on the port
    l, k = 3, 10
    rng = [-40, -40, -3, 40, 40, 1]
    scenes = SyntheticScenes(num_frames=4, num_agents=l, num_objects=k,
                             lidar_range=rng, agent_spread=10.0)
    frames = [scenes[i] for i in range(4)]
    batch = IntermediateFusionBatcher(
        max_cav=l, max_points=4000, max_objects=16, lidar_range=rng,
        pos_std=0.4, rot_std=2.0).assemble(frames)
    corrected = correct_batch_poses(
        batch, oracle_stage1(frames, batch, k),
        BoxAlignConfig(abandon_hard_cases=False), device="cpu")
    noisy_err = pairwise_error(batch["pairwise_t_matrix"], batch)
    corr_err = pairwise_error(corrected["pairwise_t_matrix"], batch)
    assert noisy_err > 0.3
    assert corr_err < noisy_err * 0.3, (noisy_err, corr_err)


def test_stage1_json_round_trip(shared, tmp_path):
    got = shared["got"]
    path = str(tmp_path / "stage1_boxes.json")
    dump_stage1_json({k: torch.from_numpy(got[k]) for k in KEYS}, [7, 8],
                     path)
    content = load_stage1_json(path)
    assert set(content) == {"7", "8"} and len(content["7"]) == 3
    arrays = stage1_content_to_arrays(content, [7, 8], max_cav=3)
    for key in KEYS:
        assert arrays[key].shape == got[key].shape
    # each agent's kept boxes, in their order, at the front of its slots
    for bi in range(2):
        for a in range(3):
            keep = got["box_mask"][bi, a]
            n = int(keep.sum())
            loaded = arrays["box_mask"][bi, a].numpy()
            assert loaded[:n].all() and not loaded[n:].any()
            for key in ("box_poses", "uncertainty"):
                np.testing.assert_array_equal(
                    arrays[key][bi, a, :n].numpy(), got[key][bi, a][keep])
    want = JS.stage1_content_to_arrays(content, [7, 8], max_cav=3)
    for key in KEYS:
        np.testing.assert_array_equal(arrays[key].numpy(),
                                      np.asarray(want[key]))
    from_json = correct_batch_poses_from_json(shared["batch"], content,
                                              [7, 8], device="cpu")
    direct = correct_batch_poses(shared["batch"], got, device="cpu")
    torch.testing.assert_close(from_json["lidar_pose"], direct["lidar_pose"])


def test_stage1_content_arrays_truncate_long_uncertainty():
    # tests/test_stage1_uncertainty.py:151-170 on the port
    n = 48
    content = {"0": [{
        "box_poses": np.random.default_rng(0).normal(size=(n, 3)).tolist(),
        "uncertainty": np.random.default_rng(1).normal(size=(n, 3)).tolist(),
    }]}
    out = stage1_content_to_arrays(content, [0], max_cav=2, max_boxes=24)
    assert out["box_poses"].shape == (1, 2, 24, 3)
    assert out["uncertainty"].shape == (1, 2, 24, 3)
    assert bool(out["box_mask"][0, 0].all())
    assert not out["box_mask"][0, 1].any()
    np.testing.assert_allclose(
        out["uncertainty"][0, 0].numpy(),
        np.asarray(content["0"][0]["uncertainty"], np.float32)[:24],
        rtol=1e-6)


def test_relative_pose_errors_and_summary_match_jax():
    rng = np.random.default_rng(12)
    clean = rng.normal(0, 20, (3, 4, 6)).astype(np.float32)
    noisy = clean + rng.normal(0, 0.5, clean.shape).astype(np.float32)
    noisy[..., 4] += 350.0 * (rng.uniform(size=(3, 4)) > 0.7)
    mask = rng.uniform(size=(3, 4)) > 0.2
    got = TE.relative_pose_errors(noisy, clean, mask)
    want = JE.relative_pose_errors(noisy, clean, mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert TE.summarize(*got) == JE.summarize(*want)
    assert TE.summarize(np.zeros(0), np.zeros(0)) == \
        JE.summarize(np.zeros(0), np.zeros(0))


def test_evaluate_pose_graph_matches_jax(shared):
    spec = jax_spec(ANCHOR_ARGS, POSTPROCESS["target_args"], "hwl")
    want = JE.evaluate_pose_graph(
        shared["jmodel"], shared["variables"], JaxBatcher(**SMALL_BATCHER),
        JaxScenes(**SMALL_SCENES), spec.anchors, POSTPROCESS, batch_size=1)
    got = TE.evaluate_pose_graph(
        shared["model"], IntermediateFusionBatcher(**SMALL_BATCHER),
        SyntheticScenes(**SMALL_SCENES), generate_anchor_box(ANCHOR_ARGS),
        POSTPROCESS, batch_size=1, device="cpu")
    assert got["frames"] == want["frames"] == 2
    assert got["before"] == want["before"]
    for key, value in want["after"].items():
        assert abs(got["after"][key] - value) <= 1e-3, key


def test_evaluate_with_the_coalign_hook(shared):
    flagship = build_model({"core_method": "point_pillar_baseline_multiscale",
                            "args": E2E_ARGS}, device="cpu", seed=3)
    cfg = dict(POSTPROCESS, target_args={"score_threshold": 0.05})
    infer = make_infer_fn(flagship, generate_anchor_box(ANCHOR_ARGS), cfg,
                          device="cpu")
    scenes = SyntheticScenes(**SMALL_SCENES)
    batcher = IntermediateFusionBatcher(**SMALL_BATCHER)
    frames = [dict(b, gt_corners=gt_corners(b))
              for b in batcher.batches(scenes, 1, shuffle=False)]
    stage1, align = shared["fn"], BoxAlignConfig(abandon_hard_cases=False)
    seen = []

    def hook(batch, ids):
        seen.append(ids)
        return correct_batch_poses(batch, stage1(batch), align, device="cpu")

    with_hook = evaluate(infer, frames, batch_hook=hook)
    assert seen == [[0], [1]]
    corrected = [correct_batch_poses(f, stage1(f), align, device="cpu")
                 for f in frames]
    assert any(not np.allclose(c["pairwise_t_matrix"].numpy(),
                               f["pairwise_t_matrix"])
               for c, f in zip(corrected, frames))
    assert with_hook == evaluate(infer, corrected)
    assert with_hook["frames"] == 2
