"""The PyTorch port's host data feed against the JAX package's, and B = 2
inference frame by frame.

  * SyntheticScenes, WorldAugmentor and IntermediateFusionBatcher give, for
    the same seeds, the JAX package's frames and batches: integer and bool
    arrays equal, floats within 1e-6 (the port's numpy path makes the JAX
    package's numpy calls, so they agree to the bit; 1e-6 leaves room for
    a numpy build that orders a sum differently). The JAX batcher is held
    to its numpy path, the one the port copies (its optional C++ data
    plane samples points differently);
  * the box and transform helpers the batcher and the labels use: numpy
    forms within 1e-6, torch forms within 1e-5 (float32 trigonometry of
    another library, on metres up to 100);
  * prefetch yields every batch in order, as tensors, and raises the
    producer's error;
  * a B = 2 make_infer_fn call gives each frame the JAX infer fn's box set
    at B = 2 (tests/test_torch_flagship.py's bounds: same count, matched
    IoU > 0.95, score within 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.data import augment as JA
from coalign_tpu.data import batch as JBATCH
from coalign_tpu.data import synthetic as JS
from coalign_tpu.inference import make_infer_fn as jax_make_infer_fn
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.utils import box_utils as JB
from coalign_tpu.utils import transforms as JT
from coalign_tpu_torch.data.augment import WorldAugmentor
from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
from coalign_tpu_torch.data.prefetch import prefetch
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.inference import make_infer_fn
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
from coalign_tpu_torch.utils import box_utils as TB
from coalign_tpu_torch.utils import transforms as TT
from coalign_tpu_torch.utils.weights import from_jax_params

from chip_smoke import TINY_ANCHORS, TINY_ARGS, match_box_sets
from test_torch_flagship import _randomize_norms

torch.set_num_threads(1)

SCENES = dict(num_frames=6, num_agents=4, num_objects=6,
              lidar_range=(-12.8, -12.8, -3.0, 12.8, 12.8, 1.0),
              points_per_object=150, ground_points=900, seed=3,
              agent_spread=40.0)
AUGMENT = [{"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x"]},
           {"NAME": "random_world_rotation",
            "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
           {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]}]
# max_cav 3 pads a slot of the frames whose far agents the comm range
# drops; 1200 points subsamples the clouds; pose noise draws on the rng
BATCHER = dict(max_cav=3, max_points=1200, max_objects=8,
               lidar_range=SCENES["lidar_range"], comm_range=20.0,
               pos_std=0.2, rot_std=0.2, seed=11)


@pytest.fixture
def jax_numpy_batcher(monkeypatch):
    monkeypatch.setattr(JBATCH, "_native", None)


def _assert_same(got, want, where):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, where
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=where)


def _assert_same_frame(got, want):
    assert len(got["agents"]) == len(want["agents"])
    for a, (ga, wa) in enumerate(zip(got["agents"], want["agents"])):
        for key in ("pose", "points"):
            _assert_same(ga[key], wa[key], f"agent {a} {key}")
    for key in ("boxes", "ids"):
        _assert_same(got["objects"][key], want["objects"][key], key)


def test_synthetic_scenes_match_jax():
    got, want = SyntheticScenes(**SCENES), JS.SyntheticScenes(**SCENES)
    assert len(got) == len(want) == SCENES["num_frames"]
    for i in range(len(got)):
        _assert_same_frame(got[i], want[i])


def test_augmentor_matches_jax():
    got, want = WorldAugmentor(AUGMENT, seed=5), JA.WorldAugmentor(AUGMENT,
                                                                  seed=5)
    scenes = SyntheticScenes(**SCENES)
    draws = []
    for i in range(len(scenes)):
        draws.append(got.sample())
        assert draws[-1] == want.sample()
        _assert_same_frame(got.apply(scenes[i], *draws[-1]),
                           JA.WorldAugmentor.apply(scenes[i], *draws[-1]))
    # both flips, and rotations and scales away from the identity, occurred
    assert {d[0] for d in draws} == {True, False}
    assert all(d[1] != 0.0 and d[2] != 1.0 for d in draws)


def test_batcher_matches_jax(jax_numpy_batcher):
    scenes = SyntheticScenes(**SCENES)
    got = IntermediateFusionBatcher(
        **BATCHER, augmentor=WorldAugmentor(AUGMENT, seed=5), native=False)
    want = JBATCH.IntermediateFusionBatcher(
        **BATCHER, augmentor=JA.WorldAugmentor(AUGMENT, seed=5))
    batches = list(zip(got.batches(scenes, 2), want.batches(scenes, 2)))
    assert len(batches) == 3
    for bg, bw in batches:
        assert set(bg) == set(bw)
        for key in bw:
            _assert_same(bg[key], bw[key], key)
    # the data exercised what it should: padded agent slots, subsampled
    # and padded point lists, gt boxes and padded gt slots
    agents = np.concatenate([b["agent_mask"] for b, _ in batches])
    counts = np.concatenate([b["point_mask"].sum(-1) for b, _ in batches])
    gt = np.concatenate([b["gt_mask"] for b, _ in batches])
    assert agents[:, 0].all() and not agents.all()
    assert counts.max() == BATCHER["max_points"]
    assert ((counts > 0) & (counts < BATCHER["max_points"])).any()
    assert gt.any() and not gt.all()
    # unshuffled, with the last short batch kept
    tail = list(got.batches(scenes, 4, shuffle=False, drop_last=False))
    assert [len(b["agent_mask"]) for b in tail] == [4, 2]


def test_box_and_transform_helpers_match_jax():
    rng = np.random.default_rng(4)
    boxes = np.zeros((2, 9, 7), np.float32)
    boxes[..., :2] = rng.uniform(-100, 100, (2, 9, 2))
    boxes[..., 2] = rng.uniform(-2, 0, (2, 9))
    boxes[..., 3:6] = rng.uniform(1.4, 4.8, (2, 9, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (2, 9))
    poses = np.zeros((2, 6), np.float32)
    poses[:, :2] = rng.uniform(-80, 80, (2, 2))
    poses[:, 3:] = rng.uniform(-10, 10, (2, 3))
    poses[:, 4] = rng.uniform(-180, 180, 2)
    points = rng.uniform(-60, 60, (500, 4)).astype(np.float32)
    lim = (-40.0, -30.0, -3.0, 40.0, 30.0, 1.0)
    tfm = np.asarray(JT.x1_to_x2_tfm(poses[0], poses[1]))
    # each case takes the module and the converter of its inputs
    cases = {
        "boxes_to_corners2d": lambda M, a: M.boxes_to_corners2d(a(boxes)),
        "corners_to_standup_2d": lambda M, a: M.corners_to_standup_2d(
            M.boxes_to_corners_3d(a(boxes))[..., :4, :]),
        "corner_to_center": lambda M, a: M.corner_to_center(
            M.boxes_to_corners_3d(a(boxes))),
        "project_boxes7_by_tfm": lambda M, a: M.project_boxes7_by_tfm(
            a(boxes[0]), a(tfm)),
        "mask_boxes_outside_range": lambda M, a: M.mask_boxes_outside_range(
            a(boxes), lim),
        "mask_points_by_range": lambda M, a: M.mask_points_by_range(
            a(points), lim),
    }
    for name, fn in cases.items():
        want = np.asarray(fn(JB, np.asarray))
        _assert_same(fn(TB, np.asarray), want, f"numpy {name}")
        got = fn(TB, torch.from_numpy)
        assert isinstance(got, torch.Tensor), name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=f"torch {name}")
    assert np.asarray(JB.mask_points_by_range(points, lim)).any()
    # the numpy transforms the batcher calls
    _assert_same(TT.x1_to_x2_tfm(poses[0], poses[1]), tfm, "x1_to_x2_tfm")
    _assert_same(TT.inverse_tfm(TT.pose_to_tfm(poses)),
                 JT.inverse_tfm(JT.pose_to_tfm(poses)), "inverse_tfm")
    _assert_same(TT.project_points(points, tfm),
                 JT.project_points(points, tfm), "project_points")
    mask = np.array([True, False])
    _assert_same(TT.get_pairwise_transformation(poses, mask),
                 JT.get_pairwise_transformation(poses, mask), "pairwise")
    torch.testing.assert_close(
        TT.x1_to_x2_tfm(torch.from_numpy(poses[0]), torch.from_numpy(
            poses[1])), torch.from_numpy(tfm), atol=1e-5, rtol=0)


def test_prefetch_yields_every_batch_in_order_and_raises_the_producers():
    batches = [{"x": np.full((2, 3), i, np.float32),
                "m": np.array([True, i % 2 == 0])} for i in range(5)]
    got = list(prefetch(iter(batches), size=2, device="cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and b["x"].dtype == \
            torch.float32 and b["m"].dtype == torch.bool
        assert (b["x"] == i).all() and bool(b["m"][1]) == (i % 2 == 0)

    def failing():
        yield batches[0]
        raise ValueError("producer failed")

    with pytest.raises(ValueError, match="producer failed"):
        list(prefetch(failing(), device="cpu"))
    # a consumer that stops early retires the side thread
    for b in prefetch(iter(batches), size=1, device="cpu"):
        break


def test_b2_inference_matches_jax_frame_by_frame(jax_numpy_batcher):
    scenes = SyntheticScenes(num_frames=2, num_agents=2, num_objects=5,
                             lidar_range=TINY_ARGS["lidar_range"],
                             points_per_object=200, ground_points=400,
                             agent_spread=5.0, seed=9)
    batch = IntermediateFusionBatcher(
        max_cav=3, max_points=1200, max_objects=8,
        lidar_range=TINY_ARGS["lidar_range"], native=False).assemble(
        [scenes[0], scenes[1]])
    flagship = {"core_method": "point_pillar_baseline_multiscale",
                "args": TINY_ARGS}
    jmodel = jax_build_model(flagship)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomize_norms(
        jax.tree_util.tree_map(np.asarray, jit_init(
            jmodel, jax.random.PRNGKey(5), jbatch, train=False)),
        np.random.default_rng(6))
    model = build_model(flagship, device="cpu")
    model.load_state_dict(from_jax_params(
        variables, TINY_ARGS["base_bev_backbone"]["layer_nums"]), strict=True)
    cfg = {"target_args": {"score_threshold": 0.3}, "nms_thresh": 0.15,
           "gt_range": TINY_ARGS["lidar_range"],
           "dir_args": TINY_ARGS["dir_args"], "max_num": 100}
    want = jax.tree_util.tree_map(np.asarray, jax_make_infer_fn(
        jmodel, generate_anchor_box(TINY_ANCHORS), cfg)(variables, jbatch))
    got = {k: v.numpy() for k, v in make_infer_fn(
        model, generate_anchor_box(TINY_ANCHORS), cfg,
        device="cpu")(batch).items()}
    assert got["corners3d"].shape == want["corners3d"].shape == (2, 100, 8, 3)
    for i in range(2):
        keep_t, keep_j = got["mask"][i], want["mask"][i]
        assert keep_j.sum() > 3, f"frame {i}: too few boxes to compare"
        match_box_sets(got["corners3d"][i][keep_t], got["scores"][i][keep_t],
                       want["corners3d"][i][keep_j],
                       want["scores"][i][keep_j])
