"""The PyTorch port's visualization (coalign_tpu_torch/visualization/,
tools/vis_data_sequence.py) against the JAX package's, on the CPU:

  * each canvas (BEV, 3D, with and without left_hand) is pixel-equal to the
    JAX one on the same points and boxes, and so is visualize's image;
  * write_png (data/image_io.py), through which the port's canvases save
    without PIL, round-trips through the port's decoder and through PIL;
  * the vis_data_sequence tool renders the fixture dataset as
    tests/test_visualization.py runs it, pixel-equal to the JAX tool's
    PNGs.
"""

import os

import numpy as np
import pytest
import yaml
from PIL import Image

from coalign_tpu.utils import box_utils as JB
from coalign_tpu.visualization import Canvas3D as JaxCanvas3D
from coalign_tpu.visualization import CanvasBEV as JaxCanvasBEV
from coalign_tpu.visualization import visualize as jax_visualize
from coalign_tpu_torch.data.image_io import read_png, write_png
from coalign_tpu_torch.visualization import Canvas3D, CanvasBEV, visualize

BEV = dict(canvas_shape=(200, 400), canvas_x_range=(-40, 40),
           canvas_y_range=(-20, 20))


def _scene(seed):
    rng = np.random.default_rng(seed)
    points = np.concatenate([rng.uniform([-45, -25, -2], [45, 25, 1], (300, 3)),
                             [[999.0, 0.0, 0.0], [0.0, 0.0, 0.0]]])
    boxes = np.zeros((6, 7), np.float32)
    boxes[:, :2] = rng.uniform([-35, -15], [35, 15], (6, 2))
    boxes[:, 2] = rng.uniform(-1.5, 0.0, 6)
    boxes[:, 3:6] = [1.5, 1.8, 4.2]
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 6)
    return points.astype(np.float32), np.asarray(
        JB.boxes_to_corners_3d(boxes, "hwl"))


@pytest.mark.parametrize("left_hand", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_bev_canvas_is_pixel_equal(seed, left_hand):
    points, corners = _scene(seed)
    ours = CanvasBEV(**BEV, left_hand=left_hand)
    ref = JaxCanvasBEV(**BEV, left_hand=left_hand)
    for c in (ours, ref):
        c.draw_canvas_points(points[:, :2], radius=1, color=(10, 10, 10))
        c.draw_boxes(corners, color=(0, 200, 0), thickness=2)
        c.draw_boxes(corners[:, :4, :2] + 1.0, color=(200, 0, 0))
    assert (ours.canvas != 255).any()
    np.testing.assert_array_equal(ours.canvas, ref.canvas)


@pytest.mark.parametrize("left_hand", [False, True])
def test_3d_canvas_is_pixel_equal(left_hand):
    points, corners = _scene(2)
    ours = Canvas3D(canvas_shape=(120, 160), left_hand=left_hand)
    ref = JaxCanvas3D(canvas_shape=(120, 160), left_hand=left_hand)
    for c in (ours, ref):
        c.draw_canvas_points(points)
        c.draw_boxes(corners, color=(0, 90, 200))
    assert (ours.canvas != 255).any()
    np.testing.assert_array_equal(ours.canvas, ref.canvas)


@pytest.mark.parametrize("method", ["bev", "3d"])
def test_visualize_writes_the_jax_image(method, tmp_path):
    points, corners = _scene(3)
    lidar_range = [-40, -20, -3, 40, 20, 1]
    ours = visualize(corners[:3], corners[3:], points, lidar_range,
                     str(tmp_path / "ours.png"), method=method,
                     left_hand=True)
    ref = jax_visualize(corners[:3], corners[3:], points, lidar_range,
                        str(tmp_path / "ref.png"), method=method,
                        left_hand=True)
    got = read_png(ours)
    np.testing.assert_array_equal(got, np.asarray(Image.open(ref)))
    assert (got == [220, 30, 30]).all(-1).any()       # predictions drawn
    if method == "bev":
        assert (got == [0, 180, 0]).all(-1).any()     # gt drawn
    with pytest.raises(ValueError, match="unknown vis method"):
        visualize(None, None, points, lidar_range, str(tmp_path / "x.png"),
                  method="side")


def test_write_png_round_trips(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (37, 53, 3), np.uint8)
    path = str(tmp_path / "img.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    with pytest.raises(ValueError, match="RGB"):
        write_png(path, img[..., :2])


def test_vis_data_sequence_tool(tmp_path):
    """The sequence viewer renders gt and points PNGs of a fixture dataset
    (ref visualization/vis_data_sequence_*.py), the JAX tool's images."""
    from coalign_tpu.tools.vis_data_sequence import main as jax_main
    from coalign_tpu_torch.data import SyntheticScenes
    from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
    from coalign_tpu_torch.tools.vis_data_sequence import main

    lr = [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0]
    scenes = SyntheticScenes(num_frames=2, num_agents=2, num_objects=3,
                             lidar_range=lr, points_per_object=32,
                             ground_points=64, seed=7)
    root = write_opv2v_fixture(str(tmp_path / "opv2v"), scenes,
                               frames_per_scenario=2)
    # the config of tests/test_visualization.py's tool test
    cfg = {
        "name": "vis_test", "root_dir": root, "validate_dir": root,
        "test_dir": root, "noise_setting": {"add_noise": False},
        "train_params": {"batch_size": 1, "max_cav": 2},
        "input_source": ["lidar"], "label_type": "lidar", "comm_range": 70,
        "fusion": {"core_method": "late", "dataset": "opv2v",
                   "args": {"proj_first": False}},
        "preprocess": {"core_method": "SpVoxelPreprocessor",
                       "args": {"voxel_size": [0.4, 0.4, 4],
                                "max_points_per_voxel": 16,
                                "max_voxel_train": 2000,
                                "max_voxel_test": 2000},
                       "cav_lidar_range": lr},
        "postprocess": {"core_method": "VoxelPostprocessor", "gt_range": lr,
                        "anchor_args": {"cav_lidar_range": lr, "l": 3.9,
                                        "w": 1.6, "h": 1.56, "r": [0, 90],
                                        "feature_stride": 2, "num": 2},
                        "target_args": {"pos_threshold": 0.6,
                                        "neg_threshold": 0.45,
                                        "score_threshold": 0.2},
                        "order": "hwl", "max_num": 16, "nms_thresh": 0.15},
    }
    path = str(tmp_path / "vis.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    for method in ("bev", "3d"):
        written = main(["-y", path, "--out", str(tmp_path / "seq"),
                        "--frames", "2", "--method", method])
        want = jax_main(["-y", path, "--out", str(tmp_path / "jax_seq"),
                         "--frames", "2", "--method", method])
        assert [os.path.basename(p) for p in written] == [
            os.path.basename(p) for p in want] and len(written) == 2
        for ours, ref in zip(written, want):
            assert os.path.getsize(ours) > 500
            np.testing.assert_array_equal(read_png(ours),
                                          np.asarray(Image.open(ref)))
