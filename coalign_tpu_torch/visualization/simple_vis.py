"""Frame visualization: predictions against gt on a BEV or 3D canvas.

Port of coalign_tpu/visualization/simple_vis.py (ref
opencood/visualization/simple_vis.py:14 visualize): green the ground
truth, red the predictions, gray the points.
"""

from __future__ import annotations

import numpy as np

from coalign_tpu_torch.visualization.canvas_3d import Canvas3D
from coalign_tpu_torch.visualization.canvas_bev import CanvasBEV

GT_COLOR = (0, 180, 0)
PRED_COLOR = (220, 30, 30)


def visualize(pred_corners, gt_corners, points, lidar_range, save_path,
              method: str = "bev", left_hand: bool = False):
    """pred_corners, gt_corners: (N, 8, 3) or None; points (P, 3+). Writes
    ``save_path`` and returns it.

    ``left_hand`` flips y (ref tools/inference.py:80: OPV2V and V2XSet are
    CARLA's left-handed frame; their renders mirror without it)."""
    points = np.asarray(points)
    if method == "bev":
        canvas = CanvasBEV(
            canvas_shape=(
                int((lidar_range[4] - lidar_range[1]) * 10),
                int((lidar_range[3] - lidar_range[0]) * 10)),
            canvas_x_range=(lidar_range[0], lidar_range[3]),
            canvas_y_range=(lidar_range[1], lidar_range[4]),
            left_hand=left_hand)
    elif method == "3d":
        canvas = Canvas3D(left_hand=left_hand)
    else:
        raise ValueError(f"unknown vis method {method!r}")

    if len(points):
        canvas.draw_canvas_points(points[:, :3] if method == "3d"
                                  else points[:, :2])
    if gt_corners is not None and len(gt_corners):
        canvas.draw_boxes(np.asarray(gt_corners), color=GT_COLOR)
    if pred_corners is not None and len(pred_corners):
        canvas.draw_boxes(np.asarray(pred_corners), color=PRED_COLOR)
    return canvas.save(save_path)
