"""3D box utilities: corners, projection and the sanity / range masks.

Port of the parts of coalign_tpu/utils/box_utils.py (ref
opencood/utils/box_utils.py) that inference, the host batcher and the
label assignment need. Dispatches on its inputs like utils/common.py: numpy
in, numpy out (the batcher's host path, computed as the JAX package's numpy
path computes it); torch in, torch out (labels on the device).

Box orders: 'hwl' (PointPillars family) is [x, y, z, h, w, l, yaw], 'lwh' is
[x, y, z, l, w, h, yaw]; yaw in radians around +z, (x, y, z) the center.
"""

from __future__ import annotations

import numpy as np

from coalign_tpu_torch.utils.common import (array_namespace, const,
                                            rotate_points_along_z)
from coalign_tpu_torch.utils.transforms import project_points

# bottom face 0-3, top face 4-7 (ref box_utils.py:193-196)
_CORNER_TEMPLATE = np.array(
    [[1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
     [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1]], dtype=np.float32) / 2.0


def boxes_to_corners_3d(boxes3d, order: str = "hwl"):
    """(..., 7) boxes -> (..., 8, 3) corners (ref box_utils.py:152)."""
    xp = array_namespace(boxes3d)
    if order == "hwl":
        boxes3d = boxes3d[..., [0, 1, 2, 5, 4, 3, 6]]  # -> lwh
    elif order != "lwh":
        raise ValueError(f"unknown order {order}")
    dims = boxes3d[..., 3:6]
    corners = dims[..., None, :] * const(xp, _CORNER_TEMPLATE, boxes3d)
    flat = corners.reshape(-1, 8, 3)
    yaw = boxes3d[..., 6].reshape(-1)
    rotated = rotate_points_along_z(flat, yaw).reshape(corners.shape)
    return rotated + boxes3d[..., None, :3]


def boxes_to_corners2d(boxes3d, order: str = "hwl"):
    """(..., 7) boxes -> (..., 4, 2) BEV bottom-face corners
    (ref box_utils.py:121)."""
    return boxes_to_corners_3d(boxes3d, order)[..., :4, :2]


def corners_to_standup_2d(corners):
    """(..., K, 2 or 3) corners -> (..., 4) [x1, y1, x2, y2] standup boxes
    (ref box_utils.py corner2d_to_standup_box)."""
    xp = array_namespace(corners)
    x, y = corners[..., 0], corners[..., 1]
    return xp.stack([xp.amin(x, axis=-1), xp.amin(y, axis=-1),
                     xp.amax(x, axis=-1), xp.amax(y, axis=-1)], axis=-1)


def corner_to_center(corner3d, order: str = "hwl"):
    """(..., 8, 3) corners -> (..., 7) boxes (ref box_utils.py:25)."""
    xp = array_namespace(corner3d)
    xyz = xp.mean(corner3d[..., [0, 3, 5, 6], :], axis=-2)
    h = xp.abs(xp.mean(corner3d[..., 4:, 2] - corner3d[..., :4, 2], axis=-1))

    def edge(a, b):
        d = corner3d[..., a, :2] - corner3d[..., b, :2]
        return xp.sqrt(xp.sum(d * d, axis=-1))

    def theta(a, b):
        d = corner3d[..., a, :] - corner3d[..., b, :]
        return xp.arctan2(d[..., 1], d[..., 0])

    l = (edge(0, 3) + edge(2, 1) + edge(4, 7) + edge(5, 6)) / 4.0
    w = (edge(0, 1) + edge(2, 3) + edge(4, 5) + edge(6, 7)) / 4.0
    yaw = (theta(1, 2) + theta(0, 3) + theta(5, 6) + theta(4, 7)) / 4.0
    if order == "hwl":
        dims = [h, w, l]
    elif order == "lwh":
        dims = [l, w, h]
    else:
        raise ValueError(f"unknown order {order}")
    return xp.stack([xyz[..., 0], xyz[..., 1], xyz[..., 2], *dims, yaw],
                    axis=-1)


def project_box3d(corners3d, transformation_matrix):
    """Project (..., 8, 3) corners with (..., 4, 4) transforms
    (ref box_utils.py:278)."""
    return project_points(corners3d, transformation_matrix)


def project_boxes7_by_tfm(boxes7, tfm, order: str = "hwl"):
    """(..., 7) center-form boxes through (..., 4, 4) transforms."""
    corners = boxes_to_corners_3d(boxes7, order)
    return corner_to_center(project_box3d(corners, tfm), order)


def mask_corners_outside_range(corners, limit_range):
    """(..., 8, 3) corners -> bool (...): some corner inside the xy range
    (ref box_utils.py:348 get_mask_for_boxes_within_range)."""
    xp = array_namespace(corners)
    inside = ((corners[..., 0] >= limit_range[0])
              & (corners[..., 0] <= limit_range[3])
              & (corners[..., 1] >= limit_range[1])
              & (corners[..., 1] <= limit_range[4]))
    return xp.any(inside, axis=-1)


def mask_boxes_outside_range(boxes7, limit_range, order: str = "hwl"):
    """(..., 7) boxes -> bool (...): some BEV corner inside the xy range."""
    return mask_corners_outside_range(boxes_to_corners_3d(boxes7, order),
                                      limit_range)


def mask_points_by_range(points, limit_range):
    """(..., 3+C) points -> bool (...): inside [x1,y1,z1,x2,y2,z2]."""
    return ((points[..., 0] >= limit_range[0])
            & (points[..., 0] <= limit_range[3])
            & (points[..., 1] >= limit_range[1])
            & (points[..., 1] <= limit_range[4])
            & (points[..., 2] >= limit_range[2])
            & (points[..., 2] <= limit_range[5]))


def mask_corners_all_inside_range(corners, limit_range, min_num_corners=8):
    """(..., 8, 3) corners -> bool (...): at least ``min_num_corners`` corners
    inside the [x1,y1,z1,x2,y2,z2] box (ref box_utils.py:384)."""
    xp = array_namespace(corners)
    lo = const(xp, limit_range[0:3], corners)
    hi = const(xp, limit_range[3:6], corners)
    inside = xp.all((corners >= lo) & (corners <= hi), axis=-1)
    return xp.sum(inside, axis=-1) >= min_num_corners


def remove_large_pred_bbx(corners3d, max_extent=6.0):
    """Sanity mask against degenerate decoded boxes (ref box_utils.py:840):
    axis-aligned x and y extents <= 6, and, as the reference's third test
    reads column 1 again, y extent != 0. (..., 8, 3) -> bool (...)."""
    xp = array_namespace(corners3d)
    x_len = xp.amax(corners3d[..., 0], axis=-1) - xp.amin(corners3d[..., 0],
                                                          axis=-1)
    y_len = xp.amax(corners3d[..., 1], axis=-1) - xp.amin(corners3d[..., 1],
                                                          axis=-1)
    return (x_len <= max_extent) & (y_len <= max_extent) & (y_len != 0.0)


def remove_bbx_abnormal_z(corners3d, min_z=-3.0, max_z=1.0):
    """Mask boxes with all corner z inside [min_z, max_z]
    (ref box_utils.py:872)."""
    xp = array_namespace(corners3d)
    z = corners3d[..., 2]
    return (xp.amin(z, axis=-1) >= min_z) & (xp.amax(z, axis=-1) <= max_z)
