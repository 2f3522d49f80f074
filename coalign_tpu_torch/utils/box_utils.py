"""3D box utilities: corners, projection and the sanity / range masks.

Port of the parts of coalign_tpu/utils/box_utils.py (ref
opencood/utils/box_utils.py) that inference needs. Dispatches on its inputs
like utils/common.py: numpy in, numpy out; torch in, torch out.

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


def project_box3d(corners3d, transformation_matrix):
    """Project (..., 8, 3) corners with (..., 4, 4) transforms
    (ref box_utils.py:278)."""
    return project_points(corners3d, transformation_matrix)


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
