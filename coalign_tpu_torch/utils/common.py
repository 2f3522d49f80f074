"""Small shared numeric helpers (ref: opencood/utils/common_utils.py).

Geometry helpers here and in transforms.py / box_utils.py dispatch on their
inputs: numpy arrays compute in numpy (host data), torch tensors in torch on
the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch


def array_namespace(*arrays):
    """torch for torch tensors, numpy for everything else."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return torch
    return np


def const(xp, value, like):
    """``value`` as an array of ``like``'s namespace, dtype and device."""
    if xp is torch:
        return torch.as_tensor(value, dtype=like.dtype, device=like.device)
    return np.asarray(value, dtype=like.dtype)


def limit_period(val, offset: float = 0.5, period: float = 2 * np.pi):
    """Wrap ``val`` into ``[-offset*period, (1-offset)*period)``
    (ref common_utils.py:70). A tensor is divided by a tensor, so that
    the division is IEEE's on every device, as the JAX package's and the
    CPU's: divided by a Python scalar, CUDA multiplies by its reciprocal,
    and a value on or next to a period's boundary can wrap into the next
    period (see ops/voxels.cell_index)."""
    if isinstance(val, torch.Tensor):
        return val - torch.floor(val / val.new_full((), period)
                                 + offset) * period
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """Rotate (B, N, 3[+C]) points by (B,) radians around +z, elementwise
    (ref common_utils.py:105)."""
    xp = array_namespace(points, angle)
    cosa = xp.cos(angle)[..., None]
    sina = xp.sin(angle)[..., None]
    x = points[..., :, 0]
    y = points[..., :, 1]
    new_x = x * cosa - y * sina
    new_y = x * sina + y * cosa
    xyz = xp.stack([new_x, new_y, points[..., :, 2]], axis=-1)
    return xp.concatenate([xyz, points[..., 3:]], axis=-1)
