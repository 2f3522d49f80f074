"""Pose <-> SE(3) transforms and pairwise agent transforms.

Port of coalign_tpu/utils/transforms.py (ref
opencood/utils/transformation_utils.py). Products of torch transforms are
written out elementwise, so they stay in full float32 on the GPU whatever
the TF32 settings are. Numpy inputs (the host batcher's) take the JAX
package's numpy calls (``np.matmul``, ``np.einsum``), so host batches come
out bit for bit as the JAX package's do.

Conventions (the reference's):
  * A 6-DoF pose is ``[x, y, z, roll, yaw, pitch]`` in degrees, CARLA axes.
  * A 3-DoF pose is ``[x, y, yaw]`` (yaw degrees).
  * ``pairwise_t_matrix[i, j]`` is T_j<-i, mapping agent-i coordinates into
    agent-j's frame.
"""

from __future__ import annotations

import numpy as np

from coalign_tpu_torch.utils.common import array_namespace, const


def matmul_f32(a, b):
    """(..., I, J) @ (..., J, K): for torch a sum of elementwise products,
    for numpy ``np.matmul``."""
    if array_namespace(a, b) is np:
        return np.matmul(a, b)
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def pose_to_tfm(pose):
    """Batched pose (..., 6) or (..., 3) -> (..., 4, 4) T_world<-x
    (ref transformation_utils.py:93 / :263 x_to_world)."""
    xp = array_namespace(pose)
    dof = pose.shape[-1]
    if dof == 3:
        x, y, yaw = pose[..., 0], pose[..., 1], xp.deg2rad(pose[..., 2])
        c, s = xp.cos(yaw), xp.sin(yaw)
        zero = xp.zeros_like(x)
        one = xp.ones_like(x)
        rows = [
            xp.stack([c, -s, zero, x], axis=-1),
            xp.stack([s, c, zero, y], axis=-1),
            xp.stack([zero, zero, one, zero], axis=-1),
            xp.stack([zero, zero, zero, one], axis=-1),
        ]
        return xp.stack(rows, axis=-2)
    if dof != 6:
        raise ValueError(f"pose must be (...,3) or (...,6), got {pose.shape}")
    x, y, z = pose[..., 0], pose[..., 1], pose[..., 2]
    roll = xp.deg2rad(pose[..., 3])
    yaw = xp.deg2rad(pose[..., 4])
    pitch = xp.deg2rad(pose[..., 5])
    c_y, s_y = xp.cos(yaw), xp.sin(yaw)
    c_r, s_r = xp.cos(roll), xp.sin(roll)
    c_p, s_p = xp.cos(pitch), xp.sin(pitch)
    zero = xp.zeros_like(x)
    one = xp.ones_like(x)
    rows = [
        xp.stack([c_p * c_y, c_y * s_p * s_r - s_y * c_r,
                  -c_y * s_p * c_r - s_y * s_r, x], axis=-1),
        xp.stack([s_y * c_p, s_y * s_p * s_r + c_y * c_r,
                  -s_y * s_p * c_r + c_y * s_r, y], axis=-1),
        xp.stack([s_p, -c_p * s_r, c_p * c_r, z], axis=-1),
        xp.stack([zero, zero, zero, one], axis=-1),
    ]
    return xp.stack(rows, axis=-2)


def tfm_to_pose(tfm: np.ndarray) -> np.ndarray:
    """(..., 4, 4) numpy transforms -> (..., 6) poses [x, y, z, roll, yaw,
    pitch] in degrees, the inverse of pose_to_tfm (ref
    transformation_utils.py:166; coalign_tpu/utils/transforms.py:90). The
    dataset readers' host helper."""
    tfm = np.asarray(tfm)
    yaw = np.rad2deg(np.arctan2(tfm[..., 1, 0], tfm[..., 0, 0]))
    roll = np.rad2deg(np.arctan2(-tfm[..., 2, 1], tfm[..., 2, 2]))
    pitch = np.rad2deg(np.arctan2(
        tfm[..., 2, 0], np.sqrt(tfm[..., 2, 1] ** 2 + tfm[..., 2, 2] ** 2)))
    return np.stack([tfm[..., 0, 3], tfm[..., 1, 3], tfm[..., 2, 3], roll,
                     yaw, pitch], axis=-1)


def inverse_tfm(tfm):
    """Closed-form inverse of rigid (..., 4, 4) transforms."""
    xp = array_namespace(tfm)
    rot_t = xp.swapaxes(tfm[..., :3, :3], -1, -2)
    trans = -matmul_f32(rot_t, tfm[..., :3, 3:4])
    top = xp.concatenate([rot_t, trans], axis=-1)
    bottom = xp.broadcast_to(const(xp, [0.0, 0.0, 0.0, 1.0], tfm),
                             top.shape[:-2] + (1, 4))
    return xp.concatenate([top, bottom], axis=-2)


def x1_to_x2_tfm(pose1, pose2):
    """T_2<-1 from two poses (ref transformation_utils.py x1_to_x2)."""
    return matmul_f32(inverse_tfm(pose_to_tfm(pose2)), pose_to_tfm(pose1))


def get_pairwise_transformation(lidar_poses, agent_mask):
    """Pairwise T_j<-i for all agent pairs.

    lidar_poses (L, 6) or (B, L, 6) degrees; agent_mask (L,) or (B, L) bool.
    Returns (L, L, 4, 4) / (B, L, L, 4, 4) with ``out[i, j] = T_j<-i`` and
    identity for pairs with a padded agent (ref transformation_utils.py:22).
    """
    xp = array_namespace(lidar_poses, agent_mask)
    squeeze = lidar_poses.ndim == 2
    poses = lidar_poses[None] if squeeze else lidar_poses
    mask = agent_mask[None] if squeeze else agent_mask
    t_wx = pose_to_tfm(poses)                          # (B, L, 4, 4)
    t_xw = inverse_tfm(t_wx)
    if xp is np:                                       # [b,i,j] = xw_j wx_i
        out = np.einsum("bjxy,biyz->bijxz", t_xw, t_wx)
    else:
        out = matmul_f32(t_xw[:, None, :], t_wx[:, :, None])
    valid = mask[:, :, None] & mask[:, None, :]
    eye = xp.broadcast_to(const(xp, [[float(r == c) for c in range(4)]
                                     for r in range(4)], out), out.shape)
    out = xp.where(valid[..., None, None], out, eye)
    return out[0] if squeeze else out


def normalize_pairwise_tfm(pairwise_t_matrix, H: int, W: int,
                           discrete_ratio: float, downsample_rate: float = 1.0):
    """(..., 4, 4) metric transforms -> (..., 2, 3) normalized affines for an
    ``align_corners=False`` affine grid over an (H, W) map of
    ``discrete_ratio * downsample_rate`` meter pixels
    (ref transformation_utils.py:69)."""
    xp = array_namespace(pairwise_t_matrix)
    t = pairwise_t_matrix
    a00 = t[..., 0, 0]
    a01 = t[..., 0, 1] * H / W
    a02 = t[..., 0, 3] / (downsample_rate * discrete_ratio * W) * 2
    a10 = t[..., 1, 0] * W / H
    a11 = t[..., 1, 1]
    a12 = t[..., 1, 3] / (downsample_rate * discrete_ratio * H) * 2
    row0 = xp.stack([a00, a01, a02], axis=-1)
    row1 = xp.stack([a10, a11, a12], axis=-1)
    return xp.stack([row0, row1], axis=-2)


def project_points(points, tfm):
    """Apply (..., 4, 4) transforms to (..., N, 3+C) points, keeping the
    extra channels (ref box_utils.py:319)."""
    xp = array_namespace(points, tfm)
    if xp is np:
        new_xyz = (np.einsum("...ij,...nj->...ni", tfm[..., :3, :3],
                             points[..., :3]) + tfm[..., None, :3, 3])
    else:
        rot = tfm[..., None, :3, :3]                   # (..., 1, 3, 3)
        xyz = points[..., None, :3]                    # (..., N, 1, 3)
        new_xyz = (rot * xyz).sum(-1) + tfm[..., None, :3, 3]
    return xp.concatenate([new_xyz, points[..., 3:]], axis=-1)
