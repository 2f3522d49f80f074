"""Poses, transforms and the anchor grid, in numpy, for the inputs the
benchmark hands to both the program and the reference.

Frozen copies of coalign_tpu_torch/utils/transforms.py (pose_to_tfm,
inverse_tfm, get_pairwise_transformation: the reference's
transformation_utils.py conventions) and postprocess/anchors.py
(generate_anchor_box), so that the yardstick does not move with the
program.
"""

from __future__ import annotations

import math

import numpy as np


def pose_to_tfm(pose: np.ndarray) -> np.ndarray:
    """(..., 6) [x, y, z, roll, yaw, pitch] in degrees -> (..., 4, 4)
    T_world<-agent (ref transformation_utils.py x_to_world)."""
    pose = np.asarray(pose, np.float64)
    x, y, z = pose[..., 0], pose[..., 1], pose[..., 2]
    roll, yaw, pitch = (np.deg2rad(pose[..., i]) for i in (3, 4, 5))
    c_y, s_y = np.cos(yaw), np.sin(yaw)
    c_r, s_r = np.cos(roll), np.sin(roll)
    c_p, s_p = np.cos(pitch), np.sin(pitch)
    zero, one = np.zeros_like(x), np.ones_like(x)
    rows = [
        np.stack([c_p * c_y, c_y * s_p * s_r - s_y * c_r,
                  -c_y * s_p * c_r - s_y * s_r, x], -1),
        np.stack([s_y * c_p, s_y * s_p * s_r + c_y * c_r,
                  -s_y * s_p * c_r + c_y * s_r, y], -1),
        np.stack([s_p, -c_p * s_r, c_p * c_r, z], -1),
        np.stack([zero, zero, zero, one], -1)]
    return np.stack(rows, -2)


def inverse_tfm(tfm: np.ndarray) -> np.ndarray:
    """Closed-form inverse of rigid (..., 4, 4) transforms."""
    rot_t = np.swapaxes(tfm[..., :3, :3], -1, -2)
    out = np.zeros_like(tfm)
    out[..., :3, :3] = rot_t
    out[..., :3, 3] = -(rot_t @ tfm[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def pairwise_transforms(poses: np.ndarray, agent_mask: np.ndarray):
    """(B, L, 6) poses, (B, L) mask -> (B, L, L, 4, 4) float32 with
    ``out[b, i, j] = T_j<-i``, the identity where either agent is padded
    (ref transformation_utils.py get_pairwise_transformation)."""
    t_wx = pose_to_tfm(poses)
    t_xw = inverse_tfm(t_wx)
    out = np.einsum("bjxy,biyz->bijxz", t_xw, t_wx)
    valid = agent_mask[:, :, None] & agent_mask[:, None, :]
    out = np.where(valid[..., None, None], out, np.eye(4))
    return out.astype(np.float32)


def anchor_grid(anchor_args: dict) -> np.ndarray:
    """(H/s, W/s, A, 7) float32 'hwl' anchors (ref
    voxel_postprocessor.py generate_anchor_box)."""
    w_px, h_px = anchor_args["W"], anchor_args["H"]
    rng = anchor_args["cav_lidar_range"]
    stride = anchor_args.get("feature_stride", 2)
    vw, vh = anchor_args["vw"], anchor_args["vh"]
    yaws = [math.radians(r) for r in anchor_args["r"]]
    x = np.linspace(rng[0] + vw, rng[3] - vw, w_px // stride)
    y = np.linspace(rng[1] + vh, rng[4] - vh, h_px // stride)
    cx, cy = np.meshgrid(x, y)
    shape = cx.shape + (len(yaws),)
    cx = np.broadcast_to(cx[..., None], shape)
    cy = np.broadcast_to(cy[..., None], shape)
    anchors = np.stack([cx, cy, np.full(shape, -1.0),
                        np.full(shape, anchor_args["h"]),
                        np.full(shape, anchor_args["w"]),
                        np.full(shape, anchor_args["l"]),
                        np.broadcast_to(np.array(yaws), shape)], -1)
    return anchors.astype(np.float32)

