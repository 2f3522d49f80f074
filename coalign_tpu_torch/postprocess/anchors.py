"""Anchor grid generation (ref voxel_postprocessor.py:30 generate_anchor_box),
ported from coalign_tpu/postprocess/anchors.py. Host numpy."""

from __future__ import annotations

import math

import numpy as np


def generate_anchor_box(anchor_args: dict, order: str = "hwl") -> np.ndarray:
    """(H/s, W/s, A, 7) float32 anchor grid.

    anchor_args needs W, H (full-resolution grid), l, w, h, r (degree list),
    cav_lidar_range, vw, vh and optionally feature_stride (default 2).
    """
    W, H = anchor_args["W"], anchor_args["H"]
    l, w, h = anchor_args["l"], anchor_args["w"], anchor_args["h"]
    r = [math.radians(x) for x in anchor_args["r"]]
    num = len(r)
    vw, vh = anchor_args["vw"], anchor_args["vh"]
    rng = anchor_args["cav_lidar_range"]
    stride = anchor_args.get("feature_stride", 2)

    x = np.linspace(rng[0] + vw, rng[3] - vw, W // stride)
    y = np.linspace(rng[1] + vh, rng[4] - vh, H // stride)
    cx, cy = np.meshgrid(x, y)
    cx = np.tile(cx[..., None], num)
    cy = np.tile(cy[..., None], num)
    cz = np.full_like(cx, -1.0)
    ws = np.full_like(cx, w)
    ls = np.full_like(cx, l)
    hs = np.full_like(cx, h)
    rs = np.stack([np.full_like(cx[..., 0], ri) for ri in r], axis=-1)
    if order == "hwl":
        anchors = np.stack([cx, cy, cz, hs, ws, ls, rs], axis=-1)
    elif order == "lhw":
        anchors = np.stack([cx, cy, cz, ls, hs, ws, rs], axis=-1)
    else:
        raise ValueError(f"unknown order {order}")
    return anchors.astype(np.float32)
