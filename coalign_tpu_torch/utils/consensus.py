"""Grid-search 2D registration consensus (robust fusion experiments).

Port of coalign_tpu/utils/consensus.py (ref opencood/utils/
max_consensus.py): the whole (dx, dy, dyaw) candidate grid is scored in one
vectorized pass, each candidate transform applied to every source keypoint
at once and scored by the source points that land within ``radius`` of a
target point.
"""

from __future__ import annotations

import math

import torch


def max_consensus_align(src, src_mask, dst, dst_mask,
                        xy_span=2.0, xy_steps=9, yaw_span_deg=4.0,
                        yaw_steps=9, radius=0.5):
    """The (dx, dy, dyaw) grid candidate with the most point consensus.

    src (N, 2), dst (M, 2) BEV keypoints with bool masks, on one device.
    Returns (best (3,) [dx, dy, yaw in radians], score: a 0-dim int64
    tensor). Ties go to the first candidate in (dx, dy, dyaw) order."""
    kw = dict(dtype=src.dtype, device=src.device)
    dx = torch.linspace(-xy_span, xy_span, xy_steps, **kw)
    dy = torch.linspace(-xy_span, xy_span, xy_steps, **kw)
    dyaw = torch.linspace(-yaw_span_deg, yaw_span_deg, yaw_steps, **kw) \
        * (math.pi / 180.0)
    gx, gy, gyaw = torch.meshgrid(dx, dy, dyaw, indexing="ij")
    cand = torch.stack([gx.reshape(-1), gy.reshape(-1), gyaw.reshape(-1)],
                       dim=-1)                                  # (C, 3)

    c, s = torch.cos(cand[:, 2]), torch.sin(cand[:, 2])
    rx = src[None, :, 0] * c[:, None] - src[None, :, 1] * s[:, None]
    ry = src[None, :, 0] * s[:, None] + src[None, :, 1] * c[:, None]
    moved = torch.stack([rx + cand[:, 0:1], ry + cand[:, 1:2]], -1)

    d2 = ((moved[:, :, None, :] - dst[None, None, :, :]) ** 2).sum(-1)
    d2 = torch.where(dst_mask[None, None, :], d2, math.inf)
    nearest = d2.min(dim=-1).values                             # (C, N)
    hits = (nearest < radius ** 2) & src_mask[None, :]
    scores = hits.sum(-1)
    best = torch.argmax(scores)
    return cand[best], scores[best]
