"""Perspective 3D canvas (host-side, numpy).

Port of coalign_tpu/visualization/canvas_3d.py (ref
opencood/visualization/simple_plot3d/canvas_3d.py): a pinhole camera
projects lidar points and box wireframes onto an image plane, pixel for
pixel as the JAX package's canvas; ``save`` writes it with
data/image_io.write_png.
"""

from __future__ import annotations

import numpy as np

from coalign_tpu_torch.data.image_io import write_png

# the 12 wireframe edges of an 8-corner box (the reference's corner order)
BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]


class Canvas3D:
    def __init__(self, canvas_shape=(600, 800), camera_xyz=(-20, 0, 12),
                 camera_pitch_deg=-20.0, focal=600.0,
                 background=(255, 255, 255), left_hand=False):
        self.h, self.w = canvas_shape
        self.focal = focal
        # ref canvas_3d.py:103: left-handed (CARLA) data flips y first
        self.left_hand = left_hand
        self.canvas = np.full((self.h, self.w, 3),
                              np.asarray(background, np.uint8),
                              dtype=np.uint8)
        p = np.deg2rad(camera_pitch_deg)
        # orthonormal camera basis in lidar coordinates (x forward, y left,
        # z up): the optical axis pitched by p, right = -y, down = forward
        # x right
        forward = np.array([np.cos(p), 0.0, np.sin(p)])
        right = np.array([0.0, -1.0, 0.0])
        down = np.cross(forward, right)
        self.rot = np.stack([right, down, forward])  # rows: x, y, z camera
        self.t = -self.rot @ np.asarray(camera_xyz, dtype=float)

    def project(self, pts):
        """(N, 3) lidar frame -> (rows, cols, valid)."""
        if self.left_hand:
            pts = pts * np.asarray([1.0, -1.0, 1.0])
        cam = pts @ self.rot.T + self.t
        z = cam[:, 2]
        valid = z > 0.5
        zs = np.where(valid, z, 1.0)
        cols = (cam[:, 0] / zs) * self.focal + self.w / 2
        rows = (cam[:, 1] / zs) * self.focal + self.h / 2
        inb = ((cols >= 0) & (cols < self.w) & (rows >= 0) & (rows < self.h))
        return rows.astype(np.int64), cols.astype(np.int64), valid & inb

    def draw_canvas_points(self, pts, color=(90, 90, 90)):
        rows, cols, valid = self.project(np.asarray(pts)[:, :3])
        self.canvas[rows[valid], cols[valid]] = color
        return self

    def draw_boxes(self, corners, color=(0, 180, 0)):
        """corners: (N, 8, 3)."""
        for box in np.asarray(corners):
            rows, cols, valid = self.project(box)
            for i, j in BOX_EDGES:
                if not (valid[i] or valid[j]):
                    continue
                n = int(max(abs(rows[j] - rows[i]),
                            abs(cols[j] - cols[i]), 1)) + 1
                rr = np.linspace(rows[i], rows[j], n).round().astype(int)
                cc = np.linspace(cols[i], cols[j], n).round().astype(int)
                keep = ((rr >= 0) & (rr < self.h)
                        & (cc >= 0) & (cc < self.w))
                self.canvas[rr[keep], cc[keep]] = color
        return self

    def save(self, path):
        write_png(path, self.canvas)
        return path
