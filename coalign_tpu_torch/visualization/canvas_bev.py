"""Bird's-eye-view canvas (host-side, numpy).

Port of coalign_tpu/visualization/canvas_bev.py (ref
opencood/visualization/simple_plot3d/canvas_bev.py:13 Canvas_BEV, heading
right as Canvas_BEV_heading_right :259): points rasterize as pixels and
boxes as polylines straight into a uint8 RGB array, pixel for pixel as the
JAX package's canvas; ``save`` writes it with data/image_io.write_png.
"""

from __future__ import annotations

import numpy as np

from coalign_tpu_torch.data.image_io import write_png


class CanvasBEV:
    """Rasterize lidar points and boxes into an RGB BEV image.

    canvas_shape: (H, W) pixels; x (forward) maps to image columns, y (left)
    to rows, heading right like the reference's inference renderer.
    ``left_hand`` negates y before rasterizing (ref canvas_bev.py:77): the
    CARLA-derived datasets (OPV2V, V2XSet) are left-handed, so their renders
    flip to read like KITTI."""

    def __init__(self, canvas_shape=(800, 2800),
                 canvas_x_range=(-140.8, 140.8), canvas_y_range=(-40, 40),
                 background=(255, 255, 255), left_hand=False):
        self.h, self.w = canvas_shape
        self.x_range = canvas_x_range
        self.y_range = canvas_y_range
        self.left_hand = left_hand
        self.canvas = np.full((self.h, self.w, 3),
                              np.asarray(background, np.uint8),
                              dtype=np.uint8)

    def get_canvas_coords(self, xy):
        """Metric (N, 2+) -> (rows, cols, valid_mask)."""
        xy = np.asarray(xy)
        if self.left_hand:
            xy = np.concatenate([xy[:, :1], -xy[:, 1:2]], axis=1)
        cols = ((xy[:, 0] - self.x_range[0])
                / (self.x_range[1] - self.x_range[0]) * self.w)
        rows = ((xy[:, 1] - self.y_range[0])
                / (self.y_range[1] - self.y_range[0]) * self.h)
        cols = np.floor(cols).astype(np.int64)
        rows = np.floor(rows).astype(np.int64)
        valid = ((cols >= 0) & (cols < self.w)
                 & (rows >= 0) & (rows < self.h))
        return rows, cols, valid

    def draw_canvas_points(self, xy, radius=0, color=(80, 80, 80)):
        rows, cols, valid = self.get_canvas_coords(xy)
        rows, cols = rows[valid], cols[valid]
        for dr in range(-radius, radius + 1):
            for dc in range(-radius, radius + 1):
                rr = np.clip(rows + dr, 0, self.h - 1)
                cc = np.clip(cols + dc, 0, self.w - 1)
                self.canvas[rr, cc] = color
        return self

    def _line(self, r0, c0, r1, c1, color):
        n = int(max(abs(r1 - r0), abs(c1 - c0), 1)) + 1
        rr = np.linspace(r0, r1, n).round().astype(np.int64)
        cc = np.linspace(c0, c1, n).round().astype(np.int64)
        keep = (rr >= 0) & (rr < self.h) & (cc >= 0) & (cc < self.w)
        self.canvas[rr[keep], cc[keep]] = color
        return self

    def draw_boxes(self, corners, color=(0, 180, 0), thickness=1):
        """corners: (N, 8, 3) or (N, 4, 2) box corners (the BEV footprint is
        drawn)."""
        corners = np.asarray(corners)
        if corners.ndim == 3 and corners.shape[1] == 8:
            corners = corners[:, :4, :2]
        for box in corners:
            rows, cols, _ = self.get_canvas_coords(box)
            for i in range(4):
                j = (i + 1) % 4
                for t in range(thickness):
                    self._line(rows[i] + t, cols[i], rows[j] + t, cols[j],
                               color)
        return self

    def save(self, path):
        write_png(path, self.canvas)
        return path
