"""World-frame training augmentations (flip, rotation, scaling), the port's
copy of coalign_tpu/data/augment.py (ref opencood/data_utils/augmentor/,
yaml block ``data_augment``).

One world transform per frame is applied to every agent's pose, its
own-frame point cloud and the world gt boxes, on the host before padding,
so relative geometry (pairwise transforms) transforms consistently. A flip
is a reflection and cannot ride through the 6-DoF pose composition, so it
is applied as a conjugation: pose [x, y, z, roll, yaw, pitch] ->
[x, -y, z, -roll, -yaw, pitch] and each agent's points mirror y -> -y.
"""

from __future__ import annotations

import numpy as np


class WorldAugmentor:
    """Config-driven frame augmentor with its own ``default_rng(seed)``."""

    def __init__(self, cfg_list=None, seed: int = 303):
        self.flip_x = False
        self.rot_range = None
        self.scale_range = None
        for c in cfg_list or []:
            name = c.get("NAME", c.get("name", ""))
            if name == "random_world_flip":
                axes = [a.lower() for a in c.get("ALONG_AXIS_LIST", ["x"])]
                self.flip_x = "x" in axes
            elif name == "random_world_rotation":
                self.rot_range = c.get("WORLD_ROT_ANGLE",
                                       [-0.78539816, 0.78539816])
            elif name == "random_world_scaling":
                self.scale_range = c.get("WORLD_SCALE_RANGE", [0.95, 1.05])
        self.rng = np.random.default_rng(seed)

    def sample(self):
        flip = self.flip_x and bool(self.rng.integers(0, 2))
        rot = float(self.rng.uniform(*self.rot_range)) if self.rot_range \
            else 0.0
        scale = float(self.rng.uniform(*self.scale_range)) \
            if self.scale_range else 1.0
        return flip, rot, scale

    @staticmethod
    def apply(frame: dict, flip: bool, rot: float, scale: float) -> dict:
        """Apply (flip over x, world-z rotation in radians, uniform scale)
        to a frame."""
        if not (flip or rot or scale != 1.0):
            return frame
        c, s = np.cos(rot), np.sin(rot)
        rot_deg = np.rad2deg(rot)

        agents = []
        for ag in frame["agents"]:
            a = dict(ag)
            p = np.asarray(ag["pose"], dtype=np.float64).copy()
            if flip:
                p = np.array([p[0], -p[1], p[2], -p[3], -p[4], p[5]])
            x, y = p[0] * scale, p[1] * scale
            p[0] = c * x - s * y
            p[1] = s * x + c * y
            p[2] *= scale
            p[4] += rot_deg
            a["pose"] = p.astype(np.float32)
            if "points" in a:
                pts = a["points"].copy()
                if flip:
                    pts[:, 1] = -pts[:, 1]
                pts[:, :3] *= scale
                a["points"] = pts
            agents.append(a)

        boxes = np.asarray(frame["objects"]["boxes"]).copy()
        if len(boxes):
            if flip:
                boxes[:, 1] = -boxes[:, 1]
                boxes[:, 6] = -boxes[:, 6]
            x, y = boxes[:, 0] * scale, boxes[:, 1] * scale
            boxes[:, 0] = c * x - s * y
            boxes[:, 1] = s * x + c * y
            boxes[:, 2] *= scale
            boxes[:, 3:6] *= scale
            boxes[:, 6] += rot
        return {**frame, "agents": agents,
                "objects": {**frame["objects"],
                            "boxes": boxes.astype(np.float32)}}

    def __call__(self, frame: dict) -> dict:
        return self.apply(frame, *self.sample())
