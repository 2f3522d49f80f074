"""Synthetic multi-agent driving scenes, the port's copy of
coalign_tpu/data/synthetic.py ``SyntheticScenes`` (lidar only): known gt
boxes and lidar point clouds sampled on box surfaces and the ground,
observed by several agents from different poses. For the same arguments it
gives the same frames as the JAX package's.

Frame structure (ref opv2v_basedataset.py retrieve_base_data):
  {"agents": [{"pose": (6,) world pose in degrees,
               "points": (P_i, 4) lidar in the agent's own frame}, ...],
   "objects": {"boxes": (O, 7) world-frame hwl boxes, "ids": (O,) int}}
with agent 0 the ego.
"""

from __future__ import annotations

import numpy as np

from coalign_tpu_torch.utils.transforms import (inverse_tfm, pose_to_tfm,
                                                project_points)


def _sample_box_surface(rng, box, n):
    """Sample lidar-ish points on the 4 side faces and the roof of an hwl
    box."""
    x, y, z, h, w, l, yaw = box
    u = rng.uniform(-0.5, 0.5, size=(n, 2))
    face = rng.integers(0, 5, size=n)
    px = np.where(face == 0, 0.5, np.where(face == 1, -0.5, u[:, 0]))
    py = np.where(face == 2, 0.5, np.where(face == 3, -0.5, u[:, 1]))
    pz = np.where(face == 4, 0.5, rng.uniform(-0.5, 0.5, size=n))
    pts = np.stack([px * l, py * w, pz * h], axis=-1)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return pts @ rot.T + np.array([x, y, z])


class SyntheticScenes:
    """Deterministic generator of multi-agent scenes: frame ``idx`` draws
    from ``np.random.default_rng(seed * 100003 + idx)``."""

    def __init__(self, num_frames=32, num_agents=3, num_objects=8,
                 lidar_range=(-40, -40, -3, 40, 40, 1),
                 points_per_object=160, ground_points=1024, seed=0,
                 agent_spread=15.0, object_spread=0.75):
        self.num_frames = num_frames
        self.num_agents = num_agents
        self.num_objects = num_objects
        self.lidar_range = lidar_range
        self.points_per_object = points_per_object
        self.ground_points = ground_points
        self.seed = seed
        self.agent_spread = agent_spread
        self.object_spread = object_spread

    def __len__(self):
        return self.num_frames

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        r = self.lidar_range
        span_x = (r[3] - r[0]) * 0.5 * self.object_spread
        span_y = (r[4] - r[1]) * 0.5 * self.object_spread

        boxes = np.zeros((self.num_objects, 7), dtype=np.float32)
        boxes[:, 0] = rng.uniform(-span_x, span_x, self.num_objects)
        boxes[:, 1] = rng.uniform(-span_y, span_y, self.num_objects)
        boxes[:, 2] = -0.6
        boxes[:, 3] = rng.uniform(1.4, 1.8, self.num_objects)   # h
        boxes[:, 4] = rng.uniform(1.5, 2.1, self.num_objects)   # w
        boxes[:, 5] = rng.uniform(3.5, 4.8, self.num_objects)   # l
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, self.num_objects)
        ids = np.arange(self.num_objects)

        agents = []
        for a in range(self.num_agents):
            pose = np.zeros(6, dtype=np.float32)
            if a > 0:
                pose[0] = rng.uniform(-self.agent_spread, self.agent_spread)
                pose[1] = rng.uniform(-self.agent_spread, self.agent_spread)
                pose[4] = rng.uniform(-180, 180)
            t_aw = inverse_tfm(pose_to_tfm(pose))           # world -> agent

            obj_pts = np.concatenate([
                _sample_box_surface(rng, b, self.points_per_object)
                for b in boxes])
            gx = rng.uniform(r[0] * 0.9, r[3] * 0.9, self.ground_points)
            gy = rng.uniform(r[1] * 0.9, r[4] * 0.9, self.ground_points)
            ground = np.stack(
                [gx, gy, np.full(self.ground_points, -1.9)], axis=-1)
            world_pts = np.concatenate([obj_pts, ground]).astype(np.float32)
            local = project_points(world_pts, t_aw)
            intensity = rng.uniform(0, 1, (local.shape[0], 1)).astype(
                np.float32)
            pts = np.concatenate([local, intensity], axis=-1)
            # per-agent dropout simulates occlusion and partial views
            keep = rng.uniform(size=len(pts)) > 0.3
            agents.append({"pose": pose, "points": pts[keep]})

        return {"agents": agents,
                "objects": {"boxes": boxes, "ids": ids}}
