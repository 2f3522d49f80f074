"""Synthetic multi-agent driving scenes, the port's copy of
coalign_tpu/data/synthetic.py ``SyntheticScenes``: known gt boxes and
lidar point clouds sampled on box surfaces and the ground, observed by
several agents from different poses; ``SyntheticCameraScenes`` adds each
agent's rendered camera views. For the same arguments they give the same
frames as the JAX package's.

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


def render_agent_cameras(pose, boxes_world, cam_hw=(128, 176), num_cams=4,
                         focal=96.0, seed=0):
    """Pinhole views of the scene's boxes from an agent's camera rig (the
    JAX package's render_agent_cameras, coalign_tpu/data/synthetic.py:
    105-168): each gt box a bright rectangle where the OpenCV projection
    puts its center, sized by 1/depth and shaded by the distance, over
    dark noise, cameras 90 degrees apart in yaw at the agent's pose.

    Returns (cams, imgs): the OPV2V yaml's camera blocks (``camera{i}``:
    cords, intrinsic, extrinsic) and a list of (H, W, 3) float32 images in
    [0, 1]."""
    from coalign_tpu_torch.data.camera_batch import camera_to_lidar_ext

    h, w = cam_hw
    rng = np.random.default_rng(seed)
    intrinsic = np.array([[focal, 0.0, (w - 1) / 2],
                          [0.0, focal, (h - 1) / 2],
                          [0.0, 0.0, 1.0]], dtype=np.float32)
    t_aw = inverse_tfm(pose_to_tfm(np.asarray(pose, np.float64)))
    centers_agent = project_points(boxes_world[:, :3].astype(np.float64),
                                   t_aw)

    cams, imgs = {}, []
    for ci in range(num_cams):
        cords = [float(v) for v in pose]
        cords[4] = float(cords[4] + 90.0 * ci)
        cams[f"camera{ci}"] = {"cords": cords,
                               "intrinsic": intrinsic.tolist(),
                               "extrinsic": np.eye(4).tolist()}
        # T_camera<-agent: the batcher's T_lidar<-camera inverted
        t_ca = np.linalg.inv(camera_to_lidar_ext(cords, pose).astype(
            np.float64))
        p_cam = centers_agent @ t_ca[:3, :3].T + t_ca[:3, 3]

        img = rng.uniform(0.0, 0.08, (h, w, 3)).astype(np.float32)
        for oi in np.argsort(-p_cam[:, 2]):     # far first, near on top
            x, y, z = p_cam[oi]
            if z < 1.0:
                continue
            u = focal * x / z + (w - 1) / 2
            v = focal * y / z + (h - 1) / 2
            half_u = focal * (0.5 * float(boxes_world[oi, 5])) / z
            half_v = focal * (0.5 * float(boxes_world[oi, 3])) / z
            u0, u1 = int(np.floor(u - half_u)), int(np.ceil(u + half_u))
            v0, v1 = int(np.floor(v - half_v)), int(np.ceil(v + half_v))
            if u1 < 0 or v1 < 0 or u0 >= w or v0 >= h:
                continue
            u0, u1 = max(u0, 0), min(u1, w - 1)
            v0, v1 = max(v0, 0), min(v1, h - 1)
            img[v0:v1 + 1, u0:u1 + 1, :] = float(np.clip(1.0 - z / 80.0,
                                                         0.25, 1.0))
        imgs.append(img)
    return cams, imgs


class SyntheticCameraScenes(SyntheticScenes):
    """SyntheticScenes with each agent's rendered camera rig
    (render_agent_cameras): ``cameras`` and ``camera_arrays``, seeded by
    seed * 7919 + idx * 31 + agent, as the JAX package's."""

    def __init__(self, *args, cam_hw=(128, 176), num_cams=4, focal=96.0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.cam_hw = cam_hw
        self.num_cams = num_cams
        self.focal = focal

    def __getitem__(self, idx):
        frame = super().__getitem__(idx)
        boxes = frame["objects"]["boxes"]
        for ai, agent in enumerate(frame["agents"]):
            cams, imgs = render_agent_cameras(
                agent["pose"], boxes, cam_hw=self.cam_hw,
                num_cams=self.num_cams, focal=self.focal,
                seed=self.seed * 7919 + idx * 31 + ai)
            agent["cameras"] = cams
            agent["camera_arrays"] = imgs
        return frame
