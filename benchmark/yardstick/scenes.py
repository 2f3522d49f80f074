"""Synthetic multi-agent lidar scenes and the host batches made of them.

A frozen copy of coalign_tpu_torch/data/synthetic.py's SyntheticScenes
(gt boxes as hwl world boxes, lidar points sampled on the boxes' side faces
and roofs and on a flat ground at z = -1.9 m, observed by each agent from its
own pose), extended for the benchmark's traffic:
  * the number of agents (the ego and the CAVs within its communication
    range) and of vehicles is drawn per frame from the traffic's ranges;
    with ``cav_range_m`` each CAV's distance is uniform out to that range
    and the vehicles lie around every agent (without it, the CAVs lie in a
    square of +-``agent_spread_m`` and the vehicles around the ego);
  * every agent holds exactly the number of points drawn for it, all of
    them inside its lidar range, so that no side masks or subsamples;
  * a vehicle has a car's silhouette (_surface_points), so that its heading
    shows in its points;
  * the batch is assembled here, as data/batch.py's IntermediateFusionBatcher
    lays it out (agents padded to max_cav, points padded), with the
    pairwise transforms worked out from the (noisy) poses here.
Frame ``idx`` of seed ``s`` draws from ``default_rng([s, 0, idx])`` and the
pose noise of request ``i`` from ``default_rng([s, 1])``, so a seed gives
the same inputs on every machine.
"""

from __future__ import annotations

import numpy as np

from benchmark.yardstick.geometry import (inverse_tfm, pairwise_transforms,
                                          pose_to_tfm)

GROUND_Z = -1.9
OBJECT_Z = -0.6
MIN_OBJECT_GAP_M = 5.5


def _seed(seed: int) -> int:
    return int(seed) % (1 << 64)


# a vehicle's faces (body to 60% of its height, a cabin over its rear 60%
# of length to full height), the share of points each takes: the front,
# the back, the two sides, the roof and bonnet, the windscreen
FACE_SHARE = (0.12, 0.12, 0.25, 0.25, 0.18, 0.08)
BODY = 0.6
CABIN_FRONT = 0.1


def _surface_points(rng, boxes: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Points on the visible faces of each hwl box, ``counts`` of them per
    box. SyntheticScenes samples a box's 4 sides and roof, whose front and
    back look alike, so no detector could tell a vehicle's heading from its
    tail; here the front is a lower bonnet and a windscreen before a cabin
    (a car's silhouette), so the heading shows in the points."""
    owner = np.repeat(np.arange(len(boxes)), counts)
    b = boxes[owner]
    n = len(owner)
    face = rng.choice(len(FACE_SHARE), size=n, p=FACE_SHARE)
    u = rng.uniform(-0.5, 0.5, size=(n, 3))
    # x along the length (front at +0.5), y across, z up from the bottom
    # (0 .. 1 of the height)
    x, y, z = u[:, 0], u[:, 1], u[:, 2] + 0.5
    x = np.where(face == 0, 0.5, np.where(face == 1, -0.5, x))
    y = np.where(face == 2, 0.5, np.where(face == 3, -0.5, y))
    z = np.where(face == 0, z * BODY, z)
    # the sides' silhouette: above the body only over the cabin
    side = (face == 2) | (face == 3)
    z = np.where(side & (z > BODY) & (x > CABIN_FRONT), z - (1 - BODY), z)
    z = np.where(face == 4, np.where(x < CABIN_FRONT, 1.0, BODY), z)
    x = np.where(face == 5, CABIN_FRONT, x)
    z = np.where(face == 5, BODY + (1 - BODY) * (u[:, 2] + 0.5), z)
    lx, ly, lz = x * b[:, 5], y * b[:, 4], (z - 0.5) * b[:, 3]
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    return np.stack([lx * c - ly * s + b[:, 0], lx * s + ly * c + b[:, 1],
                     lz + b[:, 2]], -1)


def _cav_poses(rng, n: int, cav_range: float) -> np.ndarray:
    """(n, 6) poses: the ego at the origin, each CAV at a distance uniform
    in [0, cav_range) from it, in any direction and heading."""
    poses = np.zeros((n, 6))
    d = rng.uniform(0.0, cav_range, n - 1)
    a = rng.uniform(-np.pi, np.pi, n - 1)
    poses[1:, 0], poses[1:, 1] = d * np.cos(a), d * np.sin(a)
    poses[1:, 4] = rng.uniform(-180.0, 180.0, n - 1)
    return poses


def _place_objects(rng, n: int, radius: float,
                   centres: np.ndarray | None = None) -> np.ndarray:
    """Up to ``n`` centres in a disc of ``radius`` around the origin, or
    around one of ``centres`` (k, 2) drawn for each, no two closer than
    MIN_OBJECT_GAP_M (greedy over a fixed number of candidates)."""
    r = radius * np.sqrt(rng.uniform(size=8 * n))
    a = rng.uniform(-np.pi, np.pi, size=8 * n)
    cand = np.stack([r * np.cos(a), r * np.sin(a)], -1)
    if centres is not None:
        cand += centres[rng.integers(0, len(centres), 8 * n)]
    kept = []
    for p in cand:
        if all(np.hypot(*(p - q)) >= MIN_OBJECT_GAP_M for q in kept):
            kept.append(p)
            if len(kept) == n:
                break
    return np.array(kept)


def make_frame(seed: int, idx: int, traffic: dict, lidar_range) -> dict:
    """One scene: {"agents": [{"pose": (6,), "points": (P, 4)}], "boxes":
    (O, 7) world hwl boxes}; agent 0 is the ego at the origin."""
    rng = np.random.default_rng([_seed(seed), 0, idx])
    lo_a, hi_a = traffic["agents"]
    lo_v, hi_v = traffic["vehicles"]
    n_agents = int(rng.integers(lo_a, hi_a + 1))
    n_vehicles = int(rng.integers(lo_v, hi_v + 1))
    if "cav_range_m" in traffic:
        # CAVs at distances uniform out to the communication range, the
        # vehicles in discs around every agent
        poses = _cav_poses(rng, n_agents, traffic["cav_range_m"])
        xy = _place_objects(rng, n_vehicles, traffic["object_radius_m"],
                            poses[:, :2])
    else:
        # CAVs in a square of +-agent_spread_m, the vehicles around the ego
        xy = _place_objects(rng, n_vehicles, traffic["object_radius_m"])
        poses = None
    o = len(xy)
    boxes = np.stack([xy[:, 0], xy[:, 1], np.full(o, OBJECT_Z),
                      rng.uniform(1.4, 1.8, o), rng.uniform(1.5, 2.1, o),
                      rng.uniform(3.5, 4.8, o), rng.uniform(-np.pi, np.pi, o)],
                     -1)
    r = lidar_range
    agents = []
    for a in range(n_agents):
        if poses is not None:
            pose = poses[a]
        else:
            pose = np.zeros(6)
            if a > 0:
                spread = traffic["agent_spread_m"]
                pose[:2] = rng.uniform(-spread, spread, 2)
                pose[4] = rng.uniform(-180.0, 180.0)
        t_aw = inverse_tfm(pose_to_tfm(pose))
        n_pts = int(rng.integers(traffic["points_per_agent"][0],
                                 traffic["points_per_agent"][1] + 1))
        centres = boxes[:, :2] @ t_aw[:2, :2].T + t_aw[:2, 3]
        seen = ((centres[:, 0] > r[0] + 3) & (centres[:, 0] < r[3] - 3)
                & (centres[:, 1] > r[1] + 3) & (centres[:, 1] < r[4] - 3))
        n_obj = int(round(traffic["object_point_share"] * n_pts))
        counts = np.zeros(o, np.int64)
        if seen.any():
            counts[seen] = rng.multinomial(n_obj, np.full(seen.sum(),
                                                          1.0 / seen.sum()))
        world = _surface_points(rng, boxes, counts)
        local = world @ t_aw[:3, :3].T + t_aw[:3, 3]
        inside = ((local[:, 0] >= r[0]) & (local[:, 0] < r[3])
                  & (local[:, 1] >= r[1]) & (local[:, 1] < r[4])
                  & (local[:, 2] >= r[2]) & (local[:, 2] <= r[5]))
        local = local[inside]
        n_ground = n_pts - len(local)
        ground = np.stack([rng.uniform(r[0], r[3], n_ground),
                           rng.uniform(r[1], r[4], n_ground),
                           np.full(n_ground, GROUND_Z)], -1)
        xyz = np.concatenate([local, ground])
        # float32 rounding must not carry a point onto the range's open end
        xyz = np.clip(xyz, r[:3], np.nextafter(np.asarray(r[3:], np.float32),
                                               -np.inf)).astype(np.float32)
        pts = np.concatenate([xyz, rng.uniform(0, 1, (n_pts, 1))], -1)
        agents.append({"pose": pose.astype(np.float32),
                       "points": pts[rng.permutation(n_pts)].astype(
                           np.float32)})
    return {"agents": agents, "boxes": boxes.astype(np.float32)}


def local_boxes(frame: dict, agent: int) -> np.ndarray:
    """The frame's world boxes in ``agent``'s own frame (x, y, z, h, w, l,
    yaw in radians)."""
    pose = frame["agents"][agent]["pose"]
    t_aw = inverse_tfm(pose_to_tfm(pose))
    b = frame["boxes"].astype(np.float64)
    xyz = b[:, :3] @ t_aw[:3, :3].T + t_aw[:3, 3]
    yaw = b[:, 6] - np.deg2rad(pose[4])
    yaw = (yaw + np.pi) % (2 * np.pi) - np.pi
    return np.concatenate([xyz, b[:, 3:6], yaw[:, None]], -1).astype(
        np.float32)


def assemble(frame: dict, max_cav: int, pad_points: int,
             noise: np.ndarray | None = None) -> dict:
    """The B = 1 host batch of ``frame``: points (1, L, N, 4), point_mask
    (1, L, N), agent_mask (1, L), lidar_pose (1, L, 6) (plus ``noise``
    (L, 6) where given) and lidar_pose_clean, pairwise_t_matrix
    (1, L, L, 4, 4) from lidar_pose, transformation_matrix (1, 4, 4)."""
    points = np.zeros((1, max_cav, pad_points, 4), np.float32)
    point_mask = np.zeros((1, max_cav, pad_points), bool)
    agent_mask = np.zeros((1, max_cav), bool)
    clean = np.zeros((1, max_cav, 6), np.float32)
    for a, ag in enumerate(frame["agents"][:max_cav]):
        n = len(ag["points"])
        points[0, a, :n] = ag["points"]
        point_mask[0, a, :n] = True
        agent_mask[0, a] = True
        clean[0, a] = ag["pose"]
    batch = {"points": points, "point_mask": point_mask,
             "agent_mask": agent_mask, "lidar_pose_clean": clean,
             "transformation_matrix": np.eye(4, dtype=np.float32)[None]}
    return with_poses(batch, clean if noise is None
                      else clean + noise[None] * agent_mask[..., None])


def with_poses(batch: dict, poses: np.ndarray) -> dict:
    """``batch`` (sharing its arrays) with lidar_pose ``poses`` (1, L, 6)
    and the pairwise transforms made from them."""
    out = dict(batch)
    out["lidar_pose"] = poses.astype(np.float32)
    out["pairwise_t_matrix"] = pairwise_transforms(out["lidar_pose"],
                                                   batch["agent_mask"])
    return out


def noise_table(seed: int, draws: int, max_cav: int, pos_std: float,
                rot_std: float) -> np.ndarray:
    """(draws, L, 6) Gaussian pose noise, x and y at ``pos_std`` metres and
    yaw at ``rot_std`` degrees, none on the ego (slot 0), as the yaml's
    noise_setting adds it (ref pose_utils.py generate_noise)."""
    rng = np.random.default_rng([_seed(seed), 1])
    out = np.zeros((draws, max_cav, 6), np.float32)
    out[:, 1:, 0:2] = rng.normal(0.0, pos_std, (draws, max_cav - 1, 2))
    out[:, 1:, 4] = rng.normal(0.0, rot_std, (draws, max_cav - 1))
    return out
