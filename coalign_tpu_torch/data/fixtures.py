"""Write synthetic scenes to disk in the real OPV2V layout.

The port's copy of coalign_tpu/data/fixtures.py. The reference ships no
test fixtures; these write miniature but format-faithful trees from
data/synthetic.SyntheticScenes, so that the on-disk readers are tested
against a known oracle without the datasets: an OPV2V root
(``<scenario>/<cav>/<ts>.yaml|.pcd``, and ``<ts>_camera{i}.png`` with
cameras, data/opv2v.py), a V2X-Sim info
pickle with ``.bin`` scans (data/v2xsim.py) and a DAIR-V2X-C root with its
split json (data/dairv2x.py).
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import yaml

from coalign_tpu_torch.data.image_io import write_png
from coalign_tpu_torch.data.pcd_io import write_pcd
from coalign_tpu_torch.utils.box_utils import boxes_to_corners_3d
from coalign_tpu_torch.utils.transforms import pose_to_tfm


def write_opv2v_fixture(root: str, scenes, frames_per_scenario: int = 4,
                        rsu_last: bool = False, with_cameras: bool = False,
                        cam_hw=(120, 160)):
    """Materialize ``scenes`` (SyntheticScenes or a list of frames) under
    ``root`` in the OPV2V on-disk layout. Returns the root path.

    Every agent sees every object (synthetic scenes have no occlusion), so
    each cav yaml lists all objects, as an OPV2V cav yaml lists the
    vehicles around it. With ``rsu_last`` the last agent of a frame (not
    the ego) is written as an RSU, under a negative id. With
    ``with_cameras`` each agent gets 4 cameras at its pose, 90 degrees apart
    in yaw (``camera{i}`` blocks in its yaml, focal length the width), and
    a ``<ts>_camera{i}.png`` of ``cam_hw`` seeded noise each, written by
    data/image_io.write_png: the JAX package's fixture, pixel for pixel."""
    n = len(scenes)
    n_scen = max(1, n // frames_per_scenario)
    for si in range(n_scen):
        scen_dir = os.path.join(root, f"scenario_{si:04d}")
        for fi in range(frames_per_scenario):
            idx = si * frames_per_scenario + fi
            if idx >= n:
                break
            frame = scenes[idx]
            ts = f"{idx:06d}"
            vehicles = {}
            for b, oid in zip(frame["objects"]["boxes"],
                              frame["objects"]["ids"]):
                x, y, z, h, w, l, yaw = [float(v) for v in b]
                vehicles[int(oid)] = {
                    "location": [x, y, z],
                    "center": [0.0, 0.0, 0.0],
                    "angle": [0.0, float(np.rad2deg(yaw)), 0.0],
                    "extent": [l / 2, w / 2, h / 2],
                }
            for ai, agent in enumerate(frame["agents"]):
                # the ego must sort first; a trailing RSU gets a negative id
                # (ref opv2v_basedataset.py:99-103)
                is_rsu = rsu_last and ai == len(frame["agents"]) - 1 and ai > 0
                cav_id = f"-{ai + 1}" if is_rsu else f"{ai + 1:03d}"
                cav_dir = os.path.join(scen_dir, cav_id)
                os.makedirs(cav_dir, exist_ok=True)
                params = {
                    "lidar_pose": [float(v) for v in agent["pose"]],
                    "true_ego_pos": [float(v) for v in agent["pose"]],
                    "ego_speed": 0.0,
                    "vehicles": vehicles,
                }
                if with_cameras:
                    params.update(_write_cameras(cav_dir, ts, agent["pose"],
                                                 cam_hw, idx * 31 + ai * 7))
                with open(os.path.join(cav_dir, ts + ".yaml"), "w") as f:
                    yaml.safe_dump(params, f)
                write_pcd(os.path.join(cav_dir, ts + ".pcd"),
                          agent["points"])
    return root


def _write_cameras(cav_dir: str, ts: str, pose, cam_hw, seed: int) -> dict:
    """Write an agent's 4 camera PNGs; their yaml blocks."""
    h, w = cam_hw
    blocks = {}
    for ci in range(4):
        cords = [float(v) for v in pose]
        cords[4] = float(cords[4] + 90.0 * ci)
        blocks[f"camera{ci}"] = {
            "cords": cords,
            "intrinsic": [[w, 0.0, (w - 1) / 2], [0.0, w, (h - 1) / 2],
                          [0.0, 0.0, 1.0]],
            "extrinsic": np.eye(4).tolist(),
        }
        img = np.random.default_rng(seed + ci).integers(0, 255, (h, w, 3),
                                                        dtype=np.uint8)
        write_png(os.path.join(cav_dir, f"{ts}_camera{ci}.png"), img)
    return blocks


def _yaw_to_quat(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def write_v2xsim_fixture(path: str, scenes) -> str:
    """Materialize ``scenes`` as a V2X-Sim info pickle at ``path``, the
    agents' (N, 5) float32 ``.bin`` scans beside it. Returns ``path``."""
    root = os.path.dirname(os.path.abspath(path))
    infos = []
    for idx in range(len(scenes)):
        frame = scenes[idx]
        boxes = frame["objects"]["boxes"]                # world hwl
        gt = np.zeros((len(boxes), 10), dtype=np.float64)
        gt[:, :3] = boxes[:, :3]
        gt[:, 3] = boxes[:, 5]                           # dx = l
        gt[:, 4] = boxes[:, 4]                           # dy = w
        gt[:, 5] = boxes[:, 3]                           # dz = h
        for i, b in enumerate(boxes):
            gt[i, 6:10] = _yaw_to_quat(b[6])
        info = {"agent_num": len(frame["agents"])}
        for ai, agent in enumerate(frame["agents"]):
            cav = ai + 1
            pts = agent["points"]
            scan = np.zeros((len(pts), 5), dtype=np.float32)
            scan[:, :4] = pts
            rel = f"lidar_{idx:04d}_{cav}.bin"
            scan.tofile(os.path.join(root, rel))
            info[f"lidar_path_{cav}"] = rel
            info[f"lidar_pose_{cav}"] = np.asarray(
                pose_to_tfm(agent["pose"]), dtype=np.float64)
            info[f"labels_{cav}"] = {
                "gt_boxes_global": gt,
                "gt_object_ids": np.asarray(frame["objects"]["ids"]),
            }
        infos.append(info)
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return path


def write_dairv2x_fixture(root: str, scenes) -> str:
    """Materialize scenes of at least 2 agents (the first two are the
    vehicle and the infrastructure) in the DAIR-V2X-C layout under
    ``root``, the ``data_dir``. Returns the split json's path. The
    vehicle's pose is written as an identity lidar -> novatel and its pose
    as novatel -> world; the system error offsets are 0; the sides' own
    labels are empty."""
    def jdump(rel, obj):
        p = os.path.join(root, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "w") as f:
            json.dump(obj, f)

    data_info, split = [], []
    for idx in range(len(scenes)):
        frame = scenes[idx]
        if len(frame["agents"]) < 2:
            raise ValueError("a DAIR-V2X frame needs 2 agents")
        veh, inf = frame["agents"][0], frame["agents"][1]
        fid = f"{idx:06d}"
        split.append(fid)

        t_wv = np.asarray(pose_to_tfm(veh["pose"]), dtype=np.float64)
        t_wi = np.asarray(pose_to_tfm(inf["pose"]), dtype=np.float64)
        jdump(f"vehicle-side/calib/lidar_to_novatel/{fid}.json",
              {"transform": {"rotation": np.eye(3).tolist(),
                             "translation": [[0.0], [0.0], [0.0]]}})
        jdump(f"vehicle-side/calib/novatel_to_world/{fid}.json",
              {"rotation": t_wv[:3, :3].tolist(),
               "translation": t_wv[:3, 3:4].tolist()})
        jdump(f"infrastructure-side/calib/virtuallidar_to_world/{fid}.json",
              {"rotation": t_wi[:3, :3].tolist(),
               "translation": t_wi[:3, 3:4].tolist()})

        corners = np.asarray(boxes_to_corners_3d(frame["objects"]["boxes"],
                                                 "hwl"))
        coop = [{"world_8_points": c.tolist(), "type": "car"}
                for c in corners]
        jdump(f"cooperative/label_world/{fid}.json", coop)
        jdump(f"cooperative/label_world_backup/{fid}.json", coop)
        jdump(f"vehicle-side/label/lidar/{fid}.json", [])
        jdump(f"infrastructure-side/label/virtuallidar/{fid}.json", [])

        for side, agent in (("vehicle-side", veh),
                            ("infrastructure-side", inf)):
            pdir = os.path.join(root, side, "velodyne")
            os.makedirs(pdir, exist_ok=True)
            write_pcd(os.path.join(pdir, fid + ".pcd"), agent["points"])

        data_info.append({
            "vehicle_image_path": f"vehicle-side/image/{fid}.jpg",
            "infrastructure_image_path":
                f"infrastructure-side/image/{fid}.jpg",
            "vehicle_pointcloud_path": f"vehicle-side/velodyne/{fid}.pcd",
            "infrastructure_pointcloud_path":
                f"infrastructure-side/velodyne/{fid}.pcd",
            "cooperative_label_path": f"cooperative/label_world/{fid}.json",
            "system_error_offset": {"delta_x": 0.0, "delta_y": 0.0},
        })
    jdump("cooperative/data_info.json", data_info)
    split_path = os.path.join(root, "split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    return split_path
