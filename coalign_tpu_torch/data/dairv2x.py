"""DAIR-V2X-C on-disk dataset reader (real-world vehicle + infrastructure).

Port of coalign_tpu/data/dairv2x.py (ref opencood/data_utils/datasets/
basedataset/dairv2x_basedataset.py): exactly two agents a frame, the
vehicle (always the ego) and one roadside infrastructure unit. Poses are
composed from the calibration jsons: lidar -> novatel -> world for the
vehicle, virtuallidar -> world plus the frame's ``system_error_offset`` for
the infrastructure (ref transformation_utils.py:455-489). The cooperative
label is world-frame ``world_8_points`` corner lists (ref
box_utils.project_world_objects_dairv2x:1064); each side's own label is in
its own lidar frame (``single_boxes``). Only the vehicle lists the
cooperative objects as visible. DAIR has no stable object ids, so the ids
are sequential.

Frames follow data/synthetic.py's contract. With ``native`` (the default)
a frame's two clouds are parsed in the C++ data plane's threads
(native.parse_pcd_batch), with ``native=False`` in numpy (data/pcd_io.py).
"""

from __future__ import annotations

import json
import os

import numpy as np

from coalign_tpu_torch import native as _native
from coalign_tpu_torch.data.pcd_io import read_pcd
from coalign_tpu_torch.utils.box_utils import corner_to_center
from coalign_tpu_torch.utils.transforms import tfm_to_pose


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _rt_to_tfm(rotation, translation) -> np.ndarray:
    t = np.eye(4, dtype=np.float64)
    t[:3, :3] = np.asarray(rotation, dtype=np.float64)
    t[:3, 3] = np.asarray(translation, dtype=np.float64).reshape(3)
    return t


def veh_lidar_pose(lidar_to_novatel: dict, novatel_to_world: dict):
    """T_world<-lidar of the vehicle (ref transformation_utils.py:455)."""
    a2b = _rt_to_tfm(lidar_to_novatel["transform"]["rotation"],
                     lidar_to_novatel["transform"]["translation"])
    b2c = _rt_to_tfm(novatel_to_world["rotation"],
                     novatel_to_world["translation"])
    return b2c @ a2b


def inf_lidar_pose(virtuallidar_to_world: dict, offset: dict):
    """T_world<-virtuallidar with the system error offset added to x and y
    (ref transformation_utils.py:469)."""
    t = _rt_to_tfm(virtuallidar_to_world["rotation"],
                   virtuallidar_to_world["translation"])
    t[0, 3] += offset.get("delta_x", 0.0)
    t[1, 3] += offset.get("delta_y", 0.0)
    return t


def world_corners_to_boxes(object_list):
    """The cooperative label, a list of {'world_8_points': (8, 3)} ->
    (world hwl boxes (N, 7) float32, sequential ids (N,))."""
    if not object_list:
        return np.zeros((0, 7), np.float32), np.zeros((0,), np.int64)
    corners = np.stack([np.asarray(o["world_8_points"], dtype=np.float64)
                        for o in object_list])
    boxes = np.asarray(corner_to_center(corners, "hwl"), dtype=np.float32)
    return boxes, np.arange(len(boxes), dtype=np.int64)


def single_label_to_boxes(object_list):
    """A side's own label, a list of {'3d_dimensions', '3d_location',
    'rotation'} in its lidar frame -> (N, 7) hwl boxes."""
    boxes = []
    for o in object_list:
        d, p = o["3d_dimensions"], o["3d_location"]
        boxes.append([p["x"], p["y"], p["z"], d["h"], d["w"], d["l"],
                      o["rotation"]])
    if not boxes:
        return np.zeros((0, 7), np.float32)
    return np.asarray(boxes, dtype=np.float32)


class DAIRV2XBaseDataset:
    """Serves frames from a DAIR-V2X-C root (``data_dir``) and a split json
    (the yaml's ``root_dir`` / ``validate_dir``). ``use_complemented_label``
    reads ``label_world`` (the complemented annotation), else
    ``label_world_backup`` (ref dairv2x_basedataset.py:118-153)."""

    def __init__(self, data_dir: str, split_json: str, train: bool = True,
                 load_lidar: bool = True, use_complemented_label: bool = True,
                 native: bool = True):
        self.root = data_dir
        self.train = train
        self.load_lidar = load_lidar
        self.native = native
        self.label_sub = ("label_world" if use_complemented_label
                          else "label_world_backup")
        self.split_info = _read_json(split_json)
        co = _read_json(os.path.join(data_dir, "cooperative/data_info.json"))
        self.co_data = {
            os.path.basename(fi["vehicle_image_path"]).replace(".jpg", ""): fi
            for fi in co}

    def __len__(self):
        return len(self.split_info)

    def _json(self, rel: str):
        return _read_json(os.path.join(self.root, rel))

    def __getitem__(self, idx):
        veh_id = self.split_info[idx]
        info = self.co_data[veh_id]
        inf_id = os.path.basename(info["infrastructure_image_path"]).replace(
            ".jpg", "")
        t_wv = veh_lidar_pose(
            self._json(f"vehicle-side/calib/lidar_to_novatel/{veh_id}.json"),
            self._json(f"vehicle-side/calib/novatel_to_world/{veh_id}.json"))
        t_wi = inf_lidar_pose(
            self._json("infrastructure-side/calib/virtuallidar_to_world/"
                       f"{inf_id}.json"),
            info.get("system_error_offset", {}))

        label_path = info["cooperative_label_path"]
        if self.label_sub == "label_world_backup":
            label_path = label_path.replace("label_world",
                                            "label_world_backup")
        boxes_w, ids = world_corners_to_boxes(self._json(label_path))

        sides = [(t_wv, veh_id, "vehicle-side", "label/lidar",
                  "vehicle_pointcloud_path"),
                 (t_wi, inf_id, "infrastructure-side", "label/virtuallidar",
                  "infrastructure_pointcloud_path")]
        if self.load_lidar:
            paths = [os.path.join(self.root, info[key])
                     for *_, key in sides]
            clouds = ([c.copy() for c in _native.parse_pcd_batch(paths)]
                      if self.native else [read_pcd(p) for p in paths])
        agents = []
        for ai, (t, frame_id, side, lbl_dir, _) in enumerate(sides):
            agent = {"pose": np.asarray(tfm_to_pose(t), dtype=np.float32),
                     "cav_id": str(ai),
                     "visible_ids": ids if ai == 0 else
                     np.zeros((0,), np.int64)}
            lbl = os.path.join(self.root, side, lbl_dir, f"{frame_id}.json")
            if os.path.exists(lbl):
                agent["single_boxes"] = single_label_to_boxes(
                    _read_json(lbl))
            if self.load_lidar:
                agent["points"] = clouds[ai]
            agents.append(agent)
        return {"agents": agents,
                "objects": {"boxes": boxes_w, "ids": ids},
                "frame_id": veh_id}
