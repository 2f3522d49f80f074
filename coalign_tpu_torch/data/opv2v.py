"""OPV2V / V2XSet on-disk dataset readers.

The port's copy of coalign_tpu/data/opv2v.py (ref opencood/data_utils/
datasets/basedataset/opv2v_basedataset.py). The directory scan and the
per-frame file IO stay on the host (this is pure IO); the reader emits the
frame contract of data/synthetic.py, a list of agents (ego first) plus
world-frame objects, so batching, voxelization and labels happen downstream
as for synthetic scenes.

On-disk layout (ref opv2v_basedataset.py:76-165):
  root/scenario_xx/cav_id/{timestamp}.yaml|.pcd|_cameraN.png
RSU ids are negative and are never ego; ego = first cav in sorted order.
Per-timestamp yaml keys used: ``lidar_pose`` (6-DoF [x,y,z,roll,yaw,pitch]
degrees), ``vehicles: {id: {location, center, angle, extent(half l,w,h)}}``,
``cameraN: {extrinsic, intrinsic, cords}``.

Frame contract:
  {"agents": [{"pose": (6,), "points": (P,4), "cav_id": str,
               "visible_ids": (Vi,) int, ["cameras": {...}]}],
   "objects": {"boxes": (O,7) world hwl, "ids": (O,) int}}

With ``native`` (the default, as the JAX package's where its library
builds) a frame's point clouds parse together in C++ threads
(native.parse_pcd_batch, data/opv2v.py:251-253 of the JAX package); with
``native=False`` one at a time in numpy (data/pcd_io.py). Both read the same
values.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import yaml

from coalign_tpu_torch import native as _native
from coalign_tpu_torch.data.pcd_io import read_pcd
from coalign_tpu_torch.utils.box_utils import corner_to_center
from coalign_tpu_torch.utils.transforms import pose_to_tfm

# libyaml's C loader when available: the cav yamls are the reader's hot
# parse (the pure-python scanner takes ~60 ms a frame of 5 agents); the
# resolver is extended like config/yaml_utils._Loader so that dot-less
# floats (1e-10) still parse as floats.
try:
    _CavLoader = type("_CavLoader", (yaml.CSafeLoader,), {})
except AttributeError:  # pragma: no cover - pyyaml built without libyaml
    _CavLoader = type("_CavLoader", (yaml.SafeLoader,), {})
_CavLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""", re.X),
    list("-+0123456789."))


def _load_params(path: str) -> dict:
    """A cav yaml's params, from its ``.json`` side file when there is one
    (ref opv2v_basedataset.py:202)."""
    json_path = path[:-5] + ".json"
    if os.path.exists(json_path):
        with open(json_path) as f:
            return json.load(f)
    with open(path) as f:
        return yaml.load(f, Loader=_CavLoader)


def precache_json(root_dir: str) -> int:
    """Write ``<ts>.json`` beside every cav ``<ts>.yaml`` under an OPV2V
    root, so that _load_params takes its json path (json.load reads cav
    params ~10x faster than libyaml). Returns the number of files
    written."""
    n = 0
    for dirpath, _, files in os.walk(root_dir):
        for name in files:
            if not name.endswith(".yaml"):
                continue
            path = os.path.join(dirpath, name)
            json_path = path[:-5] + ".json"
            if os.path.exists(json_path):
                continue
            with open(path) as f:
                params = yaml.load(f, Loader=_CavLoader)
            with open(json_path, "w") as f:
                json.dump(params, f)
            n += 1
    return n


def vehicles_to_world_boxes(vehicles: dict):
    """An OPV2V yaml's ``vehicles`` dict -> world-frame hwl boxes (O, 7)
    float32 and ids (O,) int64.

    As ref box_utils.project_world_objects:451: the object pose is location
    plus the center offset; the corners of the half extent [l/2, w/2, h/2]
    are rotated by the full (roll, yaw, pitch) pose; corner_to_center
    flattens them to a yaw-only box (OPV2V objects are level, so the
    flattening is exact in practice)."""
    if not vehicles:
        return (np.zeros((0, 7), dtype=np.float32),
                np.zeros((0,), dtype=np.int64))
    ids, poses, extents = [], [], []
    for vid, v in vehicles.items():
        loc = np.asarray(v["location"], dtype=np.float64)
        center = np.asarray(v.get("center", [0, 0, 0]), dtype=np.float64)
        ang = np.asarray(v["angle"], dtype=np.float64)  # [roll, yaw, pitch]
        ids.append(int(vid))
        poses.append(np.array([loc[0] + center[0], loc[1] + center[1],
                               loc[2] + center[2], ang[0], ang[1], ang[2]]))
        extents.append(np.asarray(v["extent"], dtype=np.float64))
    poses = np.stack(poses)          # (O, 6)
    extents = np.stack(extents)      # (O, 3) half l, w, h
    # unit corners scaled by the half extent, in the vertex order of the
    # reference's create_bbx (box_utils.py:414)
    unit = np.array([[1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
                     [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1]],
                    dtype=np.float64)
    corners_obj = unit[None] * extents[:, None, :]              # (O, 8, 3)
    t_wo = pose_to_tfm(poses)                                   # (O, 4, 4)
    corners_w = (corners_obj @ t_wo[:, :3, :3].transpose(0, 2, 1)
                 + t_wo[:, None, :3, 3])
    boxes_w = np.asarray(corner_to_center(corners_w, "hwl"), dtype=np.float32)
    return boxes_w, np.asarray(ids, dtype=np.int64)


class OPV2VBaseDataset:
    """Scans an OPV2V-layout root and serves frames by index.

    ``max_cav`` cuts each scenario's agents; ``shuffle_cavs`` (train only)
    reorders them at every ``reinitialize`` with ``default_rng(seed)``, the
    ego staying a vehicle; ``cache_frames`` keeps parsed frames in host
    memory, so epochs after the first read no file (treated read-only
    downstream; off with ``shuffle_cavs``, whose reinitialize re-reads the
    tree); ``load_camera`` adds each agent's camera parameters and image
    paths (the images themselves are read by the camera family, ROADMAP
    item 7); ``native`` parses a frame's clouds in the C++ data plane's
    threads, ``native=False`` in numpy."""

    label_key = "vehicles"

    def __init__(self, root_dir: str, train: bool = True, max_cav: int = 5,
                 load_lidar: bool = True, load_camera: bool = False,
                 shuffle_cavs: bool = False, seed: int = 303,
                 cache_frames: bool = False, native: bool = True):
        self.root_dir = root_dir
        self.native = native
        self.train = train
        self.max_cav = max_cav
        self.load_lidar = load_lidar
        self.load_camera = load_camera
        self.shuffle_cavs = shuffle_cavs and train
        self.cache_frames = cache_frames and not self.shuffle_cavs
        self._frame_cache: dict = {}
        self.rng = np.random.default_rng(seed)
        self.scenario_folders = sorted(
            os.path.join(root_dir, x) for x in os.listdir(root_dir)
            if os.path.isdir(os.path.join(root_dir, x)))
        if not self.scenario_folders:
            raise FileNotFoundError(f"no scenario folders under {root_dir}")
        self.reinitialize()

    def reinitialize(self):
        """(Re)build the scenario database; a train loop calls it every
        epoch to reshuffle the agents, as ref train.py:171 does."""
        self._frame_cache.clear()  # the agent order may change
        self.scenarios = []     # (cav_list, {cav: path}, timestamps)
        self.len_record = []
        total = 0
        for folder in self.scenario_folders:
            cav_list = sorted(x for x in os.listdir(folder)
                              if os.path.isdir(os.path.join(folder, x)))
            if not cav_list:
                raise FileNotFoundError(f"no cav folders under {folder}")
            if self.shuffle_cavs:
                self.rng.shuffle(cav_list)
            # RSUs (negative ids) are never the ego (ref :99-103)
            if int(cav_list[0]) < 0:
                cav_list = cav_list[1:] + [cav_list[0]]
            cav_list = cav_list[:self.max_cav]

            db = {}
            timestamps = None
            for cav_id in cav_list:
                cav_path = os.path.join(folder, cav_id)
                ts = sorted(x[:-5] for x in os.listdir(cav_path)
                            if x.endswith(".yaml")
                            and "additional" not in x
                            and "_" not in x)
                db[cav_id] = cav_path
                if timestamps is None:
                    timestamps = ts
            self.scenarios.append((cav_list, db, timestamps))
            total += len(timestamps)
            self.len_record.append(total)

    def __len__(self):
        return self.len_record[-1]

    def _locate(self, idx):
        prev = 0
        for si, upto in enumerate(self.len_record):
            if idx < upto:
                return si, idx - prev
            prev = upto
        raise IndexError(idx)

    def _camera_params(self, params: dict):
        cams = {}
        for i in range(4):
            key = f"camera{i}"
            if key in params:
                cams[key] = {
                    "extrinsic": np.asarray(params[key]["extrinsic"],
                                            dtype=np.float32),
                    "intrinsic": np.asarray(params[key]["intrinsic"],
                                            dtype=np.float32),
                    "cords": np.asarray(params[key].get("cords", [0] * 6),
                                        dtype=np.float32),
                }
        return cams

    def __getitem__(self, idx):
        if self.cache_frames:
            hit = self._frame_cache.get(idx)
            if hit is not None:
                return hit
        frame = self._read_frame(idx)
        if self.cache_frames:
            self._frame_cache[idx] = frame
        return frame

    def _read_frame(self, idx):
        si, ti = self._locate(idx)
        cav_list, db, timestamps = self.scenarios[si]
        ts = timestamps[ti]

        agents = []
        all_boxes, all_ids = [], []
        seen = set()
        if self.load_lidar and self.native:
            # a copy each, so that a frame holds no view of the shared buffer
            clouds = [c.copy() for c in _native.parse_pcd_batch(
                [os.path.join(db[c], ts + ".pcd") for c in cav_list])]
        for ci, cav_id in enumerate(cav_list):
            cav_path = db[cav_id]
            params = _load_params(os.path.join(cav_path, ts + ".yaml"))
            boxes, ids = vehicles_to_world_boxes(
                params.get(self.label_key, {}))
            agent = {"pose": np.asarray(params["lidar_pose"],
                                        dtype=np.float32),
                     "cav_id": cav_id, "visible_ids": ids}
            if self.load_lidar:
                agent["points"] = (clouds[ci] if self.native else read_pcd(
                    os.path.join(cav_path, ts + ".pcd")))
            if self.load_camera:
                agent["cameras"] = self._camera_params(params)
                agent["camera_files"] = [
                    os.path.join(cav_path, f"{ts}_camera{i}.png")
                    for i in range(4)]
            agents.append(agent)
            # fused gt = union over agents, deduplicated by id, the ego's
            # first (ref intermediate_fusion_dataset.py:390-400)
            for b, oid in zip(boxes, ids):
                if int(oid) not in seen:
                    seen.add(int(oid))
                    all_boxes.append(b)
                    all_ids.append(int(oid))

        objects = {
            "boxes": (np.stack(all_boxes).astype(np.float32)
                      if all_boxes else np.zeros((0, 7), np.float32)),
            "ids": np.asarray(all_ids, dtype=np.int64),
        }
        return {"agents": agents, "objects": objects,
                "scenario": si, "timestamp": ts}


class V2XSETBaseDataset(OPV2VBaseDataset):
    """V2XSet uses the OPV2V layout verbatim (ref v2xset_basedataset.py)."""
