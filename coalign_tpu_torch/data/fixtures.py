"""Write synthetic scenes to disk in the real OPV2V layout.

The port's copy of coalign_tpu/data/fixtures.py ``write_opv2v_fixture``. The
reference ships no test fixtures; this writes a miniature but
format-faithful OPV2V root (``<scenario>/<cav>/<ts>.yaml|.pcd``) from
data/synthetic.SyntheticScenes, so that the on-disk reader (data/opv2v.py)
is tested against a known oracle without the 100+ GB dataset.
"""

from __future__ import annotations

import os

import numpy as np
import yaml

from coalign_tpu_torch.data.pcd_io import write_pcd


def write_opv2v_fixture(root: str, scenes, frames_per_scenario: int = 4,
                        rsu_last: bool = False, with_cameras: bool = False):
    """Materialize ``scenes`` (SyntheticScenes or a list of frames) under
    ``root`` in the OPV2V on-disk layout. Returns the root path.

    Every agent sees every object (synthetic scenes have no occlusion), so
    each cav yaml lists all objects, as an OPV2V cav yaml lists the
    vehicles around it. With ``rsu_last`` the last agent of a frame (not
    the ego) is written as an RSU, under a negative id."""
    if with_cameras:
        raise NotImplementedError(
            "camera fixtures come with the LSS camera family (ROADMAP item 7)")
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
                with open(os.path.join(cav_dir, ts + ".yaml"), "w") as f:
                    yaml.safe_dump(params, f)
                write_pcd(os.path.join(cav_dir, ts + ".pcd"),
                          agent["points"])
    return root
