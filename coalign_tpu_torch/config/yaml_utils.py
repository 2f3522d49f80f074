"""Hypes yaml loading and saving, with derived-parameter computation.

The port's copy of coalign_tpu/config/yaml_utils.py (ref
opencood/hypes_yaml/yaml_utils.py): the reference's float resolver
(``1e-10``-style floats), its three derived-parameter parsers as an explicit
registry, and ``save_yaml``. Every yaml of the JAX package's hypes_yaml
loads to the same dict in both packages.
"""

from __future__ import annotations

import math
import re

import numpy as np
import yaml

_FLOAT_RESOLVER = re.compile(
    r"""^(?:
     [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)


class _Loader(yaml.SafeLoader):
    pass


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float", _FLOAT_RESOLVER, list("-+0123456789."))


def save_yaml(data: dict, path: str):
    """Dump ``data`` (numpy values as plain python) as a yaml file."""
    with open(path, "w") as f:
        yaml.safe_dump(_to_plain(data), f, default_flow_style=None)


def _to_plain(obj):
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _fill_anchor_grid_args(param: dict) -> dict:
    """The anchor grid's W/H/D and voxel sizes (ref yaml_utils.py:117-137);
    a no-op for anchor-free configs (PIXOR's BevPostprocessor)."""
    if ("voxel_size" not in param["preprocess"].get("args", {})
            or "anchor_args" not in param["postprocess"]):
        return param
    rng = param["preprocess"]["cav_lidar_range"]
    vw, vh, vd = param["preprocess"]["args"]["voxel_size"]
    param["postprocess"]["anchor_args"].update(
        vw=vw, vh=vh, vd=vd,
        W=math.ceil((rng[3] - rng[0]) / vw),
        H=math.ceil((rng[4] - rng[1]) / vh),
        D=math.ceil((rng[5] - rng[2]) / vd))
    return param


def _grid_size(param: dict) -> list:
    rng = param["preprocess"]["cav_lidar_range"]
    voxel_size = param["preprocess"]["args"]["voxel_size"]
    return np.round((np.array(rng[3:6]) - np.array(rng[0:3]))
                    / np.array(voxel_size)).astype(np.int64).tolist()


def load_point_pillar_params(param: dict) -> dict:
    """Grid size and anchor-grid args for PointPillars (ref
    yaml_utils.py:97-137)."""
    param["model"]["args"]["point_pillar_scatter"]["grid_size"] = \
        _grid_size(param)
    return _fill_anchor_grid_args(param)


def load_second_params(param: dict) -> dict:
    """SECOND's derived params (ref yaml_utils.py:140-180): the grid size,
    and the preprocessor's voxel caps handed to the model, which voxelizes
    on the device (ref sp_voxel_preprocessor.py:22, 32000 train / 70000
    test)."""
    param["model"]["args"]["grid_size"] = _grid_size(param)
    for cap in ("max_voxel_train", "max_voxel_test"):
        if cap in param["preprocess"]["args"]:
            param["model"]["args"].setdefault(
                cap, param["preprocess"]["args"][cap])
    return _fill_anchor_grid_args(param)


def load_general_params(param: dict) -> dict:
    """The anchor-grid args only (models that need no other derived
    params)."""
    return _fill_anchor_grid_args(param)


PARSERS = {
    "load_point_pillar_params": load_point_pillar_params,
    "load_second_params": load_second_params,
    "load_general_params": load_general_params,
}


def load_yaml(path: str) -> dict:
    """Load a hypes yaml and apply its declared derived-parameter parser."""
    with open(path, "r") as f:
        param = yaml.load(f, Loader=_Loader)
    parser = param.get("yaml_parser")
    if parser:
        if parser not in PARSERS:
            raise KeyError(f"unknown yaml parser {parser!r}")
        param = PARSERS[parser](param)
    return param
