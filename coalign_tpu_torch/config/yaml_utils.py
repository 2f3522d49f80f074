"""Hypes yaml loading for the ported models.

The subset of coalign_tpu/config/yaml_utils.py (ref
opencood/hypes_yaml/yaml_utils.py) that the PointPillars configs need: the
reference's float resolver (``1e-10``-style floats) and the
``load_point_pillar_params`` derived-parameter parser.
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


def load_point_pillar_params(param: dict) -> dict:
    """Grid size and anchor-grid args (ref yaml_utils.py:97-137)."""
    rng = param["preprocess"]["cav_lidar_range"]
    voxel_size = param["preprocess"]["args"]["voxel_size"]
    grid_size = np.round((np.array(rng[3:6]) - np.array(rng[0:3]))
                         / np.array(voxel_size)).astype(np.int64)
    param["model"]["args"]["point_pillar_scatter"]["grid_size"] = \
        grid_size.tolist()
    anchor_args = param["postprocess"]["anchor_args"]
    vw, vh, vd = voxel_size
    anchor_args.update(
        vw=vw, vh=vh, vd=vd,
        W=math.ceil((rng[3] - rng[0]) / vw),
        H=math.ceil((rng[4] - rng[1]) / vh),
        D=math.ceil((rng[5] - rng[2]) / vd))
    return param


PARSERS = {"load_point_pillar_params": load_point_pillar_params}


def load_yaml(path: str) -> dict:
    """Load a hypes yaml and apply its declared derived-parameter parser."""
    with open(path, "r") as f:
        param = yaml.load(f, Loader=_Loader)
    parser = param.get("yaml_parser")
    if parser:
        if parser not in PARSERS:
            raise KeyError(f"yaml parser {parser!r} is not ported")
        param = PARSERS[parser](param)
    return param
