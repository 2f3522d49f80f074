"""The PyTorch port's config loading and bandwidth accounting against the
JAX package's.

  * every hypes yaml of the JAX package loads to the same dict through the
    port's load_yaml (one case a yaml): the float resolver and the three
    derived-parameter parsers;
  * save_yaml writes the JAX save_yaml's file, numpy values included, and
    it loads back to what was saved;
  * frame_comm_bytes and summarize_bandwidth give the JAX package's numbers
    for every fusion mode, and for the intermediate fusion of every yaml
    whose model the port has (the port's class of each, built without
    weights, against the JAX class), exactly (the same float64 sums); nan
    in both for the LSS camera models.
"""

import glob
import math
import os

import numpy as np
import pytest
import torch

from coalign_tpu.config import yaml_utils as JY
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.utils import bandwidth as JBW
from coalign_tpu_torch.config.yaml_utils import load_yaml, save_yaml
from coalign_tpu_torch.models.zoo import _MODELS
from coalign_tpu_torch.utils import bandwidth as TBW

HYPES = os.path.join(os.path.dirname(__file__), "..", "coalign_tpu",
                     "hypes_yaml")
ALL_YAMLS = sorted(glob.glob(os.path.join(HYPES, "**", "*.yaml"),
                             recursive=True))
PORTED_YAMLS = [p for p in ALL_YAMLS
                if JY.load_yaml(p)["model"]["core_method"] in _MODELS]


def _yaml_id(path):
    return os.path.relpath(path, HYPES)


def test_the_zoo_has_every_yaml():
    assert len(ALL_YAMLS) == 72
    # 37 until the port took Where2comm, MASH and robust V2VNet's 7 yamls,
    # 44 until it took the SECOND family's 15, 59 until it took PIXOR's
    # pixor_intermediate.yaml, 60 until it took the six LSS camera yamls
    assert len(PORTED_YAMLS) == 66


@pytest.mark.parametrize("path", ALL_YAMLS, ids=_yaml_id)
def test_load_yaml_matches_jax(path):
    got, want = load_yaml(path), JY.load_yaml(path)
    assert got == want
    if "anchor_args" in want["postprocess"] and \
            "voxel_size" in want["preprocess"].get("args", {}):
        assert {"W", "H", "D", "vw", "vh", "vd"} <= set(
            got["postprocess"]["anchor_args"])


def test_save_yaml_roundtrip_matches_jax(tmp_path):
    params = load_yaml(os.path.join(HYPES, "opv2v", "pointpillar_coalign.yaml"))
    params["extra"] = {"array": np.arange(3, dtype=np.int64),
                       "float": np.float32(0.25), "int": np.int64(7),
                       "tuple": (1.5, 2)}
    got, want = str(tmp_path / "port.yaml"), str(tmp_path / "jax.yaml")
    save_yaml(params, got)
    JY.save_yaml(params, want)
    with open(got) as f, open(want) as g:
        assert f.read() == g.read()
    back = load_yaml(got)
    assert back["extra"] == {"array": [0, 1, 2], "float": 0.25, "int": 7,
                             "tuple": [1.5, 2]}
    params.pop("extra")
    back.pop("extra")
    assert back == params


AGENT_MASK = np.array([[True, True, True, False], [True, True, False, False]])


def _batch():
    pm = np.zeros((2, 4, 16), bool)
    pm[:, :, :9] = True
    return {"agent_mask": AGENT_MASK, "point_mask": pm}


def test_bandwidth_of_the_modes_without_a_model():
    batch = _batch()
    cases = [("early", dict(batch, shipped_points=np.array([100.0, 37.0]))),
             ("early", batch)]
    cases += [(mode, batch) for mode in ("late", "no", "no_w_uncertainty",
                                         "single")]
    for mode, b in cases:
        for max_num in (100, 50):
            got = TBW.frame_comm_bytes(mode, b, max_num=max_num)
            assert got == JBW.frame_comm_bytes(mode, b, max_num=max_num)
            assert got > 0
    assert math.isnan(TBW.frame_comm_bytes("late", {}))
    assert math.isnan(TBW.frame_comm_bytes("intermediate", batch,
                                           model=object()))
    for total, frames in ((3.5e6, 4), (0.0, 2), (1e6, 0), (float("nan"), 3)):
        assert TBW.summarize_bandwidth(total, frames) == \
            JBW.summarize_bandwidth(total, frames)


@pytest.mark.parametrize("path", PORTED_YAMLS, ids=_yaml_id)
def test_intermediate_bandwidth_matches_jax(path):
    params = load_yaml(path)
    cfg = params["model"]
    with torch.device("meta"):  # the class and its args, no weights
        model = _MODELS[cfg["core_method"]](cfg["args"])
    jax_model = jax_build_model(JY.load_yaml(path)["model"])
    batch = _batch()
    for comm_rate in (None, np.array([0.25, 0.5])):
        got = TBW.frame_comm_bytes("intermediate", batch, model=model,
                                   comm_rate=comm_rate)
        want = JBW.frame_comm_bytes("intermediate", batch, model=jax_model,
                                    comm_rate=comm_rate)
        if "grid_conf" in cfg["args"]:
            # the LSS camera models: both packages count no lidar feature
            # map for them (no lidar_range), nan
            assert math.isnan(got) and math.isnan(want)
            continue
        assert got == want and got > 0
        assert TBW.summarize_bandwidth(got, 2) == \
            JBW.summarize_bandwidth(want, 2)


def test_the_coalign_alias_counts_single_scale_in_both():
    """The class-name quirk both packages share (ROADMAP §3): the flagship
    built as point_pillar_coalign (class CoAlign) is counted as one
    single-scale map, as point_pillar_baseline_multiscale is not."""
    cfg = load_yaml(os.path.join(HYPES, "opv2v",
                                 "pointpillar_coalign.yaml"))["model"]
    batch = _batch()
    counts = {}
    for name in ("point_pillar_baseline_multiscale", "point_pillar_coalign"):
        with torch.device("meta"):
            model = _MODELS[name](cfg["args"])
        jax_model = jax_build_model(dict(cfg, core_method=name))
        counts[name] = TBW.frame_comm_bytes("intermediate", batch, model=model)
        assert counts[name] == JBW.frame_comm_bytes("intermediate", batch,
                                                    model=jax_model)
    assert counts["point_pillar_coalign"] != \
        counts["point_pillar_baseline_multiscale"]
