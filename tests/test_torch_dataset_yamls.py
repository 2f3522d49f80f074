"""Every yaml of hypes_yaml/dairv2x/ and v2xsim/ through the port's
tools/run.py on the CPU: each whose model the port has trains a step (one
epoch of 2 frames) and infers (the end-of-train eval, a frame, through the
yaml's fusion protocol; run inference of a run directory is
tests/test_torch_dairv2x_v2xsim.py's) on a fixture tree that the port's
writers wrote, the yaml cut to +-4.8 m (tests/test_torch_dairv2x_v2xsim.py's
_cut_yaml); precalc.yaml writes the stage-1 json of each split; fpvrcnn.yaml
and fvoxelrcnn.yaml raise, naming ROADMAP item 8.
"""

import glob
import os

import numpy as np
import pytest
import torch

from coalign_tpu_torch.tools import run

from chip_smoke import HYPES_ROOT
from test_torch_dairv2x_v2xsim import CPU, _cut_yaml, cut_trees  # noqa: F401

torch.set_num_threads(1)
TWO_STAGE = ("fpvrcnn", "fvoxelrcnn")


YAMLS = sorted(os.path.relpath(p, HYPES_ROOT) for folder in ("dairv2x",
                                                               "v2xsim")
               for p in glob.glob(os.path.join(HYPES_ROOT, folder, "*.yaml")))


@pytest.mark.parametrize("rel", YAMLS)
def test_yaml_trains_and_infers(rel, cut_trees, tmp_path):
    name = os.path.basename(rel)[:-len(".yaml")]
    path, params = _cut_yaml(tmp_path, rel, cut_trees)
    if name in TWO_STAGE:
        with pytest.raises(NotImplementedError, match="item 8"):
            run.main(["train", "-y", path, *CPU])
        return
    if name == "precalc":
        written = run.main(["precalc", "-y", path, *CPU])
        assert [os.path.basename(os.path.dirname(p)) for p in written] == [
            "train", "val"]
        return
    model_dir = str(tmp_path / "run")
    model, res = run.main(["train", "-y", path, "--model_dir", model_dir,
                           "--epochs", "1", "--eval_frames", "1", *CPU])
    assert res["frames"] == 1 and np.isfinite(res["ap30"])
    assert os.path.exists(os.path.join(model_dir, "net_epoch1.pth"))
