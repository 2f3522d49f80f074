"""Every yaml of hypes_yaml/dairv2x/ and v2xsim/, and the six
hypes_yaml/opv2v/lss_*.yaml on a camera fixture tree, through the port's
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


# the six OPV2V LSS camera yamls, cut to a +-8 m BEV of 0.4 m cells, 8 LID
# depth bins, 64 x 96 images and 16 image channels
LSS_YAMLS = sorted(os.path.basename(p)[:-len(".yaml")] for p in glob.glob(
    os.path.join(HYPES_ROOT, "opv2v", "lss_*.yaml")))
LSS_CUT = [-8.0, -8.0, -3.0, 8.0, 8.0, 1.0]


def cut_lss_yaml(tmp_path, name: str, tree: str) -> tuple:
    """hypes_yaml/opv2v/``name``.yaml cut to LSS_CUT on the camera fixture
    ``tree``: 2 frames a batch of 2 agents, or of the ego alone for the
    late-fusion (single-agent) yamls: the camera batcher gives a frame all
    its agents whatever the fusion, in both packages, so the single-agent
    model's (B*L) maps meet (B) labels unless L is 1 (ROADMAP section 3).
    Returns (path, params)."""
    from coalign_tpu_torch.config.yaml_utils import load_yaml
    import yaml
    params = load_yaml(os.path.join(HYPES_ROOT, "opv2v", f"{name}.yaml"))
    params.update(root_dir=tree, validate_dir=tree, test_dir=None)
    late = params["fusion"]["core_method"] == "late"
    params["train_params"].update(batch_size=2, epoches=1,
                                  max_cav=1 if late else 2)
    params["preprocess"]["cav_lidar_range"] = LSS_CUT
    params["postprocess"]["gt_range"] = LSS_CUT
    params["postprocess"]["anchor_args"]["cav_lidar_range"] = LSS_CUT
    args = params["model"]["args"]
    args["grid_conf"].update(xbound=[-8, 8, 0.4], ybound=[-8, 8, 0.4],
                             ddiscr=[2, 10, 8])
    args["data_aug_conf"]["final_dim"] = [64, 96]
    args["img_features"] = 16
    path = str(tmp_path / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(params, f)
    return path, params


@pytest.fixture(scope="module")
def camera_tree(tmp_path_factory):
    """An OPV2V camera fixture tree written by the port: 2 frames of 2
    agents, 4 cameras each of 64 x 96."""
    from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    scenes = SyntheticScenes(num_frames=2, num_agents=2, num_objects=3,
                             lidar_range=LSS_CUT, points_per_object=16,
                             ground_points=32, seed=3)
    return write_opv2v_fixture(str(tmp_path_factory.mktemp("cams")), scenes,
                               frames_per_scenario=2, with_cameras=True,
                               cam_hw=(64, 96))


@pytest.mark.parametrize("name", LSS_YAMLS)
def test_lss_yaml_trains_and_infers(name, camera_tree, tmp_path):
    """Each LSS yaml trains an epoch (a B=2 step) on the camera tree and
    infers a frame through its fusion protocol (late for the single-agent
    ones)."""
    assert len(LSS_YAMLS) == 6
    path, params = cut_lss_yaml(tmp_path, name, camera_tree)
    model_dir = str(tmp_path / "run")
    model, res = run.main(["train", "-y", path, "--model_dir", model_dir,
                           "--epochs", "1", "--eval_frames", "1", *CPU])
    assert res["frames"] == 1 and np.isfinite(res["ap30"])
    assert os.path.exists(os.path.join(model_dir, "net_epoch1.pth"))
    assert type(model).__name__ == (
        "LiftSplatShoot" if params["fusion"]["core_method"] == "late"
        else "LiftSplatShootIntermediate")
