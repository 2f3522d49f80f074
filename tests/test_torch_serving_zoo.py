"""One small model of each family beside the flagship through the serving
artifact, on the CPU: export_inference, then load_artifact, gives the direct
make_infer_fn's detections (atol 1e-6, as tests/test_torch_serving.py holds
the flagship).

  * second_sparse  second_intermediate on the sparse 3D backbone (its
                   active-site tables fixed at max_voxels rows);
  * fpvrcnn        FPV-RCNN: FPS's fixed loop, the ball query's fixed
                   chunks, the two-stage decode's NMS;
  * lss            the LSS intermediate model (ResNet-101 trunk, att
                   fusion): camera inputs nest in the contract as
                   image_inputs/<key>;
  * pixor          pixor_intermediate's dense decode.

The models are the port's at the family tests' small widths, with weights
drawn from a seed; each score threshold keeps at least two boxes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from coalign_tpu_torch.inference import make_infer_fn
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
from coalign_tpu_torch.serving import export_inference, load_artifact

import test_torch_fpvrcnn as FPV
import test_torch_lss as LSS
import test_torch_pixor as PIXOR
import test_torch_second as SECOND
from test_torch_lss_train import ANCHORS as LSS_ANCHORS

torch.set_num_threads(2)


def _second():
    cfg = {"core_method": "second_intermediate", "args": SECOND._args({
        "fusion_method": "att", "backbone_3d": {
            "num_features_out": 16, "sparse": True, "max_voxels": 512}})}
    anchors = generate_anchor_box(
        {"W": 32, "H": 32, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
         "vw": 0.8, "vh": 0.8, "feature_stride": 8,
         "cav_lidar_range": SECOND.LR})
    post = {"target_args": {"score_threshold": 0.3}, "nms_thresh": 0.15,
            "gt_range": SECOND.LR, "dir_args": SECOND.DIR_ARGS}
    return cfg, SECOND._batch(b=1), anchors, post


def _fpvrcnn():
    post = {"target_args": {"score_threshold": 0.2}, "nms_thresh": 0.15,
            "gt_range": FPV.LIDAR_RANGE}
    return (FPV.CONFIGS["fpvrcnn"], FPV.make_batch(),
            generate_anchor_box(FPV.ANCHOR_ARGS), post)


def _lss():
    core, extra, _ = LSS.MODELS["intermediate_att"]
    batch = LSS.camera_batch(b=1, l=2, n=2, seed=3)
    batch["transformation_matrix"] = np.eye(4, dtype=np.float32)[None]
    post = {"target_args": {"score_threshold": 0.01}, "nms_thresh": 0.15,
            "gt_range": LSS_ANCHORS["cav_lidar_range"],
            "dir_args": LSS.DIR_ARGS}
    return ({"core_method": core, "args": LSS.lss_args(extra)}, batch,
            generate_anchor_box(LSS_ANCHORS), post)


def _pixor():
    post = {"target_args": {"score_threshold": 0.01}, "nms_thresh": 0.15,
            "gt_range": PIXOR.LR}
    return PIXOR._cfg("pixor_intermediate"), PIXOR._batch(frames=1), \
        PIXOR.DSPEC, post


CASES = {"second_sparse": _second, "fpvrcnn": _fpvrcnn, "lss": _lss,
         "pixor": _pixor}


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_exports_and_reloads_to_the_direct_detections(case,
                                                             tmp_path):
    cfg, batch, anchors, post = CASES[case]()
    model = build_model(cfg, device="cpu", seed=0)
    want = make_infer_fn(model, anchors, post, device="cpu")(batch)
    assert want["mask"].sum() >= 2, int(want["mask"].sum())
    out = export_inference(model, batch, anchors, post,
                           str(tmp_path / case), platforms=("cpu",))
    got = load_artifact(out, device="cpu")(batch)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
