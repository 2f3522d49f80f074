"""One training step of the port's collaborative LSS model against the JAX
package's, on the CPU, at tests/test_lss.py's tiny sizes.

lss_selfatt.yaml's model (lift_splat_shoot_intermediate, single-scale att
fusion, supervise_single, the EfficientNet encoder frozen in training) cut
to 64 x 96 images and a 40 x 40 BEV, with seeded weights and norms, takes
one step of the yaml's point_pillar_loss and AdamW (lr 0.002, eps 1e-10,
weight decay 1e-4), held as tests/test_torch_baselines_train.py holds the
baselines' steps (float64: the loss terms within 1e-9, each gradient within
1e-7 of its tensor's largest, the settled parameters after the step within
1e-9; float32 within tests/test_torch_train.py's bounds; the JAX package's
float32 pins, its upsample's lerp weights among them, patched to float64
for its step). Beyond those:

  * the frozen encoder's gradient is exactly 0 (its outputs detached, as
    the JAX package's stop_gradient), so AdamW moves it only by its weight
    decay, p (1 - lr wd);
  * the single-agent heads' gradient is exactly 0: no loss reads the
    ``*_single`` outputs (make_train_step gives unreached parameters a
    zero gradient, as JAX's are).

The multiscale fusion (lss_coalign_fusion.yaml's att_ms): the JAX
package's jitted float64 step of it, under the float32 pins patched to
float64, drifts from its own eager forward (its loss terms by ~5e-4
relative), so its step is held against the JAX step computed eagerly
(``jax.disable_jit()``), whose loss terms equal the eager forward's
(ROADMAP §3 fault 15), at the same bounds: test_att_ms_train_step_matches_
jax_eager, with the ResNet-101 camera encoder (frozen in both, as the
EfficientNet one is) and one camera an agent, which keep the eager JAX
step to ~2 minutes (the EfficientNet one takes ~4: most of it compiling
each primitive).
"""

import types

import jax
import numpy as np
import torch

from coalign_tpu.models import camera_trunks as JTRUNKS
from coalign_tpu_torch.config.yaml_utils import load_yaml
from coalign_tpu_torch.postprocess.anchors import make_anchor_spec

from chip_smoke import HYPES
from test_torch_baselines_train import hold_step, port_step
from test_torch_lss import R101, MODELS, camera_batch, seeded_lss_pair

torch.set_num_threads(4)
ANCHORS = {"W": 40, "H": 40, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
           "vw": 0.4, "vh": 0.4, "feature_stride": 2,
           "cav_lidar_range": [-8, -8, -3, 8, 8, 1]}
TARGETS = {"pos_threshold": 0.3, "neg_threshold": 0.2}


def test_intermediate_train_step_matches_jax(monkeypatch):
    y = load_yaml(f"{HYPES}/lss_selfatt.yaml")
    assert y["model"]["args"]["fusion_args"]["core_method"] == "att"
    assert y["model"]["args"]["supervise_single"]
    MODELS["selfatt"] = ("lift_splat_shoot_intermediate", {
        "supervise_single": True,
        "fusion_args": {"core_method": "att", "att": {"feat_dim": 64}}}, 2)
    batch = camera_batch(b=1, l=2, n=2, seed=12)
    # seeded boxes: exact anchor-IoU ties, which the JAX package's jitted
    # and eager label assignments break differently (ROADMAP section 3),
    # do not occur on them
    rng = np.random.default_rng(13)
    batch["gt_boxes"] = np.zeros((1, 4, 7), np.float32)
    batch["gt_boxes"][0, :3] = np.concatenate([
        rng.uniform(-6, 6, (3, 2)), np.full((3, 1), -0.6),
        rng.uniform([1.4, 1.5, 3.5], [1.8, 2.1, 4.8], (3, 3)),
        rng.uniform(-np.pi, np.pi, (3, 1))], axis=1)
    batch["gt_mask"] = np.array([[True, True, True, False]])
    jmodel, variables, model = seeded_lss_pair("selfatt", batch, key=3)
    # the JAX package's corner-aligned upsample builds its lerp weights as
    # float32 numpy matrices (camera_trunks.py:54-89); for its float64 step
    # they are float64, as F.interpolate's are
    np64 = types.ModuleType("numpy")
    np64.__dict__.update(vars(np))
    np64.float32 = np.float64
    monkeypatch.setattr(JTRUNKS, "np", np64)
    hold_step(monkeypatch, jmodel, variables, model, batch, y["loss"],
              ANCHORS, TARGETS, y["optimizer"], frozen=("camencode.",))
    _, grads, params = port_step(model, batch, y["loss"],
                                 make_anchor_spec(ANCHORS, TARGETS),
                                 y["optimizer"], torch.float64)
    lr, wd = y["optimizer"]["lr"], y["optimizer"]["args"]["weight_decay"]
    before = {k: p.detach().double() for k, p in model.named_parameters()}
    frozen = [k for k in grads if k.startswith("camencode.")]
    single = [k for k in grads if "_before_fusion" in k]
    assert len(frozen) > 200 and len(single) == 6
    for key in frozen + single:
        assert not grads[key].any(), key
    for key in frozen:
        torch.testing.assert_close(params[key], before[key] * (1 - lr * wd),
                                   rtol=1e-12, atol=0, msg=key)


def _seeded_gt(batch: dict) -> dict:
    """Three seeded gt boxes in 4 slots (no exact anchor-IoU ties, ROADMAP
    section 3)."""
    rng = np.random.default_rng(13)
    batch["gt_boxes"] = np.zeros((1, 4, 7), np.float32)
    batch["gt_boxes"][0, :3] = np.concatenate([
        rng.uniform(-6, 6, (3, 2)), np.full((3, 1), -0.6),
        rng.uniform([1.4, 1.5, 3.5], [1.8, 2.1, 4.8], (3, 3)),
        rng.uniform(-np.pi, np.pi, (3, 1))], axis=1)
    batch["gt_mask"] = np.array([[True, True, True, False]])
    return batch


def test_att_ms_train_step_matches_jax_eager(monkeypatch):
    """Fault 15: lss_coalign_fusion.yaml's step (att_ms, supervise_single,
    the frozen camera encoder) against the JAX step computed eagerly, at
    hold_step's bounds."""
    y = load_yaml(f"{HYPES}/lss_coalign_fusion.yaml")
    assert y["model"]["args"]["fusion_args"]["core_method"] == "att_ms"
    assert y["model"]["args"]["supervise_single"]
    MODELS["att_ms_r101"] = ("lift_splat_shoot_intermediate", {
        **R101, "supervise_single": True}, 2)
    batch = _seeded_gt(camera_batch(b=1, l=2, n=1, seed=12))
    jmodel, variables, model = seeded_lss_pair("att_ms_r101", batch, key=3)
    np64 = types.ModuleType("numpy")
    np64.__dict__.update(vars(np))
    np64.float32 = np.float64
    monkeypatch.setattr(JTRUNKS, "np", np64)
    with jax.disable_jit():
        hold_step(monkeypatch, jmodel, variables, model, batch, y["loss"],
                  ANCHORS, TARGETS, y["optimizer"], frozen=("camencode.",))
