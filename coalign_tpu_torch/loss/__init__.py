"""Loss registry after the reference's ``loss.core_method`` reflection (ref
opencood/tools/train_utils.py:149-182; coalign_tpu/loss/__init__.py): the
port has point_pillar_loss, the stage-1 detector's uncertainty loss,
DiscoNet's distillation loss, the robust V2VNet and MASH losses,
VoxelNet's, PIXOR's, the LSS camera loss (detection plus depth
supervision) and the two-stage models' (fpvrcnn_loss, also named
ciassd_loss)."""

from coalign_tpu_torch.loss.point_pillar_loss import (  # noqa: F401
    PointPillarLoss, build_loss as _build_point_pillar)
from coalign_tpu_torch.loss.uncertainty_loss import build_uncertainty_loss

_PORTED = ["point_pillar_loss", "point_pillar_uncertainty_loss",
           "point_pillar_unc_loss", "point_pillar_disconet_loss",
           "disconet_loss", "point_pillar_v2v_robust_loss", "robust_loss",
           "point_pillar_mash_loss", "mash_loss", "voxel_net_loss",
           "voxelnet_loss", "pixor_loss", "camera_loss", "lss_loss",
           "fpvrcnn_loss", "ciassd_loss"]


def build_loss(cfg: dict):
    """The yaml ``loss`` subtree ({core_method, args}) or bare args, which
    are point_pillar_loss's."""
    if "core_method" in cfg:
        name, args = cfg["core_method"], cfg.get("args", {})
    else:
        name, args = "point_pillar_loss", cfg
    if name == "point_pillar_loss":
        return _build_point_pillar(args)
    if name in ("point_pillar_uncertainty_loss", "point_pillar_unc_loss"):
        return build_uncertainty_loss(args)
    if name in ("point_pillar_disconet_loss", "disconet_loss"):
        from coalign_tpu_torch.loss.disconet_loss import build_disconet_loss
        return build_disconet_loss(args)
    if name in ("point_pillar_v2v_robust_loss", "robust_loss"):
        from coalign_tpu_torch.loss.robust_loss import build_robust_loss
        return build_robust_loss(args)
    if name in ("point_pillar_mash_loss", "mash_loss"):
        from coalign_tpu_torch.loss.robust_loss import build_mash_loss
        return build_mash_loss(args)
    if name in ("voxel_net_loss", "voxelnet_loss"):
        from coalign_tpu_torch.loss.voxelnet_loss import build_voxelnet_loss
        return build_voxelnet_loss(args)
    if name in ("camera_loss", "lss_loss"):
        from coalign_tpu_torch.loss.depth_loss import build_camera_loss
        return build_camera_loss(args)
    if name in ("fpvrcnn_loss", "ciassd_loss"):
        from coalign_tpu_torch.loss.fpvrcnn_loss import build_fpvrcnn_loss
        return build_fpvrcnn_loss(args)
    if name == "pixor_loss":
        from coalign_tpu_torch.loss.pixor_loss import build_pixor_loss
        return build_pixor_loss(args)
    raise KeyError(f"loss {name!r} is not ported; have {_PORTED}")
