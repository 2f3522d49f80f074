"""Loss registry after the reference's ``loss.core_method`` reflection (ref
opencood/tools/train_utils.py:149-182); the port has point_pillar_loss and
the stage-1 detector's point_pillar_uncertainty_loss."""

from coalign_tpu_torch.loss.point_pillar_loss import (  # noqa: F401
    PointPillarLoss, build_loss as _build_point_pillar)
from coalign_tpu_torch.loss.uncertainty_loss import build_uncertainty_loss

_PORTED = ["point_pillar_loss", "point_pillar_uncertainty_loss",
           "point_pillar_unc_loss"]


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
    raise KeyError(f"loss {name!r} is not ported; have {_PORTED}")
