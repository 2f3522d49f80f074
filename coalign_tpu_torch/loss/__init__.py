"""Loss registry after the reference's ``loss.core_method`` reflection (ref
opencood/tools/train_utils.py:149-182); the port has point_pillar_loss."""

from coalign_tpu_torch.loss.point_pillar_loss import (  # noqa: F401
    PointPillarLoss, build_loss as _build_point_pillar)


def build_loss(cfg: dict):
    """The yaml ``loss`` subtree ({core_method, args}) or bare args, which
    are point_pillar_loss's."""
    if "core_method" in cfg:
        name, args = cfg["core_method"], cfg.get("args", {})
    else:
        name, args = "point_pillar_loss", cfg
    if name == "point_pillar_loss":
        return _build_point_pillar(args)
    raise KeyError(f"loss {name!r} is not ported; have "
                   "['point_pillar_loss']")
