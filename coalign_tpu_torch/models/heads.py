"""Detection heads: 1x1 convs for cls / reg / dir / uncertainty, ported from
coalign_tpu/models/heads.py. They sit at the top level of the reference
models (``cls_head``, ``reg_head``, ``dir_head``, ``unc_head``; ref
point_pillar_baseline_multiscale.py, point_pillar_uncertainty.py), so they
are attached to the model itself rather than to a submodule. Outputs are
NCHW."""

from __future__ import annotations

import torch
from torch import nn


def add_detection_heads(model: nn.Module, in_ch: int, args: dict):
    """The heads a model's yaml ``args`` ask for: cls and reg always, dir
    with ``dir_args``, the log-variance head (``uncertainty_dim`` x
    anchors channels) with ``uncertainty_dim``."""
    if args.get("use_iou_head", False):
        raise NotImplementedError("the IoU head is not ported yet")
    a = args["anchor_number"]
    model.cls_head = nn.Conv2d(in_ch, a, 1)
    model.reg_head = nn.Conv2d(in_ch, 7 * a, 1)
    model.dir_head = (nn.Conv2d(in_ch, args["dir_args"].get("num_bins", 2) * a,
                                1) if "dir_args" in args else None)
    model.unc_head = (nn.Conv2d(in_ch, args["uncertainty_dim"] * a, 1)
                      if "uncertainty_dim" in args else None)


def detection_heads(model: nn.Module, x: torch.Tensor) -> dict:
    out = {"cls_preds": model.cls_head(x), "reg_preds": model.reg_head(x)}
    if model.dir_head is not None:
        out["dir_preds"] = model.dir_head(x)
    if model.unc_head is not None:
        out["unc_preds"] = model.unc_head(x)
    return out


class DetectionHeads(nn.Module):
    """The heads of add_detection_heads as a submodule of their own, for a
    model with a second set (Where2comm's ``single_heads``)."""

    def __init__(self, in_ch: int, args: dict):
        super().__init__()
        add_detection_heads(self, in_ch, args)

    def forward(self, x: torch.Tensor) -> dict:
        return detection_heads(self, x)
