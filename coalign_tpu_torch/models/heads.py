"""Detection heads: 1x1 convs for cls / reg / dir / IoU / uncertainty,
ported from coalign_tpu/models/heads.py. They sit at the top level of the
reference models (``cls_head``, ``reg_head``, ``dir_head``, ``iou_head``,
``unc_head``; ref point_pillar_baseline_multiscale.py,
point_pillar_uncertainty.py), so they are attached to the model itself
rather than to a submodule; CIA-SSD's sit in its ``head`` (CIASSDHead).
Outputs are NCHW."""

from __future__ import annotations

import torch
from torch import nn


def add_detection_heads(model: nn.Module, in_ch: int, args: dict,
                        suffix: str = ""):
    """The heads a model's yaml ``args`` ask for: cls and reg always, dir
    with ``dir_args``, the IoU head (``anchor_number`` channels) with
    ``use_iou_head``, the log-variance head (``uncertainty_dim`` x anchors
    channels) with ``uncertainty_dim``; named ``<kind>_head<suffix>`` (the
    LSS model's single-agent heads are ``*_head_before_fusion``)."""
    a = args["anchor_number"]
    heads = {
        "cls": nn.Conv2d(in_ch, a, 1),
        "reg": nn.Conv2d(in_ch, 7 * a, 1),
        "dir": (nn.Conv2d(in_ch, args["dir_args"].get("num_bins", 2) * a, 1)
                if "dir_args" in args else None),
        "iou": (nn.Conv2d(in_ch, a, 1)
                if args.get("use_iou_head", False) else None),
        "unc": (nn.Conv2d(in_ch, args["uncertainty_dim"] * a, 1)
                if "uncertainty_dim" in args else None)}
    for kind, head in heads.items():
        setattr(model, f"{kind}_head{suffix}", head)


def detection_heads(model: nn.Module, x: torch.Tensor,
                    suffix: str = "") -> dict:
    """The ``<kind>_preds`` maps of add_detection_heads' heads."""
    out = {}
    for kind in ("cls", "reg", "dir", "iou", "unc"):
        head = getattr(model, f"{kind}_head{suffix}")
        if head is not None:
            out[f"{kind}_preds"] = head(x)
    return out


class DetectionHeads(nn.Module):
    """The heads of add_detection_heads as a submodule of their own, for a
    model with a second set (Where2comm's ``single_heads``)."""

    def __init__(self, in_ch: int, args: dict):
        super().__init__()
        add_detection_heads(self, in_ch, args)

    def forward(self, x: torch.Tensor) -> dict:
        return detection_heads(self, x)


class CIASSDHead(nn.Module):
    """CIA-SSD's heads under the reference's names (ref cia_ssd_utils.py
    Head, second_ssfa.py:16): ``conv_cls``, ``conv_box``, ``conv_iou``
    (always, without a bias, as the reference's), ``conv_dir`` with
    ``dir_args`` and ``conv_unc`` with ``uncertainty_dim``. The JAX
    package's iou_head has a bias, which no loss reaches
    (utils/weights.from_jax_params requires it to be 0)."""

    def __init__(self, in_ch: int, args: dict):
        super().__init__()
        a = args["anchor_number"]
        self.conv_cls = nn.Conv2d(in_ch, a, 1)
        self.conv_box = nn.Conv2d(in_ch, 7 * a, 1)
        self.conv_iou = nn.Conv2d(in_ch, a, 1, bias=False)
        self.conv_dir = (nn.Conv2d(in_ch, args["dir_args"].get("num_bins", 2)
                                   * a, 1) if "dir_args" in args else None)
        self.conv_unc = (nn.Conv2d(in_ch, args["uncertainty_dim"] * a, 1)
                         if "uncertainty_dim" in args else None)

    def forward(self, x: torch.Tensor) -> dict:
        out = {"cls_preds": self.conv_cls(x), "reg_preds": self.conv_box(x)}
        if self.conv_dir is not None:
            out["dir_preds"] = self.conv_dir(x)
        out["iou_preds"] = self.conv_iou(x)
        if self.conv_unc is not None:
            out["unc_preds"] = self.conv_unc(x)
        return out
