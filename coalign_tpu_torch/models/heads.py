"""Detection heads: 1x1 convs for cls / reg / dir, ported from
coalign_tpu/models/heads.py. They sit at the top level of the reference
models (``cls_head``, ``reg_head``, ``dir_head``; ref
point_pillar_baseline_multiscale.py), so they are attached to the model
itself rather than to a submodule. Outputs are NCHW."""

from __future__ import annotations

import torch
from torch import nn


def add_detection_heads(model: nn.Module, in_ch: int, anchor_number: int,
                        use_dir: bool, num_bins: int = 2):
    model.cls_head = nn.Conv2d(in_ch, anchor_number, 1)
    model.reg_head = nn.Conv2d(in_ch, 7 * anchor_number, 1)
    model.dir_head = (nn.Conv2d(in_ch, num_bins * anchor_number, 1)
                      if use_dir else None)


def detection_heads(model: nn.Module, x: torch.Tensor) -> dict:
    out = {"cls_preds": model.cls_head(x), "reg_preds": model.reg_head(x)}
    if model.dir_head is not None:
        out["dir_preds"] = model.dir_head(x)
    return out
