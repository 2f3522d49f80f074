"""ResNet BEV backbone with the multiscale encode/decode split (ref
base_bev_backbone_resnet.py:15), ported from coalign_tpu/models/backbones.py.
Fusion runs between ``encode`` (per-scale features) and ``decode``
(per-scale deblocks + channel concat)."""

from __future__ import annotations

import torch
from torch import nn

from coalign_tpu_torch.models.layers import ResNetTrunk, deblock


class ResNetBEVBackbone(nn.Module):
    def __init__(self, cfg: dict, input_channels: int):
        super().__init__()
        layer_nums = list(cfg["layer_nums"])
        num_filters = list(cfg["num_filters"])
        ups = list(cfg.get("upsample_strides", ()))
        up_filters = list(cfg.get("num_upsample_filter", ()))
        if len(ups) != len(layer_nums):
            raise NotImplementedError(
                "one deblock per stage is ported; an extra final deblock "
                "is not")
        self.resnet = ResNetTrunk(layer_nums, cfg["layer_strides"],
                                  num_filters, input_channels)
        self.deblocks = nn.ModuleList(
            [deblock(c_in, c_out, s)
             for c_in, c_out, s in zip(num_filters, up_filters, ups)])

    def encode(self, x: torch.Tensor, mask=None) -> tuple:
        """(F, C, H, W) -> per-scale features; ``mask`` (F,) leaves padded
        agents out of the trunk norms' training statistics."""
        return self.resnet(x, mask)

    def decode(self, features) -> torch.Tensor:
        """Per-scale deblocks + channel concat -> (F, sum(C_up), H/2, W/2).
        Its norms take no mask: after fusion every map is real (the JAX
        package passes mask=None here)."""
        ups = [deb(f) for deb, f in zip(self.deblocks, features)]
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
