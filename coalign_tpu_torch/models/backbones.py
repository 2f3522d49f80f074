"""BEV backbones with the multiscale encode/decode split, ported from
coalign_tpu/models/backbones.py: the ResNet one (ref
base_bev_backbone_resnet.py:15) and the plain SECOND-style one (ref
base_bev_backbone.py:6). Fusion runs between ``encode`` (per-scale
features) and ``decode`` (per-scale deblocks + channel concat + the
optional extra final deblock)."""

from __future__ import annotations

import torch
from torch import nn

from coalign_tpu_torch.models.layers import ConvStage, ResNetTrunk, deblock


class _BEVBackbone(nn.Module):
    """The decode stage both backbones share: one deblock per scale and,
    when ``upsample_strides`` has one entry more than ``layer_nums``, an
    extra deblock over the concatenated maps (ref
    base_bev_backbone_resnet.py:79-85), ``deblocks.{len(layer_nums)}`` as
    in the reference (the JAX package's ``extra_deblock``)."""

    def _add_deblocks(self, cfg: dict, num_filters: list):
        levels = len(cfg["layer_nums"])
        ups = list(cfg.get("upsample_strides", ()))
        up_filters = list(cfg.get("num_upsample_filter", ()))
        blocks = [deblock(c_in, c_out, s) for c_in, c_out, s in
                  zip(num_filters, up_filters[:levels], ups[:levels])]
        if len(ups) > levels:
            blocks.append(deblock(sum(up_filters[:levels]), sum(up_filters),
                                  ups[-1]))
        self.num_levels = levels
        self.deblocks = nn.ModuleList(blocks)

    def decode(self, features, mask=None) -> torch.Tensor:
        """Per-scale deblocks + channel concat (+ the extra deblock) ->
        (F, C, H', W'). The flagship decodes its fused maps, all real, with
        no mask (as the JAX package does); the single-agent models pass the
        agent mask (F,) to the deblocks' norms."""
        ups = [deb(f, mask) for deb, f in zip(self.deblocks, features)]
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        if len(self.deblocks) > self.num_levels:
            x = self.deblocks[-1](x, mask)
        return x

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        return self.decode(self.encode(x, mask), mask)


class ResNetBEVBackbone(_BEVBackbone):
    def __init__(self, cfg: dict, input_channels: int):
        super().__init__()
        num_filters = list(cfg["num_filters"])
        self.resnet = ResNetTrunk(cfg["layer_nums"], cfg["layer_strides"],
                                  num_filters, input_channels)
        self._add_deblocks(cfg, num_filters)

    def encode(self, x: torch.Tensor, mask=None) -> tuple:
        """(F, C, H, W) -> per-scale features; ``mask`` (F,) leaves padded
        agents out of the trunk norms' training statistics."""
        return self.resnet(x, mask)


class BaseBEVBackbone(_BEVBackbone):
    """Plain conv stages ``blocks.{i}`` (ref base_bev_backbone.py:6)."""

    def __init__(self, cfg: dict, input_channels: int):
        super().__init__()
        num_filters = list(cfg["num_filters"])
        in_ch = [input_channels] + num_filters[:-1]
        self.blocks = nn.ModuleList(
            [ConvStage(c_in, c_out, s, n) for c_in, c_out, s, n in zip(
                in_ch, num_filters, cfg["layer_strides"], cfg["layer_nums"])])
        self._add_deblocks(cfg, num_filters)

    def encode(self, x: torch.Tensor, mask=None) -> tuple:
        outs = []
        for stage in self.blocks:
            x = stage(x, mask)
            outs.append(x)
        return tuple(outs)


def backbone_from_config(cfg: dict, input_channels: int) -> _BEVBackbone:
    """The ResNet backbone unless ``resnet`` is False (the JAX package's
    _backbone_from_config, models/zoo.py:38)."""
    cls = ResNetBEVBackbone if cfg.get("resnet", True) else BaseBEVBackbone
    return cls(cfg, input_channels)
