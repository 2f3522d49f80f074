"""Building blocks of the PointPillars BEV trunk, NCHW.

Port of coalign_tpu/models/layers.py. Each module's parameter names are
those of the reference submodule it reproduces, so reference state dicts
load strictly:
  * BasicBlock / ResNetTrunk: torchvision BasicBlock as in ref resblock.py
    (conv1, bn1, conv2, bn2, downsample.{0,1}); its norms take torch's
    default eps 1e-5, unlike the 1e-3 of the backbone's other norms
    (docs/PARITY.md:420-428).
  * Deblock: ref base_bev_backbone_resnet.py:51-77, an
    nn.ConvTranspose2d(k=s, stride=s) (or a strided Conv2d for a stride
    below 1) + BatchNorm2d(eps 1e-3) + ReLU. The JAX package's
    TorchConvTranspose2d exists to reproduce nn.ConvTranspose2d in flax;
    here it is nn.ConvTranspose2d itself.
  * DownsampleConv: ref downsample_conv.py:30, the shrink header.
  * MaskedBatchNorm: the channel-last batch norm of the pillar network.

This slice runs inference only: the batch norms use their running
statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torch convention; the JAX package's 0.99


class MaskedBatchNorm(nn.BatchNorm1d):
    """Batch norm over the last axis of (..., C) point features.

    The JAX package's MaskedBatchNorm weights its training statistics by a
    mask of valid points; with running statistics (eval) the mask has no
    effect, and that is the only mode this slice runs. Parameter names are
    BatchNorm1d's (ref pillar_vfe.py PFNLayer.norm)."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm runs with running statistics only; "
                "training is not ported yet")
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        return (x - self.running_mean) * inv + self.bias


class BasicBlock(nn.Module):
    """torchvision BasicBlock (ref resblock.py:23)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class ResNetTrunk(nn.Module):
    """Stacked BasicBlock stages ``layer0, layer1, ...`` returning each
    stage's output (ref resblock.py:130 ResNetModified)."""

    def __init__(self, layer_nums: Sequence[int], layer_strides: Sequence[int],
                 num_filters: Sequence[int], inplanes: int):
        super().__init__()
        self.num_stages = len(layer_nums)
        for s, (n, stride, planes) in enumerate(zip(layer_nums, layer_strides,
                                                    num_filters)):
            blocks = [BasicBlock(inplanes, planes, stride)]
            blocks += [BasicBlock(planes, planes) for _ in range(n - 1)]
            self.add_module(f"layer{s}", nn.Sequential(*blocks))
            inplanes = planes

    def forward(self, x: torch.Tensor) -> tuple:
        outs = []
        for s in range(self.num_stages):
            x = getattr(self, f"layer{s}")(x)
            outs.append(x)
        return tuple(outs)


def deblock(in_ch: int, out_ch: int, stride: float) -> nn.Sequential:
    """Upsample (transposed conv) or downsample block of the decode stage
    (ref base_bev_backbone_resnet.py:51-77)."""
    if stride >= 1:
        s = int(stride)
        conv = nn.ConvTranspose2d(in_ch, out_ch, s, stride=s, bias=False)
    else:
        s = int(round(1 / stride))
        conv = nn.Conv2d(in_ch, out_ch, s, stride=s, bias=False)
    return nn.Sequential(conv, nn.BatchNorm2d(out_ch, eps=BN_EPS,
                                              momentum=BN_MOMENTUM),
                         nn.ReLU(inplace=True))


class DoubleConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 padding: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_ch, out_ch, 3, padding=1),
            nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class DownsampleConv(nn.Module):
    """Shrink header (ref downsample_conv.py:30): stacked DoubleConvs."""

    def __init__(self, cfg: dict):
        super().__init__()
        in_ch = cfg["input_dim"]
        layers = []
        for k, d, s, p in zip(cfg["kernal_size"], cfg["dim"], cfg["stride"],
                              cfg["padding"]):
            layers.append(DoubleConv(in_ch, d, k, s, p))
            in_ch = d
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
