"""The LSS camera family's trunks, NCHW, under the reference's names.

Port of coalign_tpu/models/camera_trunks.py. The JAX package keeps its own
parameter tree and imports reference checkpoints through a key map
(coalign_tpu/utils/ckpt_import.py:465-650); here every module carries the
reference's state-dict names, so tests/golden/lss_*.pth load strictly:

* EfficientNet-b0 (``efficientnet_pytorch.EfficientNet``, ref
  lss_submodule.py:41 CamEncode's ``trunk``): TF-SAME padded convs, swish,
  squeeze-excite sized from the block's input width, batch norms eps 1e-3;
  ``_conv_stem``, ``_bn0``, ``_blocks.{i}._expand_conv`` ... ``_bn2``. Its
  classification head (``_conv_head``, ``_bn1``, ``_fc``) never runs in
  the reference's feature walk and is not built: load_pth drops its keys
  (the model's STATE_DICT_DEAD), as the JAX import drops them.
* torchvision ResNet-101 through layer2 (ref lss_submodule.py:142
  CamEncode_Resnet101: ``conv1``, ``bn1``, maxpool, ``layer1`` of 3 and
  ``layer2`` of 4 Bottlenecks, 512 channels at /8), norms eps 1e-5.
* torchvision ResNet-18's layers 1-3 behind a fresh 7x7/2 ``conv1`` (no
  maxpool), the BEV encoders' trunk (ref lss_submodule.py:247/:287/:360),
  models/layers.BasicBlock.
* The reference's ``Up`` (lss_submodule.py:19): bilinear upsample with
  align_corners=True, concat [x2, x1], two 3x3 conv-BN(eps 1e-5)-ReLU
  under ``conv.{0,1,3,4}``.

Every conv the JAX package builds with ``dtype=compute_dtype()``
(camera_trunks.py:104-242) is a policy conv here (models/layers.py).
The JAX package's corner-aligned upsample is two interpolation matrices;
here it is ``F.interpolate(bilinear, align_corners=True)``, which computes
the same map (tests/test_torch_lss.py holds the two equal), and the two
matrices only for a bfloat16 map, whose rounding follows the JAX
package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.models.layers import (BN_EPS, BasicBlock,
                                             MaskedBatchNorm2d,
                                             MaskedSequential, PolicyConv2d)
from coalign_tpu_torch.runtime import lowp_call

# efficientnet-b0's MBConv stack: (in_ch, out_ch, kernel, stride, expand),
# from its blocks_args r{repeats}_k{kernel}_s{stride}_e{expand}_i{in}_o{out}
# _se0.25 (the efficientnet_pytorch registry)
EFFNET_B0_BLOCKS = (
    (32, 16, 3, 1, 1),
    (16, 24, 3, 2, 6), (24, 24, 3, 1, 6),
    (24, 40, 5, 2, 6), (40, 40, 5, 1, 6),
    (40, 80, 3, 2, 6), (80, 80, 3, 1, 6), (80, 80, 3, 1, 6),
    (80, 112, 5, 1, 6), (112, 112, 5, 1, 6), (112, 112, 5, 1, 6),
    (112, 192, 5, 2, 6), (192, 192, 5, 1, 6), (192, 192, 5, 1, 6),
    (192, 192, 5, 1, 6),
    (192, 320, 3, 1, 6),
)
# the keys of efficientnet-b0's classification head, which no forward reads
EFFNET_DEAD = ("_conv_head.", "_bn1.", "_fc.")


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), op by op in x's dtype, as flax's nn.sigmoid
    computes (XLA rounds each op of a bfloat16 one)."""
    return 1 / (1 + torch.exp(-x))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 corner-aligned lerp weights, as the JAX
    package builds them (camera_trunks.py:65-84)."""
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 2)
    t = (src - i0).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), i0] += 1.0 - t
    m[np.arange(n_out), i0 + 1] += t
    return m


def upsample_align_corners(x: torch.Tensor, scale: int) -> torch.Tensor:
    """torch ``nn.Upsample(scale_factor=s, mode='bilinear',
    align_corners=True)`` of (F, C, H, W), in x's dtype. A bfloat16 map
    (the compute-dtype policy) is upsampled as the JAX package does it, two
    products with the lerp weights in bfloat16, each rounded."""
    if x.dtype != torch.bfloat16:
        return F.interpolate(x, scale_factor=scale, mode="bilinear",
                             align_corners=True)
    h, w = x.shape[-2:]
    wy, wx = (torch.from_numpy(_interp_matrix(n, n * scale)).to(x)
              for n in (h, w))
    y = lowp_call(lambda m, a: torch.einsum("oh,bchw->bcow", m, a), wy, x)
    return lowp_call(lambda m, a: torch.einsum("pw,bcow->bcop", m, a), wx,
                     y)


class SameConv2d(PolicyConv2d):
    """A policy conv with TF's SAME padding (flax's "SAME"; efficientnet_
    pytorch's Conv2dStaticSamePadding): pad (k - 1) + (ceil(n / s) - 1) * s
    + 1 - n in all, the odd one at the end."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, groups=1,
                 bias=False):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k, s in zip(x.shape[:-3:-1], self.kernel_size[::-1],
                           self.stride[::-1]):
            total = max((math.ceil(n / s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class MBConvBlock(nn.Module):
    """efficientnet_pytorch's MBConvBlock (drop_connect is training-only
    in the reference and absent from the JAX package, so it is left out):
    expand 1x1, depthwise kxk, squeeze-excite of max(1, in_ch // 4)
    channels, project 1x1, the identity added when the block keeps its
    shape."""

    def __init__(self, in_ch, out_ch, kernel, stride, expand):
        super().__init__()
        exp = in_ch * expand
        self.skip = stride == 1 and in_ch == out_ch
        if expand != 1:
            self._expand_conv = SameConv2d(in_ch, exp, 1)
            self._bn0 = MaskedBatchNorm2d(exp, eps=BN_EPS)
        else:
            self._expand_conv = None
        self._depthwise_conv = SameConv2d(exp, exp, kernel, stride,
                                          groups=exp)
        self._bn1 = MaskedBatchNorm2d(exp, eps=BN_EPS)
        sq = max(1, in_ch // 4)
        self._se_reduce = PolicyConv2d(exp, sq, 1)
        self._se_expand = PolicyConv2d(sq, exp, 1)
        self._project_conv = SameConv2d(exp, out_ch, 1)
        self._bn2 = MaskedBatchNorm2d(out_ch, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        if self._expand_conv is not None:
            x = swish(self._bn0(self._expand_conv(x)))
        y = self._bn1(self._depthwise_conv(x))
        x = swish(y)
        if x.dtype == torch.bfloat16:
            # XLA feeds the squeeze's float32 mean the swish product before
            # its bfloat16 rounding
            se = (y.float() * sigmoid(y).float()).mean(
                dim=(2, 3), keepdim=True).to(x.dtype)
        else:
            se = x.mean(dim=(2, 3), keepdim=True)
        se = self._se_expand(swish(self._se_reduce(se)))
        x = sigmoid(se) * x
        x = self._bn2(self._project_conv(x))
        return x + inputs if self.skip else x


class EfficientNetB0(nn.Module):
    """b0's feature trunk as the reference walks it (lss_submodule.py:91
    get_eff_features): the stem and 16 MBConv blocks, returning the
    reduction_3/4/5 endpoints, each the feature just before a stride-2
    block, and the last block's output: (40 ch at /8, 112 at /16, 320 at
    /32)."""

    def __init__(self):
        super().__init__()
        self._conv_stem = SameConv2d(3, 32, 3, 2)
        self._bn0 = MaskedBatchNorm2d(32, eps=BN_EPS)
        self._blocks = nn.ModuleList([MBConvBlock(*b)
                                      for b in EFFNET_B0_BLOCKS])

    def forward(self, x: torch.Tensor) -> tuple:
        x = swish(self._bn0(self._conv_stem(x)))
        endpoints = []
        for block, (_, _, _, stride, _) in zip(self._blocks,
                                               EFFNET_B0_BLOCKS):
            if stride > 1:
                endpoints.append(x)
            x = block(x)
        endpoints.append(x)
        return endpoints[2], endpoints[3], endpoints[4]


class TorchUp(nn.Module):
    """Ref lss_submodule.py:19 Up: x1 upsampled (align_corners), cat
    [x2, x1], two 3x3 conv-BN(eps 1e-5)-ReLU."""

    def __init__(self, in_ch: int, out_ch: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv = MaskedSequential(
            PolicyConv2d(in_ch, out_ch, 3, padding=1, bias=False),
            MaskedBatchNorm2d(out_ch), nn.ReLU(inplace=True),
            PolicyConv2d(out_ch, out_ch, 3, padding=1, bias=False),
            MaskedBatchNorm2d(out_ch), nn.ReLU(inplace=True))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = upsample_align_corners(x1, self.scale)
        return self.conv(torch.cat([x2, x1], dim=1))


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (expansion 4, the stride on conv2), norms
    eps 1e-5."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = PolicyConv2d(inplanes, planes, 1, bias=False)
        self.bn1 = MaskedBatchNorm2d(planes)
        self.conv2 = PolicyConv2d(planes, planes, 3, stride=stride, padding=1,
                                  bias=False)
        self.bn2 = MaskedBatchNorm2d(planes)
        self.conv3 = PolicyConv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = MaskedBatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = MaskedSequential(
                PolicyConv2d(inplanes, planes * 4, 1, stride=stride,
                             bias=False),
                MaskedBatchNorm2d(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        return self.relu(self.bn3(self.conv3(out)) + identity)


class ResNet101Trunk(nn.Module):
    """torchvision resnet101 through layer2, the slice CamEncode_Resnet101
    keeps (lss_submodule.py:155-161): conv1 7x7/2, BN, ReLU, maxpool 3x3/2,
    layer1 (3 Bottlenecks, 256 ch), layer2 (4, 512 ch, /2): 512 ch at /8.
    Its modules sit directly under the encoder (``camencode.conv1``, ...),
    as in the reference, so this is a mixin of the encoder."""

    def _build_trunk(self):
        self.conv1 = PolicyConv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = MaskedBatchNorm2d(64)
        self.layer1 = nn.Sequential(Bottleneck(64, 64), Bottleneck(256, 64),
                                    Bottleneck(256, 64))
        self.layer2 = nn.Sequential(
            Bottleneck(256, 128, 2),
            *[Bottleneck(512, 128) for _ in range(3)])

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        return self.layer2(self.layer1(x))


class ResNet18Layers(nn.Module):
    """The BEV encoders' trunk (lss_submodule.py:247/:287/:360): a fresh
    conv1 (in -> 64, 7x7/2, no maxpool), BN, ReLU and torchvision
    resnet18's layer1..layer3; (x1 64 ch at /2, x2 128 at /4, x3 256 at
    /8) of the BEV input. Its modules sit directly under the encoder
    (``bevencode.conv1``, ``bevencode.layer1``, ...): a mixin."""

    def _build_trunk(self, in_ch: int):
        self.conv1 = PolicyConv2d(in_ch, 64, 7, stride=2, padding=3,
                                  bias=False)
        self.bn1 = MaskedBatchNorm2d(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2),
                                    BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2),
                                    BasicBlock(256, 256))

    def trunk(self, x: torch.Tensor) -> tuple:
        x = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        return x1, x2, self.layer3(x2)
