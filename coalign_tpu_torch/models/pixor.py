"""PIXOR, the dense BEV detector, and its intermediate-fusion variant, NCHW.

Port of coalign_tpu/models/pixor.py (ref opencood/models/pixor.py:256,
pixor_intermediate.py:38): the BEV occupancy raster is computed on the
device (ops/bev_raster.py); the backbone has Bottleneck stages [3, 6, 6, 3]
at 96/192/256/384 channels, FPN laterals of 196/128/96 channels and k3 s2
p1 output_padding 1 deconvolutions (``nn.ConvTranspose2d``, which the JAX
package's TorchConvTranspose2d reproduces); the header's four 3x3 convs
give a 1-channel dense cls map and a 6-channel reg map [cos, sin, dx, dy,
log w, log l] at a quarter of the raster, with no anchors. Parameter names
are the reference's, so its checkpoints load strictly.

Traps the port keeps from the JAX package:
  * every batch norm here takes eps 1e-5, not the PointPillars trunk's
    BN_EPS 1e-3; none is masked (the JAX package's norms see every agent
    frame, padded ones too);
  * ``use_bn: false`` drops the norms and gives every conv of the blocks
    and the header a bias; the stem convs never have one;
  * the header has no ReLU between its convs;
  * the cls bias starts at -4.595 and the reg kernel at 0, as flax
    initializes them for training from scratch;
  * PixorIntermediate fuses c3/c4/c5 by a parameterless attention over the
    agents with no warp: the JAX package never reads the yaml's
    ``proj_first``, so each agent's raster stays in its own frame.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from coalign_tpu_torch.models.layers import MaskedBatchNorm2d
from coalign_tpu_torch.ops.bev_raster import BevSpec, rasterize_bev

PIXOR_BN_EPS = 1e-5


def _bn(ch: int, use_bn: bool):
    return MaskedBatchNorm2d(ch, eps=PIXOR_BN_EPS) if use_bn else None


def _norm(bn, x):
    return x if bn is None else bn(x)


class PixorBottleneck(nn.Module):
    """ref pixor.py:51 Bottleneck (expansion 4): 1x1 -> 3x3 (stride) -> 1x1,
    each with its norm; the first block of a stage projects the identity
    with ``downsample`` (a strided 1x1 conv, and its norm with use_bn)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_bn: bool = True, has_down: bool = False):
        super().__init__()
        bias = not use_bn
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=bias)
        self.bn1 = _bn(planes, use_bn)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=bias)
        self.bn2 = _bn(planes, use_bn)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=bias)
        self.bn3 = _bn(planes * 4, use_bn)
        self.downsample = None
        if has_down:
            mods = [nn.Conv2d(inplanes, planes * 4, 1, stride=stride,
                              bias=bias)]
            if use_bn:
                mods.append(MaskedBatchNorm2d(planes * 4, eps=PIXOR_BN_EPS))
            self.downsample = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(_norm(self.bn1, self.conv1(x)))
        out = F.relu(_norm(self.bn2, self.conv2(out)))
        out = _norm(self.bn3, self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(identity + out)


class PixorBackbone(nn.Module):
    """ref pixor.py:106 BackBone: the stem's two 3x3 convs, four Bottleneck
    stages (planes 24/48/64/96, to 96/192/256/384 channels at /2 .. /16),
    and the FPN decode back to /4 at 96 channels; ``encode`` and ``decode``
    are split, as the reference's, so that the intermediate variant fuses
    c3/c4/c5 between them."""

    STAGES = ((24, 3), (48, 6), (64, 6), (96, 3))

    def __init__(self, in_ch: int, use_bn: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 32, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(32, 32, 3, padding=1, bias=False)
        self.bn1 = _bn(32, use_bn)
        self.bn2 = _bn(32, use_bn)
        inplanes = 32
        for i, (planes, n) in enumerate(self.STAGES):
            blocks = [PixorBottleneck(inplanes, planes, 2, use_bn, True)]
            blocks += [PixorBottleneck(planes * 4, planes, 1, use_bn, False)
                       for _ in range(n - 1)]
            self.add_module(f"block{i + 2}", nn.Sequential(*blocks))
            inplanes = planes * 4
        self.latlayer1 = nn.Conv2d(384, 196, 1)
        self.latlayer2 = nn.Conv2d(256, 128, 1)
        self.latlayer3 = nn.Conv2d(192, 96, 1)
        self.deconv1 = nn.ConvTranspose2d(196, 128, 3, stride=2, padding=1,
                                          output_padding=1)
        self.deconv2 = nn.ConvTranspose2d(128, 96, 3, stride=2, padding=1,
                                          output_padding=1)

    def encode(self, x: torch.Tensor) -> tuple:
        x = F.relu(_norm(self.bn1, self.conv1(x)))
        c1 = F.relu(_norm(self.bn2, self.conv2(x)))
        c2 = self.block2(c1)
        c3 = self.block3(c2)
        c4 = self.block4(c3)
        c5 = self.block5(c4)
        return c3, c4, c5

    def decode(self, c3, c4, c5) -> torch.Tensor:
        p5 = self.latlayer2(c4) + self.deconv1(self.latlayer1(c5))
        return self.latlayer3(c3) + self.deconv2(p5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(*self.encode(x))


class _InitConv2d(nn.Conv2d):
    """A conv whose weight and bias start at constants (flax's
    constant/zeros initializers); ``None`` keeps lecun_normal."""

    def __init__(self, *args, weight=None, bias_value=0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.weight_value = weight
        self.bias_value = bias_value

    def init_weights(self, generator: torch.Generator):
        with torch.no_grad():
            if self.weight_value is None:
                fan_in = self.in_channels * math.prod(self.kernel_size)
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
            else:
                self.weight.fill_(self.weight_value)
            self.bias.fill_(self.bias_value)


class PixorHeader(nn.Module):
    """ref pixor.py:217 Header: four 3x3 convs of 96 channels (each with
    its norm, no ReLU), then the 3x3 cls (1 channel, bias -4.595) and reg
    (6 channels, kernel 0) heads."""

    def __init__(self, use_bn: bool = True):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i + 1}", nn.Conv2d(96, 96, 3, padding=1,
                                                      bias=not use_bn))
            self.add_module(f"bn{i + 1}", _bn(96, use_bn))
        self.clshead = _InitConv2d(96, 1, 3, padding=1, bias_value=-4.595)
        self.reghead = _InitConv2d(96, 6, 3, padding=1, weight=0.0)

    def forward(self, x: torch.Tensor) -> tuple:
        for i in range(4):
            x = _norm(getattr(self, f"bn{i + 1}"),
                      getattr(self, f"conv{i + 1}")(x))
        return self.clshead(x), self.reghead(x)


class _PixorBase(nn.Module):
    def __init__(self, args: dict):
        super().__init__()
        self.args = dict(args)
        self.spec = BevSpec.from_config(args["geometry_param"])
        use_bn = bool(args.get("use_bn", True))
        self.backbone = PixorBackbone(self.spec.nz + 1, use_bn)
        self.header = PixorHeader(use_bn)

    def rasterize(self, batch: dict) -> torch.Tensor:
        """(B, L, N, 4) or (B, N, 4) points -> (B*L, nz + 1, nx, ny)."""
        points, mask = batch["points"], batch["point_mask"]
        if points.dim() == 4:
            points = points.reshape((-1,) + points.shape[2:])
            mask = mask.reshape((-1,) + mask.shape[2:])
        with record_function("stage/raster"):
            return rasterize_bev(points, mask, self.spec)

    def heads(self, feat: torch.Tensor) -> dict:
        with record_function("stage/heads"):
            cls, reg = self.header(feat)
        return {"cls_map": cls, "reg_map": reg}


class Pixor(_PixorBase):
    """Single-agent PIXOR (ref pixor.py:256-311): maps of every agent frame,
    (B*L, 1, H, W) and (B*L, 6, H, W)."""

    def forward(self, batch: dict) -> dict:
        bev = self.rasterize(batch)
        with record_function("stage/backbone"):
            feat = self.backbone(bev)
        return self.heads(feat)


def attentive_agent_fusion(feat: torch.Tensor, agent_mask: torch.Tensor):
    """(B*L, C, H, W) -> (B, C, H, W): at each pixel the ego's feature
    attends over the real agents' (scaled dot product, softmax over the
    agents; coalign_tpu/models/pixor.py:213-224, ref self_attn.py:48)."""
    b, l = agent_mask.shape
    _, c, h, w = feat.shape
    x = feat.reshape(b, l, c, h, w)
    scores = torch.einsum("bchw,blchw->blhw", x[:, 0], x) / math.sqrt(c)
    m = agent_mask[:, :, None, None]
    scores = torch.where(m, scores, float("-inf"))
    att = torch.exp(scores - scores.amax(1, keepdim=True))
    att = torch.where(m, att, 0.0)
    att = att / torch.clamp(att.sum(1, keepdim=True), min=1e-9)
    return torch.einsum("blhw,blchw->bchw", att, x)


class PixorIntermediate(_PixorBase):
    """PIXOR with the parameterless attentive fusion of c3, c4 and c5
    between the backbone's encode and decode (ref pixor_intermediate.py:14
    BackBoneIntermediate); maps (B, 1, H, W) and (B, 6, H, W)."""

    def forward(self, batch: dict) -> dict:
        mask = batch["agent_mask"]
        bev = self.rasterize(batch)
        with record_function("stage/backbone_encode"):
            c3, c4, c5 = self.backbone.encode(bev)
        with record_function("stage/fusion"):
            fused = [attentive_agent_fusion(c, mask) for c in (c3, c4, c5)]
        with record_function("stage/backbone_decode"):
            feat = self.backbone.decode(*fused)
        return self.heads(feat)


PIXOR_FAMILY = {"pixor": Pixor, "pixor_intermediate": PixorIntermediate}
