"""3D voxel backbones and SSFA: the SECOND / CIA-SSD compute path.

Port of coalign_tpu/models/voxel_backbone.py (ref sparse_backbone_3d.py:33
VoxelBackBone8x, height_compression.py:10, cia_ssd_utils.py:6 SSFA). Two
forms of the same 8x backbone share one parameter tree, so a checkpoint
loads into either:

  * VoxelBackbone8x, the dense twin: the grid is a dense (F, C, D, H, W)
    tensor and every sparse conv a dense ``F.conv3d``; a submanifold conv
    multiplies by the input's occupancy, a strided one lets the occupancy
    dilate (a max-pool with the conv's kernel, stride and padding), which
    is spconv's index semantics. Its norms see the empty cells too in
    training, as the JAX package's do;
  * SparseVoxelBackbone8x: the grid stays a fixed-height table of active
    voxels (ops/sparse_conv.py) through stage 3; stage 4 runs dense when
    its dense tensor fits a byte budget (1 GiB), else sparse. Its norms
    train over active rows only (spconv's BatchNorm1d over the feature
    table), in the dense tail over the occupied cells.

Each block (SparseConv3DBNReLU) carries the reference's names: the kernel
at ``.0.weight`` in spconv 1.x's (kz, ky, kx, Cin, Cout) layout, which the
reference checkpoints use, and the norm at ``.1`` with BatchNorm1d's state,
eps 1e-3 and the JAX package's momentum (models/layers.py). So
``backbone_3d.*`` (or ``spconv_block.*``) of a reference checkpoint loads
strictly.

Under the compute-dtype policy (models/layers.py) a sparse block casts its
feature table to the compute dtype, as the JAX package's do
(models/voxel_backbone.py:203-210): the product runs in that dtype with a
float32 accumulator (ops/sparse_conv.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.models.layers import (BN_EPS, BN_MOMENTUM,
                                             MaskedBatchNorm2d,
                                             MaskedSequential, PolicyConv2d,
                                             _MaskedNorm, compute_dtype,
                                             conv_bn_relu, promote)
from coalign_tpu_torch.ops import sparse_conv as S

DENSE_TAIL_BUDGET_BYTES = 1 << 30


class VoxelNorm(_MaskedNorm, nn.BatchNorm1d):
    """The masked batch norm of the 3D blocks on BatchNorm1d's state. It
    normalizes (F, M, C) feature tables (channels last) or dense
    (F, C, D, H, W) grids (channels at 1), ``mask`` (F, M) or
    (F, D, H, W) weighting the training statistics."""

    channel_dim = -1

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor, mask=None,
                channel_dim: int = -1) -> torch.Tensor:
        if not self.training and x.dtype != self.running_mean.dtype:
            return self._normalize(x, self.running_mean, self.running_var,
                                   channel_dim)
        if not self.training:
            if channel_dim == 1:
                return F.batch_norm(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, False, 0.0,
                                    self.eps)
            shape = x.shape
            return F.batch_norm(x.reshape(-1, shape[-1]), self.running_mean,
                                self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps).reshape(shape)
        (mean, var), _ = self._batch_stats(x, mask, channel_dim)
        return self._normalize(x, mean, var, channel_dim)


class SpConvWeight(nn.Module):
    """The kernel of a spconv SubMConv3d / SparseConv3d, (kz, ky, kx, Cin,
    Cout) as spconv 1.x stores it."""

    def __init__(self, cin: int, cout: int, kernel: tuple):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*kernel, cin, cout))

    def init_weights(self, generator: torch.Generator):
        """flax's lecun_normal with fan_in = Cin x kernel volume."""
        fan_in = self.weight.shape[3] * math.prod(self.weight.shape[:3])
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def _triple(v) -> tuple:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


class SparseConv3DBNReLU(nn.Sequential):
    """A 3D conv (no bias) + masked batch norm + ReLU, as a sparse conv on
    a SparseGrid (``sparse``) or a dense one on (F, C, D, H, W)
    (``dense``); the reference's ``spconv.SparseSequential(conv, norm,
    ReLU)`` (ref sparse_backbone_3d.py:8-29), whose ReLU has no state."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3),
                 stride=(1, 1, 1), padding=(1, 1, 1)):
        super().__init__(SpConvWeight(cin, cout, _triple(kernel)),
                         VoxelNorm(cout))
        self.stride = _triple(stride)
        self.padding = _triple(padding)

    def dense(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x (F, Cin, D, H, W) -> (F, Cout, D', H', W'); ``mask``
        (F, D', H', W') weights the norm's training statistics."""
        w = self[0].weight.permute(4, 3, 0, 1, 2)
        # no policy conv in the JAX package: a bfloat16 grid is promoted
        y = F.conv3d(promote(x, w), w, stride=self.stride,
                     padding=self.padding)
        return F.relu(self[1](y, mask, channel_dim=1))

    def sparse(self, grid: S.SparseGrid, out_set: S.SparseGrid | None = None,
               rulebook=None) -> S.SparseGrid:
        """A subm conv on ``grid``'s active set (``out_set`` None) or a
        strided one onto ``out_set``; the norm's statistics over the output's
        active rows."""
        if compute_dtype() is not None:
            grid = grid._replace(feats=grid.feats.to(compute_dtype()))
        if out_set is None:
            out = S.subm_conv(grid, self[0].weight, rulebook=rulebook)
        else:
            out = S.strided_conv(grid, self[0].weight, out_set,
                                 stride=self.stride, pad=self.padding,
                                 rulebook=rulebook)
        y = F.relu(self[1](out.feats, out.valid))
        return out._replace(feats=y * out.valid[..., None].to(y.dtype))


class Conv3DBNReLU(nn.Sequential):
    """A dense nn.Conv3d (no bias) + masked batch norm + ReLU on
    (F, C, D, H, W): VoxelNet's middle layers (ref voxel_net.py CML).
    ``mask`` (F, D', H', W') weights the norm's training statistics."""

    def __init__(self, cin: int, cout: int, kernel=3, stride=1, padding=1):
        super().__init__(nn.Conv3d(cin, cout, kernel, stride=stride,
                                   padding=padding, bias=False),
                         VoxelNorm(cout))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        return F.relu(self[1](self[0](x), mask, channel_dim=1))


def _depths(nz: int) -> tuple:
    """(stage 4's z padding, conv_out's z kernel and stride, the output
    depth) on a grid of ``nz`` z slabs, the +1 spconv pad included here
    (the JAX package reads them off its traced shapes). Stage 4 pads z by
    0 as the reference does when the depth allows ((41 -> ... -> 11) - 3)
    // 2 + 1 = 5, by 1 on tiny grids; conv_out squashes the rest with a z
    kernel of min(3, depth), striding 2 only when that leaves more."""
    d = nz + 1
    d = (d - 1) // 2 + 1                            # stage 2, pad 1
    d = (d - 1) // 2 + 1                            # stage 3
    pz = 0 if (d - 3) // 2 + 1 >= 1 else 1
    d = (d + 2 * pz - 3) // 2 + 1                   # stage 4
    kz = min(3, d)
    sz = 2 if d > kz else 1
    return pz, kz, sz, (d - kz) // sz + 1


def out_depth(nz: int) -> int:
    """The depth of the backbone's output on a grid of ``nz`` z slabs,
    which sets the height-compressed channel count (out_features x
    depth)."""
    return _depths(nz)[3]


class _Backbone8xBlocks(nn.Module):
    """The reference's blocks (ref sparse_backbone_3d.py:33-100) for a grid
    of ``nz`` z slabs: conv_input, conv1 (16), conv2 / conv3 / conv4 (a
    stride-2 conv and two subm convs: 32, 64, 64), conv_out (the z
    squash)."""

    def __init__(self, nz: int, in_features: int = 4,
                 out_features: int = 128):
        super().__init__()
        pz, kz, sz, _ = _depths(nz)
        self.out_features = out_features
        self.conv_input = SparseConv3DBNReLU(in_features, 16)
        self.conv1 = nn.ModuleList([SparseConv3DBNReLU(16, 16)])
        plan = [(16, 32, 1), (32, 64, 1), (64, 64, pz)]
        for i, (cin, cout, pad_z) in enumerate(plan):
            setattr(self, f"conv{i + 2}", nn.ModuleList([
                SparseConv3DBNReLU(cin, cout, stride=2,
                                   padding=(pad_z, 1, 1)),
                SparseConv3DBNReLU(cout, cout),
                SparseConv3DBNReLU(cout, cout)]))
        self.conv_out = SparseConv3DBNReLU(64, out_features, kernel=(kz, 1, 1),
                                           stride=(sz, 1, 1), padding=0)

    @property
    def stages(self) -> tuple:
        return self.conv2, self.conv3, self.conv4


def _dilate(occ: torch.Tensor, block: SparseConv3DBNReLU) -> torch.Tensor:
    """The active set of a strided sparse conv's output on a dense
    (F, 1, D, H, W) occupancy: a max-pool with the conv's kernel, stride
    and padding."""
    return F.max_pool3d(occ, tuple(block[0].weight.shape[:3]), block.stride,
                        block.padding)


class VoxelBackbone8x(_Backbone8xBlocks):
    """The dense twin: (F, C_in, D, H, W) -> dict of the stages' dense maps
    x_conv1 .. x_conv4 and ``out`` (F, out_features, D', H/8, W/8)."""

    def forward(self, x: torch.Tensor) -> dict:
        occ = (x.abs().sum(1, keepdim=True) > 0).to(x.dtype)
        x = self.conv_input.dense(x) * occ
        x = self.conv1[0].dense(x) * occ
        feats = {"x_conv1": x}
        for i, stage in enumerate(self.stages):
            occ = _dilate(occ, stage[0])
            for block in stage:
                x = block.dense(x) * occ
            feats[f"x_conv{i + 2}"] = x
        feats["out"] = self.conv_out.dense(x) * _dilate(occ, self.conv_out)
        return feats


class SparseVoxelBackbone8x(_Backbone8xBlocks):
    """The sparse backbone: SparseGrid over the z-padded (nz + 1, ny, nx)
    grid -> dict of the stages (SparseGrids; x_conv4 and ``out`` dense
    (F, C, D, H, W) maps when the dense tail ran, else SparseGrids). One
    subm rulebook per stage serves that stage's subm convs."""

    def __init__(self, nz: int, in_features: int = 4,
                 out_features: int = 128,
                 dense_tail_budget_bytes: int = DENSE_TAIL_BUDGET_BYTES):
        super().__init__(nz, in_features, out_features)
        self.dense_tail_budget_bytes = dense_tail_budget_bytes

    def forward(self, grid: S.SparseGrid) -> dict:
        rb = S.subm_rulebook(grid)
        x = self.conv_input.sparse(grid, rulebook=rb)
        x = self.conv1[0].sparse(x, rulebook=rb)
        feats = {"x_conv1": x}
        for i, stage in enumerate((self.conv2, self.conv3)):
            x = stage[0].sparse(x, S.downsample_active(
                x, stride=stage[0].stride, pad=stage[0].padding))
            rb = S.subm_rulebook(x)
            x = stage[1].sparse(x, rulebook=rb)
            x = stage[2].sparse(x, rulebook=rb)
            feats[f"x_conv{i + 2}"] = x
        head = self.conv4[0]
        x = head.sparse(x, S.downsample_active(x, stride=head.stride,
                                               pad=head.padding))
        dense_bytes = (x.keys.shape[0] * math.prod(x.shape) * 64
                       * x.feats.element_size())
        if dense_bytes <= self.dense_tail_budget_bytes:
            feats.update(self._dense_tail(x))
            return feats
        rb = S.subm_rulebook(x)
        x = self.conv4[1].sparse(x, rulebook=rb)
        x4 = self.conv4[2].sparse(x, rulebook=rb)
        out = self.conv_out
        out_set = S.downsample_active(x4, kernel=tuple(out[0].weight.shape[:3]),
                                      stride=out.stride, pad=out.padding)
        feats.update(x_conv4=x4, out=out.sparse(x4, out_set))
        return feats

    def _dense_tail(self, x: S.SparseGrid) -> dict:
        """Stage 4's subm convs and conv_out on the dense (F, C, D, H, W)
        map, the norms over its occupied cells. Its active set is the cells
        with a nonzero feature, as the JAX package takes it (ROADMAP §3):
        a site whose every channel the ReLU zeroed drops out, where the
        sparse tail keeps it."""
        xd = S.to_dense(x).permute(0, 4, 1, 2, 3)
        occ = (xd.abs().sum(1, keepdim=True) > 0).to(xd.dtype)
        y = self.conv4[1].dense(xd, occ[:, 0]) * occ
        x4 = self.conv4[2].dense(y, occ[:, 0]) * occ
        occ_out = _dilate(occ, self.conv_out)
        out = self.conv_out.dense(x4, occ_out[:, 0]) * occ_out
        return {"x_conv4": x4, "out": out}


def height_compression(x: torch.Tensor) -> torch.Tensor:
    """(F, C, D, H, W) -> (F, C * D, H, W), C-major as the reference's
    view (ref height_compression.py:24); the JAX package flattens D-major,
    so from_jax_params permutes the input rows of the first 2D conv."""
    f, c, d, h, w = x.shape
    return x.reshape(f, c * d, h, w)


def dense_ncdhw(out) -> torch.Tensor:
    """The backbone's ``out``, a dense (F, C, D, H, W) map or a
    SparseGrid, as the dense map."""
    if isinstance(out, S.SparseGrid):
        return S.to_dense(out).permute(0, 4, 1, 2, 3)
    return out


class SSFA(nn.Module):
    """Spatial-Semantic Feature Aggregation (ref cia_ssd_utils.py:6-57),
    NCHW, under the reference's names: a spatial branch at full resolution
    (bottom_up_block_0) and a semantic one at half (bottom_up_block_1),
    lateral 1x1s (trans_0/1), transposed convs back up (deconv_block_0/1),
    conv_0/1, and a per-pixel softmax over w_0/w_1 that blends the two.
    Every norm is a masked batch norm (eps 1e-3) whose statistics see every
    frame of the batch, as the JAX package's."""

    def __init__(self, in_channels: int, feature_num: int = 128):
        super().__init__()
        f = feature_num
        self.bottom_up_block_0 = MaskedSequential(
            nn.ZeroPad2d(1), *conv_bn_relu(in_channels, f, 1, 0),
            *conv_bn_relu(f, f), *conv_bn_relu(f, f))
        self.bottom_up_block_1 = MaskedSequential(
            *conv_bn_relu(f, 2 * f, 2), *conv_bn_relu(2 * f, 2 * f),
            *conv_bn_relu(2 * f, 2 * f))
        self.trans_0 = MaskedSequential(*_conv1x1_bn_relu(f, f))
        self.trans_1 = MaskedSequential(*_conv1x1_bn_relu(2 * f, 2 * f))
        self.deconv_block_0 = MaskedSequential(*_deconv_bn_relu(2 * f, f))
        self.deconv_block_1 = MaskedSequential(*_deconv_bn_relu(2 * f, f))
        self.conv_0 = MaskedSequential(*conv_bn_relu(f, f))
        self.conv_1 = MaskedSequential(*conv_bn_relu(f, f))
        self.w_0 = MaskedSequential(nn.Conv2d(f, 1, 1, bias=False),
                                    MaskedBatchNorm2d(1, eps=BN_EPS))
        self.w_1 = MaskedSequential(nn.Conv2d(f, 1, 1, bias=False),
                                    MaskedBatchNorm2d(1, eps=BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.bottom_up_block_0(x)
        x1 = self.bottom_up_block_1(x0)
        t0, t1 = self.trans_0(x0), self.trans_1(x1)
        o0 = self.conv_0(self.deconv_block_0(t1) + t0)
        o1 = self.conv_1(self.deconv_block_1(t1))
        w = torch.softmax(torch.cat([self.w_0(o0), self.w_1(o1)], dim=1),
                          dim=1)
        return o0 * w[:, 0:1] + o1 * w[:, 1:2]


def _conv1x1_bn_relu(cin: int, cout: int) -> list:
    return [PolicyConv2d(cin, cout, 1, bias=False),
            MaskedBatchNorm2d(cout, eps=BN_EPS), nn.ReLU(inplace=True)]


def _deconv_bn_relu(cin: int, cout: int) -> list:
    return [nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            MaskedBatchNorm2d(cout, eps=BN_EPS), nn.ReLU(inplace=True)]
