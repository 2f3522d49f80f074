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
  * conv_bn_relu / ConvStage: ref base_bev_backbone.py:30-60, the plain
    SECOND-style stage ``blocks.{i}``: ZeroPad2d(1), a strided 3x3 conv,
    then n 3x3 convs, each conv followed by BatchNorm2d(eps 1e-3) and a
    ReLU (the JAX package's ConvBNReLU / ConvStage, models/layers.py:85,
    157, which pads the strided conv by 1 on each side: the same).
  * DownsampleConv: ref downsample_conv.py:30, the shrink header.
  * NaiveCompressor: ref naive_compress.py:5, ``encoder.{0,1}`` and
    ``decoder.{0,1,3,4}``: 3x3 convs *with* their bias, each before a
    BatchNorm2d(eps 1e-3) and a ReLU. The JAX package's convs have no bias:
    its checkpoint import folds the reference's into the norm's running
    mean (coalign_tpu/utils/ckpt_import.py:195-212), so its weights come
    here with a zero conv bias (utils/weights.from_jax_params).
  * MaskedBatchNorm: the channel-last batch norm of the pillar network.

Every batch norm is the JAX package's MaskedBatchNorm (models/layers.py:
40-75), not torch's: in training it normalizes by the batch statistics,
weighted by a mask of valid elements where one is given (padded points,
padded agents), and moves its running statistics with momentum 0.01 (flax's
0.99) towards the batch mean and the *biased* batch variance, where
nn.BatchNorm takes the unbiased one. In eval it uses its running
statistics and the mask has no effect. The momentum is the JAX package's
everywhere; ref resblock.py keeps BatchNorm2d's default 0.1 in the trunk,
a place where the JAX package and the reference disagree and the port
follows the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.parallel.distributed import global_sum, summing_mesh
from coalign_tpu_torch.runtime import lowp_call

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torch convention; the JAX package's 0.99

_COMPUTE_DTYPE = None


def set_compute_dtype(dtype):
    """Set the policy layers' compute dtype: None (their parameters' dtype,
    the default) or torch.bfloat16."""
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype} is not None or bfloat16")
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype


def compute_dtype():
    return _COMPUTE_DTYPE


def promote(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` in promote(x, like)'s dtype: what a flax layer without
    ``dtype=`` computes in."""
    dt = torch.promote_types(x.dtype, like.dtype)
    return x if x.dtype == dt else x.to(dt)


def _policy_call(layer, fn, x):
    """A policy layer's ``fn(input, weight, bias)``: cast to the compute
    dtype when one is set, else as flax's dtype=None promotes them."""
    cd = _COMPUTE_DTYPE
    if cd is None:
        return fn(promote(x, layer.weight), layer.weight, layer.bias)
    y = lowp_call(fn, x.to(cd), layer.weight.to(cd), None)
    if layer.bias is None:
        return y
    # flax adds the bias after the conv or product, in the compute dtype
    shape = (-1,) + (1,) * (y.dim() - 2) if not isinstance(
        layer, nn.Linear) else (-1,)
    return y + layer.bias.to(cd).reshape(shape)


class PolicyConv2d(nn.Conv2d):
    """nn.Conv2d that computes in the compute dtype when one is set."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _policy_call(self, self._conv_forward, x)


class PolicyConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (no output_size) in the compute dtype when one is
    set."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _policy_call(self, lambda x, w, b: F.conv_transpose2d(
            x, w, b, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation), x)


class PolicyLinear(nn.Linear):
    """nn.Linear in the compute dtype when one is set."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _policy_call(self, F.linear, x)


_POLICY = (PolicyConv2d, PolicyConvTranspose2d, PolicyLinear)
_PROMOTED = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.Linear,
             nn.LayerNorm)


def _promote_input(module, args):
    x = args[0] if args else None
    if (isinstance(x, torch.Tensor) and x.is_floating_point()
            and x.dtype != module.weight.dtype):
        return (promote(x, module.weight),) + tuple(args[1:])
    return None


def promote_unpinned(model: nn.Module) -> nn.Module:
    """Give every conv, linear and layer norm of ``model`` that is not a
    policy layer flax's dtype=None behaviour: an input of a lower float
    dtype than its weight (bfloat16 from a policy layer) is promoted to the
    weight's. Inputs of the weight's dtype pass untouched."""
    for mod in model.modules():
        if (isinstance(mod, _PROMOTED) and not isinstance(mod, _POLICY)
                and getattr(mod, "weight", None) is not None):
            mod.register_forward_pre_hook(_promote_input)
    return model


def _masked_moments(x: torch.Tensor, mask, channel_dim: int):
    """Per-channel mean and biased variance of ``x`` over every axis but
    ``channel_dim``, each element weighted by ``mask`` (broadcast over the
    channels; bool or float) where given."""
    dims = tuple(d for d in range(x.dim()) if d != channel_dim % x.dim())
    # inside a data-parallel step's global_sums block the moments are the
    # whole batch's over the mesh's ranks (parallel/distributed.global_sum):
    # the global mean first, then the global sum of squares about it; the
    # ranks' shards are equal (shard_batch), so an unmasked mean is the
    # ranks' means over the world; at world 1 the same bits
    mesh = summing_mesh()
    if mask is None:
        mean = x.mean(dims, keepdim=True)
        if mesh is None:
            return mean, ((x - mean) ** 2).mean(dims, keepdim=True)
        mean = global_sum(mean) / mesh.world
        return mean, global_sum(((x - mean) ** 2).mean(dims, keepdim=True)) \
            / mesh.world
    w = mask.to(x.dtype).unsqueeze(channel_dim).expand_as(x)
    denom = torch.clamp(global_sum(w.sum(dims, keepdim=True)), min=1.0)
    mean = global_sum((x * w).sum(dims, keepdim=True)) / denom
    return mean, global_sum((w * (x - mean) ** 2).sum(dims,
                                                      keepdim=True)) / denom


class _MaskedNorm:
    """The JAX package's MaskedBatchNorm on the state of an nn.BatchNorm*
    (weight, bias, running_mean, running_var, num_batches_tracked, so
    reference checkpoints load); ``channel_dim`` is where its channels
    are."""

    channel_dim: int

    def _batch_stats(self, x, mask, channel_dim=None):
        """Training: the batch statistics, and the running statistics moved
        towards them, both on the autograd graph (flax's updated
        batch_stats are traced values too); the buffers take a detached
        copy. ``channel_dim`` overrides the class's."""
        mean, var = _masked_moments(
            promote(x, self.running_mean), mask,
            self.channel_dim if channel_dim is None else channel_dim)
        m = self.momentum
        run_mean = (1 - m) * self.running_mean + m * mean.reshape(-1)
        run_var = (1 - m) * self.running_var + m * var.reshape(-1)
        with torch.no_grad():
            self.running_mean.copy_(run_mean)
            self.running_var.copy_(run_var)
            self.num_batches_tracked += 1
        return (mean, var), (run_mean, run_var)

    def _normalize(self, x, mean, var, channel_dim=None):
        """In x's dtype: a bfloat16 input is normalized in bfloat16 by its
        statistics and affine cast down, op by op, as the JAX
        MaskedBatchNorm computes (models/layers.py:70-72)."""
        shape = [1] * x.dim()
        shape[self.channel_dim if channel_dim is None else channel_dim] = -1
        dt = x.dtype
        inv = self.weight.reshape(shape).to(dt) / torch.sqrt(
            var.reshape(shape).to(dt) + self.eps)
        return ((x - mean.reshape(shape).to(dt)) * inv
                + self.bias.reshape(shape).to(dt))


class MaskedBatchNorm(_MaskedNorm, nn.BatchNorm1d):
    """Batch norm over the last axis of (..., C) point features; ``mask``
    (...) weights its training statistics. Parameter names are
    BatchNorm1d's (ref pillar_vfe.py PFNLayer.norm)."""

    channel_dim = -1

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor, mask=None, pad_rows=None):
        """(normalized ``x``, normalized ``pad_rows`` or None). The pad rows
        are normalized by the running statistics as this call leaves them
        (in training, just updated and on the autograd graph), as the JAX
        package's pad-parity track reads them
        (coalign_tpu/models/pillar_encoder.py:77-82): they neither read nor
        move the batch statistics."""
        if self.training:
            (mean, var), running = self._batch_stats(x, mask)
        else:
            mean, var = running = self.running_mean, self.running_var
        return (self._normalize(x, mean, var),
                None if pad_rows is None
                else self._normalize(pad_rows, *running))


class MaskedBatchNorm2d(_MaskedNorm, nn.BatchNorm2d):
    """Batch norm of (F, C, H, W) maps; ``mask`` (F,) leaves padded agents'
    maps out of the training statistics (the JAX package's ``bn_mask``).
    In eval it is nn.BatchNorm2d's (cuDNN's) inference."""

    channel_dim = 1

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        if not self.training and x.dtype != self.running_mean.dtype:
            return self._normalize(x, self.running_mean, self.running_var)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mask = None if mask is None else mask[:, None, None]
        (mean, var), _ = self._batch_stats(x, mask)
        return self._normalize(x, mean, var)


class BasicBlock(nn.Module):
    """torchvision BasicBlock (ref resblock.py:23)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = PolicyConv2d(inplanes, planes, 3, stride=stride,
                                  padding=1, bias=False)
        self.bn1 = MaskedBatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = PolicyConv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = MaskedBatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                PolicyConv2d(inplanes, planes, 1, stride=stride, bias=False),
                MaskedBatchNorm2d(planes))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x (F, C, H, W); mask (F,) of the frames that are real agents."""
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](self.downsample[0](x), mask)
        out = self.relu(self.bn1(self.conv1(x), mask))
        out = self.bn2(self.conv2(out), mask)
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

    def forward(self, x: torch.Tensor, mask=None) -> tuple:
        outs = []
        for s in range(self.num_stages):
            for block in getattr(self, f"layer{s}"):
                x = block(x, mask)
            outs.append(x)
        return tuple(outs)


def conv_bn_relu(in_ch: int, out_ch: int, stride: int = 1,
                 padding: int = 1, bias: bool = False) -> list:
    """[3x3 conv, masked batch norm (eps 1e-3), ReLU]: the JAX package's
    ConvBNReLU as three entries of a Sequential, where the reference keeps
    them. ``bias`` keeps the reference's conv bias before the norm where
    its checkpoints have one (naive_compress.py, when2com_fuse.py); the
    JAX package folds it into the running mean."""
    return [PolicyConv2d(in_ch, out_ch, 3, stride=stride, padding=padding,
                         bias=bias),
            MaskedBatchNorm2d(out_ch, eps=BN_EPS), nn.ReLU(inplace=True)]


class MaskedSequential(nn.Sequential):
    """A Sequential whose ``forward(x, mask)`` passes the agent mask (F,)
    to its masked batch norms."""

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        for mod in self:
            x = mod(x, mask) if isinstance(mod, MaskedBatchNorm2d) else mod(x)
        return x


class ConvStage(MaskedSequential):
    """ZeroPad2d(1) + a strided conv_bn_relu without padding, then
    ``num_convs`` stride-1 conv_bn_relus (ref base_bev_backbone.py:30-60;
    parameter names ``{1,2,4,5,...}``)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, num_convs: int):
        mods = [nn.ZeroPad2d(1), *conv_bn_relu(in_ch, out_ch, stride, 0)]
        for _ in range(num_convs):
            mods += conv_bn_relu(out_ch, out_ch)
        super().__init__(*mods)


def deblock(in_ch: int, out_ch: int, stride: float) -> MaskedSequential:
    """Upsample (transposed conv) or downsample block of the decode stage
    (ref base_bev_backbone_resnet.py:51-77)."""
    if stride >= 1:
        s = int(stride)
        conv = PolicyConvTranspose2d(in_ch, out_ch, s, stride=s, bias=False)
    else:
        s = int(round(1 / stride))
        conv = PolicyConv2d(in_ch, out_ch, s, stride=s, bias=False)
    return MaskedSequential(conv, MaskedBatchNorm2d(out_ch, eps=BN_EPS),
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


class NaiveCompressor(nn.Module):
    """Channel bottleneck that models a lossy link (ref naive_compress.py:5):
    C -> C / ratio -> C -> C, each a 3x3 conv, a batch norm and a ReLU."""

    def __init__(self, input_dim: int, compress_ratio: int):
        super().__init__()
        mid = input_dim // compress_ratio
        self.encoder = MaskedSequential(*conv_bn_relu(input_dim, mid,
                                                      bias=True))
        self.decoder = MaskedSequential(
            *conv_bn_relu(mid, input_dim, bias=True),
            *conv_bn_relu(input_dim, input_dim, bias=True))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x (F, C, H, W); mask (F,) leaves padded agents out of the norms'
        training statistics."""
        return self.decoder(self.encoder(x, mask), mask)
