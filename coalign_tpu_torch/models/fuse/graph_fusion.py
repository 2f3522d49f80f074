"""DiscoNet, V2VNet and When2comm fusion, batched over padded agents.

Port of coalign_tpu/models/fuse/graph_fusion.py (ref fusion_in_one.py:
138-431, disco_fuse.py, convgru.py, when2com_fuse.py). Every module takes
features (B, L, C, H, W), the normalized pairwise affines (B, L, L, 2, 3)
([b, i, j] samples j's map into frame i) and agent_mask (B, L), and
returns the fused ego map (B, C, H, W). A padded agent takes part in no
softmax, mean, max or GRU output.

Parameter names are the reference's, so its checkpoints load strictly:
  * DiscoFusion: ``pixel_weight_layer.{conv1_1..conv1_4, bn1_1..bn1_3}``;
  * V2VNetFusion: ``msg_cnn``, ``conv_gru.cell_list.0.{conv_gates,
    conv_can}``, ``mlp``;
  * When2commFusion: ``query_key_net.conv{1..5}.cbr_unit.{0,1}``,
    ``{key,query}_net.conv1.cbr_unit.{0,1}``, ``{key,query}_net.fc.
    {0,2,4}``, ``attention_net.linear_{feat,context,out}``.
The reference's convs before a batch norm keep their bias (the JAX package
folds it into the norm's running mean), and its norms take the JAX
package's eps 1e-3. ``attention_net.linear_out`` is never called: the
reference's forward does not use it (when2com_fuse.py:350-355); it is kept
so that the reference's checkpoint loads strictly.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.models.layers import (BN_EPS, MaskedBatchNorm2d,
                                             MaskedSequential, PolicyConv2d,
                                             conv_bn_relu)
from coalign_tpu_torch.ops.warp import warp_affine, warp_agents_to_ego


def _masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int):
    """Softmax over ``dim`` with the entries where ``mask`` is False taking
    no part and coming out 0."""
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.where(mask, torch.softmax(logits, dim=dim), 0.0)


class PixelWeightLayer(nn.Module):
    """1x1 convs 2C -> 128 -> 32 -> 8 -> 1 (ref disco_fuse.py:76)."""

    def __init__(self, channel: int):
        super().__init__()
        for i, (c_in, c_out) in enumerate(
                [(channel, 128), (128, 32), (32, 8)], start=1):
            # ConvBNReLUs in the JAX package: policy convs
            self.add_module(f"conv1_{i}", PolicyConv2d(c_in, c_out, 1))
            self.add_module(f"bn1_{i}", MaskedBatchNorm2d(c_out, eps=BN_EPS))
        self.conv1_4 = nn.Conv2d(8, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 4):
            x = F.relu(getattr(self, f"bn1_{i}")(
                getattr(self, f"conv1_{i}")(x)))
        return F.relu(self.conv1_4(x))


class DiscoFusion(nn.Module):
    """Per-pixel weights from each warped agent beside the ego map, a
    masked softmax over agents, the weighted sum (ref fusion_in_one.py:
    138)."""

    def __init__(self, feature_dim: int):
        super().__init__()
        self.pixel_weight_layer = PixelWeightLayer(2 * feature_dim)

    def forward(self, features, affines, agent_mask):
        warped = warp_agents_to_ego(features, affines[:, 0], agent_mask)
        b, l, c, h, w = warped.shape
        ego = warped[:, :1].expand(b, l, c, h, w)
        cat = torch.cat([warped, ego], dim=2).reshape(b * l, 2 * c, h, w)
        logits = self.pixel_weight_layer(cat).reshape(b, l, h, w)
        weight = _masked_softmax(logits, agent_mask[:, :, None, None], 1)
        return torch.einsum("blhw,blchw->bchw", weight, warped)


class ConvGRUCell(nn.Module):
    """Convolutional GRU cell (ref convgru.py:7-70)."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int):
        super().__init__()
        pad = kernel_size // 2
        self.hidden_dim = hidden_dim
        self.conv_gates = nn.Conv2d(input_dim + hidden_dim, 2 * hidden_dim,
                                    kernel_size, padding=pad)
        self.conv_can = nn.Conv2d(input_dim + hidden_dim, hidden_dim,
                                  kernel_size, padding=pad)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        gates = torch.sigmoid(self.conv_gates(torch.cat([x, h], dim=1)))
        reset, update = torch.split(gates, self.hidden_dim, dim=1)
        cand = torch.tanh(self.conv_can(torch.cat([x, reset * h], dim=1)))
        return (1 - update) * h + update * cand


class ConvGRU(nn.Module):
    """One ConvGRU layer stepped once from a zero hidden state, as the JAX
    package wires it (graph_fusion.py:134-137); ``cell_list.0`` as in ref
    convgru.py."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel_size: int):
        super().__init__()
        self.cell_list = nn.ModuleList(
            [ConvGRUCell(input_dim, hidden_dim, kernel_size)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cell = self.cell_list[0]
        h = x.new_zeros((x.shape[0], cell.hidden_dim) + x.shape[2:])
        return cell(x, h)


class V2VNetFusion(nn.Module):
    """``num_iteration`` rounds of all-to-all message passing: every sender
    j warped into every receiver i (L x L warps), a message CNN on
    [warped, receiver], the ROI of the warp (warped all-ones maps) times
    the pair mask, a masked mean or max over senders, a ConvGRU update;
    then a Linear over the ego node's channels (ref fusion_in_one.py:173)."""

    def __init__(self, in_channels: int, num_iteration: int = 2,
                 agg_operator: str = "avg", kernel_size: int = 3):
        super().__init__()
        if agg_operator not in ("avg", "max"):
            raise ValueError(f"unknown V2VNet aggregation {agg_operator!r}")
        self.num_iteration = num_iteration
        self.agg_operator = agg_operator
        self.msg_cnn = nn.Conv2d(2 * in_channels, in_channels, 3, padding=1)
        self.conv_gru = ConvGRU(2 * in_channels, in_channels, kernel_size)
        self.mlp = nn.Linear(in_channels, in_channels)

    def forward(self, features, affines, agent_mask):
        b, l, c, h, w = features.shape
        pairs = affines.reshape(b * l * l, 2, 3)
        pair_valid = agent_mask[:, :, None] & agent_mask[:, None, :]
        roi = warp_affine(features.new_ones((b * l * l, 1, h, w)), pairs)
        roi = roi.reshape(b, l, l, 1, h, w) \
            * pair_valid[..., None, None, None].to(features.dtype)
        real = agent_mask[:, :, None, None, None]
        x = features
        for _ in range(self.num_iteration):
            senders = x[:, None].expand(b, l, l, c, h, w)
            warped = warp_affine(senders.reshape(b * l * l, c, h, w), pairs)
            receivers = x[:, :, None].expand(b, l, l, c, h, w)
            msg_in = torch.cat([warped.reshape(b, l, l, c, h, w), receivers],
                               dim=3).reshape(b * l * l, 2 * c, h, w)
            message = self.msg_cnn(msg_in).reshape(b, l, l, c, h, w) * roi
            if self.agg_operator == "avg":
                count = pair_valid.sum(dim=2).clamp(min=1)
                agg = message.sum(dim=2) / count[..., None, None, None]
            else:
                neg = torch.finfo(message.dtype).min
                agg = torch.where(pair_valid[..., None, None, None], message,
                                  neg).amax(dim=2)
                agg = torch.where(real, agg, 0.0)
            cat = torch.cat([x, agg], dim=2).reshape(b * l, 2 * c, h, w)
            x = self.conv_gru(cat).reshape(b, l, c, h, w)
            x = x * real.to(x.dtype)
        return self.mlp(x[:, 0].permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _CBR(nn.Module):
    """ref when2com_fuse.py conv2DBatchNormRelu: ``cbr_unit`` = [conv with
    bias, batch norm, ReLU]."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.cbr_unit = MaskedSequential(*conv_bn_relu(in_ch, out_ch, stride,
                                                       bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cbr_unit(x)


class _KeyQueryGenerator(nn.Module):
    """ref when2com_fuse.py:253 km_generator_v2: a stride-2 conv block,
    torch's adaptive average pool to (5, 7), flattened CHW, 3 Linears."""

    def __init__(self, out_size: int):
        super().__init__()
        self.conv1 = _CBR(256, 128, 2)
        self.fc = nn.Sequential(nn.Linear(128 * 5 * 7, 256), nn.ReLU(),
                                nn.Linear(256, 128), nn.ReLU(),
                                nn.Linear(128, out_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.adaptive_avg_pool2d(self.conv1(x), (5, 7))
        return self.fc(y.flatten(1))


class When2commFusion(nn.Module):
    """Query-key handshake over the ego-warped agents: a policy CNN, key
    and query generators, additive attention with a masked softmax over
    agents, the weighted sum (ref fusion_in_one.py:354,
    when2com_fuse.py:237-363)."""

    def __init__(self, in_channels: int, query_size: int = 32,
                 key_size: int = 256):
        super().__init__()
        self.key_size = key_size
        self.query_key_net = nn.Sequential(OrderedDict(
            (f"conv{i + 1}", _CBR(c_in, c_out, stride))
            for i, (c_in, c_out, stride) in enumerate(
                [(in_channels, 512, 1), (512, 256, 1), (256, 256, 2),
                 (256, 256, 1), (256, 256, 2)])))
        self.key_net = _KeyQueryGenerator(key_size)
        self.query_net = _KeyQueryGenerator(query_size)
        self.attention_net = nn.ModuleDict({
            "linear_feat": nn.Linear(key_size, 128),
            "linear_context": nn.Linear(query_size, 128),
            "linear_out": nn.Linear(128, 1)})

    def forward(self, features, affines, agent_mask):
        warped = warp_agents_to_ego(features, affines[:, 0], agent_mask)
        b, l, c, h, w = warped.shape
        x = self.query_key_net(warped.reshape(b * l, c, h, w))
        keys = self.key_net(x).reshape(b, l, self.key_size)
        query = self.query_net(x.reshape((b, l) + x.shape[1:])[:, 0])
        att = self.attention_net
        scores = torch.einsum("blf,bf->bl", att["linear_feat"](keys),
                              att["linear_context"](query))
        weight = _masked_softmax(scores, agent_mask, 1)
        return torch.einsum("bl,blchw->bchw", weight, warped)
