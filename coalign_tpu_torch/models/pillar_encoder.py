"""PillarVFE + dense-BEV scatter as one module (ref pillar_vfe.py:56,
point_pillar_scatter.py:5), ported from coalign_tpu/models/pillar_encoder.py.

Parameter names are the reference's: ``pfn_layers.0.linear`` and
``pfn_layers.0.norm``, under the model's ``pillar_vfe``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from coalign_tpu_torch.models.layers import MaskedBatchNorm, PolicyLinear
from coalign_tpu_torch.ops import pillars as P


class PFNLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, use_norm: bool):
        super().__init__()
        # computes in the compute dtype when one is set (the JAX
        # package's Dense(dtype=compute_dtype()), pillar_encoder.py:70)
        self.linear = PolicyLinear(in_ch, out_ch, bias=not use_norm)
        self.norm = MaskedBatchNorm(out_ch) if use_norm else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor, z=None):
        """relu(norm(linear(x))) of the points (F, N, C_in), the norm's
        training statistics over the valid points ``mask`` (F, N); and of
        the pad track ``z`` (..., C_in) where given, normalized by the
        running statistics (MaskedBatchNorm's ``pad_rows``), else None."""
        x = self.linear(x)
        if z is not None:
            z = self.linear(z)
        if self.norm is not None:
            x, z = self.norm(x, mask, pad_rows=z)
        return torch.relu(x), None if z is None else torch.relu(z)


class PillarEncoder(nn.Module):
    """points (F, N, 4) + mask (F, N) -> dense BEV (F, C, ny, nx).

    10-channel decoration, per-point Linear(+BN)+ReLU, max over each pillar.
    A longer ``num_filters`` stacks PFN layers as the reference does (ref
    pillar_vfe.py:10-53 PFNLayer; coalign_tpu/models/pillar_encoder.py:
    66-103): a layer before the last has ``out_ch // 2`` units, and its
    per-pillar max, gathered back to the points, is concatenated to them.

    ``pad_parity`` reproduces what the reference computes for the zeroed pad
    slots of its (pillar, 32 points) table: they run through Linear+BN+ReLU
    too and take part in the per-pillar max, so every non-empty pillar's max
    also sees relu(BN(W.0)). Reference checkpoints need it to reproduce the
    reference's activations. After a layer before the last, a pad row is
    its own features beside its pillar's max, so from there on the pad
    track is one row per pillar.
    """

    def __init__(self, spec: P.PillarSpec, num_filters: Sequence[int] = (64,),
                 use_norm: bool = True, with_distance: bool = False,
                 use_absolute_xyz: bool = True, pad_parity: bool = False):
        super().__init__()
        self.spec = spec
        self.with_distance = with_distance
        self.use_absolute_xyz = use_absolute_xyz
        self.pad_parity = pad_parity
        in_ch = (10 if use_absolute_xyz else 7) + int(with_distance)
        layers = []
        for i, out_ch in enumerate(num_filters):
            last = i == len(num_filters) - 1
            units = out_ch if last else out_ch // 2
            layers.append(PFNLayer(in_ch, units, use_norm))
            in_ch = out_ch if last else 2 * units
        self.pfn_layers = nn.ModuleList(layers)

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        f = points.shape[0]
        ids, valid = P.pillar_ids(points, mask, spec)
        feats = P.decorate_points(points, ids, valid, spec)
        if not self.use_absolute_xyz:
            feats = feats[..., 3:]
        if self.with_distance:
            dist = torch.linalg.norm(points[..., :3], dim=-1, keepdim=True)
            feats = torch.cat([feats, dist], dim=-1)
        x = feats
        z = feats.new_zeros(feats.shape[-1]) if self.pad_parity else None
        for layer in self.pfn_layers[:-1]:
            x, z = layer(x, valid, z)
            x = x * valid[..., None]
            # each pillar's max (the sentinel row last, for the invalid
            # points), gathered back to its points
            pmax = P.scatter_max_bev(x, ids, valid, spec)
            pmax = torch.cat([pmax, pmax.new_zeros(f, 1, pmax.shape[-1])], 1)
            if z is not None:
                pmax = torch.maximum(pmax, z)
            gathered = torch.gather(
                pmax, 1, ids[..., None].expand(-1, -1, pmax.shape[-1]))
            x = torch.cat([x, gathered], dim=-1)
            if z is not None:
                z = torch.cat([z.expand_as(pmax), pmax], dim=-1)
        x, z = self.pfn_layers[-1](x, valid, z)
        bev = P.scatter_max_bev(x * valid[..., None], ids, valid, spec)
        if z is not None:                        # (C,) or (F, cells + 1, C)
            if z.dim() > 1:
                z = z[:, :-1]
            occupied = P.pillar_count_bev(ids, valid, spec)[..., None] > 0
            bev = torch.where(occupied, torch.maximum(bev, z), bev)
        return bev.reshape(f, spec.ny, spec.nx, -1).permute(0, 3, 1, 2) \
            .contiguous()
