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

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                pad_parity: bool = False):
        """relu(norm(linear(x))) of the points (F, N, C_in), the norm's
        training statistics over the valid points ``mask`` (F, N); with
        ``pad_parity`` also the (C,) row of a zeroed pad slot, normalized by
        the running statistics (MaskedBatchNorm's ``pad_rows``)."""
        x = self.linear(x)
        z = self.linear(x.new_zeros(self.linear.in_features)) \
            if pad_parity else None
        if self.norm is not None:
            x, z = self.norm(x, mask, pad_rows=z)
        return torch.relu(x), None if z is None else torch.relu(z)


class PillarEncoder(nn.Module):
    """points (F, N, 4) + mask (F, N) -> dense BEV (F, C, ny, nx).

    10-channel decoration, per-point Linear(+BN)+ReLU, max over each pillar.
    This slice ports the single-layer PFN that every PointPillars config of
    the repo uses; a longer ``num_filters`` raises.

    ``pad_parity`` reproduces what the reference computes for the zeroed pad
    slots of its (pillar, 32 points) table: they run through Linear+BN+ReLU
    too and take part in the per-pillar max, so every non-empty pillar's max
    also sees relu(BN(W.0)). Reference checkpoints need it to reproduce the
    reference's activations.
    """

    def __init__(self, spec: P.PillarSpec, num_filters: Sequence[int] = (64,),
                 use_norm: bool = True, with_distance: bool = False,
                 use_absolute_xyz: bool = True, pad_parity: bool = False):
        super().__init__()
        if len(num_filters) != 1:
            raise NotImplementedError(
                f"only a single PFN layer is ported, got {list(num_filters)}")
        self.spec = spec
        self.with_distance = with_distance
        self.use_absolute_xyz = use_absolute_xyz
        self.pad_parity = pad_parity
        in_ch = (10 if use_absolute_xyz else 7) + int(with_distance)
        self.pfn_layers = nn.ModuleList(
            [PFNLayer(in_ch, num_filters[0], use_norm)])

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
        x, z = self.pfn_layers[0](feats, valid, self.pad_parity)
        bev = P.scatter_max_bev(x * valid[..., None], ids, valid, spec)
        if z is not None:                                   # (C,)
            occupied = P.pillar_count_bev(ids, valid, spec)[..., None] > 0
            bev = torch.where(occupied, torch.maximum(bev, z), bev)
        return bev.reshape(f, spec.ny, spec.nx, -1).permute(0, 3, 1, 2) \
            .contiguous()
