"""MASH: pose-free fusion by correspondence attention.

Port of coalign_tpu/models/fuse/mash.py (ref opencood/models/
point_pillar_mash.py:18-160, sub_modules/mash_utils.py). The reference
builds a correspondence volume between the ego's and each neighbor's
coarse grids, takes its argmax as a sampling grid and grid-samples the
neighbor's map; the JAX package, and so the port, takes the expectation
instead: one soft cross-attention a neighbor over the coarse grid, with a
learned no-match bin, then a max over agents.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.models.layers import MaskedSequential, conv_bn_relu


def down_block(in_ch: int, out_ch: int) -> MaskedSequential:
    """segnet-style downsample (ref mash_utils.segnetDown3): two stride-1
    and one stride-2 3x3 conv_bn_relu, without a mask (the JAX package's
    _Down normalizes over every agent slot, padded ones included)."""
    return MaskedSequential(*conv_bn_relu(in_ch, out_ch),
                            *conv_bn_relu(out_ch, out_ch),
                            *conv_bn_relu(out_ch, out_ch, stride=2))


class MASHFusion(nn.Module):
    """Pose-free correspondence fusion over (B, L, C, H, W) maps.

    ``query_net`` and ``key_net`` (log2 ``coarse_downsample`` down blocks
    each) take every agent's map to a coarse grid of ``query_dim``
    channels; the values are the maps average-pooled to that grid. The
    ego's queries attend over each agent's keys and a no-match bin
    (``no_match``, a learned logit); each agent's warped values, scaled by
    the mass on real positions, are max-fused with the ego's, upsampled
    bilinearly and max-fused with the ego's full-resolution map."""

    def __init__(self, feature_dim: int, coarse_downsample: int = 4,
                 query_dim: int = 32):
        super().__init__()
        self.coarse_downsample = coarse_downsample
        self.query_dim = query_dim
        n_down = max(1, int(math.log2(coarse_downsample)))
        dims = [feature_dim] + [query_dim] * n_down
        self.query_net = nn.ModuleList(
            [down_block(dims[i], dims[i + 1]) for i in range(n_down)])
        self.key_net = nn.ModuleList(
            [down_block(dims[i], dims[i + 1]) for i in range(n_down)])
        self.no_match = nn.Parameter(torch.zeros(1))

    def init_weights(self, generator: torch.Generator):
        """flax's init of ``no_match``: zero (its blocks take the default
        init of models/zoo.init_weights)."""
        self.no_match.zero_()

    def forward(self, features, affines, agent_mask):
        """features (B, L, C, H, W); the affines are not used (MASH is
        pose-free). Returns (fused (B, C, H, W), the correspondence logits
        (B, L, P, P + 1), P the coarse grid's pixels, the no-match bin
        last)."""
        del affines
        b, l, c, h, w = features.shape
        flat = features.reshape(b * l, c, h, w)
        q, k = flat, flat
        for q_down, k_down in zip(self.query_net, self.key_net):
            q, k = q_down(q), k_down(k)
        hc, wc = q.shape[-2:]
        q = q.reshape(b, l, self.query_dim, hc * wc).transpose(-1, -2)
        k = k.reshape(b, l, self.query_dim, hc * wc).transpose(-1, -2)
        ds = self.coarse_downsample
        vals = F.avg_pool2d(flat, ds, ds).reshape(b, l, c, hc * wc)
        vals = vals.transpose(-1, -2)                        # (B, L, P, C)

        # (B, L, P_t, P_s): the ego's query grid against each agent's keys
        logits = torch.einsum("bpd,blsd->blps", q[:, 0], k) / math.sqrt(
            self.query_dim)
        full = torch.cat([logits, self.no_match.to(logits.dtype).expand(
            logits.shape[:-1] + (1,))], dim=-1)
        attn = torch.softmax(full, dim=-1)
        warped = torch.einsum("blps,blsc->blpc", attn[..., :-1], vals)
        warped = warped * (1.0 - attn[..., -1:])

        # masked agents never win the max: where() sends them no gradient;
        # amax and maximum split the gradient among ties as JAX's max does
        cands = torch.where(agent_mask[:, :, None, None], warped,
                            float("-inf"))
        fused_c = torch.maximum(vals[:, 0], cands.amax(dim=1))
        fused_c = fused_c.transpose(1, 2).reshape(b, c, hc, wc)
        fused = F.interpolate(fused_c, size=(h, w), mode="bilinear",
                              align_corners=False)
        return torch.maximum(fused, features[:, 0]), full
