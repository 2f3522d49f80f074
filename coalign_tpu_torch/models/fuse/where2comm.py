"""Where2comm: confidence-guided sparse feature transmission and fusion.

Port of coalign_tpu/models/fuse/where2comm.py (ref opencood/models/
comm_modules/where2comm.py:9, fuse_modules/where2comm_attn.py:174): each
agent's confidence map gates which of its BEV pixels cross the channel,
then the masked maps are fused scale by scale. Neither module has
parameters; the Gaussian smoothing is a fixed depthwise convolution.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.models.fuse.fusion import AttFusion, MaxFusion


def gaussian_kernel(k_size: int = 5, sigma: float = 1.0) -> np.ndarray:
    """The reference's smoothing kernel, with its 1 / (2 pi sigma)
    normalization (not 1 / (2 pi sigma^2), and not summing to 1)."""
    center = k_size // 2
    x, y = np.mgrid[-center:k_size - center, -center:k_size - center]
    g = 1 / (2 * np.pi * sigma) * np.exp(-(x ** 2 + y ** 2) / (2 * sigma ** 2))
    return g.astype(np.float32)


class Communication(nn.Module):
    """Confidence logits -> transmission mask and communication rate (ref
    comm_modules/where2comm.py:34-78): an agent's confidence is the max
    over anchors of the sigmoid of its cls logits, smoothed by the
    zero-padded 5x5 Gaussian (sigma 1), kept where above 0.01; the ego's
    own map is never masked. The JAX package's options for these (its
    Communication fields) are set by no caller, and are constants here."""

    threshold = 0.01

    def __init__(self):
        super().__init__()
        self.register_buffer("kernel", torch.from_numpy(
            gaussian_kernel())[None, None], persistent=False)

    def confidence(self, conf_logits: torch.Tensor) -> torch.Tensor:
        """conf_logits (B, L, A, H, W) -> the smoothed confidence
        (B, L, 1, H, W) that the mask thresholds."""
        b, l, _, h, w = conf_logits.shape
        conf = torch.sigmoid(conf_logits).amax(dim=2, keepdim=True)
        return F.conv2d(conf.reshape(b * l, 1, h, w),
                        self.kernel.to(conf.dtype), padding=2).reshape(
            b, l, 1, h, w)

    def forward(self, conf_logits: torch.Tensor, agent_mask: torch.Tensor):
        """conf_logits (B, L, A, H, W) -> (mask (B, L, 1, H, W), rate ()):
        the rate is the share of the valid agents' pixels sent, taken before
        the ego's row is set to 1 (ref :61 sums the mask over H*W)."""
        h, w = conf_logits.shape[-2:]
        conf = self.confidence(conf_logits)
        mask = (conf > self.threshold).to(conf.dtype)
        valid = agent_mask[:, :, None, None, None].to(conf.dtype)
        rate = (mask * valid).sum() / torch.clamp(
            valid.sum() * (h * w), min=1.0)
        mask = torch.cat([torch.ones_like(mask[:, :1]), mask[:, 1:]], dim=1)
        return mask, rate


class Where2commFusion(nn.Module):
    """Multiscale fusion of communication-masked maps (ref
    where2comm_attn.py:262-276): scale 0 takes the transmission mask, each
    deeper scale the previous scale's mask max-pooled by the resolution
    ratio; ``agg_mode`` ATTEN fuses by AttFusion, otherwise by max."""

    def __init__(self, agg_mode: str = "ATTEN",
                 feature_dims=(64, 128, 256)):
        super().__init__()
        self.fuse_modules = nn.ModuleList(
            [AttFusion(d) if agg_mode == "ATTEN" else MaxFusion()
             for d in feature_dims])
        self.comm = Communication()

    def forward(self, scales, conf_logits, affines, agent_mask):
        """scales: per scale (B, L, C_i, h_i, w_i); conf_logits
        (B, L, A, H0, W0) at scale 0's resolution. Returns (the fused maps,
        one (B, C_i, h_i, w_i) a scale, and the communication rate)."""
        mask, rate = self.comm(conf_logits, agent_mask)
        fused = []
        for fuse, feat in zip(self.fuse_modules, scales):
            b, l, _, h, w = feat.shape
            if mask.shape[-2] != h:
                factor = mask.shape[-2] // h
                mask = F.max_pool2d(mask.reshape((b * l, 1) + mask.shape[-2:]),
                                    factor, factor).reshape(b, l, 1, h, w)
            fused.append(fuse(feat * mask, affines, agent_mask))
        return fused, rate
