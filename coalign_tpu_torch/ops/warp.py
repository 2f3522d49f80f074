"""BEV affine warping of agent feature maps.

Port of coalign_tpu/ops/warp.py, which reimplements
``F.affine_grid(align_corners=False)`` + ``F.grid_sample(bilinear, zeros,
align_corners=False)`` (ref torch_transformation_utils.py:322); here it is
those two calls. ``affine_grid`` is a batched matmul, so the grid is full
float32 only while ``torch.backends.cuda.matmul.allow_tf32`` is off (its
default). A bfloat16 map (the compute-dtype policy, models/layers.py) is
sampled as the JAX package samples it (ops/warp.py:29-62): the positions in
float32 (bfloat16 resolves integers only up to 256, so bfloat16 positions
would move samples by pixels on a wide map), the four taps and their
weights in bfloat16, blended op by op in bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from coalign_tpu_torch.ops.roi import bilinear_gather


def warp_affine(src: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """Warp a batch of maps, each by its own normalized affine.

    src (N, C, H, W); affine (N, 2, 3), mapping normalized output
    coordinates to normalized source coordinates (x along W, y along H,
    align_corners=False). Returns (N, C, H, W); samples outside the source
    are zero (the JAX package's ``warp_affine`` under vmap)."""
    if src.dtype == torch.bfloat16:
        return _warp_bf16(src, affine)
    theta = affine.to(src.dtype)
    grid = F.affine_grid(theta, list(src.shape), align_corners=False)
    return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def _warp_bf16(src: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """warp_affine of a bfloat16 map, as the JAX package's bilinear gather
    computes it (ops/roi.bilinear_gather): float32 sample positions, zero
    outside the map."""
    n, c, h, w = src.shape
    a = affine.float()[..., None, None]                  # (N, 2, 3, 1, 1)
    ys = ((2.0 * torch.arange(h, device=src.device, dtype=torch.float32)
           + 1.0) / h - 1.0)[:, None]
    xs = ((2.0 * torch.arange(w, device=src.device, dtype=torch.float32)
           + 1.0) / w - 1.0)[None, :]
    gx = a[:, 0, 0] * xs + a[:, 0, 1] * ys + a[:, 0, 2]
    gy = a[:, 1, 0] * xs + a[:, 1, 1] * ys + a[:, 1, 2]
    fx, fy = ((gx + 1.0) * w - 1.0) / 2.0, ((gy + 1.0) * h - 1.0) / 2.0
    return bilinear_gather(src, fx, fy).permute(0, 3, 1, 2)


def warp_agents_to_ego(features: torch.Tensor, affines: torch.Tensor,
                       agent_mask: torch.Tensor) -> torch.Tensor:
    """Warp every agent's map into the ego frame.

    features (B, L, C, H, W); affines (B, L, 2, 3), the normalized affines
    ego -> agent j (row 0 of the normalized pairwise matrix); agent_mask
    (B, L) bool. The ego slot (l = 0) is its own identity warp and is not
    sampled; masked agents come out as zeros. Returns (B, L, C, H, W).
    """
    b, l, c, h, w = features.shape
    warped = features
    if l > 1:
        neigh = warp_affine(features[:, 1:].reshape(b * (l - 1), c, h, w),
                            affines[:, 1:].reshape(b * (l - 1), 2, 3))
        warped = torch.cat([features[:, :1],
                            neigh.reshape(b, l - 1, c, h, w)], dim=1)
    return warped * agent_mask[:, :, None, None, None].to(features.dtype)
