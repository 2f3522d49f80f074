"""Exact greedy rotated NMS with fixed-size outputs.

Port of coalign_tpu/utils/nms.py (which replaces the reference's shapely
greedy NMS, ref box_utils.py:693). The (K, K) rotated IoU matrix comes from
the CUDA kernel (kernels/rotated_iou.py) on the GPU, one launch for the whole
batch. The sequential keep dependency is resolved by the same overlap-matrix
fixpoint as the JAX package: keep[i] = valid[i] and no kept higher-ranked box
suppresses i, iterated from keep = valid.
"""

from __future__ import annotations

import torch

from coalign_tpu_torch.kernels.rotated_iou import rotated_iou

ROUNDS_PER_SYNC = 8


def nms_rotated(corners: torch.Tensor, scores: torch.Tensor,
                valid_mask: torch.Tensor, iou_threshold: float,
                max_keep: int | None = None):
    """Greedy rotated NMS over a batch of masked corner boxes.

    corners (B, K, 4, 2), scores (B, K), valid_mask (B, K) bool. A box is
    suppressed when its IoU with a kept, higher-scoring box exceeds
    ``iou_threshold``. The IoU is the kernel's, in float32 (corners of
    another float dtype are cast).

    Returns (order (B, K) int64, keep (B, K) bool): ``order`` ranks the boxes
    by score, high to low (stable, lower index first on ties); ``keep[:, r]``
    says whether the r-th ranked box survived. With ``max_keep`` below K
    only the first ``max_keep`` survivors in rank order stay kept (the JAX
    package's cap).
    """
    k = corners.shape[1]
    scores = torch.where(valid_mask, scores, float("-inf"))
    order = torch.argsort(-scores, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)

    c = corners.float().contiguous()
    iou = rotated_iou(c, c)                                   # (B, K, K)
    # suppress[b, j, i]: the higher-ranked j would kill i
    suppress = (iou > iou_threshold) & (rank[:, :, None] < rank[:, None, :])

    # The JAX package tests for convergence after every round; here that
    # test is a host sync, so rounds run in chunks with one test per chunk.
    # Rounds past the fixpoint change nothing, and the total stays capped at
    # K rounds as in the JAX loop, so the result is the same.
    keep = valid_mask
    done = 0
    while done < k:
        for _ in range(min(ROUNDS_PER_SYNC, k - done)):
            prev = keep
            killed = (suppress & keep[:, :, None]).any(dim=1)
            keep = valid_mask & ~killed
        done += min(ROUNDS_PER_SYNC, k - done)
        if torch.equal(keep, prev):
            break
    keep = torch.gather(keep, 1, order)
    if max_keep is not None and max_keep < k:
        keep = keep & (torch.cumsum(keep.to(torch.int64), dim=1) <= max_keep)
    return order, keep
