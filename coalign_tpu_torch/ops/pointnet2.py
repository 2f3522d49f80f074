"""Masked ball query, grouping and the multi-scale set abstraction.

Port of coalign_tpu/ops/pointnet2.py (ref opencood/pcdet_utils/pointnet2/
pointnet2_stack), which FPV-RCNN's keypoint features (models/vsa.py) and its
RoI-grid pooling (models/fpvrcnn.py) use. Every op takes a leading frame
axis: the JAX package vmaps one frame's op over the frames.

The ball query keeps, of the supports within ``radius``, the ``nsample``
nearest, as the JAX package's ``lax.top_k`` does: squared distances from
the matmul identity |q|^2 + |s|^2 - 2 q.s (full float32 on CUDA while
``torch.backends.cuda.matmul.allow_tf32`` is off, runtime.configure_cuda),
masked supports at +inf, ties ranked lower index first. ``torch.topk``
promises no order among equal values, so it runs on a key unique to each
support, the distance's float32 bits in their total order joined with the
index (_order_key): the nsample smallest keys are the nearest supports
ranked by distance, then index, as ``lax.top_k`` ranks them, with no full
sort. Queries go in chunks of 512, as in the JAX package, so the
(frames, chunk, supports) distance matrix stays bounded.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.models.layers import MaskedBatchNorm

CHUNK = 512
# frames a chunk: a request's 5 agent frames at once; a B = 4 train batch's
# 20 in four groups, which keeps each chunk's (frames, 512, 30,000) int64
# distance keys and their topk near 1 GB
FRAMES = 5


def _order_key(d2: torch.Tensor) -> torch.Tensor:
    """An int64 key per (distance, index): float32 distances mapped to
    their total order's unsigned bits (a negative float's bits flipped, a
    positive one's sign bit set), times N, plus the support index. Equal
    distances rank by index; the key is unique, so topk's order among
    equal values never matters."""
    n = d2.shape[-1]
    bits = d2.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits, bits + 0x80000000)
    return u * n + torch.arange(n, device=d2.device)


def _ball_query_chunk(q, xyz, sq_support, mask, radius: float, nsample: int):
    """One chunk of queries q (F, C, 3) -> idx (F, C, nsample) int64 and
    the in-radius flags, ranked by distance then index."""
    n = xyz.shape[1]
    d2 = ((q * q).sum(-1)[..., None] + sq_support[:, None, :]
          - 2.0 * torch.matmul(q, xyz.transpose(1, 2)))
    d2 = torch.where(mask[:, None, :], d2, float("inf"))
    if d2.dtype == torch.float32:
        key = torch.topk(_order_key(d2), nsample, dim=-1,
                         largest=False).values
        idx = key % n
    else:   # a float64 model (CPU parity tests): a stable full sort
        idx = torch.sort(d2, dim=-1, stable=True).indices[..., :nsample]
    return idx, torch.gather(d2, -1, idx) <= radius * radius


def masked_ball_query(new_xyz, new_mask, xyz, mask, radius: float,
                      nsample: int, chunk: int = CHUNK):
    """new_xyz (F, K, 3) queries, new_mask (F, K); xyz (F, N, 3) supports,
    mask (F, N). Returns idx (F, K, S) int64 into the supports and valid
    (F, K, S) bool, S = min(nsample, N); a masked query has no valid
    entry. FRAMES frames and ``chunk`` queries at a time."""
    f, k = new_xyz.shape[:2]
    nsample = min(nsample, xyz.shape[1])
    sq_support = (xyz * xyz).sum(-1)
    rows = []
    for a in range(0, f, FRAMES):
        z = slice(a, a + FRAMES)
        parts = [_ball_query_chunk(new_xyz[z, s:s + chunk], xyz[z],
                                   sq_support[z], mask[z], radius, nsample)
                 for s in range(0, k, chunk)]
        rows.append((torch.cat([p[0] for p in parts], dim=1),
                     torch.cat([p[1] for p in parts], dim=1)))
    idx = torch.cat([r[0] for r in rows])
    valid = torch.cat([r[1] for r in rows])
    return idx, valid & new_mask[..., None]


def _gather_rows(x, idx):
    """x (F, N, C), idx (F, K, S) -> (F, K, S, C)."""
    f, k, s = idx.shape
    rows = torch.gather(x, 1, idx.reshape(f, k * s, 1).expand(-1, -1,
                                                              x.shape[-1]))
    return rows.reshape(f, k, s, x.shape[-1])


def group_points(new_xyz, xyz, feats, idx, valid):
    """Gather and recentre groups: new_xyz (F, K, 3), xyz (F, N, 3), feats
    (F, N, C) or None, idx/valid (F, K, S) -> (F, K, S, 3 [+ C]), invalid
    entries zero."""
    out = _gather_rows(xyz, idx) - new_xyz[:, :, None, :]
    if feats is not None:
        out = torch.cat([out, _gather_rows(feats, idx)], dim=-1)
    return out * valid[..., None]


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (ref pointnet2_modules.py
    StackSAModuleMSG; coalign_tpu/ops/pointnet2.py:78): per radius, ball
    query -> group -> a shared MLP of Linear (no bias) + masked batch norm
    (statistics over the valid entries only) + ReLU -> max over the
    samples; the branches concatenated. ``linears`` and ``norms`` hold the
    layers of all branches in order (flax's Dense_k / MaskedBatchNorm_k).
    """

    def __init__(self, in_channels: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]]):
        super().__init__()
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        self.widths = tuple(tuple(int(w) for w in m) for m in mlps)
        linears, norms = [], []
        for widths in self.widths:
            c = in_channels + 3
            for w in widths:
                linears.append(nn.Linear(c, w, bias=False))
                norms.append(MaskedBatchNorm(w))
                c = w
        self.linears = nn.ModuleList(linears)
        self.norms = nn.ModuleList(norms)
        self.out_channels = sum(w[-1] for w in self.widths)

    def forward(self, new_xyz, new_mask, xyz, mask, feats=None):
        """new_xyz (F, K, 3) + new_mask (F, K); xyz (F, N, 3) + mask
        (F, N); feats (F, N, C) or None. Returns (F, K, out_channels),
        zero for a masked query."""
        outs, layer = [], 0
        for radius, nsample, widths in zip(self.radii, self.nsamples,
                                           self.widths):
            idx, valid = masked_ball_query(new_xyz, new_mask, xyz, mask,
                                           radius, nsample)
            g = group_points(new_xyz, xyz, feats, idx, valid)
            for _ in widths:
                g = self.linears[layer](g)
                g = F.relu(self.norms[layer](g, valid)[0]) * valid[..., None]
                layer += 1
            outs.append(g.amax(dim=2))
        return torch.cat(outs, dim=-1) * new_mask[..., None]
