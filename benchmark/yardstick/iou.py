"""Rotated-BEV IoU in plain PyTorch, and the operations it needs.

Frozen copies, kept here so that the yardstick does not move with the
program:
  * polygon_area ... separated_pairs: coalign_tpu_torch/utils/iou.py as of
    the port's last module slice (the plain version of the rotated-IoU
    kernel, and the kernel's separation cull written out);
  * iou_ops: chip_smoke.py's iou_ops, the float32 operations the rotated-IoU
    function needs on given boxes, which the kernel's roofline share
    divides by the published peak.
The reference's NMS (reference/postprocess.py) takes its IoU from here.
"""

from __future__ import annotations

import math

import torch

# the separation cull's constants (coalign_tpu_torch/csrc/rotated_iou.cu)
SEPARATION_MARGIN = 1e-2   # metres between the two circumcircles
MIN_EDGE = 0.1             # metres; a shorter edge makes a box degenerate
SQUARE_COS = 1e-2          # a corner's |cos| above this makes it degenerate


def polygon_area(corners: torch.Tensor) -> torch.Tensor:
    """Shoelace area of (..., K, 2) polygons with vertices in ring order,
    taken relative to the first vertex."""
    corners = corners - corners[..., :1, :]
    x, y = corners[..., 0], corners[..., 1]
    x_n = torch.roll(x, -1, dims=-1)
    y_n = torch.roll(y, -1, dims=-1)
    return 0.5 * torch.abs(torch.sum(x * y_n - x_n * y, dim=-1))


def _points_in_quad(points, quad, eps=1e-6):
    """points (..., P, 2), convex quad (..., 4, 2), any winding -> (..., P)."""
    a = quad
    edge = torch.roll(quad, -1, dims=-2) - a
    rel = points[..., :, None, :] - a[..., None, :, :]          # (..., P, 4, 2)
    cross = (edge[..., None, :, 0] * rel[..., 1]
             - edge[..., None, :, 1] * rel[..., 0])             # (..., P, 4)
    return (torch.all(cross >= -eps, dim=-1)
            | torch.all(cross <= eps, dim=-1))


def _segment_intersections(quad1, quad2, eps=1e-9):
    """All 16 edge-edge crossings: points (..., 16, 2), valid (..., 16)."""
    r = torch.roll(quad1, -1, dims=-2) - quad1
    s = torch.roll(quad2, -1, dims=-2) - quad2
    p_ = quad1[..., :, None, :]
    r_ = r[..., :, None, :]
    q_ = quad2[..., None, :, :]
    s_ = s[..., None, :, :]
    denom = r_[..., 0] * s_[..., 1] - r_[..., 1] * s_[..., 0]
    qp = q_ - p_
    t_num = qp[..., 0] * s_[..., 1] - qp[..., 1] * s_[..., 0]
    u_num = qp[..., 0] * r_[..., 1] - qp[..., 1] * r_[..., 0]
    denom_safe = torch.where(torch.abs(denom) < eps, 1.0, denom)
    t = t_num / denom_safe
    u = u_num / denom_safe
    valid = ((torch.abs(denom) >= eps)
             & (t >= -eps) & (t <= 1 + eps)
             & (u >= -eps) & (u <= 1 + eps))
    pts = p_ + t[..., None] * r_
    batch = pts.shape[:-3]
    return pts.reshape(batch + (16, 2)), valid.reshape(batch + (16,))


def quad_intersection_area(quad1: torch.Tensor,
                           quad2: torch.Tensor) -> torch.Tensor:
    """Intersection area of convex quads (..., 4, 2) x (..., 4, 2) -> (...)."""
    in12 = _points_in_quad(quad1, quad2)
    in21 = _points_in_quad(quad2, quad1)
    xpts, xvalid = _segment_intersections(quad1, quad2)
    cand = torch.cat([quad1, quad2, xpts], dim=-2)              # (..., 24, 2)
    valid = torch.cat([in12, in21, xvalid], dim=-1)             # (..., 24)

    count = valid.sum(dim=-1)
    vf = valid[..., None].to(cand.dtype)
    centroid = (torch.sum(cand * vf, dim=-2)
                / torch.clamp(count, min=1)[..., None].to(cand.dtype))
    rel = cand - centroid[..., None, :]
    ang = torch.where(valid, torch.atan2(rel[..., 1], rel[..., 0]),
                      torch.full_like(rel[..., 0], 1e30))
    order = torch.argsort(ang, dim=-1, stable=True)
    xs = torch.gather(cand[..., 0], -1, order)
    ys = torch.gather(cand[..., 1], -1, order)

    # invalid slots sort last; filling them with the first vertex closes the
    # ring, and the duplicates add nothing to the shoelace sum
    idx = torch.arange(cand.shape[-2], device=cand.device)
    inprefix = idx < count[..., None]
    xs = torch.where(inprefix, xs, xs[..., 0:1])
    ys = torch.where(inprefix, ys, ys[..., 0:1])
    x_n = torch.roll(xs, -1, dims=-1)
    y_n = torch.roll(ys, -1, dims=-1)
    area = 0.5 * torch.abs(torch.sum(xs * y_n - x_n * ys, dim=-1))
    return torch.where(count >= 3, area, 0.0)


def rotated_iou_plain(corners1: torch.Tensor,
                      corners2: torch.Tensor) -> torch.Tensor:
    """IoU matrix of rotated BEV boxes, (..., N, 4, 2) x (..., M, 4, 2) ->
    (..., N, M); the leading dims must match.

    Each pair is intersected in a frame whose origin is the first corner of
    its row box, and each area is taken relative to the box's own first
    corner. IoU does not change under translation, and float32 then stays
    within 1e-6 of float64 at the +-140 m of the flagship's range, where the
    JAX package's untranslated form cancels down to about 5e-4
    (tests/test_torch_iou.py).
    """
    n, m = corners1.shape[-3], corners2.shape[-3]
    lead = corners1.shape[:-3]
    origin = corners1[..., :, None, 0:1, :]              # (..., N, 1, 1, 2)
    c1 = (corners1[..., :, None, :, :] - origin).expand(lead + (n, m, 4, 2))
    c2 = corners2[..., None, :, :, :] - origin
    inter = quad_intersection_area(c1, c2)
    a1 = polygon_area(corners1)[..., :, None]
    a2 = polygon_area(corners2)[..., None, :]
    union = a1 + a2 - inter
    return torch.where(union > 1e-9, inter / union, 0.0)


def box_reach(corners: torch.Tensor):
    """Centre (..., N, 2) and reach (..., N) of (..., N, 4, 2) quads: the
    mean of the corners, and the largest centre-to-corner distance plus half
    the separation margin. The reach is infinite for a degenerate box, one
    with an edge shorter than ``MIN_EDGE`` or a corner more than ~0.6 degrees
    off square, and for NaN corners."""
    centre = corners.mean(dim=-2)
    radius = torch.linalg.vector_norm(corners - centre[..., None, :],
                                      dim=-1).amax(dim=-1)
    edge = torch.roll(corners, -1, dims=-2) - corners
    len2 = (edge * edge).sum(dim=-1)
    dot = (edge * torch.roll(edge, -1, dims=-2)).sum(dim=-1)
    square = dot * dot <= SQUARE_COS ** 2 * len2 * torch.roll(len2, -1, -1)
    ok = (len2 >= MIN_EDGE ** 2).all(dim=-1) & square.all(dim=-1)
    return centre, torch.where(ok, radius + 0.5 * SEPARATION_MARGIN, math.inf)


def separated_pairs(corners1: torch.Tensor,
                    corners2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4, 2) x (..., M, 4, 2) -> bool (..., N, M): the pairs whose
    circumcircles lie more than ``SEPARATION_MARGIN`` apart, neither box
    degenerate. Their IoU is exactly 0 (csrc/rotated_iou.cu says why;
    tests/test_torch_iou_cull.py holds it against the JAX package)."""
    c1, r1 = box_reach(corners1)
    c2, r2 = box_reach(corners2)
    d = c1[..., :, None, :] - c2[..., None, :, :]
    reach = r1[..., :, None] + r2[..., None, :]
    return (d * d).sum(dim=-1) > reach * reach


def iou_ops(c1: torch.Tensor, c2: torch.Tensor) -> float:
    """The f32 operations that the rotated-IoU function needs on these boxes
    (a multiply-add counts 2, a divide, square root or comparison 1), each
    value computed once, whatever a kernel spends:
      per box  58: its 4 edge vectors (8), its shoelace area (16) and the
                test of that area against 0 (1); for the separation test
                its centre (8) and its reach, the largest centre-to-corner
                distance plus half the margin (25). The kernel's guard
                against degenerate boxes (the shortest edge, square corners)
                belongs to its cull's design, not to the function, and is
                not charged;
      per pair with a box of zero area 1: the OR of the two boxes' tests;
                the intersection lies inside that box, so the IoU is 0
                without more work (a kernel that computes such a pair in
                full, as this one does, spends more than the function
                needs);
      per cleared pair 8: the separation test (the centre difference 2, its
                squared length 3, the reaches' sum and its square 2, the
                comparison 1); such a pair's IoU is 0 without more work;
      per surviving pair 356: the 16 vertex differences between the two
                quads (32); the 32 vertex-against-edge cross products (96),
                which decide the 8 point-in-quad tests (2 comparisons each,
                64) and are the numerators of the crossings' t and u; the 16
                edge-edge denominators (48) with their eps test (16); t and
                u (32 divides) with their range tests (64); the IoU from the
                areas (4);
      per valid crossing 4, for its point;
      per surviving pair with c >= 3 candidates 13c + log2(c!): the
                centroid (2c), the pseudo-angle keys (7c), the shoelace sum
                (4c), and the sort's comparisons, log2(c!) being the fewest
                any comparison sort needs on average.
    The zero areas come from polygon_area in float32, the cleared pairs
    from separated_pairs, c and the valid crossings from the plain
    version's own tests in its frame, on these boxes."""
    n, m = c1.shape[-3], c2.shape[-3]
    origin = c1[..., :, None, 0:1, :]
    q1 = (c1[..., :, None, :, :] - origin).expand(c1.shape[:-3] + (n, m, 4, 2))
    q2 = c2[..., None, :, :, :] - origin
    xing = _segment_intersections(q1, q2)[1].sum(-1).double()
    cnt = (_points_in_quad(q1, q2).sum(-1) + _points_in_quad(q2, q1).sum(-1)
           + xing).double()
    sort = torch.lgamma(cnt + 1) / math.log(2.0)
    survivor = 356 + 4 * xing + torch.where(cnt >= 3, 13 * cnt + sort, 0.0)
    flat = ((polygon_area(c1.float()) == 0)[..., :, None]
            | (polygon_area(c2.float()) == 0)[..., None, :])
    per_pair = torch.where(flat, 1.0, torch.where(separated_pairs(c1, c2),
                                                  8.0, survivor))
    boxes = c1.shape[:-3].numel() * (n + m)
    return float(per_pair.sum()) + 58 * boxes


def iou_bytes(c1: torch.Tensor, c2: torch.Tensor) -> float:
    """The bytes the rotated-IoU function must move: each float32 corner
    of both inputs read once, each float32 IoU written once."""
    n, m = c1.shape[-3], c2.shape[-3]
    lead = c1.shape[:-3].numel()
    return 4.0 * (c1.numel() + c2.numel() + lead * n * m)
