"""The CUDA kernel's separation cull is exact, held on the CPU.

``separated_pairs`` (coalign_tpu_torch/utils/iou.py) is the predicate by
which csrc/rotated_iou.cu clears a pair without computing it and stores
exactly 0. Every pair it clears must have an IoU of exactly 0.0 in the
port's plain version and in the JAX package's ``rotated_iou_corners``
(numpy path, world coordinates), and no pair with a degenerate box may be
cleared. The inputs are the cull's hard cases: boxes whose circumcircles
are a fraction of the margin apart, corner to corner, in a row and side by
side; long thin boxes; far boxes with parallel and collinear edges; nested
and identical boxes; boxes collapsed to a point or a segment. All of them
sit at the flagship's +-140 m, where float32 rounding is largest.
"""

import numpy as np
import pytest
import torch

from coalign_tpu.utils.iou import rotated_iou_corners
from coalign_tpu_torch.utils.iou import (SEPARATION_MARGIN, box_reach,
                                         rotated_iou_plain, separated_pairs)

torch.set_num_threads(1)

DELTA = SEPARATION_MARGIN


def _rect(cx, cy, w, l, yaw):
    """(4, 2) corners of a w x l rectangle, float64."""
    tmpl = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]]) / 2.0
    lx, ly = tmpl[:, 0] * l, tmpl[:, 1] * w
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([lx * c - ly * s + cx, lx * s + ly * c + cy], -1)


def _cars(n, seed, spread=140.0):
    rng = np.random.default_rng(seed)
    return np.stack([_rect(rng.uniform(-spread, spread),
                           rng.uniform(-spread, spread),
                           rng.uniform(1.5, 2.2), rng.uniform(3.5, 4.8),
                           rng.uniform(-np.pi, np.pi)) for _ in range(n)])


def _radius(box):
    return np.linalg.norm(box - box.mean(0), axis=-1).max()


def _gap_pairs(seed, gaps, thin=False):
    """Pairs (box, other) whose circumcircles are ``gap`` apart, in three
    layouts: corner to corner along box's diagonal (the boxes' nearest
    points are then ``gap`` apart), in a row along box's long axis and side
    by side, both with the same yaw (parallel, collinear edges)."""
    rng = np.random.default_rng(seed)
    first, second = [], []
    for gap in gaps:
        for layout in ("corner", "row", "side"):
            cx, cy = rng.uniform(-140, 140, 2)
            w = rng.uniform(0.1, 0.2) if thin else rng.uniform(1.5, 2.2)
            l, yaw = rng.uniform(1.0, 10.0), rng.uniform(-np.pi, np.pi)
            box = _rect(cx, cy, w, l, yaw)
            w2 = rng.uniform(0.1, 0.2) if thin else rng.uniform(1.5, 2.2)
            l2 = rng.uniform(1.0, 10.0)
            probe = _rect(0, 0, w2, l2, 0.0)
            dist = _radius(box) + _radius(probe) + gap
            if layout == "corner":
                u = box[0] - box.mean(0)
                u /= np.linalg.norm(u)
                # turn the other box so that its corner 2 points back at
                # box's corner 0
                v = probe[2] / np.linalg.norm(probe[2])
                yaw2 = np.arctan2(-u[1], -u[0]) - np.arctan2(v[1], v[0])
            else:
                yaw2 = yaw
                ang = yaw if layout == "row" else yaw + np.pi / 2
                u = np.array([np.cos(ang), np.sin(ang)])
            centre = box.mean(0) + dist * u
            first.append(box)
            second.append(_rect(centre[0], centre[1], w2, l2, yaw2))
    return np.stack(first), np.stack(second)


def _collapsed(seed):
    """Boxes collapsed to a point and to a segment, near and far from the
    cars of ``_cars(., seed)``."""
    cars = _cars(8, seed)
    boxes = []
    for k, car in enumerate(cars):
        centre = car.mean(0) + (0.0 if k % 2 else 30.0)
        boxes.append(np.repeat(centre[None], 4, 0))                 # point
        seg = _rect(centre[0], centre[1], 0.0, 4.0, 0.3 * k)        # segment
        boxes.append(seg)
    return np.stack(boxes)


def _case(name):
    if name == "cars140":
        return _cars(160, 0), _cars(120, 1)
    if name == "gaps":
        return _gap_pairs(2, (DELTA / 2, DELTA, 2 * DELTA, 4 * DELTA))
    if name == "thin":
        return _gap_pairs(3, (DELTA / 2, DELTA, 2 * DELTA, 4 * DELTA),
                          thin=True)
    if name == "parallel_far":
        # a row of identical cars on one line, and the same row turned by
        # 1e-6 rad: parallel and collinear edges 5-100 m apart
        rng = np.random.default_rng(4)
        yaw = rng.uniform(-np.pi, np.pi)
        u = np.array([np.cos(yaw), np.sin(yaw)])
        start = rng.uniform(-140, 100, 2)
        row = np.stack([_rect(*(start + 6.0 * k * u), 1.8, 4.2, yaw)
                        for k in range(16)])
        tilted = np.stack([_rect(*(start + 6.0 * k * u), 1.8, 4.2,
                                 yaw + 1e-6) for k in range(16)])
        return row, np.concatenate([row, tilted])
    if name == "nested_identical":
        cars = _cars(20, 5)
        inner = np.stack([_rect(*c.mean(0), 1.0, 2.0, 0.4) for c in cars])
        return cars, np.concatenate([cars, inner])
    if name == "collapsed":
        return _collapsed(6), np.concatenate([_cars(8, 6), _collapsed(6)])
    raise KeyError(name)


CASES = ["cars140", "gaps", "thin", "parallel_far", "nested_identical",
         "collapsed"]


@pytest.mark.parametrize("name", CASES)
def test_cleared_pairs_have_zero_iou(name):
    c1, c2 = (c.astype(np.float32) for c in _case(name))
    cleared = separated_pairs(torch.from_numpy(c1),
                              torch.from_numpy(c2)).numpy()
    plain = rotated_iou_plain(torch.from_numpy(c1),
                              torch.from_numpy(c2)).numpy()
    jax_iou = np.asarray(rotated_iou_corners(c1, c2, xp=np))
    assert cleared.shape == plain.shape == (len(c1), len(c2))
    assert (plain[cleared] == 0.0).all()
    assert (jax_iou[cleared] == 0.0).all()


@pytest.mark.parametrize("name", CASES)
def test_degenerate_boxes_are_never_cleared(name):
    c1, c2 = (torch.from_numpy(c.astype(np.float32)) for c in _case(name))
    cleared = separated_pairs(c1, c2)
    for boxes, axis in ((c1, 1), (c2, 0)):
        edge = torch.roll(boxes, -1, dims=-2) - boxes
        short = torch.linalg.vector_norm(edge, dim=-1).amin(-1) < 0.1
        hit = cleared.any(dim=axis)
        assert not (hit & short).any()
        assert torch.isinf(box_reach(boxes)[1][short]).all()


def test_kernel_uses_the_same_constants():
    # the kernel's copy of the cull's constants, read from its source, as
    # test_kernel_sorting_network_sorts reads its network
    import re
    from coalign_tpu_torch.kernels.rotated_iou import SOURCE
    from coalign_tpu_torch.utils.iou import MIN_EDGE, SQUARE_COS
    src = SOURCE.read_text()
    for name, want in (("kSepMargin", SEPARATION_MARGIN),
                       ("kMinEdge", MIN_EDGE), ("kSquareCos", SQUARE_COS)):
        found = re.findall(rf"constexpr float {name} = ([0-9.e+-]+)f;", src)
        assert len(found) == 1 and float(found[0]) == want, name


def test_collapsed_boxes_are_degenerate():
    _, reach = box_reach(torch.from_numpy(_collapsed(6).astype(np.float32)))
    assert torch.isinf(reach).all()


def test_cull_clears_most_car_pairs():
    # cars over +-140 m: the cull must do real work
    c1, c2 = (torch.from_numpy(c.astype(np.float32))
              for c in _case("cars140"))
    assert separated_pairs(c1, c2).float().mean() > 0.95


def test_margin_decides_the_gap_pairs():
    # circles delta/2 apart stay, 2 delta and 4 delta apart are cleared
    for thin in (False, True):
        c1, c2 = _gap_pairs(7, (DELTA / 2, 2 * DELTA, 4 * DELTA), thin)
        cleared = np.diagonal(separated_pairs(
            torch.from_numpy(c1.astype(np.float32)),
            torch.from_numpy(c2.astype(np.float32))).numpy())
        np.testing.assert_array_equal(cleared, [False] * 3 + [True] * 6)


def test_skewed_quads_are_degenerate():
    # a parallelogram and a kite: the exactness argument holds for squared
    # corners only, so such quads are never cleared
    sheared = np.array([[0.0, 0.0], [4, 0], [5, 2], [1, 2]])
    kite = np.array([[0.0, 0.0], [2, -0.5], [4, 0], [2, 0.5]])
    far = _rect(50.0, 50.0, 1.8, 4.2, 0.2)
    c = torch.from_numpy(np.stack([sheared, kite, far]).astype(np.float32))
    _, reach = box_reach(c)
    assert torch.isinf(reach[:2]).all() and torch.isfinite(reach[2])
    assert not separated_pairs(c, c)[:2].any()
