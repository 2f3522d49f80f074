"""Rotated NMS of the PyTorch port against the JAX package's nms_rotated:
identical keep masks and ranking on random box clusters."""

import jax
import numpy as np
import pytest
import torch

from coalign_tpu.utils import box_utils as JB
from coalign_tpu.utils import nms as JN
from coalign_tpu_torch.utils.nms import nms_rotated

torch.set_num_threads(1)

# one compiled program for every case: the threshold is traced
_jax_nms = jax.jit(JN.nms_rotated)


def _clusters(rng, n, n_centers):
    """Boxes jittered around a few centers, so suppression chains form."""
    centers = rng.uniform(-20, 20, (n_centers, 2))
    pick = rng.integers(0, n_centers, n)
    boxes = np.zeros((n, 7), dtype=np.float32)
    boxes[:, :2] = centers[pick] + rng.normal(0, 0.8, (n, 2))
    boxes[:, 3:6] = [1.5, 1.8, 4.2]
    boxes[:, 6] = rng.normal(0, 0.4, n)
    return np.asarray(JB.boxes_to_corners2d(boxes, "hwl"))


@pytest.mark.parametrize("seed,n_centers,thresh", [
    (0, 5, 0.15), (1, 12, 0.15), (2, 3, 0.5), (3, 40, 0.01),
])
def test_keep_masks_match_jax(seed, n_centers, thresh):
    n = 64
    rng = np.random.default_rng(seed)
    corners = _clusters(rng, n, n_centers)
    scores = rng.uniform(0.0, 1.0, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    order_j, keep_j = _jax_nms(corners, scores, valid, thresh)
    order_t, keep_t = nms_rotated(torch.from_numpy(corners)[None],
                                  torch.from_numpy(scores)[None],
                                  torch.from_numpy(valid)[None], thresh)
    np.testing.assert_array_equal(order_t[0].numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(keep_t[0].numpy(), np.asarray(keep_j))
    assert 0 < keep_t.sum() < valid.sum()


def test_batch_rows_are_independent():
    rng = np.random.default_rng(7)
    corners = np.stack([_clusters(rng, 64, 4) for _ in range(3)])
    scores = rng.uniform(size=(3, 64)).astype(np.float32)
    valid = np.ones((3, 64), bool)
    order, keep = nms_rotated(torch.from_numpy(corners),
                              torch.from_numpy(scores),
                              torch.from_numpy(valid), 0.15)
    for b in range(3):
        o, k = _jax_nms(corners[b], scores[b], valid[b], 0.15)
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(k))
        np.testing.assert_array_equal(order[b].numpy(), np.asarray(o))


def test_all_invalid_keeps_nothing():
    rng = np.random.default_rng(8)
    corners = torch.from_numpy(_clusters(rng, 16, 2))[None]
    scores = torch.from_numpy(rng.uniform(size=(1, 16)).astype(np.float32))
    _, keep = nms_rotated(corners, scores,
                          torch.zeros(1, 16, dtype=torch.bool), 0.15)
    assert not keep.any()
