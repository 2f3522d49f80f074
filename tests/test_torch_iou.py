"""Rotated IoU of the PyTorch port against the JAX package.

The plain PyTorch version (the CUDA kernel's reference, and what CPU tensors
take) against ``rotated_iou_corners``, through both of its paths (numpy, and
jnp run eagerly): the same float32 algorithm, so 1e-5. (Under ``jax.jit``,
XLA reorders the arithmetic and moves small IoUs by up to 1.5e-5.)
Against the Pallas kernel in interpret mode at that test's own bound, 1e-3.
The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coalign_tpu.ops.pallas_iou import rotated_iou_pallas
from coalign_tpu.utils import box_utils as JB
from coalign_tpu.utils.iou import rotated_iou_corners
from coalign_tpu_torch.kernels import rotated_iou as K
from coalign_tpu_torch.utils.iou import polygon_area, rotated_iou_plain

torch.set_num_threads(1)



def _corners(n, seed, spread=30.0):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((n, 7), dtype=np.float32)
    boxes[:, 0] = rng.uniform(-spread, spread, n)
    boxes[:, 1] = rng.uniform(-spread, spread, n)
    boxes[:, 3] = 1.5
    boxes[:, 4] = rng.uniform(1.5, 2.2, n)
    boxes[:, 5] = rng.uniform(3.5, 4.8, n)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return np.asarray(JB.boxes_to_corners_3d(boxes, "hwl"))[:, :4, :2]


@pytest.mark.parametrize("n,m,spread,seed,xp", [
    (40, 150, 30.0, 3, np),      # the Pallas test's sparse layout
    (64, 64, 4.0, 5, np),        # dense clusters: most pairs overlap
    (7, 33, 2.0, 6, np),
    (64, 64, 4.0, 5, jnp),
])
def test_plain_matches_jax_rotated_iou_corners(n, m, spread, seed, xp):
    c1 = _corners(n, seed, spread)
    c2 = _corners(m, seed + 1, spread)
    got = rotated_iou_plain(torch.from_numpy(c1), torch.from_numpy(c2))
    want = np.asarray(rotated_iou_corners(c1, c2, xp=xp))
    assert got.shape == (n, m)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if spread < 10:
        assert (want > 0).mean() > 0.2


def test_plain_matches_pallas_kernel_interpret():
    c1, c2 = _corners(40, 3), _corners(150, 4)
    got = rotated_iou_plain(torch.from_numpy(c1), torch.from_numpy(c2))
    want = np.asarray(rotated_iou_pallas(jnp.asarray(c1), jnp.asarray(c2),
                                         interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_self_iou_diagonal_is_one():
    c = torch.from_numpy(_corners(40, 7, 3.0))
    diag = torch.diagonal(rotated_iou_plain(c, c))
    np.testing.assert_allclose(diag.numpy(), 1.0, atol=1e-4)


def test_batched_leading_dim_matches_per_frame():
    c = torch.from_numpy(_corners(3 * 20, 8, 4.0).reshape(3, 20, 4, 2))
    got = rotated_iou_plain(c, c)
    for b in range(3):
        torch.testing.assert_close(got[b], rotated_iou_plain(c[b], c[b]))


def test_polygon_area_matches_box_size():
    c = torch.from_numpy(_corners(10, 9))
    w = torch.linalg.norm(c[:, 1] - c[:, 0], dim=-1)
    l = torch.linalg.norm(c[:, 3] - c[:, 0], dim=-1)
    torch.testing.assert_close(polygon_area(c), w * l, rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    c1 = torch.from_numpy(_corners(12, 10, 3.0))
    c2 = torch.from_numpy(_corners(9, 11, 3.0))
    before = K.rotated_iou.launches
    got = K.rotated_iou(c1, c2)
    assert K.rotated_iou.launches == before
    torch.testing.assert_close(got, rotated_iou_plain(c1, c2), rtol=0, atol=0)


def test_wrapper_checks_its_inputs():
    c = torch.from_numpy(_corners(4, 12))
    with pytest.raises(TypeError):
        K.rotated_iou(c.double(), c.double())
    with pytest.raises(ValueError):
        K.rotated_iou(c.reshape(4, 8), c.reshape(4, 8))
    with pytest.raises(ValueError):
        K.rotated_iou(c[None], c)
    with pytest.raises(ValueError):
        K.rotated_iou(c.to("meta"), c.to("meta"))


def test_plain_keeps_precision_at_world_coordinates():
    """Boxes at the flagship's +-140 m range, half of them overlapping: the
    port's local-frame float32 IoU stays within 1e-6 of float64, where the
    JAX package's untranslated float32 form cancels down to about 5e-4."""
    c1 = _corners(200, 9, 140.0)
    jitter = np.random.default_rng(1).normal(0, 0.5, (100, 1, 2))
    c2 = np.concatenate([c1[:100] + jitter.astype(np.float32),
                         _corners(100, 10, 140.0)])
    truth = rotated_iou_plain(torch.from_numpy(c1).double(),
                              torch.from_numpy(c2).double()).numpy()
    got = rotated_iou_plain(torch.from_numpy(c1), torch.from_numpy(c2))
    assert (truth > 0.1).sum() > 50
    np.testing.assert_allclose(got.numpy(), truth, atol=1e-6)
    jax_err = np.abs(rotated_iou_corners(c1, c2, xp=np) - truth).max()
    assert 1e-4 < jax_err < 1e-3


@pytest.mark.parametrize("inner,want", [
    # far apart: cleared by the separation test (8 a pair); per box 57
    (np.array([[10.0, 10], [12, 10], [12, 11], [10, 11]]), 8 + 114),
    # nested: not cleared; per pair 356, the inner box's 4 corners are the
    # candidates, no crossing, 13c + log2(c!) for c = 4
    (np.array([[0.5, 0.5], [1.5, 0.5], [1.5, 1.5], [0.5, 1.5]]),
     356 + 52 + np.log2(24) + 114),
    # far apart but collapsed to a segment: degenerate, so never cleared;
    # the full count, with no candidate
    (np.array([[10.0, 10], [12, 10], [12, 10], [10, 10]]), 356 + 114),
], ids=["far_cleared", "nested", "far_degenerate"])
def test_iou_op_count(inner, want):
    # the operation count behind the kernel's bound in chip_smoke.py
    from chip_smoke import iou_ops
    outer = torch.tensor([[[0.0, 0.0], [4, 0], [4, 3], [0, 3]]])
    inner = torch.from_numpy(inner[None].astype(np.float32))
    assert iou_ops(outer, inner) == pytest.approx(want, abs=1e-9)


def test_kernel_sorting_network_sorts():
    """The kernel sorts each pair's 24 candidate slots with the network
    SORT24 in csrc/rotated_iou.cu. By the 0-1 principle it sorts every input
    if it sorts every 0/1 input: all 2^24 of them at once, one bit each,
    wire w holding bit w of every input, min = AND and max = OR."""
    import re
    src = K.SOURCE.read_text()
    body = src[src.index("#define SORT24(X)"):]
    body = body[:body.index("\n\n")]
    pairs = [(int(a), int(b))
             for a, b in re.findall(r"X\((\d+), (\d+)\)", body)]
    assert len(pairs) == 127 and all(a < b < 24 for a, b in pairs)
    n = 24
    wires = []
    for w in range(n):
        pattern, length = ((1 << (1 << w)) - 1) << (1 << w), 2 << w
        while length < 1 << n:
            pattern |= pattern << length
            length *= 2
        wires.append(pattern)
    for a, b in pairs:
        wires[a], wires[b] = wires[a] & wires[b], wires[a] | wires[b]
    assert all(wires[w] & ~wires[w + 1] == 0 for w in range(n - 1))
