"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device and skip without one. They import neither
JAX nor the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from coalign_tpu_torch.kernels import rotated_iou as K
from coalign_tpu_torch.utils.iou import rotated_iou_plain, separated_pairs
from coalign_tpu_torch.utils.nms import nms_rotated

from chip_smoke import check_degenerate, kernel_cases, seeded_corners


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _corners(shape, seed):
    """(*shape, 4, 2) car-sized boxes packed into 20 m x 20 m."""
    n = int(np.prod(shape))
    return torch.from_numpy(seeded_corners(n, seed).reshape(
        tuple(shape) + (4, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(512, 512), (40, 150), (1, 17)])
def test_kernel_matches_plain(cuda, n, m):
    # 1e-4: the same f32 function; the kernel sorts by a pseudo-angle and
    # nvcc contracts multiply-adds, a few ulp apart from the plain version
    c1, c2 = _corners((n,), 0).to(cuda), _corners((m,), 1).to(cuda)
    got = K.rotated_iou(c1, c2)
    torch.cuda.synchronize()
    assert got.shape == (n, m)
    torch.testing.assert_close(got, rotated_iou_plain(c1, c2), atol=1e-4,
                               rtol=0)
    diag = torch.diagonal(K.rotated_iou(c1, c1))
    torch.testing.assert_close(diag, torch.ones_like(diag), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ragged", "all_cleared", "identical",
                                  "world140"])
def test_kernel_matches_plain_on_the_smoke_cases(cuda, name):
    # chip_smoke.py's kernel-phase cases: a ragged tile edge, every pair
    # cleared by the cull (exactly 0), one box repeated (IoU 1), +-140 m
    c1, c2 = (c.to(cuda) for c in kernel_cases(name))
    got = K.rotated_iou(c1, c2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, rotated_iou_plain(c1, c2), atol=1e-4,
                               rtol=0)
    cleared = separated_pairs(c1, c2)
    assert (got[cleared] == 0).all()
    if name == "all_cleared":
        assert cleared.all()
    if name == "identical":
        torch.testing.assert_close(got, torch.ones_like(got), atol=1e-4,
                                   rtol=0)


@pytest.mark.cuda
def test_kernel_clears_no_degenerate_pair(cuda):
    # points, segments, skewed and thin boxes far from cars: the kernel must
    # compute every such pair, as the plain version does (see
    # chip_smoke.check_degenerate for why point boxes are counted)
    c1, c2 = (c.to(cuda) for c in kernel_cases("degenerate"))
    got = K.rotated_iou(c1, c2)
    torch.cuda.synchronize()
    assert not separated_pairs(c1, c2).any()
    check_degenerate(got, rotated_iou_plain(c1, c2))


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [10.0, 140.0])
def test_kernel_batch8_one_launch(cuda, spread):
    # B=8 frames of 512 boxes, dense (20 m x 20 m) and sparse (+-140 m)
    c = torch.from_numpy(np.stack([seeded_corners(512, s, spread)
                                   for s in range(8)])).to(cuda)
    before = K.rotated_iou.launches
    got = K.rotated_iou(c, c)
    assert K.rotated_iou.launches == before + 1
    torch.testing.assert_close(got, rotated_iou_plain(c, c), atol=1e-4,
                               rtol=0)
    diag = torch.diagonal(got, dim1=-2, dim2=-1)
    torch.testing.assert_close(diag, torch.ones_like(diag), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_kernel_batched_and_counted(cuda):
    c = _corners((3, 64), 2).to(cuda)
    before = K.rotated_iou.launches
    got = K.rotated_iou(c, c)
    assert K.rotated_iou.launches == before + 1
    torch.testing.assert_close(got, rotated_iou_plain(c, c), atol=1e-4,
                               rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    c = _corners((8,), 3).to(cuda)
    with pytest.raises(TypeError):
        K.rotated_iou(c.double(), c.double())
    with pytest.raises(ValueError):
        K.rotated_iou(c.transpose(1, 2).contiguous().transpose(1, 2), c)


@pytest.mark.cuda
def test_nms_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(4)
    c = _corners((2, 96), 5)
    scores = torch.from_numpy(rng.uniform(0, 1, (2, 96)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(0, 1, (2, 96)) > 0.1)
    want = nms_rotated(c, scores, valid, 0.15)
    before = K.rotated_iou.launches
    got = nms_rotated(c.to(cuda), scores.to(cuda), valid.to(cuda), 0.15)
    assert K.rotated_iou.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_train_step_on_cuda_matches_cpu(cuda):
    # chip_smoke.py's train_parity: float32 loss terms and running
    # statistics within 1e-4, float64 loss terms, gradients and state
    # within 1e-6 (see its docstring for the bounds, and for why the
    # float32 gradients are not held)
    from chip_smoke import train_parity
    out = train_parity()
    assert set(out) == {"float32", "float64"}


@pytest.mark.cuda
def test_prefetch_copies_to_the_card_in_order(cuda):
    from coalign_tpu_torch.data.prefetch import prefetch
    batches = [{"x": np.full((64, 1000), i, np.float32),
                "m": np.arange(7) % 2 == i % 2} for i in range(6)]
    got = list(prefetch(iter(batches), size=2))
    assert len(got) == 6
    for i, b in enumerate(got):
        assert b["x"].device.type == "cuda" and b["m"].dtype == torch.bool
        assert bool((b["x"] == i).all())
        assert torch.equal(b["m"].cpu(), torch.from_numpy(batches[i]["m"]))
