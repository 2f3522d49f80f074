"""The port's 3D voxel backbones and SSFA
(coalign_tpu_torch/models/voxel_backbone.py) against the JAX package's
modules on the CPU: the dense twin VoxelBackbone8x, the sparse
SparseVoxelBackbone8x with each stage-4 tail (the dense one under its
1 GiB byte budget, the sparse one at a budget of 0) and SSFA, in eval and
train mode, on a numpy-seeded batch of 3 frames of a 32 x 32 x 40 grid
(0.8 m, 0.1 m in z as the yamls' grids: stage 4's depth 5 squashed by a z
kernel of 3 at stride 2).

Bounds: eval mode in float32, outputs within 1e-4 of the tensor's largest
magnitude (convolutions summed in another order); train mode in float64
(test_torch_second._jax_train_float64: the JAX package's own float32
rounding exceeds 1e-4 there), outputs within 1e-8 and the running
statistics after the step within 1e-6 (read back in float32), and the
port's float32 outputs within 1e-4 of its float64 ones. SSFA's train mode
holds in float32 at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coalign_tpu.models import voxel_backbone as JVB
from coalign_tpu.ops import sparse_conv as JS
from coalign_tpu.ops import voxels as JV
from coalign_tpu_torch.models import voxel_backbone as VB
from coalign_tpu_torch.ops import sparse_conv as S
from coalign_tpu_torch.ops import voxels as V
from coalign_tpu_torch.utils.weights import from_jax_params

from test_torch_flagship import _randomize_norms
from test_torch_second import (LR, _close, _held_in_float64, _jax_train_float64,
                               _jit, _points, _port_train, _stats)

torch.set_num_threads(1)
BACKBONE_VOXEL = [0.8, 0.8, 0.1]


def _backbone_case(seed: int):
    """A batch of 3 frames on the backbones' grid, as the dense (F, D+1, H,
    W, 4) grid and as a SparseGrid, in both packages."""
    jspec = JV.VoxelSpec.from_config(LR, BACKBONE_VOXEL)
    spec = V.VoxelSpec.from_config(LR, BACKBONE_VOXEL)
    pts, mask = _points(3, 400, seed)
    dense = jnp.pad(jax.vmap(lambda p, m: JV.mean_voxelize(p, m, jspec)[0])(
        jnp.asarray(pts), jnp.asarray(mask)),
        ((0, 0), (0, 1), (0, 0), (0, 0), (0, 0)))
    jgrid = JS.sparse_mean_voxelize(jnp.asarray(pts), jnp.asarray(mask),
                                    jspec, 512, pad_z=1)
    # the port's backbone reads the JAX grid itself: the two voxelizations
    # agree to a float32 rounding (tests/test_torch_voxels.py), which the
    # float64 comparison would see
    grid = S.SparseGrid(*(torch.from_numpy(np.array(a)) for a in jgrid[:3]),
                        jgrid.shape)
    grid = grid._replace(keys=grid.keys.long())
    return spec, dense, jgrid, grid


def _port_backbone(cls, nz, variables, **kw):
    """A port backbone with the JAX backbone's variables."""
    sd = from_jax_params({col: {"VoxelBackbone8x_0": tree}
                          for col, tree in variables.items()})
    model = cls(nz, out_features=16, **kw)
    model.load_state_dict({k[len("backbone_3d."):]: v for k, v in sd.items()},
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("form", ["dense", "sparse_dense_tail",
                                  "sparse_sparse_tail"])
def test_backbones_match_jax(form, train, monkeypatch):
    """The dense twin and the sparse backbone with each stage-4 tail
    (budget 1 GiB: dense, 0: sparse) against the JAX modules: in eval mode
    in float32 (1e-4); in train mode in float64 (_jax_train_float64), the
    running statistics after the step too."""
    spec, dense, jgrid, grid = _backbone_case(seed=3)
    budget = 0 if form == "sparse_sparse_tail" else 1 << 30
    if form == "dense":
        jmod, jin = JVB.VoxelBackbone8x(out_features=16), dense
    else:
        jmod = JVB.SparseVoxelBackbone8x(out_features=16,
                                         dense_tail_budget_bytes=budget)
        jin = jgrid
    variables = _randomize_norms(jax.tree_util.tree_map(
        np.asarray, _jit(lambda r, i: jmod.init(r, i), jax.random.PRNGKey(1),
                         jin)), np.random.default_rng(2))
    if form == "dense":
        model = _port_backbone(VB.VoxelBackbone8x, spec.nz, variables)
        x = torch.from_numpy(np.array(dense)).permute(0, 4, 1, 2, 3)
    else:
        model = _port_backbone(VB.SparseVoxelBackbone8x, spec.nz, variables,
                               dense_tail_budget_bytes=budget)
        x = grid

    def dense_out(out, jax_side=False):
        if isinstance(out, (S.SparseGrid, JS.SparseGrid)):
            assert form == "sparse_sparse_tail"
            return (JS.to_dense(out) if jax_side else
                    S.to_dense(out).permute(0, 4, 1, 2, 3))
        assert form != "sparse_sparse_tail"
        return out

    def channels_last(a):
        return np.moveaxis(np.asarray(a), 1, -1)

    if not train:
        want = np.asarray(_jit(lambda v, i: dense_out(jmod.apply(
            v, i, train=False)["out"], True), variables, jin))
        with torch.no_grad():
            got = channels_last(dense_out(model(x)["out"]))
        assert got.shape[1:4] == (2, 4, 4)             # z squashed to 2
        assert float(np.abs(want).max()) > 0
        _close(got, want, 1e-4, f"{form} out")
        return
    def apply(v, i):          # densified inside, in float64
        out, upd = jmod.apply(v, i, train=True, mutable=["batch_stats"])
        return dense_out(out["out"], True), upd

    want, upd = _jax_train_float64(monkeypatch, apply, variables, jin)
    got32, got64, model64 = _port_train(model, x)
    _held_in_float64(channels_last(dense_out(got32["out"])),
                     channels_last(dense_out(got64["out"])), want,
                     f"{form} out")
    new = from_jax_params({"batch_stats": {"VoxelBackbone8x_0":
                                           upd["batch_stats"]}})
    mine = _stats(model64.state_dict())
    assert len(mine) == 2 * 12
    for key, value in _stats(new).items():
        _close(mine[key[len("backbone_3d."):]].numpy(), value.numpy(), 1e-6,
               key)


@pytest.mark.parametrize("train", [False, True])
def test_ssfa_matches_jax(train):
    x = np.random.default_rng(4).normal(size=(3, 8, 12, 20)).astype(
        np.float32)
    jmod = JVB.SSFA(feature_num=16)
    jx = jnp.asarray(x)
    variables = _randomize_norms(jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(5), jx)),
        np.random.default_rng(6))
    sd = from_jax_params({col: {"SSFA_0": tree}
                          for col, tree in variables.items()})
    model = VB.SSFA(20, 16).eval()
    model.load_state_dict({k[len("ssfa."):]: v for k, v in sd.items()},
                          strict=True)
    if train:
        want, upd = jmod.apply(variables, jx, train=True,
                               mutable=["batch_stats"])
        model.train()
    else:
        want = jmod.apply(variables, jx, train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4, "ssfa")
    if train:
        new = from_jax_params({"batch_stats": {"SSFA_0": jax.tree_util.
                                               tree_map(np.asarray,
                                                        upd["batch_stats"])}})
        mine = _stats(model.state_dict())
        assert len(mine) == 2 * 14
        for key, value in _stats(new).items():
            _close(mine[key[len("ssfa."):]].numpy(), value.numpy(), 1e-4,
                   key)
