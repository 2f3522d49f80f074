"""The port's spatial BEV sharding (parallel/spatial.py) at 2 and 4 gloo
ranks on the CPU, against the port's dense model and the JAX package's.

One group of 4 worker processes (chip_smoke.launch and chip_smoke.wait:
a free local port, each rank's output in a file, every rank killed past
the time limit) runs every check; the checks at 2 ranks run in a
subgroup of ranks 0 and 1 of that group. The parent computes the dense
references while they run.

Bounds:
  * halo_exchange at 4 ranks: the grid's two ends see zero halos, every
    other halo column is its neighbour's edge (exact);
  * global_sum inside a global_sums block of the 4-rank mesh and of the
    2-rank subgroup's: the sum over that mesh's ranks alone, and its
    gradient too (exact);
  * sharded_conv2d at strides 1 and 2 and kernel widths 1, 3 and 5 against
    the dense F.conv2d with torch's padding: 2e-4, the JAX test's bound;
  * the tiny flagship (TINY_ARGS' widths, a 64 x 64 canvas, 2 agents in 3
    slots, seeded weights and norms) through spatial_resnet_encode_fn
    (3e-4) and spatial_flagship_forward_fn (1e-3), the JAX tests' bounds,
    at 2 and 4 ranks, against the port's dense model and the JAX
    package's dense model on the same weights (from_jax_params); and its
    request through make_spatial_infer_fn: the eager request's box set.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import launch, wait

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
CONV_CASES = [(3, 1), (3, 2), (1, 2), (1, 1), (5, 1), (5, 2)]   # (kw, s)

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from coalign_tpu_torch.inference import make_infer_fn
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.parallel import spatial as S
from coalign_tpu_torch.parallel.distributed import (global_sum, global_sums,
                                                    init_distributed_mode)

job = torch.load(sys.argv[1], weights_only=False)
info = init_distributed_mode(device="cpu")
rank, world = info["rank"], info["world_size"]
pair = dist.new_group([0, 1])
meshes = {4: S.make_spatial_mesh()}
if rank < 2:
    meshes[2] = S.make_spatial_mesh(pair)
out = {}

# the global sums cover the block's mesh alone, forward and backward
for w, mesh in meshes.items():
    v = torch.tensor([rank + 1.0], requires_grad=True)
    with global_sums(mesh):
        total = global_sum(v * (rank + 1.0))
    total.backward()
    out[("sum", w)] = (float(total), float(v.grad))

# halo boundaries: columns 0..31 of one row, 8 a rank
x = torch.arange(32, dtype=torch.float32).reshape(1, 1, 1, 32)
out["halo"] = S.halo_exchange(x[..., rank * 8:(rank + 1) * 8], 1)

for kw, s in job["conv_cases"]:
    x, k = job["conv"][(kw, s)]
    mesh = meshes[4]
    wl = x.shape[-1] // world
    y = S.sharded_conv2d(x[..., rank * wl:(rank + 1) * wl], k, None, s)
    out[("conv", kw, s)] = S.gather_w(y, mesh)

model = build_model(job["cfg"], device="cpu")
model.load_state_dict(job["state"], strict=True)
model.eval()
batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
with torch.no_grad():
    bev, affine, _ = model._encode_agents(batch)
for w, mesh in meshes.items():
    enc, split = S.spatial_resnet_encode_fn(model.backbone, mesh,
                                            bev.shape[-1])
    assert split == (mesh.rank, w, bev.shape[-1] // w), split
    out[("encode", w)] = [S.gather_w(t, mesh) for t in enc(bev)]
    fwd, _ = S.spatial_flagship_forward_fn(model, mesh)
    maps = fwd(bev, affine[:, 0], batch["agent_mask"])
    out[("forward", w)] = {k: S.gather_w(v, mesh) for k, v in maps.items()}
    infer = S.make_spatial_infer_fn(model, job["anchors"], job["post"], mesh,
                                    device="cpu")
    out[("request", w)] = infer(batch)
torch.save(out, f"{job['out']}.{rank}")
dist.destroy_process_group()
print(f"RANK{rank} OK")
"""


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The job, the workers' results (rank 0's, which holds every check;
    the gathered maps are every rank's) and the parent's references."""
    import jax
    import jax.numpy as jnp
    from conftest import jit_init

    from coalign_tpu.models import build_model as jax_build_model
    from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.inference import make_infer_fn
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.utils.weights import from_jax_params

    from chip_smoke import TINY_ANCHORS, TINY_ARGS
    from test_torch_flagship import _randomize_norms

    work = tmp_path_factory.mktemp("spatial")
    lr = TINY_ARGS["lidar_range"]
    scenes = SyntheticScenes(num_frames=2, num_agents=2, num_objects=4,
                             lidar_range=lr, points_per_object=64,
                             ground_points=256, agent_spread=4.0, seed=7)
    batch = IntermediateFusionBatcher(
        max_cav=3, max_points=1500, max_objects=8, lidar_range=lr,
        native=False).assemble([scenes[0], scenes[1]])
    cfg = {"core_method": "point_pillar_baseline_multiscale",
           "args": TINY_ARGS}
    jmodel = jax_build_model(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(5), jbatch, train=False)),
        np.random.default_rng(5))
    layer_nums = TINY_ARGS["base_bev_backbone"]["layer_nums"]
    state = from_jax_params(variables, layer_nums)
    rng = np.random.default_rng(11)
    conv = {}
    for kw, s in CONV_CASES:
        x = torch.from_numpy(rng.normal(0, 1, (2, 6, 8, 64)).astype(
            np.float32))
        k = torch.from_numpy(rng.normal(0, 0.3, (10, 6, 3, kw)).astype(
            np.float32))
        conv[(kw, s)] = (x, k)
    post = {"target_args": {"score_threshold": 0.2}, "nms_thresh": 0.15,
            "gt_range": lr, "dir_args": TINY_ARGS["dir_args"],
            "max_num": 50}
    job = {"cfg": cfg, "state": state, "batch": batch, "conv": conv,
           "conv_cases": CONV_CASES, "post": post,
           "anchors": generate_anchor_box(TINY_ANCHORS),
           "out": str(work / "out")}
    torch.save(job, str(work / "job.pt"))
    ranks = launch(WORLD, [sys.executable, "-c", WORKER,
                           str(work / "job.pt")], str(work / "logs"),
                   env={"PYTHONPATH": os.pathsep.join([REPO] + sys.path),
                        "OMP_NUM_THREADS": "1"})
    try:
        # the references, while the workers run
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state, strict=True)
        model.eval()
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            bev, _, _ = model._encode_agents(tb)
            dense_enc = model.backbone.encode(bev)
            dense = model(tb)
        eager = make_infer_fn(model, job["anchors"], post, device="cpu")(tb)
        jmaps = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, jbatch)
        jenc = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False, method=lambda m, t, train:
            m.backbone.encode(t, train=train)))(
            variables, jnp.asarray(bev.permute(0, 2, 3, 1).numpy()))
    finally:
        results = wait(ranks, timeout_s=240)
    for rank, (code, out) in enumerate(results):
        assert code == 0, f"rank {rank} failed ({code}):\n{out[-3000:]}"
        assert f"RANK{rank} OK" in out
    outs = [torch.load(f"{job['out']}.{r}", weights_only=False)
            for r in range(WORLD)]
    return {"job": job, "outs": outs, "dense_enc": dense_enc,
            "dense": dense, "eager": eager,
            "jax_maps": {k: np.asarray(v) for k, v in jmaps.items()},
            "jax_enc": [np.asarray(t) for t in jenc]}


def test_halo_boundaries_zero_and_neighbour_edges(sharded):
    blocks = np.stack([o["halo"].reshape(-1).numpy()
                       for o in sharded["outs"]])
    assert blocks.shape == (WORLD, 10)        # [halo, 8 columns, halo]
    assert blocks[0, 0] == 0.0 and blocks[-1, -1] == 0.0
    for r in range(WORLD):
        np.testing.assert_array_equal(blocks[r, 1:-1],
                                      np.arange(8 * r, 8 * r + 8))
        if r > 0:
            assert blocks[r, 0] == 8 * r - 1
        if r < WORLD - 1:
            assert blocks[r, -1] == 8 * r + 8


@pytest.mark.parametrize("world", [2, 4])
def test_global_sum_covers_the_mesh_group_only(world, sharded):
    ranks = range(world)
    # sum over the mesh of (r + 1)^2; the gradient of every rank's copy,
    # summed over the mesh, times this rank's r + 1
    want = sum((r + 1.0) ** 2 for r in ranks)
    for r in ranks:
        total, grad = sharded["outs"][r][("sum", world)]
        assert total == want
        assert grad == world * (r + 1.0)


@pytest.mark.parametrize("kw,stride", CONV_CASES)
def test_sharded_conv_matches_dense(kw, stride, sharded):
    x, k = sharded["job"]["conv"][(kw, stride)]
    want = F.conv2d(x, k, stride=stride, padding=(1, kw // 2))
    for out in sharded["outs"]:
        got = out[("conv", kw, stride)]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_encode_matches_dense(world, sharded):
    got = sharded["outs"][0][("encode", world)]
    assert len(got) == len(sharded["dense_enc"]) == 2
    for g, want, jwant in zip(got, sharded["dense_enc"],
                              sharded["jax_enc"]):
        assert g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=3e-4)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), jwant,
                                   atol=3e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_forward_matches_dense(world, sharded):
    got = sharded["outs"][0][("forward", world)]
    assert set(got) == {"cls_preds", "reg_preds", "dir_preds"}
    for key, g in got.items():
        want = sharded["dense"][key]
        assert g.shape == want.shape, key
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-3,
                                   err_msg=key)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   sharded["jax_maps"][key], atol=1e-3,
                                   err_msg=key)
    # every rank gathered the same maps
    for out in sharded["outs"][1:world]:
        for key, g in out[("forward", world)].items():
            assert torch.equal(g, got[key]), key


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_request_gives_the_eager_box_set(world, sharded):
    from chip_smoke import same_box_sets

    got = sharded["outs"][0][("request", world)]
    want = sharded["eager"]
    assert int(want["mask"].sum()) > 0
    counts, _, _ = same_box_sets(got, want)
    assert counts == [int(m.sum()) for m in want["mask"]]
