"""The port's multi-layer PFN (models/pillar_encoder.py) against the JAX
package's PillarEncoder, on the CPU.

Bounds:
  * 2- and 3-layer stacks (num_filters [32, 64] and [16, 32, 64]), with
    and without pad_parity, in eval and in train mode: the canvas within
    1e-5 of its largest magnitude of the JAX encoder's on the same weights
    (float32 features of order 1, summed in another order: each layer's
    batch statistics divide the last layer's rounding by a standard
    deviation below 1, which put one element of a 3-layer train-mode
    canvas 1.2e-5 from JAX's, 2e-6 of the canvas's largest); in train
    mode the running statistics within 1e-5;
  * a 2-layer state dict under the reference's keys
    (pillar_vfe.pfn_layers.{i}.{linear,norm}.*) loads strictly through
    load_pth and gives those weights;
  * a copy of pointpillar_coalign.yaml with num_filters [32, 64] (and a
    one-block trunk, at a +-12.8 m grid) built by both packages' build_all
    from one fixture tree: head maps within 1e-4 of each map's largest on
    the same weights (the flagship tests' bound).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.models.pillar_encoder import PillarEncoder as JaxPillarEncoder
from coalign_tpu.ops.pillars import PillarSpec as JaxPillarSpec
from coalign_tpu.tools import run as JRUN
from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.models.pillar_encoder import PillarEncoder
from coalign_tpu_torch.ops.pillars import PillarSpec
from coalign_tpu_torch.tools import run as RUN
from coalign_tpu_torch.utils.weights import from_jax_params, load_pth

from chip_smoke import LATE_RANGE, hypes_at
from test_torch_flagship import _randomize_norms

torch.set_num_threads(1)

LIDAR_RANGE, VOXEL = [-12.8, -6.4, -3.0, 12.8, 6.4, 1.0], [0.4, 0.4, 4.0]


def _points(seed=31, f=3, n=700):
    rng = np.random.default_rng(seed)
    points = np.zeros((f, n, 4), np.float32)
    points[..., 0] = rng.uniform(-14, 14, (f, n))
    points[..., 1] = rng.uniform(-7, 7, (f, n))
    # half the points in a few dense pillars, some outside the range
    points[:, : n // 2, :2] = rng.integers(-3, 3, (f, n // 2, 2)) * 0.4 + 0.1
    points[..., 2] = rng.uniform(-3.5, 1.5, (f, n))
    points[..., 3] = rng.uniform(0, 1, (f, n))
    return points, rng.uniform(size=(f, n)) > 0.1


def _encoder_state(variables) -> dict:
    return {k[len("pillar_vfe."):]: v for k, v in from_jax_params({
        "params": {"encoder": variables["params"]},
        "batch_stats": {"encoder": variables["batch_stats"]}}).items()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("pad_parity", [True, False],
                         ids=["pad_parity", "no_pad_parity"])
@pytest.mark.parametrize("num_filters", [(32, 64), (16, 32, 64)],
                         ids=["2layers", "3layers"])
def test_multilayer_pfn_matches_jax(num_filters, pad_parity, train):
    points, mask = _points()
    jenc = JaxPillarEncoder(spec=JaxPillarSpec.from_config(LIDAR_RANGE,
                                                           VOXEL),
                            num_filters=num_filters, pad_parity=pad_parity)
    jp, jm = jnp.asarray(points), jnp.asarray(mask)
    variables = jax.jit(jenc.init)(jax.random.PRNGKey(1), jp, jm)
    variables = _randomize_norms(
        jax.tree_util.tree_map(np.asarray, variables),
        np.random.default_rng(2))
    if train:
        want, upd = jax.jit(lambda v, p, m: jenc.apply(
            v, p, m, train=True, mutable=["batch_stats"]))(variables, jp, jm)
    else:
        want = jax.jit(lambda v, p, m: jenc.apply(v, p, m))(variables, jp,
                                                            jm)
    want = np.asarray(want)

    enc = PillarEncoder(PillarSpec.from_config(LIDAR_RANGE, VOXEL),
                        num_filters=num_filters, pad_parity=pad_parity)
    assert [layer.linear.out_features for layer in enc.pfn_layers] == \
        [c // 2 for c in num_filters[:-1]] + [num_filters[-1]]
    enc.load_state_dict(_encoder_state(variables), strict=True)
    enc.train(train)
    with torch.no_grad():
        got = enc(torch.from_numpy(points), torch.from_numpy(mask))
    assert got.shape == (3, num_filters[-1], 32, 64)
    err = np.abs(got.permute(0, 2, 3, 1).numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())
    assert (want > 0).any(axis=-1).sum() > 50
    if train:
        stats = _encoder_state({"params": variables["params"],
                                "batch_stats": jax.tree_util.tree_map(
                                    np.asarray, upd["batch_stats"])})
        state = enc.state_dict()
        for key, value in stats.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(state[key].numpy(),
                                           value.numpy(), atol=1e-5,
                                           err_msg=key)


def test_two_layer_reference_state_dict_loads_strictly(tmp_path):
    """A 2-layer PFN under the reference's keys: pfn_layers.0 maps the 10
    decorated channels to 16 units, pfn_layers.1 its 32 (16 + the pillar
    max) to 32."""
    rng = np.random.default_rng(4)
    args = {"pillar_vfe": {"num_filters": [32, 32]}}
    shapes = {"0.linear.weight": (16, 10), "1.linear.weight": (32, 32)}
    for i, c in ((0, 16), (1, 32)):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{i}.norm.{leaf}"] = (c,)
    state = {f"pillar_vfe.pfn_layers.{k}": torch.from_numpy(
        rng.uniform(0.5, 1.5, s).astype(np.float32)) for k, s in
        shapes.items()}
    for i in range(2):
        state[f"pillar_vfe.pfn_layers.{i}.norm.num_batches_tracked"] = \
            torch.tensor(0)
    path = str(tmp_path / "pfn.pth")
    torch.save(state, path)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.pillar_vfe = PillarEncoder(
                PillarSpec.from_config(LIDAR_RANGE, VOXEL),
                num_filters=args["pillar_vfe"]["num_filters"])

    model = Holder()
    load_pth(model, path)
    got = model.state_dict()
    assert set(got) == set(state)
    for key, value in state.items():
        assert torch.equal(got[key], value), key


def test_yaml_with_two_pfn_layers_builds_alike_in_both_packages(tmp_path):
    scenes = SyntheticScenes(num_frames=2, num_agents=2, num_objects=3,
                             lidar_range=LATE_RANGE, points_per_object=48,
                             ground_points=128, seed=5)
    tree = write_opv2v_fixture(str(tmp_path / "opv2v"), scenes,
                               frames_per_scenario=2)
    params = hypes_at("pointpillar_coalign", tree, LATE_RANGE)
    params["noise_setting"] = {"add_noise": False}
    params["train_params"]["max_cav"] = 2
    margs = params["model"]["args"]
    margs["pillar_vfe"]["num_filters"] = [32, 64]
    margs["pillar_vfe"]["pad_parity"] = False
    margs["base_bev_backbone"]["layer_nums"] = [1, 1, 1]
    jbase, jbatcher, jmodel, _, _ = JRUN.build_all(copy.deepcopy(params),
                                                   train=False)
    _, _, model, _, _ = RUN.build_all(copy.deepcopy(params), train=False,
                                      device="cpu")
    assert len(model.pillar_vfe.pfn_layers) == 2
    batch = jbatcher.assemble([jbase[0]])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(3), jbatch, train=False)),
        np.random.default_rng(3))
    model.load_state_dict(from_jax_params(variables, [1, 1, 1]), strict=True)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables,
                                                                 jbatch)
    model.eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()})
    for key in ("cls_preds", "reg_preds", "dir_preds"):
        w = np.asarray(want[key])
        g = got[key].permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, key
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 1e-4, (key, err)
