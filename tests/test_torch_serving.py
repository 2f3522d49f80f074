"""The PyTorch port's serving artifact (coalign_tpu_torch/serving.py), the
twin of tests/test_serving.py on its tiny point_pillar_baseline config, on
the CPU, with the JAX package's seeded weights (utils/weights.
from_jax_params):

  * the artifact's files and meta; the reloaded program gives the direct
    make_infer_fn's detections (atol 1e-6, as the JAX test); the batch
    contract raises "missing keys" and "fixed-shape";
  * a fresh process that imports only coalign_tpu_torch.serving reproduces
    the detections without the model zoo or the config package;
  * against the JAX package: its own artifact (coalign_tpu.serving,
    platforms cpu) reloaded on the same weights and batch gives the port
    artifact's box set: the same mask in the port's max_num ranked slots
    (the JAX program keeps 100 ranked slots), corners within 1e-4 m
    and scores within 1e-5 (float32 in other op orders; the JAX frame program takes
    the plain rotated_iou_corners, not the Pallas kernel);
  * another seed's params.npz swapped into the artifact gives that seed's
    direct detections with no new export;
  * a model that refuses export raises, naming its ROADMAP item;
  * the sync-free NMS fixpoint equals the chunked one on
    tests/test_torch_nms.py's cases; torch.export traces the IoU op
    through its fake implementation as one node.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import jit_init

from coalign_tpu.data import IntermediateFusionBatcher as JaxBatcher
from coalign_tpu.data import SyntheticScenes as JaxScenes
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.postprocess.anchors import make_anchor_spec as jax_spec
from coalign_tpu.serving import export_inference as jax_export
from coalign_tpu.serving import load_artifact as jax_load
from coalign_tpu_torch import serving
from coalign_tpu_torch.inference import make_infer_fn
from coalign_tpu_torch.kernels.rotated_iou import rotated_iou
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
from coalign_tpu_torch.serving import export_inference, load_artifact
from coalign_tpu_torch.utils.nms import (keep_fixpoint_sync_free, nms_rotated)
from coalign_tpu_torch.utils.weights import from_jax_params

from test_serving import ANCHOR_ARGS, LIDAR_RANGE, MODEL_ARGS, POSTPROCESS
from test_torch_nms import _clusters

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {"core_method": "point_pillar_baseline", "args": MODEL_ARGS}


def _batch():
    ds = JaxScenes(num_frames=2, num_agents=2, num_objects=2,
                   lidar_range=LIDAR_RANGE, points_per_object=24,
                   ground_points=48, seed=5)
    batcher = JaxBatcher(max_cav=2, max_points=256, max_objects=8,
                         lidar_range=LIDAR_RANGE)
    return batcher.assemble([ds[0]])


def _jax_variables(batch, seed):
    model = jax_build_model(CONFIG)
    return model, jit_init(model, jax.random.PRNGKey(seed),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           train=False)


def _port_model(variables):
    model = build_model(CONFIG, device="cpu")
    model.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, variables),
        MODEL_ARGS["base_bev_backbone"]["layer_nums"]), strict=True)
    return model


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    batch = _batch()
    jmodel, variables = _jax_variables(batch, 0)
    model = _port_model(variables)
    anchors = make_anchor_spec(ANCHOR_ARGS, POSTPROCESS["target_args"],
                               "hwl").anchors
    out_dir = str(tmp_path_factory.mktemp("artifact"))
    export_inference(model, batch, anchors, POSTPROCESS, out_dir,
                     platforms=("cpu",))
    want = make_infer_fn(model, anchors, POSTPROCESS, device="cpu")(batch)
    return out_dir, batch, want, (jmodel, variables), anchors


def test_artifact_files_and_meta(exported):
    out_dir, batch, _, _, _ = exported
    assert os.path.exists(os.path.join(out_dir, "program.cpu.pt2"))
    assert os.path.exists(os.path.join(out_dir, "params.npz"))
    meta = json.load(open(os.path.join(out_dir, "meta.json")))
    assert meta["platforms"] == ["cpu"]
    assert meta["torch_version"] == torch.__version__
    assert set(meta["batch_spec"]) == set(serving.PROGRAM_KEYS) & set(batch)
    assert meta["batch_spec"]["points"] == {
        "shape": list(batch["points"].shape), "dtype": "float32"}
    # the artifact is for the CPU only: CUDA is refused before any load
    with pytest.raises(ValueError, match="exported for"):
        load_artifact(out_dir, device="cuda")


def test_reload_matches_direct_inference(exported):
    out_dir, batch, want, _, _ = exported
    got = load_artifact(out_dir, device="cpu")(batch)
    assert set(got) == set(want)
    assert int(want["mask"].sum()) > 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-6, err_msg=k)


def test_batch_contract_is_validated(exported):
    out_dir, batch, _, _, _ = exported
    model = load_artifact(out_dir, device="cpu")
    bad = dict(batch)
    bad.pop("points")
    with pytest.raises(ValueError, match="missing keys"):
        model(bad)
    bad = dict(batch)
    bad["points"] = np.zeros((1, 2, 7, 4), np.float32)
    with pytest.raises(ValueError, match="fixed-shape"):
        model(bad)


def test_artifact_is_self_contained(exported, tmp_path):
    """A fresh process that imports ONLY coalign_tpu_torch.serving (no
    model zoo, no config package) reproduces the detections."""
    out_dir, batch, want, _, _ = exported
    np.savez(tmp_path / "batch.npz", **batch)
    script = tmp_path / "serve.py"
    script.write_text(
        "import json, sys\n"
        "import numpy as np\n"
        "from coalign_tpu_torch.serving import load_artifact\n"
        f"m = load_artifact({out_dir!r}, device='cpu')\n"
        f"npz = np.load({str(tmp_path / 'batch.npz')!r})\n"
        "dets = m({k: npz[k] for k in npz.files})\n"
        "leaked = sorted(k for k in sys.modules if k.startswith(("
        "'coalign_tpu_torch.models', 'coalign_tpu_torch.config', "
        "'coalign_tpu.', 'jax')))\n"
        "print(json.dumps({'leaked': leaked, 'sums': {k: float(v.double()"
        ".sum()) for k, v in dets.items()}}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, str(script)], text=True,
                         capture_output=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    for k, v in res["sums"].items():
        np.testing.assert_allclose(v, float(want[k].double().sum()),
                                   rtol=1e-5, err_msg=k)


def test_port_artifact_gives_the_jax_artifacts_box_set(exported, tmp_path):
    out_dir, batch, _, (jmodel, variables), _ = exported
    spec = jax_spec(ANCHOR_ARGS, POSTPROCESS["target_args"], "hwl")
    jax_dir = str(tmp_path / "jax_artifact")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_export(jmodel, variables, jbatch, spec.anchors, POSTPROCESS, jax_dir,
               platforms=("cpu",))
    want = {k: np.asarray(v) for k, v in jax_load(jax_dir)(jbatch).items()}
    got = {k: v.numpy() for k, v in
           load_artifact(out_dir, device="cpu")(batch).items()}
    # the JAX frame program keeps 100 ranked slots, the port's the config's
    # max_num (50): the first 50 ranked slots are compared
    n = got["mask"].shape[1]
    assert want["mask"][:, :n].sum() > 0
    np.testing.assert_array_equal(got["mask"], want["mask"][:, :n])
    np.testing.assert_allclose(got["corners3d"], want["corners3d"][:, :n],
                               atol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"][:, :n],
                               atol=1e-5)


def test_swapped_params_give_that_seeds_detections(exported, tmp_path):
    out_dir, batch, want0, _, anchors = exported
    swapped = str(tmp_path / "swapped")
    shutil.copytree(out_dir, swapped)
    _, variables = _jax_variables(batch, 1)
    model = _port_model(variables)
    np.savez(os.path.join(swapped, "params.npz"),
             **{k: v.numpy() for k, v in model.state_dict().items()})
    want = make_infer_fn(model, anchors, POSTPROCESS, device="cpu")(batch)
    got = load_artifact(swapped, device="cpu")(batch)
    assert not torch.equal(want["scores"], want0["scores"])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-6, err_msg=k)


def test_refused_model_names_its_item(exported, tmp_path):
    """A forward that branches on a value read from the device (a host
    sync) cannot be traced: export raises, names the ROADMAP entry and
    writes nothing."""
    _, batch, _, (_, variables), anchors = exported

    class HostSync(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = _port_model(variables)

        def forward(self, b):
            if b["points"].abs().sum() > 0:
                return self.inner(b)
            return self.inner(b)

    with pytest.raises(NotImplementedError, match="ROADMAP §4"):
        export_inference(HostSync(), batch, anchors, POSTPROCESS,
                         str(tmp_path / "refused"), platforms=("cpu",))
    assert not os.path.exists(tmp_path / "refused")


class _NMS(torch.nn.Module):
    def __init__(self, thresh: float):
        super().__init__()
        self.thresh = thresh

    def forward(self, corners, scores, valid):
        return nms_rotated(corners, scores, valid, self.thresh)


@pytest.mark.parametrize("seed,n_centers,thresh", [
    (0, 5, 0.15), (1, 12, 0.15), (2, 3, 0.5), (3, 40, 0.01),
])
def test_sync_free_nms_equals_the_chunked_one(seed, n_centers, thresh):
    """nms_rotated traced by torch.export takes the sync-free fixpoint by
    itself (K rounds, one batched product each); the program gives the
    eager chunked form's order and keep."""
    rng = np.random.default_rng(seed)
    corners = torch.from_numpy(np.stack(
        [_clusters(rng, 64, n_centers) for _ in range(2)]))
    scores = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 64)).astype(
        np.float32))
    valid = torch.from_numpy(rng.uniform(size=(2, 64)) > 0.2)
    order, keep = nms_rotated(corners, scores, valid, thresh)
    program = torch.export.export(_NMS(thresh), (corners, scores, valid))
    rounds = sum(1 for n in program.graph.nodes
                 if n.target == torch.ops.aten.baddbmm.default)
    assert rounds == 64
    order_f, keep_f = program.module()(corners, scores, valid)
    assert torch.equal(order, order_f) and torch.equal(keep, keep_f)
    assert 0 < keep.sum() < valid.sum()


def test_sync_free_fixpoint_resolves_a_full_chain():
    """A suppression chain through all K boxes (each kills the next) needs
    every one of the K rounds: the kept boxes alternate."""
    k = 9
    suppress = torch.zeros(1, k, k, dtype=torch.bool)
    suppress[0, torch.arange(k - 1), torch.arange(1, k)] = True
    keep = keep_fixpoint_sync_free(suppress, torch.ones(1, k, dtype=bool))
    assert keep[0].tolist() == [i % 2 == 0 for i in range(k)]


def test_export_traces_the_iou_op_as_one_node():
    class IoU(torch.nn.Module):
        def forward(self, c):
            return rotated_iou(c, c)

    c = torch.from_numpy(_clusters(np.random.default_rng(4), 16, 3))[None]
    program = torch.export.export(IoU(), (c.contiguous(),))
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and "rotated_iou" in str(n.target)]
    assert len(nodes) == 1
    assert str(nodes[0].target) == "coalign_tpu_torch.rotated_iou.default"
    torch.testing.assert_close(program.module()(c), rotated_iou(c, c))


def test_the_op_checks_its_inputs():
    """An exported program calls the op without rotated_iou's wrapper: the
    op's own implementations (and its fake, under export) hold the input
    contract."""
    op = torch.ops.coalign_tpu_torch.rotated_iou
    c = torch.from_numpy(_clusters(np.random.default_rng(5), 8, 2))[None]
    with pytest.raises(TypeError):
        op(c.double(), c.double())
    with pytest.raises(ValueError):
        op(c[0], c[0])
    with pytest.raises(ValueError):
        op(c, torch.cat([c, c]))
    with pytest.raises(ValueError):
        op(c.reshape(1, 4, 4, 4), c.reshape(1, 4, 4, 4))
    torch.testing.assert_close(op(c, c), rotated_iou(c, c))
