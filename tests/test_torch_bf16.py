"""The port's compute-dtype policy (models/layers.set_compute_dtype) against
the JAX package's, on the CPU.

Three models with the JAX package's seeded weights (from_jax_params, norms
seeded): the pillar flagship at tests/test_bf16.py's size, SECOND-SSFA on
the sparse backbone (tests/test_torch_second.py's sizes) and the LSS
intermediate model (tests/test_torch_lss.py's). Each runs in float32 and
under bfloat16 in both packages. Bounds:

  * the port's bfloat16 outputs lie from the JAX package's bfloat16 outputs
    at most half as far (mean absolute) as the JAX package's bfloat16
    outputs lie from its float32 ones: the casts are in the same places
    (the ratios are printed; CHANGES.md records them). The flagship's and
    SECOND's are 0: every rounding is the JAX package's. The LSS model is
    held stage by stage: its camera encoder on the images, then the rest
    (lift, splat, BEV encoder, fusion, heads) fed the JAX camera encoder's
    bfloat16 outputs. End to end its ratio is ~0.55-0.7, bounded by 0.8:
    XLA's float32 accumulation order in EfficientNet's convolutions from
    block 10 on rounds ~1e-4 of their bfloat16 outputs the other way (fed
    the JAX package's own block-9 output, the port's blocks 10-15 and the
    encoder's head lie 0.24-0.26 from it, the whole encoder's gap), and 30
    further layers and the splat's sums spread those flips;
  * the dtype of what each policy site gives (the pillar encoder's canvas,
    the backbone's scales, the fusion, SSFA, the camera and BEV encoders)
    is the JAX package's; the heads' outputs are float32, as the JAX
    package's (tests/test_bf16.py);
  * with the policy unset the outputs equal a run before the policy was
    ever set, bit for bit; ``--bf16`` sets it, and the fixture resets it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from conftest import jit_init

from coalign_tpu.data import IntermediateFusionBatcher, SyntheticScenes
from coalign_tpu.models import build_model as jax_build_model
from coalign_tpu.models.layers import set_compute_dtype as jax_set_dtype
from coalign_tpu_torch.models import layers as LAYERS
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.utils.weights import from_jax_params

from test_bf16 import ARGS as FLAGSHIP_ARGS
from test_bf16 import LIDAR_RANGE
from test_torch_flagship import _randomize_norms
from test_torch_lss import camera_batch, lss_args, port_tree
from test_torch_second import _jax_and_port

torch.set_num_threads(4)
CASES = ("flagship", "second_ssfa_sparse", "lss_intermediate")
# what each policy site gives, as (flax module path, method) and the port's
# module (attribute path) or method
SITES = {
    "flagship": [(("encoder",), "__call__", "pillar_vfe"),
                 (("backbone",), "encode", "backbone.encode"),
                 (("fusion_nets_0",), "__call__", "fusion_net.0"),
                 (("backbone",), "decode", "backbone.decode")],
    "second_ssfa_sparse": [(("SSFA_0",), "__call__", "ssfa")],
    "lss_intermediate": [(("camencode",), "__call__", "camencode"),
                         (("bevencode",), "__call__", "bevencode")],
}


@pytest.fixture(autouse=True)
def _reset_policy():
    yield
    LAYERS.set_compute_dtype(None)
    jax_set_dtype(None)


def _case(name: str):
    """(JAX model config, numpy batch, JAX variables, port model)."""
    if name == "second_ssfa_sparse":
        cfg, batch, _, _, variables, model = _jax_and_port(name)
        return cfg, batch, variables, model
    if name == "flagship":
        ds = SyntheticScenes(num_frames=1, num_agents=2, num_objects=3,
                             lidar_range=LIDAR_RANGE, points_per_object=32,
                             ground_points=64, seed=2)
        batch = IntermediateFusionBatcher(
            max_cav=2, max_points=512, max_objects=8,
            lidar_range=LIDAR_RANGE).assemble([ds[0]])
        cfg = {"core_method": "point_pillar_baseline_multiscale",
               "args": FLAGSHIP_ARGS}
        layer_nums = FLAGSHIP_ARGS["base_bev_backbone"]["layer_nums"]
    else:
        batch = camera_batch(b=1, l=2, n=2, seed=14)
        cfg = {"core_method": "lift_splat_shoot_intermediate",
               "args": lss_args({"supervise_single": True})}
        layer_nums = None
    jmodel = jax_build_model(cfg)
    variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, jit_init(
        jmodel, jax.random.PRNGKey(5), jax.tree_util.tree_map(
            jnp.asarray, batch), train=False)), np.random.default_rng(5))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(variables, layer_nums),
                          strict=True)
    return cfg, batch, variables, model


def _jax_run(cfg, variables, batch, sites):
    """The JAX model's outputs and the outputs of ``sites``, built and
    traced under the current policy."""
    jmodel = jax_build_model(cfg)
    wanted = {(path[-1], method) for path, method, _ in sites}
    out, state = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, method: (mdl.name, method)
        in wanted))(variables, jax.tree_util.tree_map(jnp.asarray, batch))
    found = {}
    for path, method, port_name in sites:
        node = state["intermediates"]
        for key in path:
            node = node[key]
        found[port_name] = node[method][0]
    return out, found


def _port_run(model, batch, sites):
    """The port model's outputs and the outputs of ``sites`` (a forward
    hook on a module, a wrapper on a method)."""
    found, undo = {}, []
    for _, method, port_name in sites:
        *owner, attr = port_name.split(".")
        obj = model
        for part in owner:
            obj = obj[int(part)] if part.isdigit() else getattr(obj, part)
        target = obj[int(attr)] if attr.isdigit() else getattr(obj, attr)
        if isinstance(target, torch.nn.Module):
            undo.append(target.register_forward_hook(
                lambda mod, args, out, key=port_name:
                found.__setitem__(key, out)))
        else:
            def wrapped(*args, _fn=target, _key=port_name, **kw):
                found[_key] = _fn(*args, **kw)
                return found[_key]
            setattr(obj, attr, wrapped)
            undo.append(type("U", (), {"remove": lambda self, o=obj, a=attr:
                                       delattr(o, a)})())
    try:
        with torch.no_grad():
            out = model(port_tree(batch))
    finally:
        for u in undo:
            u.remove()
    return out, found


def _dtypes(tree) -> list:
    leaves = jax.tree_util.tree_leaves(tree)
    return [str(x.dtype).replace("torch.", "") for x in leaves
            if x is not None and "int" not in str(x.dtype)]


def _nchw(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x.transpose(0, 3, 1, 2) if x.ndim == 4 else x


def _ratios(p16: dict, j16: dict, j32: dict) -> dict:
    """mean |port bf16 - JAX bf16| / mean |JAX bf16 - JAX f32| of each
    output (the heads' maps, float32 in both)."""
    ratios = {}
    for key, w16 in j16.items():
        if key == "depth_logits":
            continue
        assert p16[key].dtype == torch.float32, key
        assert np.asarray(w16).dtype == np.float32, key
        w16, w32 = _nchw(w16), _nchw(j32[key])
        got = p16[key].numpy()
        assert np.isfinite(got).all(), key
        spread = float(np.abs(w16 - w32).mean())
        assert spread > 0, key              # the JAX policy changed it
        ratios[key] = float(np.abs(got - w16).mean()) / spread
    return ratios


@pytest.mark.parametrize("name", CASES)
def test_bf16_matches_jax_bf16(name):
    cfg, batch, variables, model = _case(name)
    sites = SITES[name]
    with torch.no_grad():
        before = model(port_tree(batch))
    j32, j32sites = _jax_run(cfg, variables, batch, sites)
    jax_set_dtype(jnp.bfloat16)
    j16, jsites = _jax_run(cfg, variables, batch, sites)
    jax_set_dtype(None)
    LAYERS.set_compute_dtype(torch.bfloat16)
    p16, psites = _port_run(model, batch, sites)
    LAYERS.set_compute_dtype(None)
    with torch.no_grad():
        after = model(port_tree(batch))
    ratios = _ratios(p16, j16, j32)
    print(name, "end to end", {k: round(v, 3) for k, v in ratios.items()})
    for key, want in jsites.items():
        assert _dtypes(psites[key]) == _dtypes(want), key
    for key in before:
        assert torch.equal(before[key], after[key]), key
    if name != "lss_intermediate":
        assert max(ratios.values()) <= 0.5, ratios
        return
    # measured 0.54-0.68 (the single maps' dir and reg the largest): the
    # encoder's tail, from block 10 on, rounds ~1e-4 of its bfloat16
    # outputs the other way from XLA's (test_lss_encoder_tail_from_jax_
    # block9), and the layers after it spread those flips; 0.8 leaves ~0.12
    # of margin
    assert max(ratios.values()) <= 0.8, ratios
    # stage 1, the camera encoder: context and depth logits
    enc = {}
    for i, key in enumerate(("context", "depth_logits")):
        w16, w32 = (_nchw(j["camencode"][i]) for j in (jsites, j32sites))
        got = psites["camencode"][i].float().numpy()
        enc[key] = float(np.abs(got - w16).mean() / np.abs(w16 - w32).mean())
    # stage 2, the rest, fed the JAX camera encoder's bfloat16 outputs
    ctx, logits = (torch.from_numpy(_nchw(t)) for t in jsites["camencode"])
    model.camencode.forward = lambda x: (ctx, logits)
    LAYERS.set_compute_dtype(torch.bfloat16)
    with torch.no_grad():
        rest = _ratios(model(port_tree(batch)), j16, j32)
    print(name, "camera encoder", {k: round(v, 3) for k, v in enc.items()},
          "the rest", {k: round(v, 3) for k, v in rest.items()})
    assert max(enc.values()) <= 0.5, enc
    assert max(rest.values()) <= 0.5, rest


def test_lss_encoder_tail_from_jax_block9():
    """ROADMAP §3 fault 14: the LSS camera encoder's bfloat16 gap is the
    tail's. Fed the JAX package's bfloat16 output of EfficientNet's block
    9 (and its reduction_3 endpoint, block 4's output), the port's blocks
    10-15, up1, up2 and heads give the camera encoder's context and depth
    logits at most half as far from the JAX package's bfloat16 ones as
    those lie from its float32 ones (measured 0.240 and 0.258, the whole
    encoder's 0.237 and 0.253: the first ten blocks add nothing)."""
    cfg, batch, variables, model = _case("lss_intermediate")
    sites = [(("camencode", "trunk", "blocks_4"), "__call__", "b4"),
             (("camencode", "trunk", "blocks_9"), "__call__", "b9"),
             (("camencode",), "__call__", "camencode")]
    _, j32 = _jax_run(cfg, variables, batch, sites)
    jax_set_dtype(jnp.bfloat16)
    _, j16 = _jax_run(cfg, variables, batch, sites)
    jax_set_dtype(None)
    enc = model.camencode
    LAYERS.set_compute_dtype(torch.bfloat16)
    with torch.no_grad():
        x = torch.from_numpy(_nchw(j16["b9"])).to(torch.bfloat16)
        x = r4 = enc.trunk._blocks[10](x)
        for block in enc.trunk._blocks[11:]:
            x = block(x)
        f = enc.up1(x, r4)
        f = enc.up2(f, torch.from_numpy(_nchw(j16["b4"])).to(torch.bfloat16))
        got = (enc.image_head(f), enc.depth_head(f))
    ratios = {}
    for i, key in enumerate(("context", "depth_logits")):
        w16, w32 = (_nchw(j["camencode"][i]) for j in (j16, j32))
        ratios[key] = float(np.abs(got[i].float().numpy() - w16).mean()
                            / np.abs(w16 - w32).mean())
    print("lss_intermediate encoder tail from block 10",
          {k: round(v, 3) for k, v in ratios.items()})
    assert max(ratios.values()) <= 0.5, ratios


def test_bf16_flag_sets_the_policy(monkeypatch):
    """``run.py --bf16`` sets the policy before its command runs (the
    command is stubbed here); the fixture resets it."""
    from coalign_tpu_torch.tools import run
    seen = []
    monkeypatch.setattr(run, "cmd_config_generate",
                        lambda opt: seen.append(LAYERS.compute_dtype()))
    assert LAYERS.compute_dtype() is None
    run.main(["config_generate", "-y", "unused.yaml", "--device", "cpu"])
    run.main(["config_generate", "-y", "unused.yaml", "--device", "cpu",
              "--bf16"])
    assert seen == [None, torch.bfloat16]
    with pytest.raises(ValueError):
        LAYERS.set_compute_dtype(torch.float16)


def test_policy_layers_without_the_policy_are_the_plain_layers():
    """With the policy unset a policy conv, transposed conv and linear are
    nn.Conv2d's, nn.ConvTranspose2d's and nn.Linear's, bit for bit, and a
    promoted layer passes its own dtype untouched."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 9, 7, generator=gen)
    for policy, plain, inp in (
            (LAYERS.PolicyConv2d(8, 4, 3, padding=1),
             torch.nn.Conv2d(8, 4, 3, padding=1), x),
            (LAYERS.PolicyConvTranspose2d(8, 4, 2, stride=2),
             torch.nn.ConvTranspose2d(8, 4, 2, stride=2), x),
            (LAYERS.PolicyLinear(7, 5), torch.nn.Linear(7, 5), x)):
        plain.load_state_dict(policy.state_dict())
        assert torch.equal(policy(inp), plain(inp))
        LAYERS.set_compute_dtype(torch.bfloat16)
        assert policy(inp).dtype == torch.bfloat16
        LAYERS.set_compute_dtype(None)
    conv = LAYERS.promote_unpinned(torch.nn.Sequential(
        torch.nn.Conv2d(8, 4, 1)))
    assert conv(x.bfloat16()).dtype == torch.float32
    assert torch.equal(conv(x), conv[0]._conv_forward(x, conv[0].weight,
                                                      conv[0].bias))
