"""The PointPillars models of the port: the CoAlign flagship and the
single-agent detectors.

Ports of coalign_tpu/models/zoo.py:
  * PointPillarBaselineMultiscale (:164-213; ref
    point_pillar_baseline_multiscale.py:17, aliased as the CoAlign model by
    point_pillar_coalign.py:9): PointPillars with per-scale intermediate
    fusion, optionally after a NaiveCompressor of the pillar canvas;
  * PointPillarBaseline (:127-161; ref point_pillar_baseline.py:17): one
    fusion after the whole backbone, the shrink and the optional
    NaiveCompressor, with any fusion of models/fuse/fusion.py (F-Cooper's
    max, att, mean, DiscoNet, V2VNet, When2comm, V2X-ViT);
    PointPillarIntermediate (:216-225; ref point_pillar_intermediate.py:15)
    is it with ``att`` by default, PointPillarDiscoNet (:383-407; ref
    point_pillar_disconet.py:19) DiscoNet's student at inference, with
    ``disconet`` by default and the fused map as ``feature``;
  * PointPillar (:82-106; ref point_pillar.py:17): one agent's detector,
    no fusion;
  * PointPillarUncertainty (:440-449; ref point_pillar_uncertainty.py:15):
    PointPillar with a log-variance head, CoAlign's stage-1 detector that
    feeds the pose graph (tools/stage1.py).

Batch contract (the JAX package's):
  points            (B, L, N, 4) float   raw lidar in each agent's frame
  point_mask        (B, L, N)    bool
  agent_mask        (B, L)       bool    (ego is slot 0)
  pairwise_t_matrix (B, L, L, 4, 4)      T_j<-i agent transforms (flagship)
Outputs NCHW: cls_preds (B, A, H/2, W/2), reg_preds (B, 7A, ...),
dir_preds (B, bins*A, ...), unc_preds (B, unc_dim*A, ...); the single-agent
models give them per agent frame, on (B*L, ...).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.profiler import record_function

from coalign_tpu_torch.models.backbones import backbone_from_config
from coalign_tpu_torch.models.fuse.fusion import build_fusion
from coalign_tpu_torch.models.heads import add_detection_heads, detection_heads
from coalign_tpu_torch.models.layers import DownsampleConv, NaiveCompressor
from coalign_tpu_torch.models.pillar_encoder import PillarEncoder
from coalign_tpu_torch.ops.pillars import PillarSpec
from coalign_tpu_torch.runtime import resolve_device
from coalign_tpu_torch.utils.transforms import normalize_pairwise_tfm


class _PillarBase(nn.Module):
    """The modules every PointPillars model has, under the reference's
    names: pillar_vfe, backbone, shrink_conv (with ``shrink_header``) and
    the heads."""

    def __init__(self, args: dict):
        super().__init__()
        self.args = dict(args)
        self.spec = PillarSpec.from_config(args["lidar_range"],
                                           args["voxel_size"])
        vfe = args["pillar_vfe"]
        self.pillar_vfe = PillarEncoder(
            self.spec, num_filters=tuple(vfe["num_filters"]),
            use_norm=vfe.get("use_norm", True),
            with_distance=vfe.get("with_distance", False),
            use_absolute_xyz=vfe.get("use_absolute_xyz", True),
            pad_parity=vfe.get("pad_parity", False))
        bb = args["base_bev_backbone"]
        self.backbone = backbone_from_config(bb, vfe["num_filters"][-1])
        self.shrink_conv = (DownsampleConv(args["shrink_header"])
                            if "shrink_header" in args else None)
        self.out_dim = (args["shrink_header"]["dim"][-1]
                        if "shrink_header" in args
                        else sum(bb["num_upsample_filter"]))
        add_detection_heads(self, self.out_dim, args)

    def _encode_agents(self, batch: dict):
        """The (B*L, C, ny, nx) pillar canvases of every agent slot, the
        normalized pairwise affines (B, L, L, 2, 3) and (B, L)."""
        b, l, n, _ = batch["points"].shape
        with record_function("stage/pillar_encoder"):
            bev = self.pillar_vfe(batch["points"].reshape(b * l, n, -1),
                                  batch["point_mask"].reshape(b * l, n))
        affine = normalize_pairwise_tfm(batch["pairwise_t_matrix"],
                                        self.spec.ny, self.spec.nx,
                                        self.args["voxel_size"][0])
        return bev, affine, (b, l)

    def _shrink_heads(self, x: torch.Tensor) -> dict:
        if self.shrink_conv is not None:
            x = self.shrink_conv(x)
        return detection_heads(self, x)


class PointPillarBaselineMultiscale(_PillarBase):
    """Pillar encoder -> (compressor) -> backbone encode -> per-scale
    fusion -> decode -> shrink -> heads (ref
    point_pillar_baseline_multiscale.py:93-138)."""

    def __init__(self, args: dict):
        if args.get("supervise_single"):
            raise NotImplementedError("'supervise_single' is not ported yet")
        super().__init__(args)
        bb = args["base_bev_backbone"]
        # the reference compresses the 64-channel pillar canvas
        self.naive_compressor = (NaiveCompressor(64, args["compression"])
                                 if args.get("compression", 0) else None)
        feat_dims = args.get("att", {}).get("feat_dim", list(bb["num_filters"]))
        self.fusion_net = nn.ModuleList(
            [build_fusion(args["fusion_method"], args, feat_dims[i])
             for i in range(len(bb["layer_nums"]))])

    def forward(self, batch: dict) -> dict:
        # the "stage/..." ranges name the stages in a torch.profiler trace
        # (chip_smoke.py's profile phase); without a profiler they record
        # nothing
        bev, affine, (b, l) = self._encode_agents(batch)
        bn_mask = batch["agent_mask"].reshape(b * l)
        if self.naive_compressor is not None:
            bev = self.naive_compressor(bev, bn_mask)
        with record_function("stage/backbone_encode"):
            feats = self.backbone.encode(bev, bn_mask)
        with record_function("stage/fusion"):
            fused = [fuse(feat.reshape((b, l) + feat.shape[1:]), affine,
                          batch["agent_mask"])
                     for fuse, feat in zip(self.fusion_net, feats)]
        with record_function("stage/decode_shrink_heads"):
            return self._shrink_heads(self.backbone.decode(fused))


class PointPillarBaseline(_PillarBase):
    """Pillar encoder -> backbone (encode and decode) -> shrink ->
    (compressor) -> one fusion over (B, L, C, H, W) -> heads (ref
    point_pillar_baseline.py:100-138)."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.naive_compressor = (
            NaiveCompressor(self.out_dim, args["compression"])
            if args.get("compression", 0) else None)
        self.fusion_net = build_fusion(args["fusion_method"], args,
                                       self.out_dim)

    def _fuse(self, batch: dict) -> torch.Tensor:
        """The fused ego map (B, C, H, W)."""
        bev, affine, (b, l) = self._encode_agents(batch)
        bn_mask = batch["agent_mask"].reshape(b * l)
        with record_function("stage/backbone_shrink"):
            x = self.backbone(bev, bn_mask)
            if self.shrink_conv is not None:
                x = self.shrink_conv(x)
            if self.naive_compressor is not None:
                x = self.naive_compressor(x, bn_mask)
        with record_function("stage/fusion"):
            return self.fusion_net(x.reshape((b, l) + x.shape[1:]), affine,
                                   batch["agent_mask"])

    def forward(self, batch: dict) -> dict:
        fused = self._fuse(batch)
        with record_function("stage/heads"):
            return detection_heads(self, fused)


class PointPillarIntermediate(PointPillarBaseline):
    """OpenCOOD's attentive intermediate fusion: the baseline with ``att``
    fusion unless the yaml names another (ref point_pillar_intermediate.py
    :15)."""

    def __init__(self, args: dict):
        super().__init__({"fusion_method": "att", **args})


class PointPillarDiscoNet(PointPillarBaseline):
    """DiscoNet's student at inference: the baseline with ``disconet``
    fusion unless the yaml names another, and the fused map as
    ``feature`` (B, C, H, W), which its distillation reads (ref
    point_pillar_disconet.py:19-100)."""

    def __init__(self, args: dict):
        super().__init__({"fusion_method": "disconet", **args})

    def forward(self, batch: dict) -> dict:
        fused = self._fuse(batch)
        with record_function("stage/heads"):
            out = detection_heads(self, fused)
        out["feature"] = fused
        return out


class PointPillar(_PillarBase):
    """One agent's detector (ref point_pillar.py:17): every agent frame of
    the batch goes through the model on its own, with no fusion. Padded
    agents' frames stay out of the norms' training statistics (the agent
    mask, as models/zoo.py:99-102 passes it)."""

    def forward(self, batch: dict) -> dict:
        b, l, n, _ = batch["points"].shape
        bev = self.pillar_vfe(batch["points"].reshape(b * l, n, -1),
                              batch["point_mask"].reshape(b * l, n))
        return self._shrink_heads(self.backbone(
            bev, batch["agent_mask"].reshape(b * l)))


class PointPillarUncertainty(PointPillar):
    """PointPillar with a log-variance head of ``uncertainty_dim`` (default
    3: x, y, yaw) channels per anchor, CoAlign's stage-1 detector (ref
    point_pillar_uncertainty.py:15)."""

    def __init__(self, args: dict):
        super().__init__({"uncertainty_dim": 3, **args})


class CoAlign(PointPillarBaselineMultiscale):
    """Alias (ref point_pillar_coalign.py:9)."""


_MODELS = {
    "point_pillar": PointPillar,
    "point_pillar_uncertainty": PointPillarUncertainty,
    "point_pillar_baseline_multiscale": PointPillarBaselineMultiscale,
    "point_pillar_coalign": CoAlign,
    "point_pillar_baseline": PointPillarBaseline,
    "point_pillar_intermediate": PointPillarIntermediate,
    "point_pillar_disconet": PointPillarDiscoNet,
}


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: torch.Generator):
    """flax's default kernel init: a normal truncated at 2 standard
    deviations, scaled so that its variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator):
    """The JAX package's initialization (flax's defaults): lecun_normal
    kernels with fan_in = input width times kernel area (flax counts a
    ConvTranspose's input channels too), zero biases, batch norms with
    scale 1, bias 0, running mean 0 and variance 1, layer norms with scale
    1 and bias 0; a module's own parameters (V2X-ViT's relation matrices
    and position embeddings) by its ``init_weights(generator)``."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.modules.batchnorm._BatchNorm,
                                nn.LayerNorm)):
                mod.reset_parameters()
            elif hasattr(mod, "init_weights"):
                mod.init_weights(generator)
            elif isinstance(mod, nn.Linear):
                _lecun_normal_(mod.weight, mod.in_features, generator)
            elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                _lecun_normal_(mod.weight, mod.in_channels
                               * math.prod(mod.kernel_size), generator)
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)) \
                    and mod.bias is not None:
                mod.bias.zero_()


def build_model(config: dict, device=None, seed: int = 0) -> nn.Module:
    """Build a model from the yaml ``model`` subtree (core_method + args),
    in eval mode on ``device`` (CUDA unless named; see
    runtime.resolve_device); ``model.train()`` switches it to training.
    Its weights are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` as the JAX package initializes them (init_weights), so a seed
    gives the same model on every device; a checkpoint replaces them
    (utils/weights.py)."""
    name = config["core_method"]
    if name not in _MODELS:
        raise KeyError(f"model {name!r} is not ported; have {sorted(_MODELS)}")
    dev = resolve_device(device)
    model = _MODELS[name](config["args"])
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
