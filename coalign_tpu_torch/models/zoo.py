"""The CoAlign flagship: PointPillars with per-scale intermediate fusion.

Port of coalign_tpu/models/zoo.py:164-213 ``PointPillarBaselineMultiscale``
(ref point_pillar_baseline_multiscale.py:17; point_pillar_coalign.py:9
aliases it as the CoAlign model), for inference and training.

Batch contract (the JAX package's):
  points            (B, L, N, 4) float   raw lidar in each agent's frame
  point_mask        (B, L, N)    bool
  agent_mask        (B, L)       bool    (ego is slot 0)
  pairwise_t_matrix (B, L, L, 4, 4)      T_j<-i agent transforms
Outputs NCHW: cls_preds (B, A, H/2, W/2), reg_preds (B, 7A, ...),
dir_preds (B, bins*A, ...).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.profiler import record_function

from coalign_tpu_torch.models.backbones import ResNetBEVBackbone
from coalign_tpu_torch.models.fuse.fusion import build_fusion
from coalign_tpu_torch.models.heads import add_detection_heads, detection_heads
from coalign_tpu_torch.models.layers import DownsampleConv
from coalign_tpu_torch.models.pillar_encoder import PillarEncoder
from coalign_tpu_torch.ops.pillars import PillarSpec
from coalign_tpu_torch.runtime import resolve_device
from coalign_tpu_torch.utils.transforms import normalize_pairwise_tfm


class PointPillarBaselineMultiscale(nn.Module):
    """Pillar encoder -> ResNet encode -> per-scale fusion -> decode ->
    shrink -> heads (ref point_pillar_baseline_multiscale.py:93-138)."""

    def __init__(self, args: dict):
        super().__init__()
        for key in ("supervise_single", "compression"):
            if args.get(key):
                raise NotImplementedError(f"{key!r} is not ported yet")
        if not args["base_bev_backbone"].get("resnet", True):
            raise NotImplementedError("only the ResNet BEV backbone is ported")
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
        self.backbone = ResNetBEVBackbone(bb, vfe["num_filters"][-1])
        feat_dims = args.get("att", {}).get("feat_dim", list(bb["num_filters"]))
        self.fusion_net = nn.ModuleList(
            [build_fusion(args["fusion_method"], feat_dims[i])
             for i in range(len(bb["layer_nums"]))])
        self.shrink_conv = (DownsampleConv(args["shrink_header"])
                            if "shrink_header" in args else None)
        head_in = (args["shrink_header"]["dim"][-1] if "shrink_header" in args
                   else sum(bb["num_upsample_filter"]))
        add_detection_heads(self, head_in, args["anchor_number"],
                            "dir_args" in args,
                            args.get("dir_args", {}).get("num_bins", 2))

    def forward(self, batch: dict) -> dict:
        # the "stage/..." ranges name the stages in a torch.profiler trace
        # (chip_smoke.py's profile phase); without a profiler they record
        # nothing
        b, l, n, _ = batch["points"].shape
        with record_function("stage/pillar_encoder"):
            bev = self.pillar_vfe(batch["points"].reshape(b * l, n, -1),
                                  batch["point_mask"].reshape(b * l, n))
        with record_function("stage/backbone_encode"):
            feats = self.backbone.encode(bev,
                                         batch["agent_mask"].reshape(b * l))
        with record_function("stage/fusion"):
            affine = normalize_pairwise_tfm(batch["pairwise_t_matrix"],
                                            self.spec.ny, self.spec.nx,
                                            self.args["voxel_size"][0])
            fused = [fuse(feat.reshape((b, l) + feat.shape[1:]), affine,
                          batch["agent_mask"])
                     for fuse, feat in zip(self.fusion_net, feats)]
        with record_function("stage/decode_shrink_heads"):
            x = self.backbone.decode(fused)
            if self.shrink_conv is not None:
                x = self.shrink_conv(x)
            return detection_heads(self, x)


class CoAlign(PointPillarBaselineMultiscale):
    """Alias (ref point_pillar_coalign.py:9)."""


_MODELS = {
    "point_pillar_baseline_multiscale": PointPillarBaselineMultiscale,
    "point_pillar_coalign": CoAlign,
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
    scale 1, bias 0, running mean 0 and variance 1."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()
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
