"""The model registry of the port (build_model) and its PointPillars
models: the CoAlign flagship and the single-agent detectors. The SECOND
family's models are in models/second_family.py, the PIXOR family's in
models/pixor.py, the LSS camera family's in models/camera.py, the two-stage
models' (FPV-RCNN, FVoxelRCNN) in models/fpvrcnn.py.

Ports of coalign_tpu/models/zoo.py:
  * PointPillarBaselineMultiscale (:164-213; ref
    point_pillar_baseline_multiscale.py:17, aliased as the CoAlign model by
    point_pillar_coalign.py:9): PointPillars with per-scale intermediate
    fusion, optionally after a NaiveCompressor of the pillar canvas; with
    ``supervise_single`` its ``single_heads`` give each agent's ``*_single``
    maps (B*L, ...) from the unfused scales;
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
    feeds the pose graph (tools/stage1.py);
  * PointPillarDeformTransformer (:229-240; ref
    point_pillar_deform_transformer.py:20): the baseline with ``deform``
    fusion by default;
  * PointPillarWhere2comm (:243-291; ref comm_modules/where2comm.py,
    where2comm_attn.py:174): per-scale fusion of maps masked by each
    agent's confidence, with its own single-agent heads (the ``*_single``
    outputs, on (B*L, ...)) and the ``comm_rate``;
  * PointPillarV2VNetRobust (:294-345; ref point_pillar_v2vnet_robust.py
    :21) and PointPillarMash (:348-381; ref point_pillar_mash.py:18): the
    pose-robust baselines (fuse/robust.py, fuse/mash.py);
  * PointPillarDiscoNetTeacher (:411-437; ref
    point_pillar_disconet_teacher.py:15): DiscoNet's early-fusion teacher
    on the merged cloud, its outputs prefixed ``teacher_``.

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

from coalign_tpu_torch.models.backbones import backbone_from_config
from coalign_tpu_torch.models.camera import MODELS as LSS_FAMILY
from coalign_tpu_torch.models.fpvrcnn import MODELS as TWO_STAGE
from coalign_tpu_torch.models.fuse.fusion import build_fusion
from coalign_tpu_torch.models.heads import (DetectionHeads,
                                            add_detection_heads,
                                            detection_heads)
from coalign_tpu_torch.models.layers import (DownsampleConv, NaiveCompressor,
                                             compute_dtype, promote_unpinned)
from coalign_tpu_torch.models.pillar_encoder import PillarEncoder
from coalign_tpu_torch.models.pixor import PIXOR_FAMILY
from coalign_tpu_torch.models.second_family import MODELS as SECOND_FAMILY
from coalign_tpu_torch.ops.pillars import PillarSpec
from coalign_tpu_torch.runtime import resolve_device
from coalign_tpu_torch.utils.profiling import stage
from coalign_tpu_torch.utils.transforms import (get_pairwise_transformation,
                                                inverse_tfm, matmul_f32,
                                                normalize_pairwise_tfm)


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
        with stage("stage/pillar_encoder"):
            bev = self.pillar_vfe(batch["points"].reshape(b * l, n, -1),
                                  batch["point_mask"].reshape(b * l, n))
        if compute_dtype() is not None:
            # the collaborative models' canvas in the compute dtype
            # (coalign_tpu/models/zoo.py:118-119)
            bev = bev.to(compute_dtype())
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
        super().__init__(args)
        bb = args["base_bev_backbone"]
        # the reference compresses the 64-channel pillar canvas
        self.naive_compressor = (NaiveCompressor(64, args["compression"])
                                 if args.get("compression", 0) else None)
        feat_dims = args.get("att", {}).get("feat_dim", list(bb["num_filters"]))
        self.fusion_net = nn.ModuleList(
            [build_fusion(args["fusion_method"], args, feat_dims[i])
             for i in range(len(bb["layer_nums"]))])
        # supervise_single: each agent's unfused scales decoded, shrunk and
        # through heads of their own (coalign_tpu/models/zoo.py:184-208)
        self.single_heads = (DetectionHeads(self.out_dim, args)
                             if args.get("supervise_single") else None)

    def forward(self, batch: dict) -> dict:
        # the "stage/..." ranges (utils/profiling.stage) name the stages in
        # a torch.profiler trace and, exported, the served graph's stage
        # marks (serving.py); without a profiler none is opened
        bev, affine, (b, l) = self._encode_agents(batch)
        bn_mask = batch["agent_mask"].reshape(b * l)
        if self.naive_compressor is not None:
            bev = self.naive_compressor(bev, bn_mask)
        with stage("stage/backbone_encode"):
            feats = self.backbone.encode(bev, bn_mask)
        with stage("stage/fusion"):
            fused = [fuse(feat.reshape((b, l) + feat.shape[1:]), affine,
                          batch["agent_mask"])
                     for fuse, feat in zip(self.fusion_net, feats)]
        with stage("stage/decode_shrink_heads"):
            out = self._shrink_heads(self.backbone.decode(fused))
        if self.single_heads is not None:
            with stage("stage/single_heads"):
                single = self.backbone.decode(feats, bn_mask)
                if self.shrink_conv is not None:
                    single = self.shrink_conv(single)
                out.update({k + "_single": v
                            for k, v in self.single_heads(single).items()})
        return out


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
        with stage("stage/backbone_shrink"):
            x = self.backbone(bev, bn_mask)
            if self.shrink_conv is not None:
                x = self.shrink_conv(x)
            if self.naive_compressor is not None:
                x = self.naive_compressor(x, bn_mask)
        with stage("stage/fusion"):
            return self.fusion_net(x.reshape((b, l) + x.shape[1:]), affine,
                                   batch["agent_mask"])

    def forward(self, batch: dict) -> dict:
        fused = self._fuse(batch)
        with stage("stage/heads"):
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
        with stage("stage/heads"):
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


class PointPillarDeformTransformer(PointPillarBaseline):
    """Deformable-attention fusion (ref point_pillar_deform_transformer.py
    :20, whose sampling is an external CUDA extension; here fuse/deform.py):
    the baseline with ``deform`` fusion unless the yaml names another."""

    def __init__(self, args: dict):
        super().__init__({"fusion_method": "deform", **args})


class PointPillarWhere2comm(_PillarBase):
    """Where2comm (ref comm_modules/where2comm.py, where2comm_attn.py:174):
    the backbone's scales are decoded once per agent through the shrink and
    the ``single_heads``, whose cls logits (detached) are the confidence
    maps that mask what each agent sends; the masked scales are fused
    (``where2comm.agg_operator.mode``: ATTEN or max), decoded, shrunk and
    go through the heads. Outputs the fused maps, ``comm_rate`` and the
    single heads' maps with the ``_single`` suffix on (B*L, ...)."""

    def __init__(self, args: dict):
        super().__init__(args)
        from coalign_tpu_torch.models.fuse.where2comm import Where2commFusion
        bb = args["base_bev_backbone"]
        mode = args.get("where2comm", {}).get("agg_operator", {}).get(
            "mode", "ATTEN")
        self.fusion_net = Where2commFusion(mode, tuple(bb["num_filters"]))
        self.single_heads = DetectionHeads(self.out_dim, args)

    def forward(self, batch: dict) -> dict:
        bev, affine, (b, l) = self._encode_agents(batch)
        bn_mask = batch["agent_mask"].reshape(b * l)
        with stage("stage/backbone_encode"):
            feats = self.backbone.encode(bev, bn_mask)
        with stage("stage/single_heads"):
            single = self.backbone.decode(feats, bn_mask)
            if self.shrink_conv is not None:
                single = self.shrink_conv(single)
            single_out = self.single_heads(single)
        conf = single_out["cls_preds"].detach()
        with stage("stage/fusion"):
            fused, rate = self.fusion_net(
                [f.reshape((b, l) + f.shape[1:]) for f in feats],
                conf.reshape((b, l) + conf.shape[1:]), affine,
                batch["agent_mask"])
        with stage("stage/decode_shrink_heads"):
            out = self._shrink_heads(self.backbone.decode(fused))
        out["comm_rate"] = rate
        out.update({k + "_single": v for k, v in single_out.items()})
        return out


class PointPillarV2VNetRobust(_PillarBase):
    """Robust V2VNet (ref point_pillar_v2vnet_robust.py:21-139): backbone,
    shrink, then fuse/robust.RobustFusion on the noisy pairwise transforms
    (``robust``: hidden, downsample_rate, use_consistency), then the heads.
    Outputs pose_corr, agent_scores and pairwise_t_corrected too, and, for
    a batch with ``lidar_pose_clean``, the detached ``pose_corr_target``:
    the correction T_clean @ T_noisy^-1 of each pair as (x, y, yaw). The
    three-stage curriculum (ref :72-79) is tools/train_robust.py's."""

    def __init__(self, args: dict):
        super().__init__(args)
        from coalign_tpu_torch.models.fuse.robust import RobustFusion
        rb = args.get("robust", {})
        self.fusion_net = RobustFusion(
            self.out_dim, hidden=rb.get("hidden", 128),
            downsample_rate=rb.get("downsample_rate", 2.0),
            discrete_ratio=args["voxel_size"][0],
            use_consistency=rb.get("use_consistency", True))

    def forward(self, batch: dict) -> dict:
        from coalign_tpu_torch.models.fuse.robust import tfm_to_pose3
        bev, _, (b, l) = self._encode_agents(batch)
        with stage("stage/backbone_shrink"):
            x = self.backbone(bev, batch["agent_mask"].reshape(b * l))
            if self.shrink_conv is not None:
                x = self.shrink_conv(x)
        noisy = batch["pairwise_t_matrix"].to(x.dtype)
        with stage("stage/fusion"):
            fused, aux = self.fusion_net(x.reshape((b, l) + x.shape[1:]),
                                         noisy, batch["agent_mask"])
        with stage("stage/heads"):
            out = detection_heads(self, fused)
        out.update(aux)
        if "lidar_pose_clean" in batch:
            clean = get_pairwise_transformation(batch["lidar_pose_clean"],
                                                batch["agent_mask"])
            out["pose_corr_target"] = tfm_to_pose3(
                matmul_f32(clean.to(x.dtype), inverse_tfm(noisy))).detach()
        return out


class PointPillarMash(_PillarBase):
    """MASH (ref point_pillar_mash.py:18-160): backbone, shrink, then the
    pose-free fuse/mash.MASHFusion (``mash``: coarse_downsample,
    query_dim), then the heads; outputs the correspondence logits as
    ``corr_vol`` (B, L, P, P + 1)."""

    def __init__(self, args: dict):
        super().__init__(args)
        from coalign_tpu_torch.models.fuse.mash import MASHFusion
        mash = args.get("mash", {})
        self.fusion_net = MASHFusion(
            self.out_dim, coarse_downsample=mash.get("coarse_downsample", 4),
            query_dim=mash.get("query_dim", 32))

    def forward(self, batch: dict) -> dict:
        bev, affine, (b, l) = self._encode_agents(batch)
        with stage("stage/backbone_shrink"):
            x = self.backbone(bev, batch["agent_mask"].reshape(b * l))
            if self.shrink_conv is not None:
                x = self.shrink_conv(x)
        with stage("stage/fusion"):
            fused, corr_vol = self.fusion_net(
                x.reshape((b, l) + x.shape[1:]), affine, batch["agent_mask"])
        with stage("stage/heads"):
            out = detection_heads(self, fused)
        out["corr_vol"] = corr_vol
        return out


class PointPillarDiscoNetTeacher(_PillarBase):
    """DiscoNet's early-fusion teacher (ref point_pillar_disconet_teacher.py
    :15-75): the single-agent detector on the merged ego-frame cloud
    (``teacher_points`` (B, 1, N, 4) and ``teacher_point_mask`` where the
    batch has them, data/batch.KDFusionBatcher; else ``points``), with its
    backbone's norms over every frame (no agent mask). Outputs the shrunk
    map as ``teacher_feature`` and the heads' maps prefixed ``teacher_``.
    Its modules carry the reference's names, so the reference's
    point_pillar teacher checkpoints load strictly."""

    def forward(self, batch: dict) -> dict:
        points = batch.get("teacher_points", batch["points"])
        mask = batch.get("teacher_point_mask", batch["point_mask"])
        if points.dim() == 4:
            points = points.reshape((-1,) + points.shape[2:])
            mask = mask.reshape((-1,) + mask.shape[2:])
        x = self.backbone(self.pillar_vfe(points, mask))
        if self.shrink_conv is not None:
            x = self.shrink_conv(x)
        out = {"teacher_feature": x}
        out.update({"teacher_" + k: v
                    for k, v in detection_heads(self, x).items()})
        return out


_MODELS = {
    "point_pillar": PointPillar,
    "point_pillar_uncertainty": PointPillarUncertainty,
    "point_pillar_baseline_multiscale": PointPillarBaselineMultiscale,
    "point_pillar_coalign": CoAlign,
    "point_pillar_baseline": PointPillarBaseline,
    "point_pillar_intermediate": PointPillarIntermediate,
    "point_pillar_disconet": PointPillarDiscoNet,
    "point_pillar_disconet_teacher": PointPillarDiscoNetTeacher,
    "point_pillar_deform_transformer": PointPillarDeformTransformer,
    "point_pillar_where2comm": PointPillarWhere2comm,
    "point_pillar_v2vnet_robust": PointPillarV2VNetRobust,
    "point_pillar_mash": PointPillarMash,
    **SECOND_FAMILY,
    **PIXOR_FAMILY,
    **LSS_FAMILY,
    **TWO_STAGE,
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
    and position embeddings, MASH's no-match logit, robust V2VNet's alpha)
    and the Linears that start at zero (ZeroInitLinear), and the SECOND
    family's sparse-conv kernels (fan_in = Cin x kernel volume), by its
    ``init_weights(generator)``; nn.Conv3d kernels as the 2D ones."""
    with torch.no_grad():
        for mod in model.modules():
            # biases first, so that a module's own init_weights can set
            # one (PIXOR's cls head)
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d,
                                nn.Conv3d)) and mod.bias is not None:
                mod.bias.zero_()
            if isinstance(mod, (nn.modules.batchnorm._BatchNorm,
                                nn.LayerNorm)):
                mod.reset_parameters()
            elif hasattr(mod, "init_weights"):
                mod.init_weights(generator)
            elif isinstance(mod, nn.Linear):
                _lecun_normal_(mod.weight, mod.in_features, generator)
            elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d,
                                  nn.Conv3d)):
                _lecun_normal_(mod.weight, mod.in_channels
                               * math.prod(mod.kernel_size), generator)


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
    return promote_unpinned(model).to(dev).eval()
