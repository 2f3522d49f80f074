"""Lift-Splat-Shoot camera detectors: single-agent and collaborative.

Port of coalign_tpu/models/camera.py (ref opencood/models/
lift_splat_shoot.py:16, lift_splat_shoot_intermediate.py:18,
sub_modules/lss_submodule.py), NCHW, under the reference's state-dict
names (``camencode``, ``bevencode``, the heads, ``*_head_before_fusion``
for the single-agent heads, ``shrink_conv``), so tests/golden/lss_*.pth
load strictly (utils/weights.load_pth). The trunks are
models/camera_trunks.py; lift and splat are ops/lss.py.

Camera batch (``image_inputs``, the JAX package's contract, channels last):
  imgs       (B, L, N, H, W, 3)  normalized images
  rots       (B, L, N, 3, 3)     camera -> lidar rotation
  trans      (B, L, N, 3)        camera -> lidar translation
  intrins    (B, L, N, 3, 3)
  post_rots  (B, L, N, 3, 3)     the image augmentation
  post_trans (B, L, N, 3)
  depth_map  (B, L, N, H, W)     metric depth, read with ``use_gt_depth``
Outputs are NCHW on (B*L, ...) for the single-agent model and (B, ...) for
the collaborative one; ``depth_logits`` (B*L, N, D, fH, fW) where the
encoder predicts depth.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.models.camera_trunks import (EFFNET_DEAD,
                                                    EfficientNetB0,
                                                    ResNet18Layers,
                                                    ResNet101Trunk, TorchUp,
                                                    upsample_align_corners)
from coalign_tpu_torch.models.fuse.fusion import build_fusion
from coalign_tpu_torch.models.heads import (add_detection_heads,
                                            detection_heads)
from coalign_tpu_torch.models.layers import (DownsampleConv,
                                             MaskedBatchNorm2d,
                                             compute_dtype)
from coalign_tpu_torch.ops.lss import (LSSSpec, bin_depths, get_geometry,
                                       voxel_pool)
from coalign_tpu_torch.utils.profiling import stage
from coalign_tpu_torch.utils.transforms import normalize_pairwise_tfm


class CamEncode(nn.Module):
    """EfficientNet-b0 image encoder (ref lss_submodule.py:41): up1 fuses
    reduction_5 and 4 to /16, up2 fuses reduction_3 to /8 (downsample 8),
    then the 1x1 ``image_head`` (context, C ch) and ``depth_head`` (D
    logits) on the shared 512 channels; no depth head with
    ``use_gt_depth``."""

    def __init__(self, depth_bins: int, cam_channels: int,
                 downsample: int = 8, use_gt_depth: bool = False):
        super().__init__()
        self.trunk = EfficientNetB0()
        self.up1 = TorchUp(320 + 112, 512)
        self.up2 = TorchUp(512 + 40, 512) if downsample == 8 else None
        self.image_head = nn.Conv2d(512, cam_channels, 1)
        self.depth_head = (None if use_gt_depth
                           else nn.Conv2d(512, depth_bins, 1))

    def forward(self, x: torch.Tensor):
        r3, r4, r5 = self.trunk(x)
        f = self.up1(r5, r4)
        if self.up2 is not None:
            f = self.up2(f, r3)
        return self.image_head(f), (None if self.depth_head is None
                                    else self.depth_head(f))


class CamEncodeResnet101(ResNet101Trunk):
    """ResNet-101 through layer2 (ref lss_submodule.py:142
    CamEncode_Resnet101): 512 ch at /8, then the 1x1 heads. The reference
    also builds up1/up2 blocks that its downsample-8 forward never calls:
    they are not built, and load_pth drops their keys."""

    def __init__(self, depth_bins: int, cam_channels: int,
                 downsample: int = 8, use_gt_depth: bool = False):
        super().__init__()
        self._build_trunk()
        self.image_head = nn.Conv2d(512, cam_channels, 1)
        self.depth_head = (None if use_gt_depth
                           else nn.Conv2d(512, depth_bins, 1))

    def forward(self, x: torch.Tensor):
        f = self.trunk(x)
        return self.image_head(f), (None if self.depth_head is None
                                    else self.depth_head(f))


class BevEncode(ResNet18Layers):
    """Single-agent BEV encoder (ref lss_submodule.py:247): resnet18
    layers 1-3, ``up1`` Up(64 + 256 -> 256, x4), then ``up2``: upsample x2,
    3x3 conv, BN (eps 1e-5), ReLU, 1x1 conv to ``out_ch``; full BEV
    resolution."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self._build_trunk(in_ch)
        self.up1 = TorchUp(64 + 256, 256, scale=4)
        self.up2 = nn.Sequential(
            nn.Identity(),  # the reference's nn.Upsample, no state
            nn.Conv2d(256, 128, 3, padding=1, bias=False),
            MaskedBatchNorm2d(128), nn.ReLU(inplace=True),
            nn.Conv2d(128, out_ch, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, _, x3 = self.trunk(x)
        y = upsample_align_corners(self.up1(x3, x1), 2)
        return self.up2(y)


class BevEncodeFusion(ResNet18Layers):
    """Collaborative BEV encoder (ref lss_submodule.py:287
    BevEncodeSSFusion, :360 BevEncodeMSFusion): resnet18 trunk, decode by
    ``up_layer2`` and ``up_layer1``, then ``down_layer`` (256 -> 256 ->
    128, 3x3 convs with ReLUs). ``ms`` fuses each trunk scale (the
    parameterless max / att; ``fuse_modules``), else the decoded 256-ch
    map once (``fuse_module``, any fusion of the registry). Returns
    (x_single (B*L, 128, ...), x_fuse (B, 128, ...)), both at BEV/2."""

    def __init__(self, in_ch: int, fusion_args: dict, ms: bool):
        super().__init__()
        self._build_trunk(in_ch)
        method = fusion_args.get("core_method", "att")
        for suf in ("_ms", "_ss"):
            method = method.removesuffix(suf)
        sub_args = fusion_args.get("args", fusion_args)
        self.ms = ms
        self.up_layer2 = TorchUp(256 + 128, 256)
        self.up_layer1 = TorchUp(256 + 64, 256)
        self.down_layer = nn.Sequential(
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(256, 128, 3, padding=1), nn.ReLU(inplace=True))
        if ms:
            self.fuse_modules = nn.ModuleList(
                [build_fusion(method, sub_args, c) for c in (64, 128, 256)])
        else:
            self.fuse_module = build_fusion(method, sub_args, 256)

    def forward(self, x, affine, agent_mask):
        b, l = agent_mask.shape

        def fuse(net, feat):
            return net(feat.reshape((b, l) + feat.shape[1:]), affine,
                       agent_mask)

        def decode(x1, x2, x3):
            return self.up_layer1(self.up_layer2(x3, x2), x1)

        x1, x2, x3 = self.trunk(x)
        x_single = self.down_layer(decode(x1, x2, x3))
        with stage("stage/fusion"):
            if self.ms:
                f1, f2, f3 = (fuse(net, feat) for net, feat in
                              zip(self.fuse_modules, (x1, x2, x3)))
                x_fuse = self.down_layer(decode(f1, f2, f3))
            else:
                # decoded again, as the JAX package does: in training its
                # norms' running statistics move twice
                x_fuse = self.down_layer(fuse(self.fuse_module,
                                              decode(x1, x2, x3)))
        return x_single, x_fuse


class _LSSBase(nn.Module):
    """The camera encoder, the lift and the splat (the JAX package's
    _LSSBase._lift_splat, coalign_tpu/models/camera.py:196-269)."""

    def __init__(self, args: dict):
        super().__init__()
        self.args = dict(args)
        self.spec = LSSSpec.from_config(args["grid_conf"],
                                        args["data_aug_conf"],
                                        args.get("img_downsample", 8))
        # the reference's knob is bevout_feature; bev_out_channels is the
        # JAX package's alias
        self.bev_out = int(args.get("bevout_feature",
                                    args.get("bev_out_channels", 128)))
        self.use_gt_depth = bool(args.get("use_depth_gt",
                                          args.get("use_gt_depth")))
        self.cam_channels = args.get("img_features", 64)
        resnet = "resnet" in args.get("camera_encoder",
                                      "EfficientNet").lower()
        enc = CamEncodeResnet101 if resnet else CamEncode
        self.camencode = enc(self.spec.depth_bins, self.cam_channels,
                             self.spec.downsample, self.use_gt_depth)
        # checkpoint keys of reference modules that no forward reads
        self.STATE_DICT_DEAD = (("camencode.up1.", "camencode.up2.")
                                if resnet else tuple(
                                    "camencode.trunk." + k
                                    for k in EFFNET_DEAD))
        self.register_buffer("frustum", torch.from_numpy(
            self.spec.frustum()), persistent=False)

    def _lift_splat(self, image_inputs: dict, freeze: bool = False):
        """(F = B*L agent frames) x N cameras -> the (F, nz*C, ny, nx) BEV
        and the depth logits (F, N, D, fH, fW), or None.

        With ``use_gt_depth`` and a ``depth_map`` the depth distribution is
        the one-hot of the binned gt depth (ref lss_submodule.py:51-69).
        ``freeze`` runs the encoder without autograd, the reference's
        requires_grad=False on camencode (lift_splat_shoot_intermediate.py
        :30): its parameters get no gradient, its norms still train. Under
        the compute-dtype policy the lift and the splat run in it
        (coalign_tpu/models/camera.py:240-248); the geometry does not."""
        spec = self.spec
        imgs = image_inputs["imgs"]
        lead = imgs.shape[:-3]                     # (B, L, N)
        n = lead[-1]
        f = math.prod(lead[:-1])
        fh, fw = spec.feat_hw
        with stage("stage/camera_trunk"):
            x = imgs.reshape((f * n,) + imgs.shape[-3:]).permute(0, 3, 1, 2)
            # frozen: no graph through the encoder, whose outputs no
            # gradient reaches (the JAX package's stop_gradient); its norms'
            # statistics still move in training
            with torch.no_grad() if freeze else contextlib.nullcontext():
                context, depth_logits = self.camencode(x)
        with stage("stage/lift"):
            if depth_logits is None or (self.use_gt_depth
                                        and "depth_map" in image_inputs):
                dm = image_inputs["depth_map"].reshape(
                    (f * n,) + image_inputs["depth_map"].shape[-2:])
                ds = spec.downsample
                dm = dm[:, ::ds, ::ds][:, :fh, :fw]
                idx = bin_depths(dm, spec.mode, spec.ddiscr[0],
                                 spec.ddiscr[1], spec.depth_bins)
                # an index out of the bins is an all-zero row
                depth = F.one_hot(idx, spec.depth_bins + 1)[
                    ..., :spec.depth_bins].to(context.dtype).permute(
                        0, 3, 1, 2)
            else:
                depth = torch.softmax(depth_logits, dim=1)
            if compute_dtype() is not None:
                depth = depth.to(compute_dtype())
                context = context.to(compute_dtype())
            # (F*N, D, fH, fW, 1) x (F*N, 1, fH, fW, C)
            feats = depth[..., None] * context.permute(0, 2, 3, 1)[:, None]
            feats = feats.reshape((f, n) + feats.shape[1:])

            def r(key):
                a = image_inputs[key]
                return a.reshape((f, n) + a.shape[len(lead):])

            geom = get_geometry(self.frustum.to(image_inputs["rots"].dtype),
                                r("rots"), r("trans"), r("intrins"),
                                r("post_rots"), r("post_trans"))
        with stage("stage/splat"):
            bev = voxel_pool(geom, feats, spec)
        if depth_logits is None:
            return bev, None
        return bev, depth_logits.reshape((f, n) + depth_logits.shape[1:])


class LiftSplatShoot(_LSSBase):
    """Single-agent camera detector (ref lift_splat_shoot.py:16): every
    agent frame on its own, BevEncode at full BEV resolution, the optional
    ``shrink_conv``, the heads."""

    def __init__(self, args: dict):
        super().__init__(args)
        spec = self.spec
        self.bevencode = BevEncode(spec.nz * self.cam_channels, self.bev_out)
        self.shrink_conv = (DownsampleConv(args["shrink_header"])
                            if "shrink_header" in args else None)
        out = (args["shrink_header"]["dim"][-1] if "shrink_header" in args
               else self.bev_out)
        add_detection_heads(self, out, args)

    def forward(self, batch: dict) -> dict:
        bev, depth_logits = self._lift_splat(batch["image_inputs"])
        with stage("stage/bev_encoder"):
            x = self.bevencode(bev)
            if self.shrink_conv is not None:
                x = self.shrink_conv(x)
        with stage("stage/heads"):
            out = detection_heads(self, x)
        if depth_logits is not None:
            out["depth_logits"] = depth_logits
        return out


class LiftSplatShootIntermediate(_LSSBase):
    """Collaborative camera detector with SS or MS BEV fusion (ref
    lift_splat_shoot_intermediate.py:18-68). In training the camera encoder
    is frozen, as the reference's, unless ``freeze_camencode: false``. With
    ``supervise_single`` the single-agent heads give the ``*_single``
    outputs (B*L, ...)."""

    def __init__(self, args: dict):
        super().__init__(args)
        spec = self.spec
        fusion_args = args.get("fusion_args", {})
        self.bevencode = BevEncodeFusion(
            spec.nz * self.cam_channels, fusion_args,
            ms=fusion_args.get("core_method", "att_ms").endswith("ms"))
        add_detection_heads(self, 128, args)
        # supervise_single's heads, under the reference's names
        # (``*_head_before_fusion``)
        self.supervise_single = bool(args.get("supervise_single", False))
        if self.supervise_single:
            add_detection_heads(self, 128, args, "_before_fusion")

    def forward(self, batch: dict) -> dict:
        spec = self.spec
        freeze = self.training and self.args.get("freeze_camencode", True)
        bev, depth_logits = self._lift_splat(batch["image_inputs"], freeze)
        affine = normalize_pairwise_tfm(batch["pairwise_t_matrix"], spec.ny,
                                        spec.nx, spec.xbound[2])
        with stage("stage/bev_encoder"):
            single, fused = self.bevencode(bev, affine, batch["agent_mask"])
        with stage("stage/heads"):
            out = detection_heads(self, fused)
            if depth_logits is not None:
                out["depth_logits"] = depth_logits
            if self.supervise_single:
                out.update({k + "_single": v for k, v in detection_heads(
                    self, single, "_before_fusion").items()})
        return out


MODELS = {"lift_splat_shoot": LiftSplatShoot,
          "lift_splat_shoot_intermediate": LiftSplatShootIntermediate}
