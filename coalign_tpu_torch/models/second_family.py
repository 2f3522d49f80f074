"""The SECOND, CIA-SSD and VoxelNet models.

Port of coalign_tpu/models/second_family.py:
  * Second (ref second.py:14): mean voxels -> the 8x 3D backbone ->
    height compression -> BaseBEVBackbone -> heads, one agent's frame at
    a time;
  * SecondIntermediate (ref second_intermediate.py:15, AttBEVBackbone):
    the same with a fusion at every scale of the 2D backbone, the pairwise
    affines normalized to the /8 grid;
  * CIASSD / SecondSSFA (ref ciassd.py:11, second_ssfa.py:16): the SSFA
    trunk and CIA-SSD's heads (with the IoU head); SecondSSFAUncertainty
    (ref second_ssfa_uncertainty.py:17) adds the log-variance head,
    CoAlign's stage-1 detector on SECOND;
  * VoxelNet (ref voxel_net.py:177): a stacked VFE into a dense grid, three
    dense 3D convs squashing z, the 2D backbone and the heads;
    VoxelNetIntermediate (ref voxel_net_intermediate.py:61) fuses the 2D
    backbone's output.

Voxelization runs on the device from the batch's padded points
(ops/voxels.py, ops/sparse_conv.py). The 3D backbone is the sparse one
(models/voxel_backbone.py) when the grid has more than 1 << 22 cells, as
every 0.1 m grid of the yamls has, else its dense twin; ``backbone_3d.
sparse`` (or the reference's ``spconv`` block name) true or false forces
one. VoxelNet has no such gate: its VFE fills a dense grid and its middle
convs are dense (cuDNN).

The batch is the flagship's (models/zoo.py). Head maps are NCHW; the
single-agent models give them for every agent frame (B * L, ...). The
"stage/voxelize", "stage/backbone_3d", "stage/bev_trunk" (SSFA's too) and
"stage/fusion" ranges name the stages in a torch.profiler trace.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from coalign_tpu_torch.models.backbones import BaseBEVBackbone
from coalign_tpu_torch.models.fuse.fusion import build_fusion
from coalign_tpu_torch.models.heads import (CIASSDHead, add_detection_heads,
                                            detection_heads)
from coalign_tpu_torch.models.voxel_backbone import (
    SSFA, Conv3DBNReLU, SparseVoxelBackbone8x, VoxelBackbone8x, VoxelNorm,
    dense_ncdhw, height_compression, out_depth)
from coalign_tpu_torch.ops.sparse_conv import sparse_mean_voxelize
from coalign_tpu_torch.ops.voxels import (VoxelSpec, mean_voxelize,
                                          scatter_max_voxels_batched,
                                          voxel_ids,
                                          voxel_max_broadcast_batched,
                                          voxel_mean_batched)
from coalign_tpu_torch.utils.transforms import normalize_pairwise_tfm

SPARSE_ABOVE_CELLS = 1 << 22


def _frames(batch: dict) -> tuple:
    """The batch's points and point mask with agents flattened into frames:
    (B * L, N, 4), (B * L, N)."""
    points, mask = batch["points"], batch["point_mask"]
    if points.dim() == 4:
        points = points.reshape((-1,) + points.shape[2:])
        mask = mask.reshape((-1,) + mask.shape[2:])
    return points, mask


class _VoxelBase(nn.Module):
    """The yaml args and the voxel grid every model of the family has."""

    def __init__(self, args: dict):
        super().__init__()
        self.args = dict(args)
        self.spec = VoxelSpec.from_config(args["lidar_range"],
                                          args["voxel_size"])

    def _bev_channels(self, out_features: int) -> int:
        return out_features * out_depth(self.spec.nz)


class _SecondBase(_VoxelBase):
    """Mean voxels and the 8x 3D backbone under ``backbone_name`` (the
    reference's: ``backbone_3d``, or ``spconv_block`` for the SSFA
    models; load_pth takes either name, ``STATE_DICT_ALIASES``)."""

    backbone_name = "backbone_3d"
    STATE_DICT_ALIASES = {"spconv_block.": "backbone_3d."}

    def __init__(self, args: dict):
        super().__init__(args)
        # "spconv" is the reference second_ssfa.py's name for the block
        self.cfg3d = args.get("backbone_3d", args.get("spconv", {}))
        self.out_features = self.cfg3d.get("num_features_out", 128)
        cls = SparseVoxelBackbone8x if self.use_sparse else VoxelBackbone8x
        self.add_module(self.backbone_name,
                        cls(self.spec.nz, out_features=self.out_features))

    @property
    def use_sparse(self) -> bool:
        """The sparse backbone unless the grid has at most 1 << 22 cells,
        where the dense twin is the cheaper form ('auto'); a bool
        ``sparse`` in the block's args forces either."""
        mode = self.cfg3d.get("sparse", "auto")
        if mode == "auto":
            return self.spec.num_voxels > SPARSE_ABOVE_CELLS
        return bool(mode)

    def voxel_cap(self) -> int:
        """The sparse path's voxels a frame: the preprocessor's
        max_voxel_train in training and max_voxel_test in eval (32000 and
        70000 in the OPV2V yamls; yaml_utils.load_second_params hands them
        to the model), ``backbone_3d.max_voxels`` overriding both."""
        cap = self.args.get("max_voxel_train" if self.training
                            else "max_voxel_test")
        return int(self.cfg3d.get("max_voxels", cap or 70000))

    def _bev_features(self, batch: dict) -> torch.Tensor:
        """Voxelize -> 3D backbone -> height compression: (F, C * D, H/8,
        W/8), C-major as the reference's."""
        points, mask = _frames(batch)
        with record_function("stage/voxelize"):
            if self.use_sparse:
                grid = sparse_mean_voxelize(points, mask, self.spec,
                                            self.voxel_cap(), pad_z=1)
            else:
                grid, _ = mean_voxelize(points, mask, self.spec)
                # spconv pads the z extent by one empty slice (ref
                # sparse_backbone_3d.py:39)
                grid = F.pad(grid, (0, 0, 0, 0, 0, 0, 0, 1)).permute(
                    0, 4, 1, 2, 3)
        with record_function("stage/backbone_3d"):
            out = getattr(self, self.backbone_name)(grid)["out"]
            return height_compression(dense_ncdhw(out))


class Second(_SecondBase):
    """Single-agent SECOND (ref second.py:14-60)."""

    def __init__(self, args: dict):
        super().__init__(args)
        bb = args["base_bev_backbone"]
        self.backbone_2d = BaseBEVBackbone(
            bb, self._bev_channels(self.out_features))
        add_detection_heads(self, sum(bb["num_upsample_filter"]), args)

    def forward(self, batch: dict) -> dict:
        x = self._bev_features(batch)
        with record_function("stage/bev_trunk"):
            x = self.backbone_2d(x)
        return detection_heads(self, x)


class SecondIntermediate(Second):
    """SECOND with a fusion (``fusion_method``, att by default) at every
    scale of the 2D backbone (ref second_intermediate.py:15,
    AttBEVBackbone); the affines are normalized to the /8 grid."""

    def __init__(self, args: dict):
        super().__init__(args)
        method = args.get("fusion_method", "att")
        self.fusion_net = nn.ModuleList(
            [build_fusion(method, args, c)
             for c in args["base_bev_backbone"]["num_filters"]])

    def forward(self, batch: dict) -> dict:
        b, l = batch["agent_mask"].shape
        x = self._bev_features(batch)
        affine = normalize_pairwise_tfm(
            batch["pairwise_t_matrix"], self.spec.ny // 8, self.spec.nx // 8,
            self.args["voxel_size"][0] * 8)
        with record_function("stage/bev_trunk"):
            scales = self.backbone_2d.encode(x)
        with record_function("stage/fusion"):
            fused = [fuse(f.reshape((b, l) + f.shape[1:]), affine,
                          batch["agent_mask"])
                     for fuse, f in zip(self.fusion_net, scales)]
        with record_function("stage/bev_trunk"):
            x = self.backbone_2d.decode(fused)
        return detection_heads(self, x)


class CIASSD(_SecondBase):
    """Single-agent CIA-SSD (ref ciassd.py:11-46): the SSFA trunk and
    CIA-SSD's heads, the IoU head included."""

    backbone_name = "spconv_block"
    STATE_DICT_ALIASES = {"backbone_3d.": "spconv_block."}

    def __init__(self, args: dict):
        super().__init__(args)
        f = args.get("ssfa", {}).get("feature_num", 128)
        self.ssfa = SSFA(self._bev_channels(self.out_features), f)
        self.head = CIASSDHead(f, self.args)

    def forward(self, batch: dict) -> dict:
        x = self._bev_features(batch)
        with record_function("stage/bev_trunk"):
            x = self.ssfa(x)
        return self.head(x)


class SecondSSFA(CIASSD):
    """The name the SECOND + SSFA yamls use (ref second_ssfa.py:16)."""


class SecondSSFAUncertainty(CIASSD):
    """SECOND-SSFA with a log-variance head of ``uncertainty_dim`` (default
    3) channels an anchor (ref second_ssfa_uncertainty.py:17)."""

    def __init__(self, args: dict):
        super().__init__({"uncertainty_dim": 3, **args})


class VFELayer(nn.Module):
    """VoxelNet's VFE (ref voxel_net.py SVFE): a pointwise Linear (no bias)
    + batch norm + ReLU to ``out_features / 2`` channels, concatenated with
    each point's voxel max. Its norm's statistics take every point slot,
    padded ones too, as the JAX package's."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.linear = nn.Linear(in_features, out_features // 2, bias=False)
        self.norm = VoxelNorm(out_features // 2)

    def forward(self, feats, ids, valid, num_voxels: int) -> torch.Tensor:
        x = F.relu(self.norm(self.linear(feats))) * valid[..., None]
        return torch.cat([x, voxel_max_broadcast_batched(
            x, ids, valid, num_voxels)], dim=-1)


class VoxelNet(_VoxelBase):
    """VoxelNet (ref voxel_net.py:177): the stacked VFE (svfe) into a dense
    (F, 128, D, H, W) grid, three dense 3D convs (cml) squashing z, the 2D
    backbone and the heads."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.svfe = nn.ModuleDict({
            "vfe_1": VFELayer(7, 32), "vfe_2": VFELayer(32, 128),
            "linear": nn.Linear(128, 128, bias=False),
            "norm": VoxelNorm(128)})
        self.cml = nn.ModuleList([
            Conv3DBNReLU(128, 64, stride=(2, 1, 1)),
            Conv3DBNReLU(64, 64, padding=(0, 1, 1)),
            Conv3DBNReLU(64, 64, stride=(2, 1, 1))])
        d = (self.spec.nz - 1) // 2 + 1
        d = ((d - 2) - 1) // 2 + 1
        bb = args["base_bev_backbone"]
        self.backbone_2d = BaseBEVBackbone(bb, 64 * d)
        self.out_dim = sum(bb["num_upsample_filter"])
        add_detection_heads(self, self.out_dim, args)

    def _svfe(self, batch: dict) -> torch.Tensor:
        """Padded points -> the dense (F, 128, nz, ny, nx) grid of each
        voxel's max feature."""
        points, mask = _frames(batch)
        spec, nv = self.spec, self.spec.num_voxels
        ids, valid = voxel_ids(points, mask, spec)
        ones = valid.to(points.dtype)[..., None]
        # 7 channels: xyz, intensity, offset to the voxel's centroid
        mean = voxel_mean_batched(points[..., :3], ids, valid, nv)
        x = torch.cat([points, points[..., :3] - mean], dim=-1) * ones
        x = self.svfe["vfe_1"](x, ids, valid, nv)
        x = self.svfe["vfe_2"](x, ids, valid, nv)
        x = F.relu(self.svfe["norm"](self.svfe["linear"](x))) * ones
        return scatter_max_voxels_batched(x, ids, valid, spec).permute(
            0, 4, 1, 2, 3)

    def _trunk(self, batch: dict) -> torch.Tensor:
        with record_function("stage/voxelize"):
            x = self._svfe(batch)
        with record_function("stage/backbone_3d"):
            for conv in self.cml:
                x = conv(x)
            x = height_compression(x)
        with record_function("stage/bev_trunk"):
            return self.backbone_2d(x)

    def forward(self, batch: dict) -> dict:
        return detection_heads(self, self._trunk(batch))


class VoxelNetIntermediate(VoxelNet):
    """VoxelNet with a fusion (``fusion_method``, att by default) of the 2D
    backbone's output (ref voxel_net_intermediate.py:61)."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.fusion_net = build_fusion(args.get("fusion_method", "att"), args,
                                       self.out_dim)

    def forward(self, batch: dict) -> dict:
        b, l = batch["agent_mask"].shape
        x = self._trunk(batch)
        h, w = x.shape[2:]
        ds = self.spec.ny // h
        affine = normalize_pairwise_tfm(batch["pairwise_t_matrix"], h, w,
                                        self.args["voxel_size"][0] * ds)
        with record_function("stage/fusion"):
            fused = self.fusion_net(x.reshape((b, l) + x.shape[1:]), affine,
                                    batch["agent_mask"])
        return detection_heads(self, fused)


MODELS = {
    "second": Second,
    "second_intermediate": SecondIntermediate,
    "ciassd": CIASSD,
    "second_ssfa": SecondSSFA,
    "second_ssfa_uncertainty": SecondSSFAUncertainty,
    "voxel_net": VoxelNet,
    "voxel_net_intermediate": VoxelNetIntermediate,
}
