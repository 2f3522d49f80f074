"""FPV-RCNN and FVoxelRCNN: the two-stage collaborative detectors.

Port of coalign_tpu/models/fpvrcnn.py (ref opencood/models/fpvrcnn.py:18-90,
fvoxelrcnn.py:17):
  stage 1  each agent frame's SECOND trunk (mean voxels, the 8x 3D
           backbone, SSFA) and heads with the IoU head, decoded on the
           device into ``stage1_postprocess.max_boxes`` boxes an agent
           (postprocess/decode.post_process, one NMS launch for all the
           batch's agent frames); the proposals are detached, as the JAX
           package's stop_gradient and the reference's no_grad decode;
  matcher  the agents' boxes clustered and score-fused (models/matcher.py)
           into ``max_rois`` RoIs a frame;
  stage 2  FPV-RCNN (a ``vsa`` block): FPS keypoints of every agent featured
           by VoxelSetAbstraction (models/vsa.py), projected into the ego
           frame (the CPM), kept inside the enlarged RoIs, and pooled at
           each RoI's rotated grid by a second ball-query set abstraction;
           FVoxelRCNN: every agent's BEV map warped into the ego frame, the
           max over agents, bilinear RoI-grid pooling (ops/roi.py). A shared
           MLP (RoIHead) regresses the refinement and an IoU confidence.

As in the JAX package, stage 1's ``boxes7`` are in each agent's own frame
(post_process projects only the corners), and the matcher clusters them
so; the keypoints it selects are in the ego frame (ROADMAP §3 records this
among the JAX package's disagreements with the reference; the port follows
it). Outputs: the stage-1 head maps as ``*_single`` (B * L, ...), NCHW;
``rois``, ``roi_mask``, ``roi_scores``, ``roi_cls``, ``roi_reg``,
``boxes_refined`` and ``scores_refined`` (B, R, ...); the stage-1 boxes.
The "stage/stage1_decode", "stage/matcher", "stage/ball_query" and
"stage/roi_head" ranges name the stages in a torch.profiler trace, beside
the trunk's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from coalign_tpu_torch.models.fuse.robust import ZeroInitLinear
from coalign_tpu_torch.models.heads import add_detection_heads, detection_heads
from coalign_tpu_torch.models.matcher import match_and_fuse
from coalign_tpu_torch.models.second_family import _SecondBase
from coalign_tpu_torch.models.voxel_backbone import SSFA
from coalign_tpu_torch.models.vsa import VoxelSetAbstraction
from coalign_tpu_torch.ops.pointnet2 import SAModuleMSG
from coalign_tpu_torch.ops.roi import (points_in_rotated_boxes,
                                       roi_grid_points, roi_grid_pool)
from coalign_tpu_torch.ops.warp import warp_agents_to_ego
from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
from coalign_tpu_torch.postprocess.decode import post_process
from coalign_tpu_torch.utils.profiling import stage
from coalign_tpu_torch.utils.transforms import (normalize_pairwise_tfm,
                                                project_points)


class RoIHead(nn.Module):
    """Shared-MLP RoI refinement (ref roi_head.py:13): two Linear + ReLU of
    ``hidden``, then the confidence (1) and the residuals (7, starting at
    zero); ``dense.{0..3}`` are flax's Dense_0..3."""

    def __init__(self, in_features: int, hidden: int = 256):
        super().__init__()
        self.dense = nn.ModuleList([
            nn.Linear(in_features, hidden), nn.Linear(hidden, hidden),
            nn.Linear(hidden, 1), ZeroInitLinear(hidden, 7)])

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats (R, G, C) -> (cls (R,), reg (R, 7))."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = F.relu(self.dense[0](x))
        x = F.relu(self.dense[1](x))
        return self.dense[2](x)[:, 0], self.dense[3](x)


class FpvRcnn(_SecondBase):
    """The two-stage detector (ref fpvrcnn.py:18-90): the keypoint stage 2
    when the args have a ``vsa`` block, else the BEV one."""

    backbone_name = "spconv_block"
    STATE_DICT_ALIASES = {"backbone_3d.": "spconv_block."}

    def __init__(self, args: dict):
        super().__init__(args)
        f = args.get("ssfa", {}).get("feature_num", 128)
        self.ssfa = SSFA(self._bev_channels(self.out_features), f)
        add_detection_heads(self, f, {**args, "use_iou_head": True})
        aa = dict(args["anchor_args"])
        # the grid geometry where the yaml parser has not filled it
        aa.setdefault("vw", args["voxel_size"][0])
        aa.setdefault("vh", args["voxel_size"][1])
        aa.setdefault("W", self.spec.nx)
        aa.setdefault("H", self.spec.ny)
        self.register_buffer("anchors", torch.as_tensor(generate_anchor_box(
            aa, args.get("order", "hwl"))), persistent=False)
        grid = args.get("roi_grid_size", 6)
        if "vsa" in args:
            cfg = args["vsa"]
            self.vsa = VoxelSetAbstraction(cfg, args["lidar_range"],
                                           args["voxel_size"], f)
            rg = args.get("roi_head", {}).get("roi_grid_pool", {})
            grid = int(rg.get("grid_size", grid))
            self.roi_grid_pool = SAModuleMSG(
                int(cfg["num_out_features"]), rg.get("pool_radius",
                                                     (0.8, 1.6)),
                rg.get("n_sample", (16, 16)),
                rg.get("mlps", ((64, 64), (64, 64))))
            c = self.roi_grid_pool.out_channels
        else:
            c = f
        self.grid_size = grid
        self.roi_head = RoIHead(grid * grid * c, args.get("roi_hidden", 256))

    def _stage1(self, stage1: dict, tfm: torch.Tensor, agent_mask):
        """The agents' decoded boxes, detached: boxes (B, L*k, 7) in each
        agent's frame, scores and valid (B, L*k), a padded agent's boxes
        invalid."""
        b, l = agent_mask.shape
        post = self.args.get("stage1_postprocess", {})
        k = post.get("max_boxes", 32)
        dets = post_process(
            stage1["cls_preds"].detach(), stage1["reg_preds"].detach(),
            self.anchors, tfm, dir_preds=(
                stage1["dir_preds"].detach() if "dir_preds" in stage1
                else None),
            score_threshold=post.get("score_threshold", 0.2),
            nms_threshold=post.get("nms_thresh", 0.15),
            gt_range=tuple(self.args["lidar_range"]), prefilter_k=256,
            max_keep=k)
        valid = dets["mask"].reshape(b, l, k) & agent_mask[:, :, None]
        return (dets["boxes7"].reshape(b, l * k, 7),
                dets["scores"].reshape(b, l * k), valid.reshape(b, l * k))

    def _keypoint_stage2(self, batch, feat, tfm, fused, b, l):
        """The keypoint path: (B, R, G, C) pooled RoI-grid features."""
        pts = batch["points"].reshape((b * l,) + batch["points"].shape[2:])
        pmask = batch["point_mask"].reshape(b * l, -1)
        kp_xyz, kp_feat, kp_mask = self.vsa(pts, pmask, bev_feat=feat)
        nk = kp_xyz.shape[1]
        # the CPM crossing the channel: keypoints projected into the ego
        # frame, merged over the agents
        kp_ego = project_points(kp_xyz, tfm.to(kp_xyz.dtype)).reshape(
            b, l * nk, 3)
        kp_feat = kp_feat.reshape(b, l * nk, kp_feat.shape[-1])
        kp_mask = (kp_mask.reshape(b, l, nk)
                   & batch["agent_mask"][:, :, None]).reshape(b, l * nk)
        # keypoints inside the (enlarged) fused boxes (ref vsa.py:165-201)
        sel = fused["boxes"]
        if self.args["vsa"].get("enlarge_selection_boxes", True):
            sel = sel + sel.new_tensor([0, 0, 0, 0.5, 0.5, 0.5, 0])
        inside = points_in_rotated_boxes(kp_ego, sel) \
            & fused["mask"][..., None]
        kp_mask = kp_mask & inside.any(dim=1)
        # every RoI's rotated grid ball-queries the merged keypoints
        g = self.grid_size ** 2
        grid_xy = roi_grid_points(fused["boxes"], self.grid_size)
        r = grid_xy.shape[1]
        grid_z = fused["boxes"][..., None, 2:3].expand(b, r, g, 1)
        new_xyz = torch.cat([grid_xy, grid_z], -1).reshape(b, r * g, 3)
        new_mask = fused["mask"][..., None].expand(b, r, g).reshape(b, r * g)
        with stage("stage/ball_query"):
            pooled = self.roi_grid_pool(new_xyz, new_mask, kp_ego, kp_mask,
                                        feats=kp_feat)
        return pooled.reshape(b, r, g, -1)

    def _bev_stage2(self, batch, feat, fused, b, l):
        """The BEV path: (B, R, G, C) RoI-grid samples of the max over the
        agents' maps warped into the ego frame."""
        c, h, w = feat.shape[1:]
        affine = normalize_pairwise_tfm(
            batch["pairwise_t_matrix"].to(feat.dtype), self.spec.ny // 8,
            self.spec.nx // 8, self.args["voxel_size"][0] * 8)
        warped = warp_agents_to_ego(feat.reshape(b, l, c, h, w),
                                    affine[:, 0], batch["agent_mask"])
        return roi_grid_pool(warped.amax(dim=1), fused["boxes"],
                             self.args["lidar_range"],
                             self.args["voxel_size"], 8, self.grid_size)

    def forward(self, batch: dict) -> dict:
        b, l = batch["agent_mask"].shape
        feat = self._bev_features(batch)
        with stage("stage/bev_trunk"):
            feat = self.ssfa(feat)                        # (B*L, C, H, W)
        stage1 = detection_heads(self, feat)
        # T_ego<-j of every agent frame
        tfm = batch["pairwise_t_matrix"][:, :, 0].reshape(b * l, 4, 4)
        with stage("stage/stage1_decode"):
            boxes, scores, valid = self._stage1(stage1, tfm.to(feat.dtype),
                                                batch["agent_mask"])
        with stage("stage/matcher"):
            fused = match_and_fuse(
                boxes, scores, valid, self.args.get("matcher_iou", 0.1),
                self.args.get("max_rois", 32),
                version=self.args.get("matcher_version", "ref"),
                gt_range=self.args.get("lidar_range"))
        if "vsa" in self.args:
            pooled = self._keypoint_stage2(batch, feat, tfm, fused, b, l)
        else:
            with stage("stage/roi_head"):
                pooled = self._bev_stage2(batch, feat, fused, b, l)
        with stage("stage/roi_head"):
            r = pooled.shape[1]
            cls, reg = self.roi_head(pooled.reshape((b * r,)
                                                    + pooled.shape[2:]))
            cls, reg = cls.reshape(b, r), reg.reshape(b, r, 7)
            # the refinement: dx, dy by the box diagonal, dz by its height,
            # log-residual sizes, additive yaw
            rois = fused["boxes"]
            diag = torch.sqrt(rois[..., 4] ** 2 + rois[..., 5] ** 2 + 1e-6)
            refined = torch.cat([
                rois[..., 0:2] + reg[..., 0:2] * diag[..., None],
                rois[..., 2:3] + reg[..., 2:3] * rois[..., 3:4],
                rois[..., 3:6] * torch.exp(torch.clamp(reg[..., 3:6], -2, 2)),
                rois[..., 6:7] + reg[..., 6:7]], dim=-1)
        out = {k + "_single": v for k, v in stage1.items()}
        out.update({
            "stage1_boxes": boxes, "stage1_scores": scores,
            "stage1_valid": valid, "rois": rois, "roi_mask": fused["mask"],
            "roi_scores": fused["scores"], "roi_cls": cls, "roi_reg": reg,
            "boxes_refined": refined,
            "scores_refined": torch.sigmoid(cls) * fused["mask"]})
        return out


class FVoxelRcnn(FpvRcnn):
    """The Voxel-RCNN-headed variant (ref fvoxelrcnn.py:17): the same
    model; its yamls have no ``vsa`` block, so stage 2 is the BEV path."""


MODELS = {"fpvrcnn": FpvRcnn, "fvoxelrcnn": FVoxelRcnn}
