"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:
  1. card    the GPU's name and power limit (nvidia-smi);
  2. build   nvcc builds the rotated-IoU kernel into coalign_tpu_torch/_build/
             and reports ptxas's registers, stack frame and spills; g++
             builds the host data plane (native/data_plane.cpp) there at
             the same time;
  3. kernel  the kernel against its plain PyTorch version on the seeded
             cases of kernel_cases(), with the share of pairs that the
             kernel's separation cull clears;
  4. full    the CoAlign flagship at full width (200x704 canvas, 5 agents,
             ResNet [3,5,8] x [64,128,256], att fusion at 3 scales, K=512
             NMS prefilter) with the reference checkpoint, against the
             reference's own recording: head maps and the final box set;
             the main path's kernel launches are counted here;
  5. serve   20 timed requests of the full-width infer fn (CUDA events);
     profile torch.profiler over PROFILE_REQUESTS (3) more: device and
             host time per stage
             of the forward and post-processing, the device's busy share;
  6. ap      AP30/50/70 of the tiny flagship on the 10 recorded frames;
  7. train   the yaml's flagship trained from scratch at full width: B=4
             synthetic frames of 5 agents at bench.py's train scale, the
             yaml's loss, targets, AdamW and schedule; 3 warm-up and 10
             timed steps (CUDA events), peak memory, the loss terms of the
             first and last step; no IoU-kernel launch in a train step;
     train_eval   its validation loss and one B=4 eval batch through
             make_infer_fn (the kernel's launches counted);
     train_profile   torch.profiler over one step, per stage;
     train_parity    the tiny flagship's step on CUDA against the CPU;
     train_ap   tests/test_end2end.py's gate on the card: the tiny
             flagship trained 250 steps on two frames, then AP;
  8. stage1  CoAlign's stage-1 detector at full width (pointpillar_
             uncertainty.yaml's widths, the flagship checkpoint's shared
             weights and a seeded uncertainty head) on the recording's 5
             agents: CUDA against the CPU (head maps, per-agent box sets,
             uncertainties), one IoU-kernel launch over the 5 agent frames;
  9. posegraph   the pose graph at full size (B=4, L=5, K=24) on oracle
             detections of synthetic scenes: CUDA float32 against CPU
             float64, no host sync inside, the corrected pairwise error
             below 0.3 of the noisy one; ms at B=1 and B=4;
 10. coalign the two-pass request, B=1, 20 frames with the yaml's pose
             noise: stage-1, pose graph, flagship, post-processing; 2 IoU
             launches a request, ms beside the flagship alone, the pose
             errors before and after;
     coalign_profile   torch.profiler over 3 requests, with the
             stage/stage1 and stage/pose_graph ranges beside the flagship's;
 11. late    late fusion of the recording's 5 agents (B=1) through
             make_late_infer_fn with stage1's detector: CUDA against the
             CPU (box sets) in the modes late and no, 2 IoU launches a
             request (the agents' NMS at (5, 512), the joint NMS at
             (1, 500), held against the plain version), 20 timed requests
             and a profile each;
 12. early   early fusion of the same agents merged into one (1, 1, 30000,
             4) cloud, pointpillar_early.yaml's point_pillar with the
             flagship checkpoint's weights: CUDA against the CPU (head maps,
             box set), one IoU launch, 20 timed requests and a profile;
 13. stage1_train   pointpillar_uncertainty.yaml's detector trained from
             scratch at full width on late train batches (B=4, one agent a
             frame) with the uncertainty loss; stage1_train_profile;
             stage1_parity, the tiny stage-1 detector's step on CUDA against
             the CPU (train_parity's bounds); stage1_ap,
             tests/test_late_inference.py's gate (late AP30 > 0.05 and >= no
             fusion's - 0.05) for the tiny stage-1 detector trained on the
             card, then its detections correcting noisy poses (reported);
     noise_sweep   tools/noise_sweep on the tiny flagship of train_ap at
             pose noise 0 and 0.4, without and with that stage-1 correction
             (reported).
 14. baselines   one line for each of the seven intermediate-fusion
             baselines of BASELINES (the OPV2V yamls pointpillar_fcooper,
             _selfatt, _selfatt_singlescale, _disconet, _v2vnet, _when2comm
             and _v2xvit) at full width on the recording's 5 agents,
             through make_infer_fn: every weight the model shares by key
             with fullscale_multiscale.pth from it, the learned fusion
             seeded; CUDA against the CPU (head maps within 2e-3, the same
             box set at match_box_sets' bounds, at the yaml's score
             threshold lowered until 10 boxes remain, the threshold
             printed), 1 IoU launch a request, peak memory, 20 timed
             requests and a profile;
     baseline_recordings   DiscoNet's and V2VNet's reference checkpoints
             on CUDA against their recordings (2e-4).
 15. disk    the on-disk data path and the run CLI (disk_check, one line a
             step): an OPV2V fixture tree of 8 full-size frames written and
             read back; the host's read and assembly ms a frame; run
             config_generate, train and a resumed train on the tree; run
             inference of a reference-style run directory (frame 0 against
             make_infer_fn, 1 IoU launch a frame, frames/s from disk, the
             loop's busy share); the C++ data plane against numpy on the
             tree (exact parse, host ms a frame, the eval loop on each path,
             DeviceBatchCache's second epoch from the card); run precalc
             and the inference it corrects;
             the noise_sweep and pose_graph_eval command lines; the tiny
             reference run on CUDA against the CPU.
 16. fusions_rest   one line for each of pointpillar_where2comm, _mash and
             _v2vnet_robust (the OPV2V yamls) and the deformable fusion on
             pointpillar_selfatt.yaml's args (no yaml sets it), as the
             baselines phase: CUDA against the CPU (maps, Where2comm's
             mask with its single cls bias shifted so that half the
             neighbours' pixels are sent, MASH's corr_vol,
             robust V2VNet's pose outputs, the box set), 1 IoU launch a
             request, peak memory, 20 timed requests and a profile.
 17. train_rest   B=4 full-width train steps of robust V2VNet at stages 0,
             1 and 2 (the frozen parameters bit-identical after the
             steps), MASH, Where2comm and DiscoNet's KD step (student and
             frozen teacher): ms, peak memory, loss terms; rest_parity,
             their tiny twins' CUDA steps against the CPU (train_parity's
             bounds).
 18. second  one line for each of SECOND_YAMLS (the OPV2V yamls SECOND
             and SECOND_uncertainty, late; SECOND_early; second_intermediate
             and voxelnet_intermediate) at their full widths and grids on
             5 synthetic agents of 30,000 points, B=1: CUDA against the
             CPU with seeded weights (the cls head rescaled to spread the
             scores) and, for SECOND and SECOND_early, with
             second_ssfa.pth, which then serves (head maps within 2e-3 of
             each map's largest, the same box set); voxels and overflow an
             agent, the strided stages' sites kept and dropped at the cap,
             IoU launches a request (2 late, else 1), peak memory, 20
             timed requests, a profile with the stage/voxelize,
             backbone_3d, bev_trunk, fusion and post_process ranges, and
             the 3D backbone's device time by part (backbone3d_breakdown);
     second_recordings   second.pth and second_intermediate.pth on CUDA
             against their recordings, dense twin and sparse backbone;
     second_train   B=4 full-width steps of second_intermediate.yaml and
             SECOND.yaml (the yamls' loss, Adam and schedule, the 32,000
             train cap): ms, peak memory, voxels a frame;
     second_parity   a tiny SECOND-SSFA's step on the sparse backbone,
             CUDA against the CPU (train_parity's bounds).
 19. baselines_train   B=4 full-width train steps of the seven yamls of
             BASELINES from scratch (each yaml's loss and AdamW): ms, peak
             memory, loss terms, no IoU launch; baselines_train_parity, the
             tiny twins of DiscoNet, V2VNet, When2comm and V2X-ViT
             (BASELINE_TWINS), CUDA step against the CPU's
             (train_parity's bounds); disconet_ap, DiscoNet's twin trained
             250 steps to DISCONET_AP_GATE;
     periods fault 10 (after the kernel phase): limit_period and the
             direction bins of 1,000,000 yaws and the boundary ones, CUDA
             equal to the CPU;
 20. datasets   DAIR-V2X and V2X-Sim fixture trees written by the port at
             dairv2x/ and v2xsim/pointpillar_coalign.yaml's ranges (504 x
             200 and 160 x 160 canvases, 2 and 5 agents of ~30,000 points),
             run inference of each from disk with fullscale_multiscale.pth
             (1 IoU launch a frame, frames/s), frame 0 CUDA against the
             CPU (maps within 2e-3, the same box set), 20 timed requests;
             then the DAIR CoAlign two-pass request (dairv2x/
             pointpillar_uncertainty.yaml's stage-1, the pose graph at L=2:
             2 IoU launches, at (2, 512) and (1, 512));
 21. pixor   pixor_intermediate.yaml at its full raster (704 x 400 x 21, 5
             agents) with pixor_inter.pth's shared weights: CUDA against
             the CPU (maps within 2e-3 of each map's largest, the same box
             set), 1 IoU launch, 20 timed requests and a profile;
             pixor_recordings, pixor.pth and pixor_inter.pth against their
             recordings on the card; pixor_train, its B=4 step.
 22. lss_cells   fault 12 on the card: the splat's cells of the full-width
             LSS geometry (4.6M frustum points) and of 1M points on and
             beside cell boundaries, CUDA equal to the CPU;
 23. lss     lss_coalign_fusion.yaml at full width (5 agents, 4 cameras of
             480 x 640, 48 LID bins, a 240 x 240 BEV), seeded weights:
             CUDA against the CPU (maps within 2e-3 of each map's largest,
             the same box set at a score threshold lowered until 10 boxes
             remain), 1 IoU launch, 20 timed requests; lss_profile by stage
             (camera_trunk, lift, splat, bev_encoder, fusion, heads,
             post_process); lss_single, lss_single_efficientnet and
             _resnet101 once each through late fusion (2 IoU launches);
     lss_train   its B = 4 step (3 warm-up, 5 timed), peak memory, loss
             terms; lss_train_parity, a tiny LSS's step on CUDA against the
             CPU (train_parity's bounds);
 24. camera_disk   a camera fixture tree (4 frames, 5 agents, 4 PNGs of
             600 x 800 each) written by the port, the host's read-and-decode
             ms a frame, run inference of lss_coalign_fusion.yaml on it
             (frames/s, 1 IoU launch a frame);
 25. bf16    the flagship and the LSS request in float32 and under
             set_compute_dtype(torch.bfloat16): ms, cls_preds' mean
             relative distance (< 0.15), float32 heads; the trained tiny
             flagship's AP in both (reported).
 26. fpvrcnn, fvoxelrcnn   opv2v/fpvrcnn.yaml and fvoxelrcnn.yaml at full
             width (41 x 800 x 2816 at 0.1 m, the 70,000-voxel eval cap,
             4,096 keypoints and 32 stage-1 boxes an agent, 32 RoIs, 6 x 6
             RoI grids) on second's 5 agents of ~30,000 points, seeded
             weights (the stage-1 scores spread and their threshold set,
             fpv_stage1_threshold):
             CUDA against the CPU (stage-1 maps, RoIs, refined boxes and
             confidences within 2e-3 of each map's largest, the masks
             equal, the box set with at least 10 boxes), 2 IoU launches a
             request, peak memory, 20 timed requests and a profile (over 2
             FPV-RCNN requests, 5 FVoxelRCNN ones) with the
             stage/voxelize, backbone_3d, bev_trunk, stage1_decode,
             matcher, fps, ball_query, roi_head and post_process ranges,
             and the plain matcher's ms at (1, 160);
     fpvrcnn_train   fpvrcnn.yaml's B=4 step (1 warm-up, 3 timed), 1 IoU
             launch a step (the stage-1 NMS; the JAX package's step trains
             stage 1 alone); fpvrcnn_parity, a tiny FPV-RCNN's step on CUDA
             against the CPU (train_parity's bounds).
Then one JSON line describing each kernel (with its launches on each
path above), timed at eight shapes (the main
path's NMS input; that input stacked 8 times, a B=8 batch's one launch; 8
frames of densely packed boxes; the stage-1 NMS input over 5 agent frames;
the DAIR CoAlign request's stage-1 NMS input over 2 agent frames; the late
request's joint NMS input; FPV-RCNN's stage-1 (5 x 256) and refined
(1 x 32) NMS inputs; CUDA events around launches queued behind a sleep
kernel, queued_ms) beside its bound and the time of one
launch that writes the same output (out.zero_()), the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Any failed check
raises, so the exit code is not 0. make_infer_fn runs float32 in full
float32 (TF32 off) and lets cuDNN autotune (runtime.configure_cuda).

The goldens are read in place from tests/golden/; nothing of JAX or of the
coalign_tpu package is imported. The CPU can rehearse train_ap, stage1_ap,
the sweep and the parity phases' steps: train_to_ap("cpu"),
stage1_to_ap("cpu"), sweep_check(model, stage1, "cpu"),
_one_sgd_step("cpu", ...).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")

# The full-width flagship of tests/test_golden_fullscale.py (FULL_ARGS,
# ANCHOR_ARGS) and the tiny one of tests/test_golden_e2e.py (TINY_ARGS,
# ANCHOR_ARGS); those modules import JAX, so the dicts are repeated here.
FULL_ARGS = {
    "voxel_size": [0.4, 0.4, 4.0],
    "lidar_range": [-140.8, -40.0, -3.0, 140.8, 40.0, 1.0],
    "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [64],
                   "pad_parity": True},
    "point_pillar_scatter": {"num_features": 64},
    "base_bev_backbone": {"layer_nums": [3, 5, 8], "layer_strides": [2, 2, 2],
                          "num_filters": [64, 128, 256],
                          "upsample_strides": [1, 2, 4],
                          "num_upsample_filter": [128, 128, 128],
                          "resnet": True},
    "fusion_method": "att",
    "att": {"feat_dim": [64, 128, 256]},
    "shrink_header": {"kernal_size": [3], "stride": [1], "padding": [1],
                      "dim": [256], "input_dim": 384},
    "dir_args": {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]},
}
FULL_ANCHORS = {"W": 704, "H": 200, "l": 3.9, "w": 1.6, "h": 1.56,
                "r": [0, 90], "num": 2, "feature_stride": 2,
                "vw": 0.4, "vh": 0.4, "vd": 4.0,
                "cav_lidar_range": FULL_ARGS["lidar_range"]}
TINY_ARGS = {
    "voxel_size": [0.4, 0.4, 4.0],
    "lidar_range": [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0],
    "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [64],
                   "pad_parity": True},
    "point_pillar_scatter": {"num_features": 64},
    "base_bev_backbone": {"layer_nums": [2, 2], "layer_strides": [2, 2],
                          "num_filters": [32, 64], "upsample_strides": [1, 2],
                          "num_upsample_filter": [64, 64], "resnet": True},
    "shrink_header": {"kernal_size": [3], "stride": [1], "padding": [1],
                      "dim": [64], "input_dim": 128},
    "dir_args": {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]},
    "fusion_method": "att",
    "att": {"feat_dim": [32, 64]},
}
TINY_ANCHORS = {"W": 64, "H": 64, "l": 3.9, "w": 1.6, "h": 1.56,
                "r": [0, 90], "num": 2, "feature_stride": 2,
                "vw": 0.4, "vh": 0.4, "vd": 4.0,
                "cav_lidar_range": TINY_ARGS["lidar_range"]}

# Training at full width: the yaml's model from scratch (FULL_ARGS without
# pad_parity, which only reproduces reference checkpoints) with the loss,
# targets, optimizer and schedule of
# coalign_tpu/hypes_yaml/opv2v/pointpillar_coalign.yaml, on synthetic scenes
# at bench.py's train scale (bench.py:88-101), B = 4 (the yaml's
# batch_size).
TRAIN_FULL_ARGS = {**FULL_ARGS, "pillar_vfe": {
    k: v for k, v in FULL_ARGS["pillar_vfe"].items() if k != "pad_parity"}}
TRAIN_SCENES = dict(num_agents=5, num_objects=20, points_per_object=400,
                    ground_points=16000, agent_spread=30.0, seed=1,
                    lidar_range=FULL_ARGS["lidar_range"])
TRAIN_BATCHER = dict(max_cav=5, max_points=30000, max_objects=100,
                     comm_range=70.0, lidar_range=FULL_ARGS["lidar_range"])
TRAIN_BATCH = 4
YAML_TARGETS = {"pos_threshold": 0.6, "neg_threshold": 0.45,
                "score_threshold": 0.20}
YAML_LOSS = {"pos_cls_weight": 2.0,
             "cls": {"alpha": 0.25, "gamma": 2.0, "weight": 2.0},
             "reg": {"sigma": 3.0, "weight": 2.0},
             "dir": {"weight": 0.2, "args": FULL_ARGS["dir_args"]}}
YAML_OPTIMIZER = {"core_method": "Adam", "lr": 0.002,
                  "args": {"eps": 1e-10, "weight_decay": 1e-4}}
YAML_SCHEDULER = {"core_method": "multistep", "gamma": 0.1,
                  "step_size": [10, 15]}

# The tiny training of tests/test_end2end.py (MODEL_ARGS, ANCHOR_ARGS,
# POSTPROCESS, LOSS_ARGS, _setup's scenes and batcher), which imports JAX:
# train_ap trains it to AP as that test does, and train_parity steps it on
# both devices.
E2E_RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
E2E_ARGS = {
    "voxel_size": [0.5, 0.5, 4.0],
    "lidar_range": E2E_RANGE,
    "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [32]},
    "point_pillar_scatter": {"num_features": 32},
    "base_bev_backbone": {"layer_nums": [2, 2], "layer_strides": [2, 2],
                          "num_filters": [32, 64], "upsample_strides": [1, 2],
                          "num_upsample_filter": [32, 32]},
    "fusion_method": "att",
    "att": {"feat_dim": [32, 64]},
    "shrink_header": {"kernal_size": [3], "stride": [1], "padding": [1],
                      "dim": [64], "input_dim": 64},
    "dir_args": {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]},
}
E2E_ANCHORS = {"W": 64, "H": 64, "l": 4.2, "w": 1.8, "h": 1.6, "r": [0, 90],
               "vw": 0.5, "vh": 0.5, "feature_stride": 2,
               "cav_lidar_range": E2E_RANGE}
E2E_POSTPROCESS = {
    "anchor_args": E2E_ANCHORS,
    "target_args": {"pos_threshold": 0.6, "neg_threshold": 0.45,
                    "score_threshold": 0.25},
    "order": "hwl", "max_num": 100, "nms_thresh": 0.15,
    "gt_range": E2E_RANGE,
    "dir_args": {"dir_offset": 0.7853, "num_bins": 2, "anchor_yaw": [0, 90]},
}
E2E_LOSS = {"pos_cls_weight": 2.0,
            "cls": {"alpha": 0.25, "gamma": 2.0, "weight": 2.0},
            "reg": {"sigma": 3.0, "weight": 2.0},
            "dir": {"weight": 0.2, "args": {"dir_offset": 0.7853,
                                            "num_bins": 2,
                                            "anchor_yaw": [0, 90]}}}
E2E_SCENES = dict(num_frames=4, num_agents=2, num_objects=4,
                  lidar_range=E2E_RANGE, agent_spread=4.0,
                  points_per_object=220, ground_points=512,
                  object_spread=0.55, seed=7)
E2E_BATCHER = dict(max_cav=2, max_points=2500, max_objects=16,
                   lidar_range=E2E_RANGE, comm_range=70.0)

# CoAlign's first pass at full width: the stage-1 detector of
# coalign_tpu/hypes_yaml/opv2v/pointpillar_uncertainty.yaml (the flagship's
# pillar encoder, ResNet [3,5,8] trunk, deblocks, shrink and heads without
# fusion, plus a log-variance head) and its post-processing, K = 24 boxes an
# agent; the pose graph with pointpillar_coalign.yaml's box_align args and
# pose noise. The oracle detections' noise is
# tests/test_stage1_uncertainty.py's.
STAGE1_ARGS = {**{k: v for k, v in FULL_ARGS.items()
                  if k not in ("fusion_method", "att")},
               "uncertainty_dim": 3}
STAGE1_POSTPROCESS = {"target_args": YAML_TARGETS, "nms_thresh": 0.15,
                      "gt_range": FULL_ARGS["lidar_range"],
                      "dir_args": FULL_ARGS["dir_args"]}
STAGE1_BOXES = 24
# the tiny flagship's stage-1 twin (coalign_multiscale.pth's shared weights)
TINY_STAGE1_ARGS = {**{k: v for k, v in TINY_ARGS.items()
                       if k not in ("fusion_method", "att")},
                    "uncertainty_dim": 3}
YAML_BOX_ALIGN = {"use_uncertainty": True, "landmark_SE2": True,
                  "adaptive_landmark": False, "normalize_uncertainty": False,
                  "abandon_hard_cases": True, "drop_hard_boxes": True}
YAML_NOISE = {"pos_std": 0.2, "rot_std": 0.2}
ORACLE_NOISE = {"pos_std": 0.4, "rot_std": 2.0}
COALIGN_REQUESTS = 20

# Late and early fusion and stage-1 training at full width: the point_pillar
# of coalign_tpu/hypes_yaml/opv2v/pointpillar_{late,early}.yaml (the
# flagship's encoder, ResNet [3,5,8] trunk, deblocks, shrink and heads,
# without fusion or pad_parity) and pointpillar_uncertainty.yaml's
# point_pillar_uncertainty (the same plus a log-variance head), with the
# yamls' post-processing (100 boxes an agent before late fusion's joint
# NMS) and the uncertainty yaml's loss, whose settings under ``kl`` neither
# package reads (coalign_tpu_torch/loss/uncertainty_loss.py).
EARLY_ARGS = {k: v for k, v in TRAIN_FULL_ARGS.items()
              if k not in ("fusion_method", "att")}
STAGE1_TRAIN_ARGS = {**EARLY_ARGS, "uncertainty_dim": 3}
LATE_POSTPROCESS = {**STAGE1_POSTPROCESS, "max_num": 100}
YAML_UNC_LOSS = {"core_method": "point_pillar_uncertainty_loss",
                 "args": {**YAML_LOSS, "kl": {"weight": 0.5,
                                              "xy_loss_type": "l2",
                                              "angle_weight": 1.0}}}
LATE_REQUESTS = 20
# calls in a profile (profile_calls): the script's profiles took ~0.8 ms of
# host time for each kernel launch they recorded, and with 5 calls a
# profile the script ran 1,156 s of its 1,200 on a slow host
PROFILE_REQUESTS = 3

# The tiny late-fusion training of tests/test_late_inference.py (ARGS, its
# anchors, POST, its loss, scenes and batcher), which imports JAX, with an
# uncertainty head and the uncertainty loss: stage1_ap trains CoAlign's
# stage-1 detector as that test trains its single-agent model and holds it
# to that test's gate. Its noisy frames for the pose graph are 20 more
# scenes of the same kind. stage1_parity steps the E2E-sized stage-1
# detector on a late train batch on both devices.
LATE_RANGE = [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0]
LATE_TINY_ARGS = {
    "voxel_size": [0.4, 0.4, 4.0], "lidar_range": LATE_RANGE,
    "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [32]},
    "point_pillar_scatter": {"num_features": 32},
    "base_bev_backbone": {"layer_nums": [2, 2], "layer_strides": [2, 2],
                          "num_filters": [32, 64],
                          "upsample_strides": [1, 2],
                          "num_upsample_filter": [64, 64], "resnet": False},
    "shrink_header": {"kernal_size": [3], "stride": [1], "padding": [1],
                      "dim": [64], "input_dim": 128},
}
LATE_TINY_ANCHORS = {"W": 64, "H": 64, "l": 3.9, "w": 1.6, "h": 1.56,
                     "r": [0, 90], "vw": 0.4, "vh": 0.4, "feature_stride": 2,
                     "cav_lidar_range": LATE_RANGE}
LATE_TINY_TARGETS = {"pos_threshold": 0.3, "neg_threshold": 0.2}
LATE_TINY_POST = {"target_args": {"score_threshold": 0.1},
                  "nms_thresh": 0.15, "gt_range": LATE_RANGE}
LATE_TINY_LOSS = {"pos_cls_weight": 2.0,
                  "cls": {"alpha": 0.25, "gamma": 2.0, "weight": 2.0},
                  "reg": {"sigma": 3.0, "weight": 2.0}}
LATE_TINY_SCENES = dict(num_frames=4, num_agents=3, num_objects=4,
                        lidar_range=LATE_RANGE, points_per_object=48,
                        ground_points=96, seed=9)
LATE_TINY_BATCHER = dict(max_cav=3, max_points=1024, max_objects=8,
                         lidar_range=LATE_RANGE)
E2E_STAGE1_ARGS = {**{k: v for k, v in E2E_ARGS.items()
                      if k not in ("fusion_method", "att")},
                   "uncertainty_dim": 3}
SWEEP_LEVELS = ((0.0, 0.0), (0.4, 0.4))

# The intermediate-fusion baselines at full width: the models and the
# post-processing of seven coalign_tpu/hypes_yaml/opv2v/<name>.yaml, read
# from those files (the flagship's encoder, ResNet [3,5,8] trunk, deblocks,
# shrink and heads, plus each yaml's fusion). Every weight a model shares by
# key with fullscale_multiscale.pth comes from it; the learned fusion_net is
# seeded.
BASELINES = ("pointpillar_fcooper", "pointpillar_selfatt",
             "pointpillar_selfatt_singlescale", "pointpillar_disconet",
             "pointpillar_v2vnet", "pointpillar_when2comm",
             "pointpillar_v2xvit")
BASELINE_MIN_BOXES = 10
# tests/test_ckpt_import.py:140-308's recorded baselines that the card
# holds to their recordings (their checkpoints are 1.2 and 2.7 MB; the
# 25 MB when2comm and v2xvit ones stay on the CPU): TINY_ARGS on the plain
# backbone with each fusion's args
RECORDED_ARGS = {**{k: v for k, v in TINY_ARGS.items()
                    if k not in ("fusion_method", "att")},
                 "base_bev_backbone": {**TINY_ARGS["base_bev_backbone"],
                                       "resnet": False}}
RECORDED_BASELINES = {
    "disconet": {"fusion_method": "disconet", "disconet": {"feat_dim": 64}},
    "v2vnet": {"fusion_method": "v2vnet", "v2vnet": {
        "in_channels": 64, "num_iteration": 2, "gru_flag": True,
        "agg_operator": "avg", "conv_gru": {
            "H": 32, "W": 32, "kernel_size": [[3, 3]], "num_layers": 1}}},
}

# The on-disk path: the OPV2V yamls read in place, pointed at a fixture tree
# that the port's write_opv2v_fixture writes from synthetic scenes at the
# train phase's scale (8 frames in 2 scenarios, 5 agents of up to 24,000
# points, those in range, the last agent an RSU); the CLI's runs read it
# back from disk.
HYPES_ROOT = os.path.join(ROOT, "coalign_tpu", "hypes_yaml")
HYPES = os.path.join(HYPES_ROOT, "opv2v")
DISK_SCENES = {**TRAIN_SCENES, "num_frames": 8, "seed": 21}
DISK_FRAMES_PER_SCENARIO = 4
DISK_SWEEP_LEVELS = "0,0.4"
# the tiny reference-style run directory: the tiny flagship of the ap phase
# (coalign_multiscale.pth) on a tree at its +-12.8 m range; its config
# leaves pad_parity unset, as a reference run's does
TINY_DISK_SCENES = dict(num_frames=4, num_agents=2, num_objects=3,
                        lidar_range=LATE_RANGE, points_per_object=48,
                        ground_points=96, seed=3)

# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

T0 = time.time()


def phase(name: str, **fields):
    print(json.dumps({"phase": name, "elapsed_s": round(time.time() - T0, 3),
                      **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def hypes_at(name: str, tree: str, lidar_range=None,
             model_args: dict | None = None) -> dict:
    """The OPV2V yaml ``name`` (coalign_tpu/hypes_yaml/opv2v/, read in
    place) pointed at the fixture tree ``tree``: root_dir and validate_dir
    the tree, no test_dir; with ``lidar_range`` cut to that range (the
    preprocess range, the gt range, the anchors and the model) and its
    derived params computed anew; with ``model_args`` another model."""
    from coalign_tpu_torch.config.yaml_utils import PARSERS, load_yaml
    params = load_yaml(os.path.join(HYPES, f"{name}.yaml"))
    params.update(root_dir=tree, validate_dir=tree, test_dir=None)
    if model_args is not None:
        params["model"]["args"] = json.loads(json.dumps(model_args))
    if lidar_range is not None:
        lr = list(lidar_range)
        params["preprocess"]["cav_lidar_range"] = lr
        params["postprocess"]["gt_range"] = lr
        params["postprocess"]["anchor_args"]["cav_lidar_range"] = lr
        params["model"]["args"]["lidar_range"] = lr
        params = PARSERS[params["yaml_parser"]](params)
    return params


def write_run_dir(model_dir: str, params: dict, checkpoint: str) -> str:
    """A reference-style run directory: ``params`` as config.yaml and
    ``checkpoint`` as net_epoch1.pth. Returns the directory."""
    import shutil

    from coalign_tpu_torch.config.yaml_utils import save_yaml
    os.makedirs(model_dir, exist_ok=True)
    save_yaml(params, os.path.join(model_dir, "config.yaml"))
    shutil.copyfile(checkpoint, os.path.join(model_dir, "net_epoch1.pth"))
    return model_dir


def tiny_reference_run(workdir: str, device=None) -> tuple:
    """The tiny reference-style run directory under ``workdir``: a fixture
    tree of TINY_DISK_SCENES and a run directory of the tiny flagship
    (TINY_ARGS without pad_parity, which the CLI's loader sets for a
    reference run) with coalign_multiscale.pth. The checkpoint is not
    trained on these scenes, so each frame's gt is crafted from its
    detections (on ``device``) as generate_fixtures.py's gen_e2e_ap crafts
    the ap phase's: its first six boxes moved by graded offsets and one far
    box, so that AP is not 0 and changes across the three IoU gates.
    Returns (tree, run directory)."""
    from coalign_tpu_torch.data import IntermediateFusionBatcher, SyntheticScenes
    from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
    from coalign_tpu_torch.inference import make_infer_fn
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.utils.box_utils import project_boxes7_by_tfm
    from coalign_tpu_torch.utils.transforms import pose_to_tfm
    from coalign_tpu_torch.utils.weights import load_pth

    model = build_model({"core_method": "point_pillar_baseline_multiscale",
                         "args": TINY_ARGS}, device=device)
    load_pth(model, os.path.join(GOLDEN, "coalign_multiscale.pth"))
    post = {"target_args": YAML_TARGETS, "nms_thresh": 0.15,
            "gt_range": LATE_RANGE, "dir_args": TINY_ARGS["dir_args"]}
    infer = make_infer_fn(model, generate_anchor_box(TINY_ANCHORS), post,
                          device=device)
    batcher = IntermediateFusionBatcher(max_cav=2, lidar_range=LATE_RANGE)
    scenes = SyntheticScenes(**TINY_DISK_SCENES)
    rng = np.random.default_rng(777)
    frames = []
    for i in range(len(scenes)):
        frame = scenes[i]
        dets = {k: v.cpu().numpy() for k, v in
                infer(batcher.assemble([frame])).items()}
        boxes = dets["boxes7"][0][dets["mask"][0]][:6].astype(np.float64)
        check(len(boxes) == 6, f"tiny frame {i}: {len(boxes)} detections")
        ang = rng.uniform(0, 2 * np.pi, len(boxes))
        dist = np.array([0.0, 0.3, 0.8, 1.5, 2.5, 0.15])
        gt = np.concatenate([boxes, boxes[:1]])
        gt[:-1, 0] += dist * np.cos(ang)
        gt[:-1, 1] += dist * np.sin(ang)
        gt[-1, :2] += [9.0, 7.0]
        world = project_boxes7_by_tfm(
            gt, pose_to_tfm(frame["agents"][0]["pose"].astype(np.float64)))
        frames.append(dict(frame, objects={
            "boxes": world.astype(np.float32),
            "ids": np.arange(len(gt), dtype=np.int64)}))
    tree = write_opv2v_fixture(os.path.join(workdir, "tiny_tree"), frames,
                               frames_per_scenario=2)
    args = json.loads(json.dumps(TINY_ARGS))
    del args["pillar_vfe"]["pad_parity"]
    params = hypes_at("pointpillar_coalign", tree, LATE_RANGE, args)
    params.pop("box_align")
    params["noise_setting"] = {"add_noise": False}
    params["train_params"]["max_cav"] = 2
    run = write_run_dir(os.path.join(workdir, "tiny_run"), params,
                        os.path.join(GOLDEN, "coalign_multiscale.pth"))
    return tree, run


def boundary_yaws(n_random: int, seed: int = 10) -> np.ndarray:
    """float32 yaws at and one ulp beside k pi / 2 (the direction bins'
    and the decode's boundaries at 2 bins) and k 2 pi (limit_period's),
    k in -8..8 (one ulp beside only for k != 0), then ``n_random`` uniform ones in [-4 pi, 4 pi): the
    inputs of fault 10's checks (tests/test_torch_cuda.py,
    tests/test_torch_baselines_train.py)."""
    marks = np.concatenate([np.arange(-8, 9) * np.pi / 2,
                            np.arange(-8, 9) * 2 * np.pi]).astype(np.float32)
    inf = np.float32(np.inf)
    # 0's neighbours are denormals, which XLA's CPU flushes to zero
    near = marks[marks != 0]
    edges = np.concatenate([marks, np.nextafter(near, inf),
                            np.nextafter(near, -inf)])
    rng = np.random.default_rng(seed)
    rand = rng.uniform(-4 * np.pi, 4 * np.pi, n_random).astype(np.float32)
    return np.concatenate([edges, rand]).astype(np.float32)


def seeded_corners(n: int, seed: int, spread: float = 10.0) -> np.ndarray:
    """(n, 4, 2) BEV corners of car-sized boxes with centres in
    [-spread, spread]^2; by default packed into 20 m x 20 m, so that many
    pairs overlap."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(-spread, spread, n), rng.uniform(-spread, spread, n)
    w, l = rng.uniform(1.5, 2.0, n), rng.uniform(3.5, 4.5, n)
    yaw = rng.uniform(-np.pi, np.pi, n)
    tmpl = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]]) / 2.0
    lx, ly = tmpl[None, :, 0] * l[:, None], tmpl[None, :, 1] * w[:, None]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    return np.stack([lx * c - ly * s + cx[:, None],
                     lx * s + ly * c + cy[:, None]], -1).astype(np.float32)


KERNEL_CASES = ("512x512", "40x150", "ragged", "all_cleared", "identical",
                "identical_far", "world140", "degenerate")
# three boxes of the DAIR-V2X CoAlign request's stage-1 NMS input on which
# the kernel gave a box's IoU with itself as 0 and 1/3 (ROADMAP §3 fault 11)
FAR_LONG_BOXES = np.array([
    [[-79.39507, -26.840303], [-78.61742, -24.758463],
     [-88.08465, -21.222021], [-88.8623, -23.303862]],
    [[103.23726, 32.150143], [104.12688, 33.761353],
     [96.50322, 37.970722], [95.6136, 36.359512]],
    [[97.72641, 27.684153], [98.33675, 29.514414],
     [88.50734, 32.7922], [87.897, 30.961935]]], np.float32)


def degenerate_corners(seed: int) -> np.ndarray:
    """(64, 4, 2) degenerate boxes over x in [-140, 140], y in [20, 140]:
    16 collapsed to a point, 16 to a 4 m segment, 16 skewed (8
    parallelograms sheared 30 degrees, 8 kites) and 16 thin (0.05 m x
    4 m), each at a random yaw."""
    rng = np.random.default_rng(seed)
    shapes = np.concatenate([
        np.zeros((16, 4, 2)),
        np.tile([[-2.0, 0], [2, 0], [2, 0], [-2, 0]], (16, 1, 1)),
        np.tile([[-2.0, -0.9], [2, -0.9], [2 + 1.04, 0.9], [-2 + 1.04, 0.9]],
                (8, 1, 1)),
        np.tile([[-2.0, 0], [0, -0.5], [2, 0], [0, 0.5]], (8, 1, 1)),
        np.tile([[-2.0, -0.025], [2, -0.025], [2, 0.025], [-2, 0.025]],
                (16, 1, 1))])
    yaw = rng.uniform(-np.pi, np.pi, 64)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    x, y = shapes[..., 0], shapes[..., 1]
    centre = np.stack([rng.uniform(-140, 140, 64), rng.uniform(20, 140, 64)],
                      -1)[:, None]
    return (np.stack([x * c - y * s, x * s + y * c], -1)
            + centre).astype(np.float32)


def kernel_cases(name: str):
    """The kernel phase's inputs, (corners1, corners2) on the CPU:
    512x512, 40x150   seeded boxes packed into 20 m x 20 m;
    ragged            (3, 517) against (3, 131): neither a multiple of the
                      kernel's 32 x 32 tile;
    all_cleared       two 16 x 16 grids of cars, 50 m apart, the second
                      shifted by 25 m: every pair is cleared;
    identical         one box 256 times against itself: every IoU is 1;
    identical_far     FAR_LONG_BOXES and 253 boxes of 10 m x 2.2 m over
                      x in [-100, 100], y in [-40, 40] at random yaws,
                      each against itself (its IoU is 1) and the others;
    world140          512 cars over +-140 m against 256 jittered copies of
                      them and 256 others;
    degenerate        the 64 boxes of degenerate_corners, far from 256 cars
                      over x in [-140, 140], y in [-140, 0], against those
                      cars and themselves: the cull must clear none of
                      their pairs."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    if name in ("512x512", "40x150"):
        n, m, seed = (512, 512, 0) if name == "512x512" else (40, 150, 1)
        return t(seeded_corners(n, seed)), t(seeded_corners(m, seed + 100))
    if name == "ragged":
        return (t(seeded_corners(3 * 517, 2).reshape(3, 517, 4, 2)),
                t(seeded_corners(3 * 131, 3).reshape(3, 131, 4, 2)))
    if name == "all_cleared":
        grid = 50.0 * np.stack(np.meshgrid(np.arange(16), np.arange(16)),
                               -1).reshape(-1, 1, 2) - 375.0
        cars = seeded_corners(256, 4, spread=0.0)
        return t(cars + grid), t(cars[::-1] + grid + 25.0)
    if name == "identical":
        box = seeded_corners(1, 5, spread=30.0)
        return t(np.repeat(box, 256, 0)), t(np.repeat(box, 256, 0))
    if name == "identical_far":
        rng = np.random.default_rng(11)
        n = 253
        yaw = rng.uniform(-np.pi, np.pi, (n, 1))
        base = np.array([[-5.05, -1.1], [5.05, -1.1], [5.05, 1.1],
                         [-5.05, 1.1]])
        x = base[:, 0] * np.cos(yaw) - base[:, 1] * np.sin(yaw)
        y = base[:, 0] * np.sin(yaw) + base[:, 1] * np.cos(yaw)
        centre = rng.uniform([-100, -40], [100, 40], (n, 1, 2))
        boxes = np.concatenate([FAR_LONG_BOXES,
                                np.stack([x, y], -1) + centre])
        return t(boxes), t(boxes)
    if name == "world140":
        c1 = seeded_corners(512, 6, spread=140.0)
        jitter = np.random.default_rng(7).normal(0, 0.5, (256, 1, 2))
        return t(c1), t(np.concatenate(
            [c1[:256] + jitter, seeded_corners(256, 8, spread=140.0)]))
    if name == "degenerate":
        cars = seeded_corners(256, 9, spread=140.0)
        cy = cars[:, :, 1].mean(1, keepdims=True)
        cars[..., 1] += cy / 2 - 72.0 - cy       # centres into [-142, -2]
        odd = degenerate_corners(10)
        return t(odd), t(np.concatenate([cars, odd]))
    raise KeyError(name)


def check_degenerate(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The kernel (``got``) against its plain version (``want``) on
    kernel_cases("degenerate"), whose boxes the cull must never clear. The
    segments, skewed and thin boxes (rows 16-63) have a well-defined IoU:
    within 1e-4 of the plain version, and never exactly 0 where it is not.
    A point box's IoU with any box is a ratio of two rounding errors (every
    point lies "inside" it; the union cancels to a few ulp) in the kernel,
    in the plain version and in the JAX package alike, so which of its pairs
    come out 0 differs between them; a cull would make all of them 0, so
    the kernel must give at least half as many nonzero values as the plain
    version on rows 0-15."""
    err = (got[16:] - want[16:]).abs().max().item()
    zeroed = int(((got[16:] == 0) & (want[16:] != 0)).sum())
    point_nonzero = int((got[:16] != 0).sum())
    plain_point_nonzero = int((want[:16] != 0).sum())
    check(err <= 1e-4, f"kernel vs plain, degenerate boxes: {err:.2e}")
    check(zeroed == 0, f"kernel gives 0 on {zeroed} degenerate pairs")
    check(plain_point_nonzero > 0
          and point_nonzero >= plain_point_nonzero / 2,
          f"point boxes: {point_nonzero} nonzero IoUs in the kernel, "
          f"{plain_point_nonzero} in the plain version")
    return {"max_abs_diff": err, "point_nonzero": point_nonzero,
            "plain_point_nonzero": plain_point_nonzero}


def counted_call(fn, *args):
    """(fn(*args), the rotated-IoU kernel's launches in that call): the
    count is set to 0 just before and read just after."""
    from coalign_tpu_torch.kernels import rotated_iou as K
    torch.cuda.synchronize()
    K.rotated_iou.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    return out, K.rotated_iou.launches


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: CUDA events around ``reps`` calls
    queued behind a sleep kernel, so that the card runs them back to back
    and the host's launch overhead stays out. The sleep is made 4x longer
    until the start event is still pending once every call is queued; a
    call that waits on the card never lets that happen, and fails the
    script. Unlike device_ms this does not read the profiler's kernel
    records, which late in the script's process lost the IoU kernel's
    launches three times in a row, or put it at a fifth of its time."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000                      # ~10 ms at the H100's clock
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    check(False, "the calls could not be queued behind a sleep kernel")


def device_ms(fn, reps: int):
    """Device time per call of ``fn``, from the profiler's kernel records
    (CUPTI): the time of its kernels summed over ``reps`` calls and divided
    by ``reps``. Unlike CUDA events around a loop of calls, this leaves out
    the host's launch overhead and the gaps between kernels. None when
    three profiles in a row recorded no device activity (now and then one
    records none). Late in the script's process the records can lose
    launches, so the IoU kernel's shapes are timed with queued_ms."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            return total_us / reps / 1e3
    return None


def iou_ops(c1: torch.Tensor, c2: torch.Tensor) -> float:
    """The f32 operations that the rotated-IoU function needs on these boxes
    (a multiply-add counts 2, a divide, square root or comparison 1), each
    value computed once, whatever a kernel spends:
      per box  58: its 4 edge vectors (8), its shoelace area (16) and the
                test of that area against 0 (1); for the separation test
                its centre (8) and its reach, the largest centre-to-corner
                distance plus half the margin (25). The kernel's guard
                against degenerate boxes (the shortest edge, square corners)
                belongs to its cull's design, not to the function, and is
                not charged;
      per pair with a box of zero area 1: the OR of the two boxes' tests;
                the intersection lies inside that box, so the IoU is 0
                without more work (a kernel that computes such a pair in
                full, as this one does, spends more than the function
                needs);
      per cleared pair 8: the separation test (the centre difference 2, its
                squared length 3, the reaches' sum and its square 2, the
                comparison 1); such a pair's IoU is 0 without more work;
      per surviving pair 356: the 16 vertex differences between the two
                quads (32); the 32 vertex-against-edge cross products (96),
                which decide the 8 point-in-quad tests (2 comparisons each,
                64) and are the numerators of the crossings' t and u; the 16
                edge-edge denominators (48) with their eps test (16); t and
                u (32 divides) with their range tests (64); the IoU from the
                areas (4);
      per valid crossing 4, for its point;
      per surviving pair with c >= 3 candidates 13c + log2(c!): the
                centroid (2c), the pseudo-angle keys (7c), the shoelace sum
                (4c), and the sort's comparisons, log2(c!) being the fewest
                any comparison sort needs on average.
    The zero areas come from polygon_area in float32, the cleared pairs
    from separated_pairs, c and the valid crossings from the plain
    version's own tests in its frame, on these boxes."""
    from coalign_tpu_torch.utils.iou import (_points_in_quad,
                                             _segment_intersections,
                                             polygon_area, separated_pairs)
    n, m = c1.shape[-3], c2.shape[-3]
    origin = c1[..., :, None, 0:1, :]
    q1 = (c1[..., :, None, :, :] - origin).expand(c1.shape[:-3] + (n, m, 4, 2))
    q2 = c2[..., None, :, :, :] - origin
    xing = _segment_intersections(q1, q2)[1].sum(-1).double()
    cnt = (_points_in_quad(q1, q2).sum(-1) + _points_in_quad(q2, q1).sum(-1)
           + xing).double()
    sort = torch.lgamma(cnt + 1) / np.log(2.0)
    survivor = 356 + 4 * xing + torch.where(cnt >= 3, 13 * cnt + sort, 0.0)
    flat = ((polygon_area(c1.float()) == 0)[..., :, None]
            | (polygon_area(c2.float()) == 0)[..., None, :])
    per_pair = torch.where(flat, 1.0, torch.where(separated_pairs(c1, c2),
                                                  8.0, survivor))
    boxes = c1.shape[:-3].numel() * (n + m)
    return float(per_pair.sum()) + 58 * boxes


def time_shape(c: torch.Tensor, pairs: torch.Tensor | None = None) -> dict:
    """The kernel on ``c`` against itself: its device time (queued_ms), its
    bound, the share of pairs its cull clears, the device time of one
    launch that writes the same output (``out.zero_()``), its difference
    from the plain version (over ``pairs``, a (B, N, N) mask, when given)
    and the plain version's device time."""
    from coalign_tpu_torch.kernels import rotated_iou as K
    from coalign_tpu_torch.utils.iou import rotated_iou_plain, separated_pairs
    got = K.rotated_iou(c, c)
    want = rotated_iou_plain(c, c)
    diff = (got - want).abs()
    err = (diff if pairs is None else diff[pairs]).max().item()
    check(err <= 1e-4, f"kernel vs plain on {list(c.shape)}: {err:.2e}")
    ops = iou_ops(c, c)
    ops_ms = ops / PEAK_F32_OPS * 1e3
    bytes_ms = (c.numel() * 4 * 2 + got.numel() * 4) / PEAK_BYTES * 1e3
    kernel_ms = queued_ms(lambda: K.rotated_iou(c, c), 100)
    out = torch.empty_like(got)
    floor_ms = queued_ms(out.zero_, 100)
    bound = max(ops_ms, bytes_ms)
    check(bound <= kernel_ms, f"kernel on {list(c.shape)} faster than its "
          f"bound: {kernel_ms:.3e} < {bound:.3e} ms (write floor "
          f"{floor_ms:.3e})")
    return {"shape": list(c.shape), "pairs": got.numel(), "max_abs_err": err,
            "cleared_share": float(separated_pairs(c, c).double().mean()),
            "ops": ops, "kernel_ms": kernel_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "share": bound / kernel_ms, "write_floor_ms": floor_ms,
            "plain_ms": queued_ms(lambda: rotated_iou_plain(c, c), 1)}


def profile_calls(fn, reps: int = PROFILE_REQUESTS) -> dict:
    """Where the time of one call of ``fn`` goes: torch.profiler over
    ``reps`` calls after one untimed call. Per stage (the "stage/..."
    ranges of the model's forward, of make_infer_fn and of
    make_train_step), the device time of the kernels launched inside it and
    the host time of the range, each per call; the backward pass runs in
    autograd's own thread, outside its range, so the "backward" stage's
    device time is that of the kernels launched by autograd's engine; the
    device kernels' total per call and their share of the call's wall time;
    the kernels' launches per call; the five kernels with the most device
    time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    events = prof.key_averages()
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    stages = {e.key[len("stage/"):]: {
        "device_ms": e.device_time_total / reps / 1e3,
        "host_ms": e.cpu_time_total / reps / 1e3}
        for e in events if e.device_type == cpu and e.key.startswith("stage/")}
    if "backward" in stages:
        stages["backward"]["device_ms"] = sum(
            e.device_time_total for e in events if e.device_type == cpu
            and e.key.startswith("autograd::engine::evaluate_function"))\
            / reps / 1e3
    # a range can also appear on the device timeline under its own name
    kernels = sorted((e for e in events if e.device_type == gpu
                      and not e.key.startswith("stage/")),
                     key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    return {"calls": reps, "stages": stages,
            "call_wall_ms": wall_ms,
            "device_kernel_ms": device_ms,
            "device_kernel_launches": sum(e.count for e in kernels) / reps,
            "device_busy_share": device_ms / wall_ms,
            "top_kernels": [[e.key[:72],
                             e.self_device_time_total / reps / 1e3,
                             e.count // reps] for e in kernels[:5]]}


def golden_batch(io, keys, pairwise, n_points: int) -> dict:
    """The padded B=1 batch of a recorded frame: one agent per point-cloud
    key of ``io``, padded to ``n_points``."""
    points = np.zeros((1, len(keys), n_points, 4), np.float32)
    pmask = np.zeros((1, len(keys), n_points), bool)
    for a, key in enumerate(keys):
        pts = io[key]
        points[0, a, :len(pts)] = pts
        pmask[0, a, :len(pts)] = True
    return {"points": points, "point_mask": pmask,
            "agent_mask": np.ones((1, len(keys)), bool),
            "pairwise_t_matrix": pairwise,
            "transformation_matrix": np.eye(4, dtype=np.float32)[None]}


def fullscale_batch():
    """The recorded full-width frame of fullscale_io.npz and its io."""
    io = np.load(os.path.join(GOLDEN, "fullscale_io.npz"))
    keys = [f"points_{a}" for a in range(io["pairwise"].shape[1])]
    n_points = max(len(io[k]) for k in keys)
    return golden_batch(io, keys, io["pairwise"], n_points), io


def match_boxes(ours_c, ref_c) -> tuple:
    """Greedy 1:1 match of the reference's (M, 8, 3) corners to ours:
    (for each reference box, the index of ours and their IoU)."""
    from coalign_tpu_torch.utils.iou import rotated_iou_plain
    iou = rotated_iou_plain(torch.from_numpy(ref_c[:, :4, :2].copy()),
                            torch.from_numpy(ours_c[:, :4, :2].copy())).numpy()
    taken = np.zeros(len(ours_c), bool)
    index, best = [], []
    for i in range(len(ref_c)):
        masked = np.where(taken, -1.0, iou[i])
        j = int(np.argmax(masked))
        taken[j] = True
        index.append(j)
        best.append(float(masked[j]))
    return np.array(index, int), np.array(best)


def match_box_sets(ours_c, ours_s, ref_c, ref_s):
    """Greedy 1:1 match of the reference boxes to ours (as in
    tests/test_golden_fullscale.py): same count, IoU > 0.95, score
    difference < 1e-3; raises AssertionError otherwise. Returns (min IoU,
    max score difference)."""
    check(len(ours_c) == len(ref_c),
          f"box count {len(ours_c)} vs reference {len(ref_c)}")
    index, iou = match_boxes(ours_c, ref_c)
    worst_iou = float(iou.min()) if len(iou) else 1.0
    worst_ds = float(np.abs(ref_s - ours_s[index]).max()) if len(iou) \
        else 0.0
    check(worst_iou > 0.95, f"unmatched box: best IoU {worst_iou:.4f}")
    check(worst_ds < 1e-3, f"score drift {worst_ds:.2e}")
    return worst_iou, worst_ds


def train_full(card: str) -> tuple:
    """The train phase: the yaml's flagship from scratch at full width, B = 4
    synthetic frames of 5 agents, 3 warm-up steps (cuDNN autotunes the
    backward's convolutions) and 10 steps timed with CUDA events; then the
    Checks:
    every loss term finite, every parameter a finite gradient, every
    running statistic moved, the total loss lower at step 13 than at step
    1, no rotated-IoU launch in a train step and one at least in the eval
    batch. Returns (the phase's fields, the train step, the device batch)."""
    from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
    from coalign_tpu_torch.data.prefetch import prefetch
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
    from coalign_tpu_torch.train import build_optimizer, make_train_step

    scenes = SyntheticScenes(num_frames=TRAIN_BATCH, **TRAIN_SCENES)
    batcher = IntermediateFusionBatcher(**TRAIN_BATCHER)
    host = batcher.assemble([scenes[i] for i in range(TRAIN_BATCH)])
    (batch,) = list(prefetch(iter([host])))     # pinned, side-stream copy
    model = build_model({"core_method": "point_pillar_baseline_multiscale",
                         "args": TRAIN_FULL_ARGS}, seed=0)
    spec = make_anchor_spec(FULL_ANCHORS, YAML_TARGETS)
    loss = build_loss(YAML_LOSS)
    opt, sched = build_optimizer(model.parameters(), YAML_OPTIMIZER,
                                 YAML_SCHEDULER)
    step = make_train_step(model, loss, spec, opt, sched)
    running = {k: v.clone() for k, v in model.state_dict().items()
               if k.endswith(("running_mean", "running_var"))}

    def run():
        terms = [step(batch) for _ in range(3)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            terms.append(step(batch))
        end.record()
        return terms, start, end

    torch.cuda.reset_peak_memory_stats()
    (terms, start, end), train_launches = counted_call(run)
    ms = start.elapsed_time(end) / 10
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first = {k: float(v) for k, v in terms[0].items()}
    last = {k: float(v) for k, v in terms[-1].items()}
    check(all(np.isfinite(float(v)) for t in terms for v in t.values()),
          "a loss term is not finite")
    for name, p in model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"{name}: no finite gradient")
    state = model.state_dict()
    still = [k for k, v in running.items() if torch.equal(state[k], v)]
    check(not still, f"running statistics that did not move: {still[:3]}")
    check(last["total_loss"] < first["total_loss"],
          f"total loss {first['total_loss']:.4f} -> {last['total_loss']:.4f}")
    check(train_launches == 0,
          f"{train_launches} rotated-IoU launches in 13 train steps")
    fields = {"batch": TRAIN_BATCH, "agents": TRAIN_BATCHER["max_cav"],
              "points_per_agent": TRAIN_BATCHER["max_points"],
              "valid_points": int(host["point_mask"].sum()),
              "gt_boxes": int(host["gt_mask"].sum()),
              "canvas": [200, 704], "timed_steps": 10, "ms_per_step": ms,
              "frames_per_s": TRAIN_BATCH * 1000.0 / ms,
              "peak_mem_gib": peak, "first_step": first, "last_step": last,
              "launches_per_train_step": train_launches / len(terms),
              "card": card}
    return fields, (model, loss, spec, batcher, scenes, step, batch)


def train_eval(model, loss, spec, batcher, scenes, batch) -> dict:
    """The train_eval phase: the trained model's validation loss over the
    train phase's frames, and one B = 4 eval batch through make_infer_fn,
    whose rotated-IoU launches are counted. Its kept boxes must be finite
    (a model 13 steps from scratch may decode inf sizes in boxes that the
    score threshold drops)."""
    from coalign_tpu_torch.inference import make_infer_fn
    from coalign_tpu_torch.train import validate
    val_loss = validate(model, loss, spec, batcher, scenes, TRAIN_BATCH)
    check(np.isfinite(val_loss), "validation loss is not finite")
    infer = make_infer_fn(model, spec.anchors, {
        "target_args": YAML_TARGETS, "nms_thresh": 0.15,
        "gt_range": FULL_ARGS["lidar_range"],
        "dir_args": FULL_ARGS["dir_args"], "max_num": 100})
    dets, launches = counted_call(infer, batch)
    check(launches >= 1, "the eval batch launched no rotated_iou")
    check(tuple(dets["corners3d"].shape) == (TRAIN_BATCH, 100, 8, 3),
          f"eval boxes of shape {tuple(dets['corners3d'].shape)}")
    kept = dets["corners3d"][dets["mask"]]
    check(bool(torch.isfinite(kept).all()), "a kept eval box is not finite")
    return {"val_loss": val_loss, "boxes_kept": int(dets["mask"].sum()),
            "launches_per_eval_batch": launches}


def _tiny_parity_batch() -> dict:
    """The CPU tests' training batch (tests/test_torch_train.py): two
    2-agent frames in a max_cav 3 batch (a padded agent slot) of 2500
    points (padded point slots)."""
    from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    scenes = SyntheticScenes(**E2E_SCENES)
    return IntermediateFusionBatcher(
        max_cav=3, max_points=2500, max_objects=16,
        lidar_range=E2E_RANGE).assemble([scenes[0], scenes[1]])


E2E_FLAGSHIP = {"core_method": "point_pillar_baseline_multiscale",
                "args": E2E_ARGS}


def _tiny_stage1_batch() -> dict:
    """stage1_parity's batch: a late train batch (one agent a frame, L = 1)
    of the two frames of _tiny_parity_batch."""
    from coalign_tpu_torch.data.batch import LateFusionBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    scenes = SyntheticScenes(**E2E_SCENES)
    return LateFusionBatcher(
        max_cav=3, max_points=2500, max_objects=16,
        lidar_range=E2E_RANGE).assemble_train([scenes[0], scenes[1]])


def _one_sgd_step(device: str, dtype: torch.dtype, batch: dict,
                  model_cfg: dict = E2E_FLAGSHIP, loss_cfg: dict = E2E_LOSS,
                  teacher_cfg: dict | None = None,
                  anchor_args: dict = E2E_ANCHORS):
    """One make_train_step of a tiny model (the flagship by default; seed
    0) with SGD (lr 1e-2) on ``device`` in ``dtype``, with a frozen teacher
    of ``teacher_cfg`` (seed 1) where given, its labels on ``anchor_args``:
    (loss terms, gradients, state dict after the step), on the CPU in
    float64."""
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
    from coalign_tpu_torch.train import make_train_step
    model = build_model(model_cfg, device=device, seed=0).to(dtype)
    teacher = (None if teacher_cfg is None else
               build_model(teacher_cfg, device=device, seed=1).to(dtype))
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    terms = make_train_step(model, build_loss(loss_cfg), make_anchor_spec(
        anchor_args, E2E_POSTPROCESS["target_args"]), opt,
        device=device, teacher=teacher)(batch)
    return ({k: float(v) for k, v in terms.items()},
            {k: p.grad.detach().double().cpu()
             for k, p in model.named_parameters()},
            {k: v.double().cpu() for k, v in model.state_dict().items()
             if v.is_floating_point()})


# parameters whose gradient is 0 in exact arithmetic and ~1e-17 in float64
# on either device: the bias of a conv right before a batch norm
# (DiscoNet's pixel-weight layer, in the KD student; When2comm's
# cbr_units), and a bias that shifts every logit of a softmax alike
# (When2comm's key and attention biases, V2X-ViT's key biases). Started at
# 0, they stay ~1e-19 after an SGD step. train_parity holds their gradient
# and value by the absolute error, within ZERO_GRAD_ATOL in float64
# (zero_grad_keys).
ZERO_GRADS = tuple(f"fusion_net.pixel_weight_layer.conv1_{i}.bias"
                   for i in (1, 2, 3))
ZERO_GRAD_ATOL = 1e-12


def zero_grad_keys(grads: dict) -> list:
    """The keys of ``grads`` (a float64 step's) whose gradient is 0 in
    exact arithmetic: ZERO_GRADS, and every tensor whose largest gradient
    is rounding noise, below 1e-13 of the step's largest."""
    top = max(float(g.abs().max()) for g in grads.values())
    return [k for k, g in grads.items()
            if k in ZERO_GRADS or float(g.abs().max()) < 1e-13 * top]


def _max_rel(got: dict, want: dict, skip=()) -> list:
    """[largest |got - want| over its tensor's largest |want|, its key]
    over the keys of ``want`` not in ``skip``."""
    return max([float((got[k] - w).abs().max() / w.abs().max().clamp_min(
        1e-30)), k] for k, w in want.items() if k not in skip)


def _small_refs(want: dict) -> list:
    """The keys of ``want`` whose largest magnitude is below 1e-9."""
    return sorted(k for k, w in want.items() if float(w.abs().max()) < 1e-9)


def train_parity(batch: dict | None = None, model_cfg: dict = E2E_FLAGSHIP,
                 loss_cfg: dict = E2E_LOSS, teacher_cfg: dict | None = None,
                 anchor_args: dict = E2E_ANCHORS) -> dict:
    """The CUDA step against the CPU step on the same seeded weights and
    batch (by default the tiny flagship on _tiny_parity_batch). In
    float32, the loss terms within 1e-4 relative and the running
    statistics after the step within 1e-4 of each tensor's largest
    magnitude: summation orders and grid_sample's atomics differ. In
    float64, the loss terms, the gradients and the whole state after the
    step (parameters after one SGD step, running statistics) within 1e-6
    of each tensor's largest magnitude, but zero_grad_keys' within
    ZERO_GRAD_ATOL absolute; the keys whose gradient is below 1e-9 are
    listed (small_ref_grads). The anchor targets are float32 (computed
    in the step's dtype, then cast, as the JAX package does), and can
    differ by an ulp between the devices' log and trigonometry. The
    float32 gradients (and so the parameters after the step) are
    reported, not held: two float32 runs can put a ReLU input that lies
    within rounding of 0 on different sides, which moves that element's
    gradient by its whole value and every gradient upstream of it by up to
    ~1e-2 (tests/test_torch_train.py)."""
    batch = _tiny_parity_batch() if batch is None else batch
    out = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-6)):
        cpu_terms, cpu_grads, cpu_state = _one_sgd_step(
            "cpu", dtype, batch, model_cfg, loss_cfg, teacher_cfg,
            anchor_args)
        terms, grads, state = _one_sgd_step("cuda", dtype, batch, model_cfg,
                                            loss_cfg, teacher_cfg,
                                            anchor_args)
        name = str(dtype).split(".")[-1]
        running = [k for k in cpu_state if "running_" in k]
        zero = zero_grad_keys(cpu_grads)
        errs = {"loss_terms": max([abs(terms[k] - v) / abs(v), k]
                                  for k, v in cpu_terms.items()),
                "running_stats": _max_rel(
                    state, {k: cpu_state[k] for k in running}),
                "grads": _max_rel(grads, cpu_grads, zero),
                "state": _max_rel(state, cpu_state, zero)}
        held = (["loss_terms", "running_stats"] if dtype == torch.float32
                else list(errs))
        for key in held:
            check(errs[key][0] <= tol, f"{name} {key}: {errs[key]}")
        abs_err = {k: max(float((grads[k] - cpu_grads[k]).abs().max()),
                          float((state[k] - cpu_state[k]).abs().max()))
                   for k in zero}
        if dtype == torch.float64:
            for key, err in abs_err.items():
                check(err <= ZERO_GRAD_ATOL, f"{name} {key}: {err:.2e}")
        out[name] = {"bound": tol, "held": held, "rel_err": errs,
                     "zero_grads_abs_err": abs_err,
                     "zero_grads_bound": ZERO_GRAD_ATOL,
                     "small_ref_grads": _small_refs(cpu_grads),
                     "terms": terms}
    return out


def train_to_ap(device=None, model_cfg: dict | None = None) -> dict:
    """tests/test_end2end.py's gate on the port: the tiny flagship (or
    ``model_cfg``; seed 42) trained 250 Adam steps (lr 3e-3, eps 1e-10) on
    its two fixed frames, then evaluated at B = 2 through make_infer_fn.
    Returns the losses, the trained model and the AP; the caller checks
    them."""
    from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.inference import evaluate, gt_corners, make_infer_fn
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
    from coalign_tpu_torch.train import build_optimizer, make_train_step
    scenes = SyntheticScenes(**E2E_SCENES)
    batch = IntermediateFusionBatcher(**E2E_BATCHER).assemble(
        [scenes[0], scenes[1]])
    model = build_model(model_cfg or E2E_FLAGSHIP, device=device, seed=42)
    spec = make_anchor_spec(E2E_ANCHORS, E2E_POSTPROCESS["target_args"])
    opt, sched = build_optimizer(model.parameters(),
                                 {"lr": 3e-3, "args": {"eps": 1e-10}})
    step = make_train_step(model, build_loss(E2E_LOSS), spec, opt, sched,
                           device=device)
    losses = torch.stack([step(batch)["total_loss"]
                          for _ in range(250)]).tolist()
    infer = make_infer_fn(model, spec.anchors, E2E_POSTPROCESS,
                          device=device)
    result = evaluate(infer, [dict(batch, gt_corners=gt_corners(batch))])
    return {"losses": losses, "model": model, **result}


def oracle_stage1(frames, batch, k: int = STAGE1_BOXES) -> dict:
    """tests/test_stage1_uncertainty.py's oracle stage-1 detections for a
    batch assembled from ``frames``: each frame's first ``k`` gt boxes in
    each agent's clean frame (the batch's lidar_pose_clean), x, y and yaw
    in radians, all with log-variance -3."""
    from coalign_tpu_torch.utils.transforms import inverse_tfm, pose_to_tfm
    b, l = batch["agent_mask"].shape
    poses = np.zeros((b, l, k, 3), np.float32)
    mask = np.zeros((b, l, k), bool)
    for bi, frame in enumerate(frames):
        gt = frame["objects"]["boxes"][:k]
        xyz1 = np.concatenate([gt[:, :3], np.ones((len(gt), 1))], -1)
        for a in np.flatnonzero(batch["agent_mask"][bi]):
            pose = batch["lidar_pose_clean"][bi, a]
            local = xyz1 @ inverse_tfm(pose_to_tfm(pose)).T
            poses[bi, a, :len(gt)] = np.stack(
                [local[:, 0], local[:, 1], gt[:, 6] - np.deg2rad(pose[4])],
                -1)
            mask[bi, a, :len(gt)] = True
    return {"box_poses": poses, "box_mask": mask,
            "uncertainty": np.full((b, l, k, 3), -3.0, np.float32)}


def pairwise_error(pairwise, batch) -> float:
    """Largest translation error of a batch's pairwise transforms against
    those of its clean poses (tests/test_stage1_uncertainty.py's measure)."""
    from coalign_tpu_torch.utils.transforms import get_pairwise_transformation
    clean = get_pairwise_transformation(batch["lidar_pose_clean"],
                                        batch["agent_mask"])
    got = pairwise.cpu().numpy() if isinstance(pairwise, torch.Tensor) \
        else pairwise
    return float(np.abs(got[..., :2, 3] - clean[..., :2, 3]).max())


def pose_diff(got, want) -> tuple:
    """Largest |x, y| difference (m) and yaw difference (degrees, wrapped)
    of two (..., 3) x, y, yaw-degrees tensors."""
    d = (got.double().cpu() - want.double().cpu()).abs()
    dyaw = (d[..., 2] + 180.0) % 360.0 - 180.0
    return float(d[..., :2].max()), float(dyaw.abs().max())


def _capture_iou_inputs():
    """Replace utils/nms.py's rotated_iou with a wrapper that keeps a copy
    of each first argument; returns (the list, a function that restores
    the kernel)."""
    from coalign_tpu_torch.utils import nms as nms_module
    captured, kernel_fn = [], nms_module.rotated_iou

    def capture(c1, c2):
        captured.append(c1.clone())
        return kernel_fn(c1, c2)

    nms_module.rotated_iou = capture

    def restore():
        nms_module.rotated_iou = kernel_fn
    return captured, restore


def stage1_model(device, args=STAGE1_ARGS,
                 checkpoint: str = "fullscale_multiscale.pth"):
    """The stage-1 detector (``args``: STAGE1_ARGS at full width, seed 0)
    with every weight but its uncertainty head from the flagship
    checkpoint ``checkpoint`` of tests/golden/ (TINY_STAGE1_ARGS go with
    coalign_multiscale.pth)."""
    from coalign_tpu_torch.models.zoo import build_model
    model = build_model({"core_method": "point_pillar_uncertainty",
                         "args": args}, device=device, seed=0)
    sd = torch.load(os.path.join(GOLDEN, checkpoint),
                    map_location="cpu", weights_only=True)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    check(sorted(missing) == ["unc_head.bias", "unc_head.weight"]
          and not unexpected, f"checkpoint keys: missing {missing}, "
          f"unexpected {unexpected}")
    return model


def stage1_check(card) -> tuple:
    """The stage1 phase: the full-width stage-1 fn on the recording's 5
    agents, on CUDA against the same on the CPU: head maps within 2e-3
    (the full phase's bound), each agent's kept boxes matched with
    match_box_sets' bounds (IoU > 0.95, score within 1e-3) and their
    log-variances within 1e-3; one IoU-kernel launch, at (5, 512). Returns
    (the phase's fields, the CUDA stage-1 fn, the kernel's input)."""
    from coalign_tpu_torch.inference import to_device
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.tools.stage1 import make_stage1_fn
    from coalign_tpu_torch.utils.box_utils import boxes_to_corners_3d
    batch, _ = fullscale_batch()
    anchors = generate_anchor_box(FULL_ANCHORS)
    models = {dev: stage1_model(dev) for dev in ("cuda", "cpu")}
    fns = {dev: make_stage1_fn(m, anchors, STAGE1_POSTPROCESS, STAGE1_BOXES,
                               device=dev) for dev, m in models.items()}
    with torch.no_grad():
        maps = {dev: m(to_device(batch, dev)) for dev, m in models.items()}
    map_err = {k: (v.cpu() - maps["cpu"][k]).abs().max().item()
               for k, v in maps["cuda"].items()}
    for key, err in map_err.items():
        check(err < 2e-3, f"stage-1 {key}: CUDA vs CPU {err:.2e}")

    captured, restore = _capture_iou_inputs()
    try:
        fns["cuda"](batch)
    finally:
        restore()
    dets, launches = counted_call(fns["cuda"], batch)
    check(launches == 1, f"{launches} IoU launches in one stage-1 call")
    check(tuple(captured[0].shape) == (5, 512, 4, 2),
          f"stage-1 NMS input {tuple(captured[0].shape)}")
    ref = fns["cpu"](batch)
    dets = {k: v.cpu().numpy() for k, v in dets.items()}
    ref = {k: v.numpy() for k, v in ref.items()}
    worst_iou, worst_ds, worst_unc, kept = 1.0, 0.0, 0.0, []
    for a in range(batch["agent_mask"].shape[1]):
        ours, want = dets["box_mask"][0, a], ref["box_mask"][0, a]
        ours_c = boxes_to_corners_3d(dets["boxes7"][0, a][ours], "hwl")
        ref_c = boxes_to_corners_3d(ref["boxes7"][0, a][want], "hwl")
        iou, ds = match_box_sets(ours_c, dets["scores"][0, a][ours], ref_c,
                                 ref["scores"][0, a][want])
        index, _ = match_boxes(ours_c, ref_c)
        unc = np.abs(dets["uncertainty"][0, a][ours][index]
                     - ref["uncertainty"][0, a][want])
        worst_iou, worst_ds = min(worst_iou, iou), max(worst_ds, ds)
        worst_unc = max([worst_unc] + unc.ravel().tolist())
        kept.append(int(ours.sum()))
    check(worst_unc <= 1e-3, f"stage-1 uncertainty: CUDA vs CPU {worst_unc}")
    ms = event_ms(lambda: fns["cuda"](batch), reps=10)
    return ({"agents": len(kept), "boxes_per_agent": kept,
             "map_max_abs_err": map_err, "min_matched_iou": worst_iou,
             "max_score_diff": worst_ds, "max_uncertainty_diff": worst_unc,
             "rotated_iou_launches": launches,
             "nms_shape": list(captured[0].shape[:2]), "ms_per_call": ms,
             "card": card}, fns["cuda"], captured[0])


def posegraph_check(card) -> dict:
    """The posegraph phase: the pose graph at full size, B = 4 frames of
    L = 5 agents and K = 24 oracle boxes (20 objects) of synthetic scenes
    at the train phase's scale, with tests/test_stage1_uncertainty.py's
    noise (0.4 m, 2 degrees) and abandon_hard_cases off. CUDA float32
    against CPU float64: refined poses within 2e-3 m and 2e-3 degrees, the
    same abandoned samples; no host sync inside (sync debug mode "error");
    the corrected pairwise error on CUDA below 0.3 of the noisy one. Then
    the time of align_poses_batch at B = 1 and 4, at that noise and at the
    yaml's (0.2 m, 0.2 degrees, the yaml's box_align args), and its device
    time against its wall time."""
    from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.posegraph import BoxAlignConfig, align_poses_batch
    from coalign_tpu_torch.posegraph.box_align import align_xyyaw
    from coalign_tpu_torch.tools.stage1 import correct_batch_poses
    scenes = SyntheticScenes(num_frames=TRAIN_BATCH, **TRAIN_SCENES)
    frames = [scenes[i] for i in range(TRAIN_BATCH)]
    keys = ("box_poses", "box_mask", "uncertainty")

    def inputs(batch, dets, device, dtype=torch.float32):
        out = [torch.as_tensor(x, device=device) for x in (
            *(dets[k] for k in keys), batch["lidar_pose"],
            batch["agent_mask"])]
        return [x.to(dtype) if x.is_floating_point() else x for x in out]

    out = {"batch": TRAIN_BATCH, "agents": TRAIN_BATCHER["max_cav"],
           "boxes_per_agent": STAGE1_BOXES, "card": card}
    oracle = BoxAlignConfig(abandon_hard_cases=False)
    yaml_cfg = BoxAlignConfig.from_yaml(YAML_BOX_ALIGN)
    for name, noise, cfg in (("oracle_noise", ORACLE_NOISE, oracle),
                             ("yaml_noise", YAML_NOISE, yaml_cfg)):
        batch = IntermediateFusionBatcher(**TRAIN_BATCHER, **noise).assemble(
            frames)
        dets = oracle_stage1(frames, batch)
        gpu = inputs(batch, dets, "cuda")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = align_xyyaw(*gpu, cfg=cfg)
            align_poses_batch(*gpu, cfg=cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = align_xyyaw(*inputs(batch, dets, "cpu", torch.float64),
                           cfg=cfg)
        dxy, dyaw = pose_diff(got["refined"], want["refined"])
        check(dxy <= 2e-3 and dyaw <= 2e-3, f"{name}: CUDA float32 vs CPU "
              f"float64 pose {dxy:.2e} m, {dyaw:.2e} deg")
        check(torch.equal(got["abandoned"].cpu(), want["abandoned"]),
              f"{name}: abandoned samples differ")
        corrected = correct_batch_poses(batch, dets, cfg)
        noisy_err = pairwise_error(batch["pairwise_t_matrix"], batch)
        corr_err = pairwise_error(corrected["pairwise_t_matrix"], batch)
        if name == "oracle_noise":
            check(noisy_err > 0.3 and corr_err < 0.3 * noisy_err,
                  f"pairwise error {noisy_err:.4f} -> {corr_err:.4f}")
        out[name] = {
            **noise, "box_align": cfg._asdict(),
            "max_pose_diff_m": dxy, "max_yaw_diff_deg": dyaw,
            "abandoned": got["abandoned"].tolist(),
            "noisy_pairwise_err_m": noisy_err,
            "corrected_pairwise_err_m": corr_err,
            "ms_b4": event_ms(lambda: align_poses_batch(*gpu, cfg=cfg), 20),
            "ms_b1": event_ms(lambda: align_poses_batch(
                *(x[:1] for x in gpu), cfg=cfg), 20)}
    prof = profile_calls(lambda: align_poses_batch(*gpu, cfg=yaml_cfg))
    out["profile_b4"] = {k: prof[k] for k in (
        "call_wall_ms", "device_kernel_ms", "device_busy_share",
        "device_kernel_launches", "top_kernels")}
    return out


def coalign_check(card, stage1, infer) -> tuple:
    """The coalign phase: the two-pass request at full width, B = 1, on
    20 synthetic frames at the train phase's scale with the yaml's pose
    noise: stage-1 (``stage1``), correct_batch_poses with the yaml's
    box_align args, the flagship's ``infer``. Checks: 2 IoU launches a
    request, finite kept boxes of the flagship's shape, the corrected poses
    on CUDA within 2e-3 m and 2e-3 degrees of the CPU's from the same
    stage-1 detections. Reports ms a request with correction and for the
    flagship alone on the same frames and the relative pose errors before
    and after (not gated: the weights never saw these scenes). Returns (the
    phase's fields, the request fn, a frame to profile it on)."""
    import itertools

    from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.posegraph import BoxAlignConfig
    from coalign_tpu_torch.tools.pose_graph_eval import (relative_pose_errors,
                                                         summarize)
    from coalign_tpu_torch.tools.stage1 import correct_batch_poses
    scenes = SyntheticScenes(num_frames=COALIGN_REQUESTS, **TRAIN_SCENES)
    batcher = IntermediateFusionBatcher(**TRAIN_BATCHER, **YAML_NOISE)
    frames = [batcher.assemble([scenes[i]]) for i in range(COALIGN_REQUESTS)]
    cfg = BoxAlignConfig.from_yaml(YAML_BOX_ALIGN)

    def request(batch):
        return infer(correct_batch_poses(batch, stage1(batch), cfg))

    request(frames[0])
    torch.cuda.synchronize()
    dets, launches = counted_call(request, frames[1])
    check(launches == 2, f"{launches} IoU launches in one CoAlign request")
    check(tuple(dets["corners3d"].shape) == (1, 100, 8, 3),
          f"boxes of shape {tuple(dets['corners3d'].shape)}")
    check(bool(torch.isfinite(dets["corners3d"][dets["mask"]]).all()),
          "a kept box is not finite")

    first = stage1(frames[1])
    gpu = correct_batch_poses(frames[1], first, cfg)
    cpu = correct_batch_poses(frames[1], {k: v.cpu() for k, v in
                                          first.items()}, cfg, device="cpu")
    dxy, dyaw = pose_diff(gpu["lidar_pose"][..., [0, 1, 4]],
                          cpu["lidar_pose"][..., [0, 1, 4]])
    check(dxy <= 2e-3 and dyaw <= 2e-3,
          f"corrected pose CUDA vs CPU {dxy:.2e} m, {dyaw:.2e} deg")

    errs = {"before": ([], []), "after": ([], [])}
    abandoned = 0
    for frame in frames:
        corrected = correct_batch_poses(frame, stage1(frame), cfg)
        after = corrected["lidar_pose"].cpu().numpy()
        abandoned += int(np.array_equal(after, frame["lidar_pose"]))
        for key, poses in (("before", frame["lidar_pose"]), ("after", after)):
            t, r = relative_pose_errors(poses, frame["lidar_pose_clean"],
                                        frame["agent_mask"])
            errs[key][0].append(t)
            errs[key][1].append(r)

    it = itertools.cycle(frames)
    ms = event_ms(lambda: request(next(it)), reps=COALIGN_REQUESTS)
    it = itertools.cycle(frames)
    flagship_ms = event_ms(lambda: infer(next(it)), reps=COALIGN_REQUESTS)
    return {"requests": COALIGN_REQUESTS, "batch": 1,
            "agents": TRAIN_BATCHER["max_cav"], **YAML_NOISE,
            "rotated_iou_launches_per_request": launches,
            "corrected_pose_cuda_vs_cpu": [dxy, dyaw],
            "ms_per_frame": ms, "frames_per_s": 1000.0 / ms,
            "flagship_ms_per_frame": flagship_ms,
            "flagship_frames_per_s": 1000.0 / flagship_ms,
            "frames_left_uncorrected": abandoned,
            "pose_error": {key: summarize(np.concatenate(t),
                                          np.concatenate(r))
                           for key, (t, r) in errs.items()},
            "card": card}, request, frames[0]


def same_box_sets(got: dict, want: dict) -> tuple:
    """match_box_sets on each frame's kept boxes of two detection dicts
    (corners3d, scores, mask; tensors on any device). Returns (boxes per
    frame, min matched IoU, max score difference)."""
    got = {k: got[k].cpu().numpy() for k in ("corners3d", "scores", "mask")}
    want = {k: want[k].cpu().numpy() for k in ("corners3d", "scores",
                                               "mask")}
    counts, worst_iou, worst_ds = [], 1.0, 0.0
    for b in range(len(got["mask"])):
        ours, ref = got["mask"][b], want["mask"][b]
        iou, ds = match_box_sets(got["corners3d"][b][ours],
                                 got["scores"][b][ours],
                                 want["corners3d"][b][ref],
                                 want["scores"][b][ref])
        counts.append(int(ours.sum()))
        worst_iou, worst_ds = min(worst_iou, iou), max(worst_ds, ds)
    return counts, worst_iou, worst_ds


def timed_requests(fn, batch, profile_reps: int = PROFILE_REQUESTS) -> dict:
    """LATE_REQUESTS requests of ``fn`` on ``batch`` with CUDA events, and
    profile_calls' device ms, host ms, busy share and launches a request
    over ``profile_reps`` requests."""
    ms = event_ms(lambda: fn(batch), reps=LATE_REQUESTS)
    prof = profile_calls(lambda: fn(batch), profile_reps)
    return {"requests": LATE_REQUESTS, "ms_per_frame": ms,
            "profiled_requests": profile_reps,
            "frames_per_s": 1000.0 / ms,
            "profile": {k: prof[k] for k in (
                "stages", "call_wall_ms", "device_kernel_ms",
                "device_busy_share", "device_kernel_launches",
                "top_kernels")}}


def late_check(card) -> tuple:
    """The late phase: late fusion of the recording's 5 agents (B = 1),
    with late_transforms' per-agent transforms from the recorded pairwise
    ones, through make_late_infer_fn and stage1_model's detector (the
    flagship checkpoint's weights; the seeded log-variance head is not
    read). Checks, for the modes late and no: CUDA against the CPU, the
    same box set at match_box_sets' bounds; 2 IoU launches a late request
    (the agents' NMS at (5, 512), the joint NMS at (1, 500)). The joint
    NMS's launch is held against rotated_iou_plain on its own input over
    the pairs the NMS reads, those of two candidate boxes (a slot that
    post_process dropped holds a zero box, a point, whose IoUs are
    rounding noise in both versions; ROADMAP fault 4); its other pairs are
    counted. Then 20 timed requests and a profile. Returns (the phase's
    fields, the joint NMS's input, its candidate mask)."""
    from coalign_tpu_torch.data.batch import late_transforms
    from coalign_tpu_torch.inference import make_late_infer_fn
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.utils.iou import rotated_iou_plain
    from coalign_tpu_torch.kernels import rotated_iou as K
    batch, _ = fullscale_batch()
    batch = late_transforms(batch)
    anchors = generate_anchor_box(FULL_ANCHORS)
    models = {dev: stage1_model(dev) for dev in ("cuda", "cpu")}
    out = {"agents": int(batch["agent_mask"].sum()), "card": card}
    for mode in ("late", "no"):
        infer, ref = (make_late_infer_fn(models[dev], anchors,
                                         LATE_POSTPROCESS, mode, device=dev)
                      for dev in ("cuda", "cpu"))
        infer(batch)                                  # cuDNN autotunes
        captured, restore = _capture_iou_inputs()
        try:
            dets, launches = counted_call(infer, batch)
        finally:
            restore()
        check(launches == 2, f"{launches} IoU launches in a {mode} request")
        check([tuple(c.shape[:2]) for c in captured] == [(5, 512), (1, 500)],
              f"{mode} NMS inputs {[tuple(c.shape) for c in captured]}")
        counts, worst_iou, worst_ds = same_box_sets(dets, ref(batch))
        check(counts[0] > 0, f"no box in the {mode} request")
        out[mode] = {"boxes": counts[0], "min_matched_iou": worst_iou,
                     "max_score_diff": worst_ds,
                     "rotated_iou_launches": launches,
                     "nms_shapes": [list(c.shape[:2]) for c in captured],
                     **timed_requests(infer, batch)}
        if mode == "late":
            joint = captured[1]
            valid = joint.abs().amax(dim=(-2, -1)) > 0
            out["late"]["candidates"] = int(valid.sum())
    pairs = valid[:, :, None] & valid[:, None, :]
    got = K.rotated_iou(joint, joint)
    want = rotated_iou_plain(joint, joint)
    err = (got - want)[pairs].abs().max().item()
    check(err <= 1e-4, f"joint NMS IoU, kernel vs plain: {err:.2e}")
    out["joint_nms_iou"] = {
        "shape": list(joint.shape), "max_abs_err": err,
        "candidate_pairs": int(pairs.sum()),
        "other_pairs_differing": int(((got - want).abs() > 1e-4).sum())}
    return out, joint, valid


def early_check(card) -> dict:
    """The early phase: early fusion of the recording's 5 agents, merged
    by data/batch.merge_agents into one (1, 1, 30000, 4) cloud in the ego
    frame, detected by pointpillar_early.yaml's point_pillar through
    make_infer_fn. Its weights are the flagship checkpoint's, which it
    shares key for key (the att fusion has none): seeded weights gave no
    box on the card, and parity on an empty box set proves nothing.
    Checks: head maps on CUDA within 2e-3 of the CPU's (the full phase's
    bound), the same box set at match_box_sets' bounds, one IoU launch a
    request. Then 20 timed requests and a profile."""
    from coalign_tpu_torch.data.batch import merge_agents
    from coalign_tpu_torch.inference import make_infer_fn, to_device
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.utils.weights import load_pth
    batch, _ = fullscale_batch()
    batch = merge_agents(batch, FULL_ARGS["lidar_range"])
    check(batch["points"].shape[:3] == (1, 1, 30000),
          f"merged cloud {batch['points'].shape}")
    anchors = generate_anchor_box(FULL_ANCHORS)
    models = {dev: load_pth(build_model({"core_method": "point_pillar",
                                         "args": EARLY_ARGS}, device=dev),
                            os.path.join(GOLDEN, "fullscale_multiscale.pth"))
              for dev in ("cuda", "cpu")}
    infer, ref = (make_infer_fn(models[dev], anchors, LATE_POSTPROCESS,
                                device=dev) for dev in ("cuda", "cpu"))
    infer(batch)
    dets, launches = counted_call(infer, batch)
    check(launches == 1, f"{launches} IoU launches in an early request")
    with torch.no_grad():
        maps = {dev: m(to_device(batch, dev)) for dev, m in models.items()}
    map_err = {k: (v.cpu() - maps["cpu"][k]).abs().max().item()
               for k, v in maps["cuda"].items()}
    for key, err in map_err.items():
        check(err < 2e-3, f"early {key}: CUDA vs CPU {err:.2e}")
    counts, worst_iou, worst_ds = same_box_sets(dets, ref(batch))
    check(counts[0] > 0, "no box in the early request")
    return {"points": int(batch["point_mask"].sum()),
            "shipped_points": float(batch["shipped_points"][0]),
            "map_max_abs_err": map_err, "boxes": counts[0],
            "min_matched_iou": worst_iou, "max_score_diff": worst_ds,
            "rotated_iou_launches": launches,
            **timed_requests(infer, batch), "card": card}


def baseline_yaml(name: str) -> tuple:
    """The model config and the post-processing args of the OPV2V yaml
    ``name`` (one of BASELINES)."""
    from coalign_tpu_torch.config.yaml_utils import load_yaml
    y = load_yaml(os.path.join(ROOT, "coalign_tpu", "hypes_yaml", "opv2v",
                               f"{name}.yaml"))
    post = {k: y["postprocess"][k] for k in ("target_args", "nms_thresh",
                                             "gt_range", "dir_args",
                                             "max_num")}
    return y["model"], post


def baseline_model(model_cfg: dict, device, state_dict: dict):
    """The model of ``model_cfg`` at full width on ``device`` (seed 0),
    every weight it shares by key with fullscale_multiscale.pth
    (``state_dict``) from that checkpoint: all of them for the max and att
    fusions, all but the learned fusion_net's for the others; Where2comm's
    single_heads are the checkpoint's heads. Returns (the model, the number
    of seeded fusion_net tensors)."""
    from coalign_tpu_torch.models.zoo import build_model
    model = build_model(model_cfg, device=device, seed=0)
    if hasattr(model, "single_heads"):
        state_dict = {**state_dict, **{
            "single_heads." + k: v for k, v in state_dict.items()
            if k.startswith(("cls_head.", "reg_head.", "dir_head."))}}
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    check(not unexpected and all(k.startswith("fusion_net.")
                                 for k in missing),
          f"{model_cfg['core_method']} checkpoint keys: missing "
          f"{missing[:4]}, unexpected {unexpected[:4]}")
    return model, len(missing)


def where2comm_bias_shift(model, batch: dict) -> float:
    """The shift of Where2comm's single cls bias at which half of the
    valid neighbours' pixels of ``batch`` are sent, by bisection on the
    card's single cls logits of the frame (a shift of the bias moves every
    logit by as much). With the checkpoint's heads every pixel passes the
    0.01 threshold at full width, and the mask would be all ones."""
    from coalign_tpu_torch.inference import to_device
    with torch.no_grad():
        logits = model(to_device(batch, next(model.parameters()).device))[
            "cls_preds_single"]
        agents = torch.as_tensor(batch["agent_mask"], device=logits.device)
        logits = logits.reshape(agents.shape + logits.shape[1:])
        comm = model.fusion_net.comm

        def share(shift: float) -> float:
            conf = comm.confidence(logits + shift)[:, 1:][agents[:, 1:]]
            return float((conf > comm.threshold).float().mean())
        lo, hi = -30.0, 30.0
        for _ in range(40):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if share(mid) < 0.5 else (lo, mid)
    return (lo + hi) / 2


def where2comm_mask_check(name: str, cpu_model, batch: dict, masks: dict,
                          cpu_single, single_err: float) -> dict:
    """Where2comm's transmission mask, the card's against the CPU's own
    (``masks``: each device's (mask, comm_rate) from its forward). A pixel
    may be sent by one and not the other only where the CPU's smoothed
    confidence lies within what the single maps' measured error allows of
    the threshold: the kernel's sum times sigmoid's largest slope (1/4)
    times that error. comm_rate within 1e-6 plus the share of such pixels;
    the sent share of the neighbours' pixels well between 0 and 1."""
    comm = cpu_model.fusion_net.comm
    agents = torch.as_tensor(batch["agent_mask"])
    with torch.no_grad():
        conf = comm.confidence(cpu_single.reshape(
            agents.shape + cpu_single.shape[1:]))
    (cuda_mask, cuda_rate), (cpu_mask, cpu_rate) = (
        [x.cpu() for x in masks[dev]] for dev in ("cuda", "cpu"))
    valid = agents[:, :, None, None, None].expand_as(cpu_mask)
    differ = (cuda_mask != cpu_mask) & valid
    flips = int(differ.sum())
    margin = float(comm.kernel.sum()) * 0.25 * single_err
    near = float((conf[differ] - comm.threshold).abs().max()) if flips else 0.0
    check(near <= margin, f"{name}: {flips} pixels sent by one device only, "
          f"{near:.2e} from the threshold (allowed {margin:.2e})")
    pixels = int(np.prod(conf.shape[-2:]))
    rate_err = abs(float(cuda_rate) - float(cpu_rate))
    check(rate_err <= 1e-6 + flips / (int(agents.sum()) * pixels),
          f"{name} comm_rate: CUDA vs CPU {rate_err:.2e}, {flips} flips")
    neighbours = valid[:, 1:]
    sent = {dev: int(m[:, 1:][neighbours].sum())
            for dev, m in (("cuda", cuda_mask), ("cpu", cpu_mask))}
    share = sent["cuda"] / (int(agents[:, 1:].sum()) * pixels)
    check(0.05 < share < 0.95, f"{name}: sent share {share:.4f}")
    return {"comm_rate": float(cuda_rate), "comm_rate_err": rate_err,
            "sent_pixels": sent["cuda"], "sent_pixels_cpu": sent["cpu"],
            "neighbor_pixels": int(agents[:, 1:].sum()) * pixels,
            "sent_share": share, "pixels_sent_by_one_device": flips,
            "their_max_dist_to_threshold": near,
            "allowed_dist_to_threshold": margin}


def baseline_parity(name: str, state_dict: dict,
                    config: tuple | None = None) -> tuple:
    """The yaml ``name``'s model (or ``config``'s, a (model config,
    post-processing args) pair) on the recording's 5 agents, CUDA against
    the CPU (a full-width forward takes 2-17 s there on an H100 host's 8
    cores): head maps within 2e-3 (the full phase's bound); Where2comm's
    single cls bias shifted so that about half the neighbours' pixels are
    sent (where2comm_bias_shift), the CPU fusing with the card's mask, and
    the mask held by where2comm_mask_check; the same box set at
    match_box_sets' bounds (IoU > 0.95, scores within 1e-3) through
    make_infer_fn at the yaml's score threshold, lowered until
    BASELINE_MIN_BOXES boxes remain on the CPU (parity on an empty set
    proves nothing). Returns (the fields, the CUDA infer fn at that
    threshold, the batch)."""
    from coalign_tpu_torch.inference import (infer_setup, make_infer_fn,
                                             to_device)
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.postprocess.decode import post_process
    from coalign_tpu_torch.runtime import configure_cuda
    configure_cuda()
    model_cfg, post = config or baseline_yaml(name)
    batch, _ = fullscale_batch()
    anchors = generate_anchor_box(FULL_ANCHORS)
    built = {dev: baseline_model(model_cfg, dev, state_dict)
             for dev in ("cuda", "cpu")}
    models = {dev: model for dev, (model, _) in built.items()}
    extra, masks, hooks = {}, {}, []
    if hasattr(models["cuda"], "single_heads"):
        shift = where2comm_bias_shift(models["cuda"], batch)
        for model in models.values():
            with torch.no_grad():
                model.single_heads.cls_head.bias.add_(shift)
        extra["single_cls_bias_shift"] = shift

        def keep(dev):
            def hook(module, inputs, output):
                masks[dev] = output
                if dev == "cpu":      # the CPU fuses with the card's mask
                    return tuple(x.cpu() for x in masks["cuda"])
            return hook
        hooks = [models[dev].fusion_net.comm.register_forward_hook(
            keep(dev)) for dev in ("cuda", "cpu")]
    with torch.no_grad():
        cuda_maps = models["cuda"](to_device(batch, "cuda"))
        t = time.perf_counter()
        cpu_maps = models["cpu"](to_device(batch, "cpu"))
        cpu_s = time.perf_counter() - t
    for hook in hooks:
        hook.remove()
    map_err = {k: (cuda_maps[k].cpu() - v).abs().max().item()
               for k, v in cpu_maps.items() if k != "comm_rate"}
    for key, err in map_err.items():
        check(err < 2e-3, f"{name} {key}: CUDA vs CPU {err:.2e}")
    if masks:
        extra.update(where2comm_mask_check(
            name, models["cpu"], batch, masks,
            cpu_maps["cls_preds_single"], map_err["cls_preds_single"]))

    # the CPU's boxes: make_infer_fn's post-processing on the CPU maps
    _, cpu_anchors, kwargs = infer_setup(models["cpu"], anchors,
                                         post, "cpu")
    tfm = torch.from_numpy(batch["transformation_matrix"])
    for threshold in (kwargs["score_threshold"], 0.1, 0.05, 0.02, 0.01):
        kwargs["score_threshold"] = threshold
        ref = post_process(cpu_maps["cls_preds"], cpu_maps["reg_preds"],
                           cpu_anchors, tfm,
                           dir_preds=cpu_maps.get("dir_preds"),
                           max_keep=post["max_num"], **kwargs)
        if int(ref["mask"].sum()) >= BASELINE_MIN_BOXES:
            break
    check(int(ref["mask"].sum()) >= BASELINE_MIN_BOXES,
          f"{name}: {int(ref['mask'].sum())} boxes at score 0.01")
    cfg = {**post, "target_args": {
        **post["target_args"], "score_threshold": threshold}}
    infer = make_infer_fn(models["cuda"], anchors, cfg)
    counts, worst_iou, worst_ds = same_box_sets(infer(batch), ref)
    return ({"core_method": model_cfg["core_method"],
             "fusion": model_cfg["args"].get("fusion_method"),
             "seeded_fusion_tensors": built["cpu"][1],
             "cpu_forward_s": cpu_s,
             "score_threshold": threshold,
             "yaml_score_threshold":
                 post["target_args"]["score_threshold"],
             "map_max_abs_err": map_err, "boxes": counts[0],
             "min_matched_iou": worst_iou, "max_score_diff": worst_ds,
             **extra},
            infer, batch)


def baselines_check(card) -> dict:
    """The baselines phase, one line a yaml of BASELINES: baseline_parity,
    then one request with its IoU-kernel launches counted (exactly 1) and
    its peak memory, 20 timed requests and a profile. Returns each
    config's launches a request."""
    state_dict = torch.load(os.path.join(GOLDEN, "fullscale_multiscale.pth"),
                            map_location="cpu", weights_only=True)
    launches_per_request = {}
    for name in BASELINES:
        fields, infer, batch = baseline_parity(name, state_dict)
        torch.cuda.reset_peak_memory_stats()
        dets, launches = counted_call(infer, batch)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(launches == 1, f"{launches} IoU launches in a {name} request")
        launches_per_request[name] = launches
        phase("baselines", config=name, **fields,
              rotated_iou_launches=launches, peak_mem_gib=peak,
              **timed_requests(infer, batch), card=card)
        del infer
        torch.cuda.empty_cache()
    return launches_per_request


def baseline_recordings() -> dict:
    """The baseline_recordings phase: RECORDED_BASELINES' checkpoints on
    CUDA, their head maps against the reference's recordings at
    tests/test_ckpt_import.py's bound, 2e-4."""
    from coalign_tpu_torch.inference import to_device
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.runtime import configure_cuda
    from coalign_tpu_torch.utils.weights import load_pth
    configure_cuda()
    out = {}
    for fusion, extra in RECORDED_BASELINES.items():
        io = np.load(os.path.join(GOLDEN, f"baseline_{fusion}_io.npz"))
        model = load_pth(build_model({"core_method": "point_pillar_baseline",
                                      "args": {**RECORDED_ARGS, **extra}}),
                         os.path.join(GOLDEN, f"baseline_{fusion}.pth"))
        batch = golden_batch(io, ("ego_points", "cav_points"), io["pairwise"],
                             512)
        with torch.no_grad():
            maps = model(to_device(batch, "cuda"))
        out[fusion] = {k: float(np.abs(maps[k].cpu().numpy() - io[k]).max())
                       for k in ("cls_preds", "reg_preds", "dir_preds")}
        for key, err in out[fusion].items():
            check(err <= 2e-4, f"baseline_{fusion} {key}: {err:.2e} from "
                  "the recording")
    return out


# The rest of the PointPillars fusions at full width: three OPV2V yamls of
# the repo (read in place) and the deformable fusion, which no yaml sets,
# on pointpillar_selfatt.yaml's args with fusion_method deform.
FUSIONS_REST = ("pointpillar_where2comm", "pointpillar_mash",
                "pointpillar_v2vnet_robust", "deform")
DEFORM_ARGS_FROM = "pointpillar_selfatt"
REST_TRAIN_STEPS = (1, 3)                 # warm-up, timed


def rest_config(name: str) -> tuple:
    """(model config, post-processing args) of a FUSIONS_REST entry."""
    if name != "deform":
        return baseline_yaml(name)
    model_cfg, post = baseline_yaml(DEFORM_ARGS_FROM)
    return ({"core_method": "point_pillar_deform_transformer",
             "args": {**model_cfg["args"], "fusion_method": "deform"}}, post)


def fusions_rest_check(card) -> dict:
    """The fusions_rest phase, one line a FUSIONS_REST entry, as
    baselines_check: baseline_parity's CUDA against the CPU (maps within
    2e-3, Where2comm's half-sent mask and comm_rate as
    where2comm_mask_check holds them,
    MASH's corr_vol and robust V2VNet's pose outputs with the maps, the
    same box set), one counted request (exactly 1 IoU launch), its peak
    memory, 20 timed requests and a profile. Returns each entry's launches
    a request."""
    state_dict = torch.load(os.path.join(GOLDEN, "fullscale_multiscale.pth"),
                            map_location="cpu", weights_only=True)
    launches_per_request = {}
    for name in FUSIONS_REST:
        config = rest_config(name)
        fields, infer, batch = baseline_parity(name, state_dict, config)
        torch.cuda.reset_peak_memory_stats()
        _, launches = counted_call(infer, batch)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(launches == 1, f"{launches} IoU launches in a {name} request")
        launches_per_request[name] = launches
        note = ({"yaml": None, "args_from": f"{DEFORM_ARGS_FROM}.yaml",
                 "why": "no yaml of the repo sets point_pillar_deform_"
                        "transformer"} if name == "deform"
                else {"yaml": f"coalign_tpu/hypes_yaml/opv2v/{name}.yaml"})
        phase("fusions_rest", config=name, **note, **fields,
              rotated_iou_launches=launches, peak_mem_gib=peak,
              **timed_requests(infer, batch), card=card)
        del infer
        torch.cuda.empty_cache()
    return launches_per_request


def _rest_train_setup(name: str, batch_size: int):
    """(model, loss, optimizer, batch) of a train_rest entry at full width:
    the yaml's model from scratch (seed 0, no pad_parity), its loss and
    optimizer, on B = ``batch_size`` synthetic frames of TRAIN_SCENES with
    the yaml's pose noise. ``name`` is a yaml of FUSIONS_REST, robust
    V2VNet as ``..._stage{s}`` (the stage's loss and staged optimizer), or
    ``kd`` (pointpillar_disconet.yaml's DiscoNet student and a frozen
    early-fusion teacher with the flagship checkpoint's weights)."""
    from coalign_tpu_torch.config.yaml_utils import load_yaml
    from coalign_tpu_torch.data.batch import (IntermediateFusionBatcher,
                                              KDFusionBatcher)
    from coalign_tpu_torch.data.prefetch import prefetch
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.tools.train_robust import staged_optimizer
    from coalign_tpu_torch.train import build_optimizer
    yaml_name, stage = name, None
    if "_stage" in name:
        yaml_name, stage = name.split("_stage")[0], int(name[-1])
    if name == "kd":
        yaml_name = "pointpillar_disconet"
    y = load_yaml(os.path.join(HYPES, f"{yaml_name}.yaml"))
    args = y["model"]["args"]
    args["pillar_vfe"].pop("pad_parity", None)
    model_cfg, loss_cfg = y["model"], y["loss"]
    teacher = None
    if name == "kd":
        model_cfg = {"core_method": "point_pillar_disconet", "args": args}
        loss_cfg = {"core_method": "point_pillar_disconet_loss",
                    "args": {**loss_cfg["args"], "kd": {"weight": 1.0}}}
        teacher = build_model({"core_method":
                               "point_pillar_disconet_teacher",
                               "args": {**args, "pillar_vfe": {
                                   **args["pillar_vfe"],
                                   "pad_parity": True}}}, seed=1)
        missing, unexpected = teacher.load_state_dict(torch.load(
            os.path.join(GOLDEN, "fullscale_multiscale.pth"),
            map_location="cpu", weights_only=True), strict=False)
        check(not missing and not unexpected,
              f"teacher keys: {missing[:3]} {unexpected[:3]}")
    if stage is not None:
        loss_cfg = {**loss_cfg, "args": {**loss_cfg["args"], "robust": {
            **loss_cfg["args"].get("robust", {}), "stage": stage}}}
    model = build_model(model_cfg, seed=0)
    if stage is not None:
        opt, sched = staged_optimizer(model, stage, y["optimizer"])
    else:
        opt, sched = build_optimizer(model.parameters(), y["optimizer"])
    scenes = SyntheticScenes(num_frames=batch_size, **TRAIN_SCENES)
    ns = y.get("noise_setting", {})
    noise = ns.get("args", {}) if ns.get("add_noise") else {}
    cls = KDFusionBatcher if name == "kd" else IntermediateFusionBatcher
    host = cls(**TRAIN_BATCHER, pos_std=noise.get("pos_std", 0.0),
               rot_std=noise.get("rot_std", 0.0)).assemble(
        [scenes[i] for i in range(batch_size)])
    (batch,) = list(prefetch(iter([host])))
    return model, build_loss(loss_cfg), opt, sched, teacher, batch


REST_TRAIN = ("pointpillar_v2vnet_robust_stage0",
              "pointpillar_v2vnet_robust_stage1",
              "pointpillar_v2vnet_robust_stage2", "pointpillar_mash",
              "pointpillar_where2comm", "kd")


def train_rest(card) -> dict:
    """The train_rest phase, one line a REST_TRAIN entry: train_lines."""
    return train_lines(card, REST_TRAIN, "train_rest", REST_TRAIN_STEPS)


def train_lines(card, names, phase_name: str, steps: tuple) -> dict:
    """One ``phase_name`` line a yaml of ``names`` (_rest_train_setup):
    ``steps`` warm-up and timed steps (CUDA events) at B = 4, full width,
    cuDNN autotuned but for NO_AUTOTUNE_TRAIN's;
    ms a step, peak memory, the first and last loss terms, every term
    finite, no IoU launch in a step. Robust V2VNet's stages: the
    parameters the stage freezes bit-identical after the steps, the
    others and every batch norm's statistics moved. A robust step that
    does not fit at B = 4 runs at B = 2, and its line says so. Returns the
    IoU launches a train step."""
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
    from coalign_tpu_torch.tools.train_robust import stage_param_labels
    from coalign_tpu_torch.train import make_train_step
    spec = make_anchor_spec(FULL_ANCHORS, YAML_TARGETS)
    launches = {}
    for name in names:
        autotune = name not in NO_AUTOTUNE_TRAIN
        for batch_size in (TRAIN_BATCH, 2):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                model, loss, opt, sched, teacher, batch = _rest_train_setup(
                    name, batch_size)
                before = {k: v.clone() for k, v in model.state_dict().items()}
                step = make_train_step(model, loss, spec, opt, sched,
                                       teacher=teacher)
                # after make_train_step, whose configure_cuda turns it on
                torch.backends.cudnn.benchmark = autotune
                warm, timed = steps

                def run():
                    terms = [step(batch) for _ in range(warm)]
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    terms += [step(batch) for _ in range(timed)]
                    end.record()
                    return terms, start, end

                (terms, start, end), n_iou = counted_call(run)
                break
            except torch.cuda.OutOfMemoryError:
                check("robust" in name and batch_size == TRAIN_BATCH,
                      f"{name} does not fit at B={batch_size}")
                model = opt = step = batch = teacher = None
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(all(np.isfinite(float(v)) for t in terms for v in t.values()),
              f"{name}: a loss term is not finite")
        check(n_iou == 0, f"{name}: {n_iou} IoU launches in a train step")
        fields = {}
        if "_stage" in name:
            labels = stage_param_labels(model, int(name[-1]))
            state = model.state_dict()
            moved = {k: not torch.equal(state[k], before[k]) for k in labels}
            frozen = [k for k, v in labels.items() if v == "freeze"]
            check(not any(moved[k] for k in frozen),
                  f"{name}: a frozen parameter moved")
            check(all(moved[k] for k, v in labels.items() if v == "train"),
                  f"{name}: a trained parameter did not move")
            stats = [k for k in state if k.endswith("running_mean")]
            check(all(not torch.equal(state[k], before[k]) for k in stats),
                  f"{name}: a running mean did not move")
            check(("pose_loss" in terms[-1]) == (int(name[-1]) >= 1),
                  f"{name}: pose loss {sorted(terms[-1])}")
            fields = {"frozen_params": len(frozen),
                      "trained_params": len(labels) - len(frozen),
                      "frozen_bit_identical": True}
        if name == "kd":
            fields["teacher"] = "fullscale_multiscale.pth, frozen"
        ms = start.elapsed_time(end) / steps[1]
        launches[name] = n_iou
        torch.backends.cudnn.benchmark = True
        phase(phase_name, config=name, batch=batch_size,
              note=None if batch_size == TRAIN_BATCH else
              f"does not fit at B={TRAIN_BATCH}", cudnn_autotune=autotune,
              timed_steps=steps[1], ms_per_step=ms,
              frames_per_s=batch_size * 1000.0 / ms, peak_mem_gib=peak,
              first_step={k: float(v) for k, v in terms[0].items()},
              last_step={k: float(v) for k, v in terms[-1].items()},
              **fields, card=card)
        del model, opt, step, batch, teacher, terms
    torch.cuda.empty_cache()
    return launches


def rest_parity() -> dict:
    """train_parity of the tiny twins of train_rest's models (E2E_ARGS'
    widths on _tiny_parity_batch): robust V2VNet at stage 1 (the pose and
    score terms on, on the frames with the yaml's pose noise), MASH,
    Where2comm, and the KD step (DiscoNet's student against a frozen
    teacher on KD batches of the same frames)."""
    from coalign_tpu_torch.data.batch import (IntermediateFusionBatcher,
                                              KDFusionBatcher)
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    base = {k: v for k, v in E2E_ARGS.items()
            if k not in ("fusion_method", "att")}
    scenes = SyntheticScenes(**E2E_SCENES)
    frames = [scenes[0], scenes[1]]
    batcher = dict(max_cav=3, max_points=2500, max_objects=16,
                   lidar_range=E2E_RANGE)
    noisy = IntermediateFusionBatcher(**batcher, **YAML_NOISE).assemble(
        frames)
    kd_batch = KDFusionBatcher(**batcher).assemble(frames)
    cases = {
        "robust": ({"core_method": "point_pillar_v2vnet_robust",
                    "args": {**base, "robust": {"hidden": 16}}},
                   {"core_method": "point_pillar_v2v_robust_loss",
                    "args": {**E2E_LOSS, "robust": {"stage": 1}}}, None,
                   noisy),
        "mash": ({"core_method": "point_pillar_mash",
                  "args": {**base, "mash": {"coarse_downsample": 2,
                                            "query_dim": 8}}},
                 {"core_method": "point_pillar_mash_loss",
                  "args": E2E_LOSS}, None, None),
        "where2comm": ({"core_method": "point_pillar_where2comm",
                        "args": {**E2E_ARGS, "where2comm": {
                            "agg_operator": {"mode": "ATTEN"}}}},
                       E2E_LOSS, None, None),
        "kd": ({"core_method": "point_pillar_disconet", "args": base},
               {"core_method": "point_pillar_disconet_loss",
                "args": {**E2E_LOSS, "kd": {"weight": 1.0}}},
               {"core_method": "point_pillar_disconet_teacher",
                "args": base}, kd_batch),
    }
    return {name: train_parity(batch, model_cfg, loss_cfg, teacher)
            for name, (model_cfg, loss_cfg, teacher, batch)
            in cases.items()}


def stage1_train_full(card) -> tuple:
    """The stage1_train phase: pointpillar_uncertainty.yaml's detector from
    scratch (seed 0) at full width on LateFusionBatcher(train=True) batches
    (one agent a frame in its own frame) of 8 synthetic frames at the train
    phase's scale, B = 4: the yaml's loss (with the uncertainty term),
    targets, AdamW and schedule; 3 warm-up and 10 timed steps alternating
    between the two batches (CUDA events), peak memory. Checks: every loss
    term finite, unc_loss among them; every parameter a finite gradient;
    the total loss of step 13 below step 1's (the same batch); no IoU
    launch. Returns (the phase's fields, the step, a batch)."""
    from coalign_tpu_torch.data.batch import LateFusionBatcher
    from coalign_tpu_torch.data.prefetch import prefetch
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
    from coalign_tpu_torch.train import build_optimizer, make_train_step
    scenes = SyntheticScenes(num_frames=2 * TRAIN_BATCH, **TRAIN_SCENES)
    batcher = LateFusionBatcher(**TRAIN_BATCHER, train=True)
    batches = list(prefetch(batcher.batches(scenes, TRAIN_BATCH,
                                            shuffle=False)))
    check(len(batches) == 2 and tuple(batches[0]["agent_mask"].shape)
          == (TRAIN_BATCH, 1), "late train batches")
    model = build_model({"core_method": "point_pillar_uncertainty",
                         "args": STAGE1_TRAIN_ARGS}, seed=0)
    opt, sched = build_optimizer(model.parameters(), YAML_OPTIMIZER,
                                 YAML_SCHEDULER)
    step = make_train_step(model, build_loss(YAML_UNC_LOSS), make_anchor_spec(
        FULL_ANCHORS, YAML_TARGETS), opt, sched)
    torch.cuda.reset_peak_memory_stats()
    terms, warm = counted_call(lambda: [step(batches[i % 2])
                                        for i in range(3)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(3, 13):
        terms.append(step(batches[i % 2]))
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 10
    check(warm == 0, f"{warm} IoU launches in 3 stage-1 train steps")
    first = {k: float(v) for k, v in terms[0].items()}
    last = {k: float(v) for k, v in terms[12].items()}
    check("unc_loss" in first, "no unc_loss term")
    check(all(np.isfinite(float(v)) for t in terms for v in t.values()),
          "a loss term is not finite")
    for name, p in model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"{name}: no finite gradient")
    check(last["total_loss"] < first["total_loss"],
          f"total loss {first['total_loss']:.4f} -> {last['total_loss']:.4f}")
    return ({"batch": TRAIN_BATCH, "agents_per_frame": 1,
             "valid_points": int(batches[0]["point_mask"].sum()),
             "gt_boxes": int(batches[0]["gt_mask"].sum()),
             "canvas": [200, 704], "timed_steps": 10, "ms_per_step": ms,
             "frames_per_s": TRAIN_BATCH * 1000.0 / ms,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "first_step": first, "last_step": last,
             "launches_per_train_step": warm / 3, "card": card},
            step, batches[0])


def deterministic(on: bool):
    """With ``on``, cuDNN's deterministic algorithms without autotuning and
    PyTorch's deterministic implementations where it has them (a warning
    where not), so that a short training run ends at the same weights on
    every run of one commit on one card: stage1_to_ap's 80 Adam steps
    otherwise gave late AP30 0.27-0.61 and no-fusion 0.32-0.48 over four
    runs on one card, and once failed the gate. Off restores
    runtime.configure_cuda's autotuning."""
    torch.backends.cudnn.benchmark = not on
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)


def stage1_to_ap(device=None) -> dict:
    """tests/test_late_inference.py's training on the port, for CoAlign's
    stage-1 detector: the tiny point_pillar_uncertainty (seed 0) trained 80
    Adam steps (lr 3e-3) with the uncertainty loss on one late train batch
    of the 4 scenes, then evaluated at B = 2 through make_fusion_infer_fn in
    the modes late and no, training and evaluation deterministic
    (deterministic). Then its detections (make_stage1_fn, 24 boxes an
    agent) correct the poses of 20 more scenes of 10 objects (4 boxes
    are too few landmarks for the pose graph) with the yaml's pose noise
    and box_align args: the relative pose errors before and after,
    and the frames the pose graph leaves uncorrected. Returns the losses,
    the APs, the pose errors and the stage-1 fn; the caller checks the
    gate."""
    from coalign_tpu_torch.data.batch import (IntermediateFusionBatcher,
                                              LateFusionBatcher)
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.inference import (evaluate, gt_corners,
                                             make_fusion_infer_fn)
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.posegraph import BoxAlignConfig
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
    from coalign_tpu_torch.tools.pose_graph_eval import (relative_pose_errors,
                                                         summarize)
    from coalign_tpu_torch.tools.stage1 import (correct_batch_poses,
                                                make_stage1_fn)
    from coalign_tpu_torch.train import build_optimizer, make_train_step
    scenes = SyntheticScenes(**LATE_TINY_SCENES)
    batcher = LateFusionBatcher(**LATE_TINY_BATCHER)
    train_batch = batcher.assemble_train([scenes[i] for i in range(4)])
    model = build_model({"core_method": "point_pillar_uncertainty",
                         "args": {**LATE_TINY_ARGS, "uncertainty_dim": 3}},
                        device=device, seed=0)
    spec = make_anchor_spec(LATE_TINY_ANCHORS, LATE_TINY_TARGETS)
    opt, _ = build_optimizer(model.parameters(), {"lr": 3e-3, "args": {}})
    step = make_train_step(model, build_loss(
        {"core_method": "point_pillar_uncertainty_loss",
         "args": LATE_TINY_LOSS}), spec, opt, device=device)
    frames = [dict(b, gt_corners=gt_corners(b)) for b in batcher.batches(
        scenes, 2, shuffle=False, drop_last=False)]
    try:
        deterministic(True)
        losses = torch.stack([step(train_batch)["total_loss"]
                              for _ in range(80)]).tolist()
        infer = {mode: make_fusion_infer_fn(model, spec.anchors,
                                            LATE_TINY_POST, mode,
                                            device=device)
                 for mode in ("late", "no")}
        deterministic(True)          # the infer fns' configure_cuda
        ap = {mode: evaluate(fn, frames) for mode, fn in infer.items()}
    finally:
        deterministic(False)

    stage1 = make_stage1_fn(model, spec.anchors, LATE_TINY_POST,
                            STAGE1_BOXES, device=device)
    noisy = IntermediateFusionBatcher(**LATE_TINY_BATCHER, **YAML_NOISE)
    cfg = BoxAlignConfig.from_yaml(YAML_BOX_ALIGN)
    errs = {"before": ([], []), "after": ([], [])}
    left, boxes = 0, []
    pose_scenes = SyntheticScenes(**dict(LATE_TINY_SCENES, num_frames=20,
                                         num_objects=10, seed=10))
    for i in range(len(pose_scenes)):
        batch = noisy.assemble([pose_scenes[i]])
        dets = stage1(batch)
        boxes.append(int(dets["box_mask"].sum()))
        after = correct_batch_poses(batch, dets, cfg, device=device)[
            "lidar_pose"].cpu().numpy()
        left += int(np.array_equal(after, batch["lidar_pose"]))
        for key, poses in (("before", batch["lidar_pose"]), ("after", after)):
            t, r = relative_pose_errors(poses, batch["lidar_pose_clean"],
                                        batch["agent_mask"])
            errs[key][0].append(t)
            errs[key][1].append(r)
    return {"losses": losses, "ap": ap, "stage1": stage1,
            "pose_frames": 20, "frames_left_uncorrected": left,
            "stage1_boxes_per_frame": boxes,
            "pose_error": {key: summarize(np.concatenate(t),
                                          np.concatenate(r))
                           for key, (t, r) in errs.items()}}


def cli(fn, *args) -> tuple:
    """(fn(*args), what it printed): one of the port's command lines (a
    ``main`` and its argv), run in this process."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def npy_box_set(npy_dir: str, idx: int) -> tuple:
    """(corners, scores) of the kept boxes of batch ``idx``'s first frame in
    an inference's --save_npy dump."""
    def load(name):
        return np.load(os.path.join(npy_dir, f"{idx:05d}_{name}.npy"))[0]
    mask = load("pred_mask")
    return load("pred_corners")[mask], load("pred_scores")[mask]


def host_read_ms(params: dict, batch_size: int | None,
                 native: bool = True) -> float:
    """Host ms a frame to read the tree's frames (a new dataset, so no
    frame is cached) and, with ``batch_size``, to assemble them into
    batches of that size, on the C++ data plane or (``native=False``) in
    numpy."""
    from coalign_tpu_torch.data import build_dataset
    base, batcher = build_dataset(params, train=False, native=native)
    t = time.perf_counter()
    if batch_size is None:
        for i in range(len(base)):
            base[i]
    else:
        for _ in batcher.batches(base, batch_size, shuffle=False,
                                 drop_last=False):
            pass
    return (time.perf_counter() - t) * 1e3 / len(base)


def host_parse_ms(tree: str, frames: int, native: bool = False) -> dict:
    """Host ms a frame to parse the tree's cav params (from the json side
    files where there are, else the yamls) and its point clouds, each
    alone: the clouds one by one in numpy, or (``native``) a frame's
    together in the C++ data plane's threads."""
    from coalign_tpu_torch import native as data_plane
    from coalign_tpu_torch.data.opv2v import _load_params
    from coalign_tpu_torch.data.pcd_io import read_pcd
    files = sorted(os.path.join(d, f[:-5]) for d, _, fs in os.walk(tree)
                   for f in fs if f.endswith(".yaml"))
    by_frame = {}
    for f in files:      # <scenario>/<cav>/<timestamp>
        scenario = os.path.dirname(os.path.dirname(f))
        by_frame.setdefault((scenario, os.path.basename(f)), []).append(f)
    out = {}
    t = time.perf_counter()
    for f in files:
        _load_params(f + ".yaml")
    out["params_ms"] = (time.perf_counter() - t) * 1e3 / frames
    t = time.perf_counter()
    for group in by_frame.values():
        if native:
            data_plane.parse_pcd_batch([f + ".pcd" for f in group])
        else:
            for f in group:
                read_pcd(f + ".pcd")
    out["pcd_ms"] = (time.perf_counter() - t) * 1e3 / frames
    return out


def native_check(card, tree, params, ref_params, model, anchors, post,
                 eval_base, serve_ms, build) -> dict:
    """The disk phase's native step: the C++ data plane (``build``: its
    seconds and library) against the numpy path on the tree. Every pcd
    parses to the numpy reader's array exactly; host ms a frame to parse
    the params and the clouds, to read, and to read and assemble at B=1
    and B=4, taken numpy, native, native, numpy and averaged, beside the
    serve phase's request ms; the eval loop from disk on each path (the
    same order): frames/s and the device's busy share; DeviceBatchCache
    over the tree's B=1 eval batches on the card: the bytes it keeps, and a
    second epoch served without one batch assembled."""
    from coalign_tpu_torch import native as data_plane
    from coalign_tpu_torch.data import build_dataset
    from coalign_tpu_torch.data.device_cache import DeviceBatchCache
    from coalign_tpu_torch.data.pcd_io import read_pcd
    from coalign_tpu_torch.inference import evaluate_dataset, make_infer_fn
    pcds = sorted(os.path.join(d, f) for d, _, fs in os.walk(tree)
                  for f in fs if f.endswith(".pcd"))
    for path in pcds:
        check(np.array_equal(data_plane.parse_pcd(path), read_pcd(path)),
              f"{path}: the C++ parse differs from numpy's")
    frames = len(eval_base)
    runs = {"numpy": [], "native": []}
    for path in ("numpy", "native", "native", "numpy"):
        nat = path == "native"
        runs[path].append({
            **host_parse_ms(tree, frames, nat),
            "read_ms": host_read_ms(params, None, nat),
            "read_assemble_b1_ms": host_read_ms(params, 1, nat),
            "read_assemble_b4_ms": host_read_ms(params, 4, nat)})
    host = {p: {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}
            for p, rs in runs.items()}

    def eval_from_disk(nat):
        _, batcher = build_dataset(ref_params, train=False, native=nat)
        return evaluate_dataset(model, batcher, eval_base, anchors, post)

    loop = {"numpy": [], "native": []}
    results = {}
    for path in ("numpy", "native", "native", "numpy"):
        nat = path == "native"
        eval_from_disk(nat)                                 # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        results[path] = eval_from_disk(nat)
        torch.cuda.synchronize()
        loop[path].append(frames / (time.perf_counter() - t))
    busy = {p: profile_calls(lambda: eval_from_disk(p == "native"),
                             reps=1)["device_busy_share"] for p in loop}
    for key in ("ap30", "ap50", "ap70"):
        check(abs(results["native"][key] - results["numpy"][key]) <= 0.05,
              f"native and numpy eval {key}: {results}")

    # DeviceBatchCache over the tree's eval batches
    _, batcher = build_dataset(ref_params, train=False)
    reads, assembled = [], {}

    class Batches:
        def __len__(self):
            return frames

        def __getitem__(self, i):
            reads.append(i)
            assembled[i] = batcher.assemble([eval_base[i]])
            return assembled[i]

    cache = DeviceBatchCache()
    t = time.perf_counter()
    first = list(cache.epoch(Batches()))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    reads.clear()
    t = time.perf_counter()
    second = list(cache.epoch(Batches()))
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t
    check(cache.num_cached == frames and not reads,
          f"{cache.num_cached} cached, {len(reads)} read again")
    check(all(a["points"] is b["points"] for a, b in zip(first, second)),
          "the second epoch did not replay the cached tensors")
    infer = make_infer_fn(model, anchors, post)
    want = infer(assembled[0])     # the host batch the cache copied
    got = infer(second[0])
    check(torch.equal(got["mask"], want["mask"]),
          "a cached batch gives other detections")
    phase("disk", step="native", build=build, pcds=len(pcds),
          parse_equal_numpy=True, host=host,
          pcd_speedup=host["numpy"]["pcd_ms"] / host["native"]["pcd_ms"],
          serve_ms_per_frame=serve_ms,
          host_over_serve={p: h["read_assemble_b1_ms"] / serve_ms
                           for p, h in host.items()},
          eval_frames_per_s={p: float(np.mean(v)) for p, v in loop.items()},
          eval_loop_busy_share=busy,
          eval={p: {k: results[p][k] for k in ("ap30", "ap50", "ap70")}
                for p in results},
          device_cache={"frames": frames, "bytes": cache.cached_bytes,
                        "first_epoch_s": first_s,
                        "second_epoch_s": second_s,
                        "second_epoch_reads": len(reads)},
          card=card)


def disk_check(card: str, serve_ms: float, native_build: dict) -> dict:
    """The disk phase: the on-disk data path and the run CLI at full width.

      read   write_opv2v_fixture writes DISK_SCENES (8 frames in 2
             scenarios, 5 agents, an RSU last) and
             build_dataset reads them back: poses and points exact, boxes
             within 1e-4 m, the RSU never the ego;
      host   host ms a frame on the numpy path to read (5 yamls, 5 pcds;
             the params and the clouds also each alone) and to assemble at
             B=1 and B=4, from
             the yamls and from precache_json's side files, beside the
             serve phase's request ms (the files were just written, so
             they come from the page cache);
      train  run config_generate on pointpillar_coalign.yaml, run train on
             it over the tree for 1 epoch at the yaml's B=4 (config.yaml
             with pad_parity false, net_epoch1.pth, scripts_backup.zip),
             then a second train that resumes from net_epoch1.pth;
      inference   a reference-style run directory (the yaml on the tree,
             fullscale_multiscale.pth as net_epoch1.pth) through run
             inference --save_npy: frame 0's dump holds make_infer_fn's box
             set on the same batch assembled here (match_box_sets' bounds);
             1 IoU launch a frame; the eval loop's frames/s from disk and
             the device's busy share in it;
      native the C++ data plane against the numpy path on the tree
             (native_check);
      coalign    run precalc with the stage1 phase's detector saved as a
             .pth (stage1_boxes.json), then run inference with box_align
             at that json and the yaml's pose noise: AP, IoU launches a
             precalc batch and an eval frame, frames corrected and
             abandoned by the pose graph;
      sweep  the noise_sweep command line at pose noise 0 and 0.4 and
             pose_graph_eval on a run directory of that detector (both
             reported);
      parity the tiny reference run (tiny_reference_run) through run
             inference on CUDA and on the CPU: the same box sets at
             match_box_sets' bounds, AP within 0.005.
    Returns the IoU launches of a CLI eval frame and of a precalc batch."""
    import shutil

    from coalign_tpu_torch.config.yaml_utils import load_yaml, save_yaml
    from coalign_tpu_torch.data import SyntheticScenes, build_dataset
    from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
    from coalign_tpu_torch.data.opv2v import precache_json
    from coalign_tpu_torch.inference import evaluate_dataset, make_infer_fn
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.tools import noise_sweep, pose_graph_eval, run
    from coalign_tpu_torch.utils.weights import load_pth

    work = os.path.join(ROOT, "coalign_tpu_torch", "_build", "disk")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    fullscale = os.path.join(GOLDEN, "fullscale_multiscale.pth")
    dev = torch.device("cuda")

    # read: the tree written and read back
    scenes = SyntheticScenes(**DISK_SCENES)
    t = time.perf_counter()
    tree = write_opv2v_fixture(os.path.join(work, "opv2v"), scenes,
                               DISK_FRAMES_PER_SCENARIO, rsu_last=True)
    write_s = time.perf_counter() - t
    params = hypes_at("pointpillar_coalign", tree)
    base, _ = build_dataset(params, train=False)
    check(len(base) == DISK_SCENES["num_frames"], f"{len(base)} frames read")
    box_err = 0.0
    for i in range(len(base)):
        frame, ref = base[i], scenes[i]
        ids = [int(a["cav_id"]) for a in frame["agents"]]
        check(len(ids) == DISK_SCENES["num_agents"] and ids[0] > 0
              and ids[-1] < 0, f"frame {i}: agents {ids}")
        for got, want in zip(frame["agents"], ref["agents"]):
            check(np.array_equal(got["pose"], want["pose"])
                  and np.array_equal(got["points"], want["points"]),
                  f"frame {i}: agent {got['cav_id']} read back otherwise")
        check(np.array_equal(frame["objects"]["ids"], ref["objects"]["ids"]),
              f"frame {i}: object ids")
        d = frame["objects"]["boxes"] - ref["objects"]["boxes"]
        d[:, 6] = np.mod(d[:, 6] + np.pi, 2 * np.pi) - np.pi
        box_err = max(box_err, float(np.abs(d).max()))
    check(box_err <= 1e-4, f"boxes read back {box_err:.2e} off")
    points = [len(a["points"]) for i in range(len(base))
              for a in scenes[i]["agents"]]
    phase("disk", step="read", frames=len(base),
          agents=DISK_SCENES["num_agents"],
          points_per_agent=[min(points), max(points)],
          write_s=write_s, max_box_err=box_err, card=card)

    # host: read and assemble, from the yamls and from the json side files
    host = {}
    for source in ("yaml", "json"):
        if source == "json":
            t = time.perf_counter()
            host["json_files"] = precache_json(tree)
            host["precache_s"] = time.perf_counter() - t
        # the numpy path; the native step measures both paths
        host[source] = {"read_ms": host_read_ms(params, None, False),
                        **host_parse_ms(tree, len(base)),
                        "read_assemble_b1_ms": host_read_ms(params, 1, False),
                        "read_assemble_b4_ms": host_read_ms(params, 4,
                                                            False)}
    phase("disk", step="host", **host, serve_ms_per_frame=serve_ms,
          host_over_serve=host["json"]["read_assemble_b1_ms"] / serve_ms,
          card=card)

    # train: config_generate, train, resume
    full_yaml = os.path.join(work, "pointpillar_coalign_full.yaml")
    cli(run.main, ["config_generate", "-y",
                   os.path.join(HYPES, "pointpillar_coalign.yaml"),
                   "--output", full_yaml])
    train_dir = os.path.join(work, "train_run")
    argv = ["train", "-y", full_yaml, "--root_dir", tree, "--model_dir",
            train_dir, "--epochs", "1"]
    t = time.perf_counter()
    (_, trained), _ = cli(run.main, argv)
    train_s = time.perf_counter() - t
    saved = load_yaml(os.path.join(train_dir, "config.yaml"))
    check(saved["model"]["args"]["pillar_vfe"]["pad_parity"] is False,
          "the trained run's config has no pad_parity false")
    for name in ("net_epoch1.pth", "scripts_backup.zip"):
        check(os.path.exists(os.path.join(train_dir, name)), f"no {name}")
    t = time.perf_counter()
    _, text = cli(run.main, argv)
    resume_s = time.perf_counter() - t
    check('"resumed_from": "net_epoch1.pth"' in text, "train did not resume")
    check(os.path.exists(os.path.join(train_dir, "net_epoch2.pth")),
          "the resumed train saved no net_epoch2.pth")
    phase("disk", step="train", train_s=train_s, resume_s=resume_s,
          steps_per_epoch=len(base) // saved["train_params"]["batch_size"],
          eval_after_train=trained, card=card)

    # inference from a reference-style run directory
    ref_dir = write_run_dir(os.path.join(work, "ref_run"), params, fullscale)
    t = time.perf_counter()
    (res, text), launches = counted_call(
        cli, run.main, ["inference", "--model_dir", ref_dir, "--save_npy"])
    cli_s = time.perf_counter() - t
    check('"loaded_checkpoint": "net_epoch1.pth"' in text,
          "the reference checkpoint was not loaded")
    check(res["frames"] == len(base) and launches == res["frames"],
          f"{launches} IoU launches over {res['frames']} frames")
    ref_params = load_yaml(os.path.join(ref_dir, "config.yaml"))
    ref_params["model"]["args"]["pillar_vfe"]["pad_parity"] = True
    model = build_model(ref_params["model"])
    load_pth(model, fullscale)
    post = run.postprocess_cfg(ref_params)
    anchors = generate_anchor_box(post["anchor_args"])
    eval_base, eval_batcher = build_dataset(ref_params, train=False)
    want = {k: v.cpu().numpy() for k, v in make_infer_fn(
        model, anchors, post)(eval_batcher.assemble([eval_base[0]])).items()}
    mask = want["mask"][0]
    check(mask.sum() > 0, "frame 0 has no box")
    iou, ds = match_box_sets(*npy_box_set(os.path.join(ref_dir, "npy"), 0),
                             want["corners3d"][0][mask],
                             want["scores"][0][mask])

    def eval_from_disk():
        _, batcher = build_dataset(ref_params, train=False)
        return evaluate_dataset(model, batcher, eval_base, anchors, post)

    eval_from_disk()
    torch.cuda.synchronize()
    t = time.perf_counter()
    eval_from_disk()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    prof = profile_calls(eval_from_disk, reps=1)
    phase("disk", step="inference", eval=res, cli_s=cli_s,
          rotated_iou_launches=launches,
          launches_per_eval_frame=launches / res["frames"],
          frame0_boxes=int(mask.sum()), min_matched_iou=iou,
          max_score_diff=ds, eval_frames_per_s=len(eval_base) / eval_s,
          request_frames_per_s=1000.0 / serve_ms,
          eval_loop_busy_share=prof["device_busy_share"],
          eval_loop_profile={k: prof[k] for k in (
              "call_wall_ms", "device_kernel_ms", "device_kernel_launches")},
          card=card)
    native_check(card, tree, params, ref_params, model, anchors, post,
                 eval_base, serve_ms, native_build)
    del model

    # coalign: precalc, then inference corrected from its json
    stage1_path = os.path.join(work, "stage1.pth")
    torch.save(stage1_model(dev).state_dict(), stage1_path)
    pc = dict(params, validate_dir=None, box_align_pre_calc={
        "stage1_model": "point_pillar_uncertainty",
        "stage1_model_config": STAGE1_ARGS,
        "stage1_model_path": stage1_path,
        "output_save_path": os.path.join(work, "precalc"),
        "max_boxes": STAGE1_BOXES, "batch_size": TRAIN_BATCH})
    pc_yaml = os.path.join(work, "precalc.yaml")
    save_yaml(pc, pc_yaml)
    (written, _), pc_launches = counted_call(
        cli, run.main, ["precalc", "-y", pc_yaml])
    n_batches = -(-len(base) // TRAIN_BATCH)
    check(len(written) == 1 and pc_launches == n_batches,
          f"precalc: {written}, {pc_launches} IoU launches")
    ba = json.loads(json.dumps(params))
    ba["box_align"]["val_result"] = written[0]
    ba_dir = write_run_dir(os.path.join(work, "box_align_run"), ba,
                           fullscale)
    (ba_res, text), ba_launches = counted_call(
        cli, run.main, ["inference", "--model_dir", ba_dir])
    check('"box_align_json"' in text, "inference took no box_align json")
    check(ba_launches == ba_res["frames"] == len(base),
          f"{ba_launches} IoU launches over {ba_res['frames']} frames")
    ba_params = load_yaml(os.path.join(ba_dir, "config.yaml"))
    hook, _ = cli(run._box_align_hook, ba_params, dev)
    _, batcher = build_dataset(ba_params, train=False)
    corrected = 0
    for i, batch in enumerate(batcher.batches(eval_base, 1, shuffle=False,
                                              drop_last=False)):
        moved = hook(batch, [i])["lidar_pose"].cpu().numpy()
        corrected += int(not np.array_equal(moved, batch["lidar_pose"]))
    with open(written[0]) as f:
        boxes = [len(agent["box_poses"]) for frame in json.load(f).values()
                 for agent in frame]
    phase("disk", step="coalign", precalc_rotated_iou_launches=pc_launches,
          launches_per_precalc_batch=pc_launches / n_batches,
          stage1_boxes_per_agent=[min(boxes), max(boxes)],
          eval_noisy=res, eval_corrected=ba_res,
          launches_per_eval_frame=ba_launches / ba_res["frames"],
          frames_corrected=corrected,
          frames_abandoned=len(eval_base) - corrected, card=card)

    # sweep: the noise sweep and the pose-graph evaluation command lines
    sweep, _ = cli(noise_sweep.main, ["--model_dir", ref_dir, "--levels",
                                      DISK_SWEEP_LEVELS])
    s1_dir = write_run_dir(os.path.join(work, "stage1_run"),
                           hypes_at("pointpillar_uncertainty", tree),
                           stage1_path)
    pge, _ = cli(pose_graph_eval.main, ["--model_dir", s1_dir])
    check(pge["frames"] == len(base), f"pose graph over {pge['frames']}")
    phase("disk", step="sweep",
          noise_sweep={f"{k[0]:g}": v for k, v in sweep.items()},
          pose_graph=pge, card=card)

    # parity: the tiny reference run on CUDA and on the CPU
    _, tiny_cuda = tiny_reference_run(work, device=dev)
    tiny_cpu = shutil.copytree(tiny_cuda, tiny_cuda + "_cpu")
    got, _ = cli(run.main, ["inference", "--model_dir", tiny_cuda,
                            "--save_npy", "--device", "cuda"])
    want, _ = cli(run.main, ["inference", "--model_dir", tiny_cpu,
                             "--save_npy", "--device", "cpu"])
    worst_iou, worst_ds = 1.0, 0.0
    for i in range(want["frames"]):
        iou, ds = match_box_sets(*npy_box_set(os.path.join(tiny_cuda, "npy"),
                                              i),
                                 *npy_box_set(os.path.join(tiny_cpu, "npy"),
                                              i))
        worst_iou, worst_ds = min(worst_iou, iou), max(worst_ds, ds)
    for key in ("ap30", "ap50", "ap70"):
        check(abs(got[key] - want[key]) <= 0.005,
              f"tiny {key}: CUDA {got[key]:.4f}, CPU {want[key]:.4f}")
    phase("disk", step="parity", cuda=got, cpu=want,
          min_matched_iou=worst_iou, max_score_diff=worst_ds, card=card)
    return {"launches_per_cli_eval_frame": launches / res["frames"],
            "launches_per_precalc_batch": pc_launches / n_batches}


def sweep_check(flagship, stage1, device=None) -> dict:
    """The noise_sweep phase: tools/noise_sweep.noise_sweep of the tiny
    flagship that train_ap trained (``flagship``) on the 4 frames of its
    scenes at B = 2, at SWEEP_LEVELS, without and with the pose-graph
    correction from ``stage1`` (stage1_ap's detector; the yaml's box_align
    args). Reported, not gated."""
    from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.posegraph import BoxAlignConfig
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.tools.noise_sweep import noise_sweep
    out = {}
    for name, fn in (("noisy", None), ("stage1_corrected", stage1)):
        res = noise_sweep(
            flagship, lambda p, r: IntermediateFusionBatcher(
                **E2E_BATCHER, pos_std=p, rot_std=r),
            SyntheticScenes(**E2E_SCENES), generate_anchor_box(E2E_ANCHORS),
            E2E_POSTPROCESS, stage1=fn,
            align_cfg=BoxAlignConfig.from_yaml(YAML_BOX_ALIGN),
            levels=SWEEP_LEVELS, batch_size=2, device=device)
        out[name] = {f"{p:g}_{r:g}": v for (p, r), v in res.items()}
    return out


# The SECOND family at full width: five OPV2V yamls at their own
# widths and grids (41x800x2816 at 0.1 m, 41x832x2816 for
# second_intermediate.yaml, 10x200x704 at 0.4 m for VoxelNet), on synthetic
# scenes of 5 agents with 30,000 points an agent in range (the batchers'
# cap, as the other phases). SECOND.yaml and SECOND_early.yaml load
# tests/golden/second_ssfa.pth, which has their widths (3D out 64, SSFA
# 128), and serve with it; every yaml's boxes are held with seeded weights
# (second_parity).
SECOND_YAMLS = ("SECOND", "SECOND_early", "second_intermediate",
                "voxelnet_intermediate", "SECOND_uncertainty")
SECOND_CHECKPOINTED = ("SECOND", "SECOND_early")
SECOND_SCENES = dict(num_agents=5, num_objects=20, points_per_object=800,
                     ground_points=60000, agent_spread=30.0, seed=1)
SECOND_TRAIN = ("second_intermediate", "SECOND")
SECOND_TRAIN_STEPS = (1, 3)               # warm-up, timed
# the recordings of tests/test_ckpt_import.py (generate_fixtures.py
# SECOND_ARGS, which imports nothing of JAX but lives beside the tests)
SECOND_REC_ARGS = {
    "voxel_size": [0.4, 0.4, 0.1],
    "lidar_range": [-12.8, -12.8, -3.0, 12.8, 12.8, 1.0],
    "anchor_number": 2,
    "backbone_3d": {"num_features_out": 128},
    "base_bev_backbone": {"layer_nums": [2, 2], "layer_strides": [1, 2],
                          "num_filters": [64, 128], "upsample_strides": [1, 2],
                          "num_upsample_filter": [128, 128]},
}
# the tiny SECOND-SSFA of second_parity: the E2E scenes at 0.5 m voxels,
# the sparse backbone (the yamls' path) at a cap of 4096 voxels a frame
SECOND_TINY_ARGS = {
    "voxel_size": [0.5, 0.5, 0.5], "lidar_range": E2E_RANGE,
    "anchor_number": 2,
    "backbone_3d": {"num_features_out": 16, "sparse": True,
                    "max_voxels": 4096},
    "ssfa": {"feature_num": 32}, "use_iou_head": True,
    "dir_args": E2E_ARGS["dir_args"]}
SECOND_TINY_ANCHORS = {**E2E_ANCHORS, "feature_stride": 8}


def second_yaml(name: str) -> dict:
    """The OPV2V yaml ``name`` through its parser (read in place)."""
    from coalign_tpu_torch.config.yaml_utils import load_yaml
    return load_yaml(os.path.join(HYPES, f"{name}.yaml"))


def second_model(name: str, device, checkpoint: bool = False) -> tuple:
    """(the yaml's model at full width on ``device``, a note on its
    weights): seeded (seed 0), or with ``checkpoint`` second_ssfa.pth,
    loaded strictly: its widths are SECOND_CHECKPOINTED's (a strict load
    checks every shape), and it has a direction head, so their model args
    get the postprocess's dir_args."""
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.utils.weights import load_pth
    y = second_yaml(name)
    cfg = y["model"]
    if not checkpoint:
        return build_model(cfg, device=device, seed=0), "seeded"
    cfg = {**cfg, "args": {**cfg["args"],
                           "dir_args": y["postprocess"]["dir_args"]}}
    model = load_pth(build_model(cfg, device=device, seed=0),
                     os.path.join(GOLDEN, "second_ssfa.pth"))
    sd = model.state_dict()
    shapes = {k: list(sd[k].shape) for k in (
        "spconv_block.conv_out.0.weight", "ssfa.bottom_up_block_0.1.weight",
        "head.conv_cls.weight", "head.conv_dir.weight")}
    return model, f"second_ssfa.pth, strict; shapes {shapes}"


def second_batch(name: str, frames: int = 1, train: bool = False) -> dict:
    """``frames`` synthetic frames at the yaml's range, through the batcher
    of its fusion: intermediate, early (the 5 agents merged into one
    cloud) or late (late_transforms' per-agent transforms; in training one
    agent a frame, assemble_train)."""
    from coalign_tpu_torch.data.batch import (EarlyFusionBatcher,
                                              IntermediateFusionBatcher,
                                              LateFusionBatcher)
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    y = second_yaml(name)
    lr = y["preprocess"]["cav_lidar_range"]
    scenes = SyntheticScenes(num_frames=frames, lidar_range=lr,
                             **SECOND_SCENES)
    kind = y["fusion"]["core_method"]
    cls = {"late": LateFusionBatcher, "early": EarlyFusionBatcher}.get(
        kind, IntermediateFusionBatcher)
    batcher = cls(max_cav=5, max_points=30000, max_objects=100,
                  comm_range=70.0, lidar_range=lr)
    frames = [scenes[i] for i in range(frames)]
    if train and kind == "late":
        return batcher.assemble_train(frames)
    return batcher.assemble(frames)


def second_voxels(model, batch: dict) -> dict:
    """Occupied voxels an agent frame of the batch, and those beyond the
    model's cap (ops/sparse_conv.occupancy_overflow; VoxelNet has no
    cap)."""
    from coalign_tpu_torch.ops.sparse_conv import occupancy_overflow
    points = torch.as_tensor(batch["points"]).flatten(0, 1).cuda()
    mask = torch.as_tensor(batch["point_mask"]).flatten(0, 1).cuda()
    occupied = occupancy_overflow(points, mask, model.spec, 0)
    real = np.asarray(batch["agent_mask"]).reshape(-1)
    out = {"points_per_agent": [int(m) for m in mask.sum(1)[real].tolist()],
           "occupied_voxels_per_agent": occupied[real].tolist()}
    if hasattr(model, "voxel_cap"):
        cap = model.voxel_cap()
        over = occupancy_overflow(points, mask, model.spec, cap)[real]
        out.update(voxel_cap=cap,
                   voxels_per_agent=torch.clamp(
                       occupied[real], max=cap).tolist(),
                   overflow_per_agent=over.tolist(),
                   sparse_backbone=model.use_sparse)
        if model.use_sparse:
            out["strided_sites_per_agent"] = strided_sites(
                model, points, mask, cap, real)
    return out


def strided_sites(model, points, mask, cap: int, real) -> dict:
    """Active sites of the sparse backbone's three strided outputs, each
    table capped at ``cap`` rows as its input's (downsample_active drops
    the largest keys beyond it): for stages 2, 3 and 4, the sites kept
    and those dropped an agent frame (the uncapped set has at most 8
    sites an input)."""
    from coalign_tpu_torch.ops.sparse_conv import (downsample_active,
                                                   sparse_mean_voxelize)
    grid = sparse_mean_voxelize(points, mask, model.spec, cap, pad_z=1)
    backbone = getattr(model, model.backbone_name)
    out = {}
    for i, block in enumerate(backbone.stages):
        kw = dict(stride=block[0].stride, pad=block[0].padding)
        full = downsample_active(grid, max_out=8 * grid.keys.shape[1], **kw)
        grid = downsample_active(grid, **kw)
        kept = grid.valid.sum(1)
        out[f"stage{i + 2}"] = {"kept": kept[real].tolist(), "dropped": (
            full.valid.sum(1) - kept)[real].tolist()}
    return out


def _map_errors(got: dict, want: dict) -> dict:
    """Per head map: the largest |CUDA - CPU|, the map's largest magnitude
    and their ratio."""
    out = {}
    for k, v in want.items():
        err = (got[k].cpu() - v).abs().max().item()
        scale = v.abs().max().item()
        out[k] = {"max_abs_err": err, "max_abs": scale,
                  "rel_err": err / max(scale, 1e-30)}
    return out


def separated_threshold(scores: torch.Tensor, floor: float,
                        least: int = 48, min_gap: float = 1e-3) -> tuple:
    """A score threshold at which two devices' box sets can be compared:
    the yaml's (``floor``) when it leaves fewer than 512 candidates a frame
    (the top-K prefilter's size), ``least`` at least in all, and no score
    within 1e-3 of it (the devices' scores differ by ~1e-5); else, of the
    midpoints between consecutive distinct scores that do so, the one in
    the widest gap (above or below the yaml's, as the baselines phase
    lowers its threshold until 10 boxes remain), at least 1e-3 from any
    score (``min_gap``: 1e-3 unless the caller measured the devices'
    difference).
    ``scores`` (F, K) are sigmoid scores. Returns (threshold, distance of
    the nearest score to it)."""
    per_frame = torch.sort(scores, dim=1).values
    k = scores.shape[1]

    def counts(t):            # (F, T) candidates above each threshold
        return k - torch.searchsorted(
            per_frame, t.expand(scores.shape[0], -1).contiguous(),
            right=True)

    def fits(t):
        c = counts(t)
        return (c.max(0).values < 512) & (c.sum(0) >= least)

    t = torch.tensor([floor], dtype=scores.dtype)
    margin = float((scores - floor).abs().min())
    if bool(fits(t)[0]) and margin > min_gap:
        return floor, margin
    values = torch.unique(scores)                     # ascending
    mids = (values[:-1] + values[1:]) / 2
    gaps = (values[1:] - values[:-1]) / 2
    ok = fits(mids[None])
    check(bool(ok.any()), "no score threshold leaves 1-511 candidates: "
          f"above {floor} {counts(t)[:, 0].tolist()}, each frame's top "
          f"{per_frame[:, -3:].tolist()}")
    best = int(torch.argmax(torch.where(ok, gaps, -1.0)))
    check(float(gaps[best]) > min_gap,
          f"no separated score threshold: gap {float(gaps[best]):.2e}")
    return float(mids[best]), float(gaps[best])


def spread_cls_scores(models: dict, cls_preds: torch.Tensor) -> list:
    """Rescale the cls head of both ``models`` ({device: model}) so that
    each anchor's most frequent logit in ``cls_preds`` (B, A, H, W), the
    empty cells' (their features are all alike), becomes -5 (score 0.0067)
    and its 64 x B-th largest 0 (score 0.5), where the sigmoid spreads
    scores most. A seeded SECOND's subm convs sum few
    active taps, so each layer shrinks its features: its logits are ~1e-6
    and every score ties at 0.5 within float32, the empty cells' tying
    thousands of anchors at the top-K prefilter's edge. (Setting the
    norms' statistics from the batch instead amplified the devices'
    rounding through channels of near-zero variance: cls maps 0.18 apart
    on the card.) Returns each anchor's (scale, bias shift)."""
    logits = cls_preds.transpose(0, 1).flatten(1).cpu()       # (A, ...)
    empty = torch.mode(logits, dim=1).values
    rank = 64 * cls_preds.shape[0]
    kth = torch.topk(logits, rank, dim=1).values[:, -1]
    scale = 5.0 / (kth - empty).clamp_min(1e-30)
    out = []
    for model in models.values():
        conv = (model.head.conv_cls if hasattr(model, "head")
                else model.header.clshead if hasattr(model, "header")
                else model.cls_head)
        with torch.no_grad():
            s = scale.to(conv.weight.device)
            # new logit = scale * (logit - empty) - 5
            shift = -5.0 - s * empty.to(s.device)
            conv.weight.mul_(s[:, None, None, None])
            conv.bias.mul_(s).add_(shift)
        out = [[float(a), float(b)] for a, b in zip(scale, shift.cpu())]
    return out


def _second_pair(name: str, batch: dict, checkpoint: bool) -> dict:
    """second_model on CUDA and on the CPU (seeded ones with
    spread_cls_scores' cls head), and the batch through both: head maps
    within 2e-3 of the map's largest magnitude (the baselines phase's
    2e-3, relative: the seeded maps but cls are ~1e-6, second_ssfa.pth's
    ~4e4), and the box sets of the yaml's infer fn at match_box_sets'
    bounds, at separated_threshold's score (chosen on the card's scores;
    the checkpoint's at the yaml's). The CPU runs its
    infer fn once, its maps taken by a forward hook. Returns the fields,
    the CUDA infer fn and the CUDA model."""
    from coalign_tpu_torch.inference import make_fusion_infer_fn, to_device
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.tools.run import postprocess_cfg
    y = second_yaml(name)
    kind = y["fusion"]["core_method"]
    built = {dev: second_model(name, dev, checkpoint)
             for dev in ("cuda", "cpu")}
    models = {dev: m for dev, (m, _) in built.items()}
    shift = None
    if not checkpoint:
        with torch.no_grad():
            shift = spread_cls_scores(
                models, models["cuda"](to_device(batch, "cuda"))["cls_preds"])
    anchors = generate_anchor_box(y["postprocess"]["anchor_args"])
    with torch.no_grad():
        cuda_maps = models["cuda"](to_device(batch, "cuda"))
    check(tuple(cuda_maps["cls_preds"].shape[-2:]) == anchors.shape[:2],
          f"{name}: maps {tuple(cuda_maps['cls_preds'].shape)} against "
          f"anchors {anchors.shape}")
    for key, out in cuda_maps.items():
        check(bool(torch.isfinite(out).all()), f"{name}: {key} not finite")
    scores = torch.sigmoid(cuda_maps["cls_preds"].permute(0, 2, 3, 1)
                           .flatten(1)).cpu()
    post = postprocess_cfg(y)
    threshold, margin = post["target_args"]["score_threshold"], None
    if not checkpoint:          # the checkpoint's scores are all 0 or 1
        threshold, margin = separated_threshold(scores, threshold)
    post = {**post, "target_args": {**post["target_args"],
                                    "score_threshold": threshold}}
    infer, ref = (make_fusion_infer_fn(models[dev], anchors, post, kind,
                                       device=dev) for dev in ("cuda", "cpu"))
    cpu_maps = {}
    hook = models["cpu"].register_forward_hook(
        lambda mod, inputs, out: cpu_maps.update(out))
    t = time.perf_counter()
    want = ref(batch)
    cpu_s = time.perf_counter() - t
    hook.remove()
    errs = _map_errors(cuda_maps, cpu_maps)
    for key, e in errs.items():
        check(e["rel_err"] <= 2e-3,
              f"{name} {key}: CUDA vs CPU {e}")
    counts, worst_iou, worst_ds = same_box_sets(infer(batch), want)
    return {"weights": built["cuda"][1], "cls_scale_shift": shift,
            "map_err": errs,
            "cpu_request_s": cpu_s, "score_threshold": threshold,
            "threshold_margin": margin, "boxes": counts,
            "min_matched_iou": worst_iou,
            "max_score_diff": worst_ds}, infer, models["cuda"]


def second_parity(name: str, card) -> tuple:
    """The yaml ``name``'s model at full width, B = 1, CUDA against the CPU
    (_second_pair) with seeded weights, and for SECOND_CHECKPOINTED also
    with second_ssfa.pth's, which then serve: its random deep trunk
    saturates every logit (|x| ~ 1e4) and decodes no finite box, so the
    box sets of that pair are empty on both devices and the seeded pair's
    are the ones that test the boxes (at least one box). One request's IoU
    launches (1; 2 for late fusion) and peak memory. Returns (the fields,
    the serving infer fn, the batch, its CUDA model)."""
    from coalign_tpu_torch.runtime import configure_cuda
    configure_cuda()
    y = second_yaml(name)
    kind = y["fusion"]["core_method"]
    batch = second_batch(name)
    seeded, infer, model = _second_pair(name, batch, False)
    check(seeded["boxes"][0] > 0, f"no box in the seeded {name} request")
    fields = {"config": name, "fusion": kind,
              "core_method": y["model"]["core_method"],
              "grid": [model.spec.nz, model.spec.ny, model.spec.nx],
              "agents": int(np.asarray(batch["agent_mask"]).sum()),
              **second_voxels(model, batch), "seeded": seeded}
    if name in SECOND_CHECKPOINTED:
        del infer, model
        fields["checkpoint"], infer, model = _second_pair(name, batch, True)
    infer(batch)                                  # cuDNN autotunes
    torch.cuda.reset_peak_memory_stats()
    _, launches = counted_call(infer, batch)
    want = 2 if kind == "late" else 1
    check(launches == want, f"{launches} IoU launches in a {name} request")
    fields.update(rotated_iou_launches=launches,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return fields, infer, batch, model


# kernel-name patterns of the 3D backbone's parts, tried in this order
BACKBONE3D_PARTS = (
    ("rulebooks_and_active_sets", ("searchsorted", "sort", "radix", "scan",
                                    "cumsum", "unique", "reduce_kernel")),
    ("gathers", ("index", "gather", "scatter", "cat")),
    ("dense_convs", ("conv", "fprop", "dgrad", "wgrad", "winograd")),
    ("products", ("gemm", "cutlass", "matmul", "splitk")),
)


def backbone3d_breakdown(model, batch: dict, reps: int = 3) -> dict:
    """Where the 3D backbone's device time goes: torch.profiler over
    ``reps`` calls of the model's 3D backbone alone on the batch's voxel
    grid (sparse or the dense twin's, or VoxelNet's middle convs), each
    kernel's device time summed into BACKBONE3D_PARTS by its name (the
    rest: norms, ReLU, masks, copies), ms a call."""
    from coalign_tpu_torch.inference import to_device
    from coalign_tpu_torch.ops.sparse_conv import sparse_mean_voxelize
    b = to_device(batch, "cuda")
    points = b["points"].flatten(0, 1)
    mask = b["point_mask"].flatten(0, 1)
    with torch.no_grad():
        if hasattr(model, "cml"):                    # VoxelNet
            grid = model._svfe(b)

            def call():
                x = grid
                for conv in model.cml:
                    x = conv(x)
        else:
            backbone = getattr(model, model.backbone_name)
            check(model.use_sparse, "a full-width SECOND runs sparse")
            grid = sparse_mean_voxelize(points, mask, model.spec,
                                        model.voxel_cap(), pad_z=1)

            def call():
                backbone(grid)
        call()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
    parts = {name: 0.0 for name, _ in BACKBONE3D_PARTS}
    parts["other"] = 0.0
    launches = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = e.key.lower()
        part = next((name for name, pats in BACKBONE3D_PARTS
                     if any(p in key for p in pats)), "other")
        parts[part] += e.self_device_time_total / reps / 1e3
        launches += e.count
    return {"device_ms": parts, "total_ms": sum(parts.values()),
            "launches": launches / reps}


def second_check(card) -> dict:
    """The second phase, one line a yaml of SECOND_YAMLS: second_parity,
    20 timed requests and a profile (timed_requests). Returns each yaml's
    IoU launches a request."""
    launches = {}
    for name in SECOND_YAMLS:
        fields, infer, batch, model = second_parity(name, card)
        launches[name] = fields["rotated_iou_launches"]
        phase("second", **fields, **timed_requests(infer, batch),
              backbone_3d=backbone3d_breakdown(model, batch), card=card)
        del infer, batch, model
        torch.cuda.empty_cache()
    return launches


def second_recordings() -> dict:
    """The second_recordings phase: second.pth and second_intermediate.pth
    on CUDA against their recordings, through load_pth, on the dense twin
    and on the sparse backbone, within tests/test_ckpt_import.py's bounds
    (rtol 2e-3, atol 1e-3; rtol 5e-3 for the intermediate). Returns the
    largest errors relative to those bounds."""
    from coalign_tpu_torch.inference import to_device
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.runtime import configure_cuda
    from coalign_tpu_torch.utils.weights import load_pth
    configure_cuda()                      # full float32: TF32 off
    cases = {"second": ("second", SECOND_REC_ARGS, ("points",), 2e-3),
             "second_intermediate": ("second_intermediate",
                                     {**SECOND_REC_ARGS,
                                      "fusion_method": "att"},
                                     ("points0", "points1"), 5e-3)}
    out = {}
    for name, (core, args, keys, rtol) in cases.items():
        io = np.load(os.path.join(GOLDEN, f"{name}_io.npz"))
        batch = golden_batch(io, keys, None, 512)
        # one agent a frame, as the recordings traced them
        batch = {"points": batch["points"].transpose(1, 0, 2, 3),
                 "point_mask": batch["point_mask"].transpose(1, 0, 2),
                 "agent_mask": np.ones((len(keys), 1), bool),
                 "pairwise_t_matrix": np.tile(np.eye(4, dtype=np.float32),
                                              (len(keys), 1, 1, 1, 1))}
        for sparse in (False, True):
            model = build_model({"core_method": core, "args": {
                **args, "backbone_3d": {**args["backbone_3d"],
                                        "sparse": sparse}}})
            check(model.use_sparse == sparse, f"{name} backbone form")
            load_pth(model, os.path.join(GOLDEN, f"{name}.pth"))
            with torch.no_grad():
                maps = model(to_device(batch, "cuda"))
            worst = 0.0
            for key in ("cls_preds", "reg_preds"):
                got = maps[key].cpu().numpy()
                ratio = np.abs(got - io[key]) / (1e-3 + rtol * np.abs(io[key]))
                worst = max(worst, float(ratio.max()))
            check(worst <= 1.0, f"{name} sparse={sparse}: {worst:.3f} of "
                  f"the bound")
            out[f"{name}_{'sparse' if sparse else 'dense'}"] = worst
    return out


def second_train(card) -> dict:
    """The second_train phase, one line a yaml of SECOND_TRAIN: the yaml's
    model from scratch (seed 0) at full width with its loss, Adam and
    schedule on B = 4 synthetic frames (second_intermediate: 4 frames of 5
    agents, 20 agent frames; SECOND.yaml, late: one agent a frame), the
    train cap max_voxel_train 32,000; SECOND_TRAIN_STEPS warm-up and timed
    steps (CUDA events; both on cuDNN's heuristic algorithms,
    NO_AUTOTUNE_TRAIN): ms a step, the peak memory of the
    warm-up (model, optimizer state, any cuDNN autotuning) and of the timed
    steps, the
    voxels and overflow a frame, the first and last loss terms, every term
    finite, no IoU launch.
    A step that does not fit on the card is recorded, not cut. Returns the
    IoU launches a train step."""
    from coalign_tpu_torch.data.prefetch import prefetch
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
    from coalign_tpu_torch.train import build_optimizer, make_train_step
    launches = {}
    for name in SECOND_TRAIN:
        y = second_yaml(name)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(y["model"], seed=0)
        opt, sched = build_optimizer(model.parameters(), y["optimizer"],
                                     y.get("lr_scheduler"))
        post = y["postprocess"]
        step = make_train_step(model, build_loss(y["loss"]),
                               make_anchor_spec(post["anchor_args"],
                                                post["target_args"]),
                               opt, sched)
        host = second_batch(name, TRAIN_BATCH, train=True)
        (batch,) = list(prefetch(iter([host])))
        model.train()
        voxels = second_voxels(model, host)
        warm, timed = SECOND_TRAIN_STEPS
        peaks = []                 # the warm-up's (cuDNN autotunes there)
        # after make_train_step, whose configure_cuda turns it on
        autotune = name not in NO_AUTOTUNE_TRAIN
        torch.backends.cudnn.benchmark = autotune
        try:
            def run():
                terms = [step(batch) for _ in range(warm)]
                torch.cuda.synchronize()
                peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                terms += [step(batch) for _ in range(timed)]
                end.record()
                return terms, start, end

            (terms, start, end), n_iou = counted_call(run)
        except torch.cuda.OutOfMemoryError as e:
            torch.backends.cudnn.benchmark = True
            phase("second_train", config=name, batch=TRAIN_BATCH,
                  fits=False, error=str(e)[:300],
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  **voxels, card=card)
            del model, opt, step, batch
            continue
        torch.backends.cudnn.benchmark = True
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(all(np.isfinite(float(v)) for t in terms for v in t.values()),
              f"{name}: a loss term is not finite")
        check(n_iou == 0, f"{name}: {n_iou} IoU launches in a train step")
        ms = start.elapsed_time(end) / timed
        launches[name] = n_iou
        phase("second_train", config=name, batch=TRAIN_BATCH, fits=True,
              cudnn_autotune=autotune,
              agent_frames=int(np.asarray(host["agent_mask"]).sum()),
              timed_steps=timed, ms_per_step=ms,
              frames_per_s=TRAIN_BATCH * 1000.0 / ms,
              warmup_peak_mem_gib=peaks[0], peak_mem_gib=peak,
              **voxels,
              first_step={k: float(v) for k, v in terms[0].items()},
              last_step={k: float(v) for k, v in terms[-1].items()},
              card=card)
        del model, opt, step, batch, terms
    torch.cuda.empty_cache()
    return launches


def second_step_parity() -> dict:
    """train_parity of SECOND_TINY_ARGS' second_ssfa (the sparse backbone)
    on _tiny_stage1_batch (one agent a frame) with the yaml's
    point_pillar_loss: the CUDA step against the CPU step."""
    return train_parity(
        _tiny_stage1_batch(),
        {"core_method": "second_ssfa", "args": SECOND_TINY_ARGS},
        {"core_method": "point_pillar_loss", "args": E2E_LOSS},
        anchor_args=SECOND_TINY_ANCHORS)



# ---------------------------------------------------------------------------
# The seven OPV2V baselines' training, the DAIR-V2X and V2X-Sim readers, and
# the PIXOR family.

BASELINE_TRAIN_STEPS = (1, 3)             # warm-up, timed
# train lines timed on cuDNN's heuristic algorithms, without autotuning:
# V2VNet's float32 ConvGRU autotunes for ~130 s in its first step, which
# the script's 1,200 s cannot spare beside the LSS phases (its step takes
# ~2.7 s on the heuristics' algorithms, ~2.2 s autotuned); second_
# intermediate's (~100 s of its line) and the LSS model's (~70 s) neither,
# beside the two-stage phases (the script ran 1,249 s with them tuned);
# nor robust V2VNet's (~30 s), When2comm's (~35 s) and SECOND's (~20 s),
# whose autotuning took 85 of the script's 934 s on one host, which ran
# 1,156 s on a slower one
NO_AUTOTUNE_TRAIN = ("pointpillar_v2vnet", "second_intermediate",
                     "lss_coalign_fusion", "pointpillar_v2vnet_robust_stage0",
                     "pointpillar_v2vnet_robust_stage1",
                     "pointpillar_v2vnet_robust_stage2",
                     "pointpillar_when2comm", "SECOND")
# train_parity's tiny twins of the baselines with a learned fusion: the tiny
# flagship's trunk (E2E_ARGS: 64 channels fused at 32 x 32) with each fusion
BASELINE_TWIN_BASE = {k: v for k, v in E2E_ARGS.items()
                      if k not in ("fusion_method", "att")}
BASELINE_TWINS = {
    "disconet": {"fusion_method": "disconet"},
    "v2vnet": {"fusion_method": "v2vnet", "v2vnet": {
        "num_iteration": 2, "agg_operator": "avg",
        "conv_gru": {"kernel_size": [[3, 3]]}}},
    "when2comm": {"fusion_method": "when2comm", "when2comm": {
        "query_size": 8, "key_size": 16}},
    "v2xvit": {"fusion_method": "v2xvit", "v2xvit": {"transformer": {
        "encoder": {"num_blocks": 1, "depth": 2,
                    "cav_att_config": {"dim": 64, "use_hetero": True,
                                       "heads": 2, "dim_head": 32},
                    "pwindow_att_config": {
                        "dim": 64, "heads": [2, 2, 1],
                        "dim_head": [32, 32, 64], "window_size": [4, 8, 16],
                        "relative_pos_embedding": True,
                        "fusion_method": "split_attn"},
                    "feed_forward": {"mlp_dim": 96}}}}},
}
# the DiscoNet twin's train-to-AP gate: tests/test_end2end.py's (written in
# PERF.md before the first run on the card)
DISCONET_AP_GATE = {"last_over_first_loss": 0.05, "ap30": 0.8, "ap50": 0.6}


def baseline_twin(name: str) -> dict:
    return {"core_method": "point_pillar_baseline",
            "args": {**BASELINE_TWIN_BASE, **BASELINE_TWINS[name]}}


def periods_check() -> dict:
    """Fault 10 on the card: limit_period (period 2 pi, offset 0.5; the
    decode's pi, offset 0) and PointPillarLoss's direction bins of
    boundary_yaws(1,000,000) on CUDA equal the CPU's exactly."""
    from coalign_tpu_torch.loss.point_pillar_loss import (PointPillarLoss,
                                                          PointPillarLossCfg)
    from coalign_tpu_torch.utils.common import limit_period
    yaws = torch.from_numpy(boundary_yaws(1_000_000))
    for offset, period in ((0.5, 2 * np.pi), (0.0, np.pi)):
        got = limit_period(yaws.cuda(), offset, period).cpu()
        check(torch.equal(got, limit_period(yaws, offset, period)),
              f"limit_period({offset}, {period:.4f}): CUDA differs from CPU")
    loss = PointPillarLoss(PointPillarLossCfg(dir_offset=0.0, num_bins=2,
                                              anchor_yaw_deg=(0.0, 0.0)))
    reg = torch.zeros(1, len(yaws), 7)
    reg[0, :, 6] = yaws
    bins = loss._direction_targets(reg.cuda()).cpu()
    check(torch.equal(bins, loss._direction_targets(reg)),
          "direction bins: CUDA differs from CPU")
    return {"yaws": len(yaws), "boundary_yaws": len(yaws) - 1_000_000,
            "wrapped_equal": True, "bins_equal": True,
            "second_bin_share": float(bins[0, :, 1].mean())}


def baselines_train(card) -> dict:
    """The baselines_train phase: train_lines of BASELINES (the yamls'
    models from scratch, their loss and AdamW, B = 4, full width);
    baselines_train_parity, the CUDA step of each learned fusion's tiny
    twin against the CPU's (train_parity's bounds); disconet_ap, the
    DiscoNet twin trained to DISCONET_AP_GATE. Returns the IoU launches a
    train step."""
    launches = train_lines(card, BASELINES, "baselines_train",
                           BASELINE_TRAIN_STEPS)
    phase("baselines_train_parity", **{
        name: train_parity(None, baseline_twin(name))
        for name in BASELINE_TWINS})
    gate, ap_launches = counted_call(train_to_ap, None,
                                     baseline_twin("disconet"))
    losses = gate.pop("losses")
    gate.pop("model")
    ratio = losses[-1] / losses[0]
    check(ratio < DISCONET_AP_GATE["last_over_first_loss"],
          f"DiscoNet loss did not drop: {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(gate["frames"] == 2 and gate["ap30"] > DISCONET_AP_GATE["ap30"]
          and gate["ap50"] > DISCONET_AP_GATE["ap50"],
          f"DiscoNet AP too low after training: {gate}")
    phase("disconet_ap", steps=250, gate=DISCONET_AP_GATE,
          first_loss=losses[0], last_loss=losses[-1],
          loss_every_50=losses[::50], **gate,
          rotated_iou_launches=ap_launches, card=card)
    return launches


# The datasets phase: fixture trees at the yamls' ranges, ~30,000 points an
# agent (DAIR: the vehicle and the infrastructure; V2X-Sim: 5 agents)
DATASET_YAMLS = ("dairv2x/pointpillar_coalign", "v2xsim/pointpillar_coalign")
DAIR_STAGE1_YAML = "dairv2x/pointpillar_uncertainty"
DATASET_SCENES = dict(num_frames=4, num_objects=20, points_per_object=900,
                      ground_points=24000, agent_spread=30.0, seed=31)
DATASET_REQUESTS = 20


def dataset_params(work: str, rel: str) -> tuple:
    """The yaml ``rel`` (of hypes_yaml/) on a fixture tree that the port's
    writer writes under ``work``: DATASET_SCENES at the yaml's range with
    its max_cav agents; no test_dir, no box_align json. Returns (the
    params, the points of each agent written)."""
    from coalign_tpu_torch.config.yaml_utils import load_yaml
    from coalign_tpu_torch.data.fixtures import (write_dairv2x_fixture,
                                                 write_v2xsim_fixture)
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    params = load_yaml(os.path.join(HYPES_ROOT, f"{rel}.yaml"))
    params.pop("box_align", None)
    scenes = SyntheticScenes(
        num_agents=params["train_params"]["max_cav"],
        lidar_range=params["preprocess"]["cav_lidar_range"],
        **DATASET_SCENES)
    name = rel.split("/")[0]
    root = os.path.join(work, name)
    if name == "dairv2x":
        split = write_dairv2x_fixture(root, scenes)
        params.update(data_dir=root, root_dir=split, validate_dir=split)
    else:
        os.makedirs(root, exist_ok=True)
        pkl = write_v2xsim_fixture(os.path.join(root, "infos.pkl"), scenes)
        params.update(root_dir=pkl, validate_dir=pkl)
    params["test_dir"] = None
    return params, [len(a["points"]) for i in range(len(scenes))
                    for a in scenes[i]["agents"]]


def dataset_parity(name: str, models: dict, batch: dict, post: dict,
                   anchors) -> dict:
    """CUDA against the CPU on one batch of the dataset: head maps within
    2e-3, the same box set (match_box_sets' bounds) through make_infer_fn,
    at the yaml's score threshold lowered until BASELINE_MIN_BOXES boxes
    remain on the CPU."""
    from coalign_tpu_torch.inference import make_infer_fn, to_device
    from coalign_tpu_torch.runtime import configure_cuda
    configure_cuda()            # full float32 before the first forward
    with torch.no_grad():
        maps = {dev: m(to_device(batch, dev)) for dev, m in models.items()}
    map_err = {k: (v.cpu() - maps["cpu"][k]).abs().max().item()
               for k, v in maps["cuda"].items()}
    for key, err in map_err.items():
        check(err < 2e-3, f"{name} {key}: CUDA vs CPU {err:.2e}")
    for threshold in (post["target_args"]["score_threshold"], 0.1, 0.05,
                      0.02, 0.01):
        cfg = {**post, "target_args": {**post["target_args"],
                                       "score_threshold": threshold}}
        ref = make_infer_fn(models["cpu"], anchors, cfg, device="cpu")(batch)
        if int(ref["mask"].sum()) >= BASELINE_MIN_BOXES:
            break
    check(int(ref["mask"].sum()) >= BASELINE_MIN_BOXES,
          f"{name}: {int(ref['mask'].sum())} boxes at score 0.01")
    counts, iou, ds = same_box_sets(
        make_infer_fn(models["cuda"], anchors, cfg)(batch), ref)
    return {"map_max_abs_err": map_err, "score_threshold": threshold,
            "boxes": counts, "min_matched_iou": iou, "max_score_diff": ds}


def dataset_check(card, work: str, rel: str, fullscale: str) -> dict:
    """One datasets line: ``rel``'s yaml on its fixture tree
    (dataset_params) as a reference-style run directory with
    ``fullscale`` (the flagship checkpoint, whose keys the yaml's model
    shares) through run inference from disk: 1 IoU launch a frame, frames/s
    of the whole command and of the eval loop; frame 0 CUDA against the
    CPU (dataset_parity); 20 timed requests and a profile of the infer fn.
    Returns (the params, the IoU launches a CLI frame)."""
    from coalign_tpu_torch.config.yaml_utils import load_yaml
    from coalign_tpu_torch.data import build_dataset
    from coalign_tpu_torch.inference import evaluate_dataset, make_infer_fn
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.tools import run
    from coalign_tpu_torch.utils.weights import load_pth
    t = time.perf_counter()
    params, points = dataset_params(work, rel)
    write_s = time.perf_counter() - t
    ref_dir = write_run_dir(os.path.join(work, rel.replace("/", "_")),
                            params, fullscale)
    t = time.perf_counter()
    (res, text), launches = counted_call(
        cli, run.main, ["inference", "--model_dir", ref_dir])
    cli_s = time.perf_counter() - t
    check('"loaded_checkpoint": "net_epoch1.pth"' in text,
          f"{rel}: the checkpoint was not loaded")
    frames = DATASET_SCENES["num_frames"]
    check(res["frames"] == frames and launches == frames,
          f"{rel}: {launches} IoU launches over {res['frames']} frames")
    ref_params = load_yaml(os.path.join(ref_dir, "config.yaml"))
    ref_params["model"]["args"]["pillar_vfe"]["pad_parity"] = True
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = build_model(ref_params["model"], device=dev)
        load_pth(models[dev], fullscale)
    post = run.postprocess_cfg(ref_params)
    anchors = generate_anchor_box(post["anchor_args"])
    base, batcher = build_dataset(ref_params, train=False)
    batch = batcher.assemble([base[0]])
    fields = dataset_parity(rel, models, batch, post, anchors)

    def eval_from_disk():
        _, b = build_dataset(ref_params, train=False)
        return evaluate_dataset(models["cuda"], b, base, anchors, post)

    eval_from_disk()
    torch.cuda.synchronize()
    t = time.perf_counter()
    eval_from_disk()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    infer = make_infer_fn(models["cuda"], anchors, post)
    torch.cuda.reset_peak_memory_stats()
    infer(batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phase("datasets", config=rel, frames=frames,
          agents=int(batch["agent_mask"].shape[1]),
          grid=[post["anchor_args"]["W"], post["anchor_args"]["H"]],
          points_per_agent=[min(points), max(points)], write_s=write_s,
          eval=res, cli_s=cli_s, cli_frames_per_s=frames / cli_s,
          eval_frames_per_s=frames / eval_s, rotated_iou_launches=launches,
          launches_per_frame=launches / frames, **fields,
          peak_mem_gib=peak, **timed_requests(infer, batch), card=card)
    return params, launches / frames


def dair_coalign_check(card, params: dict, fullscale: str) -> tuple:
    """The datasets phase's DAIR CoAlign line: the two-pass request on the
    DAIR tree (B = 1, L = 2, the coalign yaml's pose noise):
    DAIR_STAGE1_YAML's stage-1 detector (the flagship checkpoint's shared
    weights, a seeded uncertainty head, K = 24 boxes an agent), the pose
    graph with the coalign yaml's box_align args, the flagship. Checks: 2
    IoU launches a request, the stage-1 NMS at (2, 512), the corrected
    poses on CUDA within 2e-3 m and 2e-3 degrees of the CPU's from the
    same stage-1 detections. Returns (the fields, the stage-1 NMS input)."""
    import itertools

    from coalign_tpu_torch.config.yaml_utils import load_yaml
    from coalign_tpu_torch.data import build_dataset
    from coalign_tpu_torch.inference import make_infer_fn
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.posegraph import BoxAlignConfig
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.tools import run
    from coalign_tpu_torch.tools.stage1 import (correct_batch_poses,
                                                make_stage1_fn)
    from coalign_tpu_torch.utils.weights import load_pth
    y1 = load_yaml(os.path.join(HYPES_ROOT, f"{DAIR_STAGE1_YAML}.yaml"))
    stage1 = make_stage1_fn(
        stage1_model("cuda", y1["model"]["args"]),
        generate_anchor_box(y1["postprocess"]["anchor_args"]),
        run.postprocess_cfg(y1), STAGE1_BOXES)
    coalign = load_yaml(os.path.join(HYPES_ROOT, f"{DATASET_YAMLS[0]}.yaml"))
    cfg = BoxAlignConfig.from_yaml(coalign["box_align"]["args"])
    model = build_model({**params["model"], "args": {
        **params["model"]["args"], "pillar_vfe": {
            **params["model"]["args"]["pillar_vfe"], "pad_parity": True}}})
    load_pth(model, fullscale)
    post = run.postprocess_cfg(params)
    infer = make_infer_fn(model, generate_anchor_box(post["anchor_args"]),
                          post)
    base, batcher = build_dataset(params, train=False)
    frames = [batcher.assemble([base[i]]) for i in range(len(base))]

    def request(batch):
        return infer(correct_batch_poses(batch, stage1(batch), cfg))

    request(frames[0])
    captured, restore = _capture_iou_inputs()
    try:
        dets, launches = counted_call(request, frames[1])
    finally:
        restore()
    shapes = [list(c.shape[:2]) for c in captured]
    check(launches == 2 and shapes == [[2, 512], [1, 512]],
          f"{launches} IoU launches at {shapes} in a DAIR CoAlign request")
    check(bool(torch.isfinite(dets["corners3d"][dets["mask"]]).all()),
          "a kept box is not finite")
    first = stage1(frames[1])
    gpu = correct_batch_poses(frames[1], first, cfg)
    cpu = correct_batch_poses(frames[1], {k: v.cpu() for k, v in
                                          first.items()}, cfg, device="cpu")
    dxy, dyaw = pose_diff(gpu["lidar_pose"][..., [0, 1, 4]],
                          cpu["lidar_pose"][..., [0, 1, 4]])
    check(dxy <= 2e-3 and dyaw <= 2e-3,
          f"DAIR corrected pose CUDA vs CPU {dxy:.2e} m, {dyaw:.2e} deg")
    it = itertools.cycle(frames)
    ms = event_ms(lambda: request(next(it)), reps=DATASET_REQUESTS)
    it = itertools.cycle(frames)
    flagship_ms = event_ms(lambda: infer(next(it)), reps=DATASET_REQUESTS)
    prof = profile_calls(lambda: request(frames[1]))
    phase("datasets", config="dairv2x coalign two-pass",
          stage1_yaml=f"coalign_tpu/hypes_yaml/{DAIR_STAGE1_YAML}.yaml",
          agents=2, requests=DATASET_REQUESTS,
          rotated_iou_launches_per_request=launches, nms_shapes=shapes,
          corrected_pose_cuda_vs_cpu=[dxy, dyaw], ms_per_frame=ms,
          frames_per_s=1000.0 / ms, flagship_ms_per_frame=flagship_ms,
          profile={k: prof[k] for k in (
              "stages", "call_wall_ms", "device_kernel_ms",
              "device_busy_share", "device_kernel_launches")}, card=card)
    return launches, captured[0]


def datasets_check(card) -> tuple:
    """The datasets phase (dataset_check for each of DATASET_YAMLS, then
    dair_coalign_check). Its trees and run directories go under the
    gitignored coalign_tpu_torch/_build/datasets/. Returns (IoU launches a
    CLI frame of each yaml and a DAIR CoAlign request, the (2, 512) NMS
    input)."""
    import shutil
    work = os.path.join(ROOT, "coalign_tpu_torch", "_build", "datasets")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    fullscale = os.path.join(GOLDEN, "fullscale_multiscale.pth")
    launches = {}
    for rel in DATASET_YAMLS:
        params, launches[rel] = dataset_check(card, work, rel, fullscale)
        if rel.startswith("dairv2x"):
            dair = params
    launches["dairv2x_coalign_request"], nms_input = dair_coalign_check(
        card, dair, fullscale)
    return launches, nms_input


PIXOR_YAML = "opv2v/pixor_intermediate"
PIXOR_SCENES = dict(num_frames=4, num_agents=5, num_objects=20,
                    points_per_object=900, ground_points=24000,
                    agent_spread=30.0, seed=41)
PIXOR_TRAIN_STEPS = (1, 3)                # warm-up, timed


def pixor_setup(device, y: dict, checkpoint: bool = True) -> tuple:
    """pixor_intermediate.yaml's model at its full raster on ``device``
    (seed 0) with every tensor of pixor_inter.pth whose shape it shares:
    all but the stem's first conv, whose input is the yaml's 21-channel
    raster, not the recording's 8. Returns (model, the seeded keys)."""
    from coalign_tpu_torch.models.zoo import build_model
    model = build_model(y["model"], device=device, seed=0)
    if not checkpoint:
        return model, []
    sd = torch.load(os.path.join(GOLDEN, "pixor_inter.pth"),
                    map_location="cpu", weights_only=True)
    own = model.state_dict()
    shared = {k: v for k, v in sd.items() if own[k].shape == v.shape}
    missing, unexpected = model.load_state_dict(shared, strict=False)
    check(not unexpected and missing == ["backbone.conv1.weight"],
          f"pixor_inter.pth keys: missing {missing}, unexpected {unexpected}")
    return model, missing


def pixor_batch(y: dict, frames: int) -> dict:
    from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    lr = y["preprocess"]["cav_lidar_range"]
    scenes = SyntheticScenes(**{**PIXOR_SCENES, "num_frames": frames},
                             lidar_range=lr)
    return IntermediateFusionBatcher(
        max_cav=5, max_points=30000, max_objects=100, lidar_range=lr,
        comm_range=y.get("comm_range", 70.0)).assemble(
        [scenes[i] for i in range(frames)])


def pixor_recordings() -> dict:
    """pixor.pth and pixor_inter.pth on CUDA against their recordings
    (their 8-channel rasters driven through the backbone and header),
    within tests/test_ckpt_import.py's bound, 2e-3 of each map's largest.
    Returns each map's error as a share of the bound."""
    from coalign_tpu_torch.models.pixor import attentive_agent_fusion
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.utils.weights import load_pth
    out = {}
    for tag, core in (("pixor", "pixor"), ("pixor_inter",
                                           "pixor_intermediate")):
        io = np.load(os.path.join(GOLDEN, f"{tag}_io.npz"))
        geom = {"L1": -9.6, "L2": 9.6, "W1": -9.6, "W2": 9.6, "H1": -3.0,
                "H2": -0.2, "res": 0.4}
        model = build_model({"core_method": core, "args": {
            "geometry_param": geom, "use_bn": True}})
        load_pth(model, os.path.join(GOLDEN, f"{tag}.pth"))
        bev = torch.from_numpy(io["bev"]).cuda()
        with torch.no_grad():
            if tag == "pixor":
                feat = model.backbone(bev)
            else:
                mask = torch.ones(1, 2, dtype=torch.bool, device="cuda")
                feat = model.backbone.decode(*[
                    attentive_agent_fusion(c, mask)
                    for c in model.backbone.encode(bev)])
            cls, reg = model.header(feat)
        for key, got in (("cls", cls), ("reg", reg)):
            ref = io[key]
            rel = float(np.abs(got.cpu().numpy() - ref).max()
                        / np.abs(ref).max())
            check(rel < 2e-3, f"{tag} {key}: {rel:.2e} of its largest")
            out[f"{tag}_{key}"] = rel / 2e-3
    return out


def pixor_check(card) -> dict:
    """The pixor phase: pixor_intermediate.yaml at its full raster (704 x
    400 x 21, 5 agents of ~30,000 points, B = 1) with pixor_inter.pth
    (pixor_setup): CUDA against the CPU, maps within 2e-3 of each map's
    largest and the same box set (match_box_sets' bounds) through
    make_infer_fn's dense branch, on a cls head spread as
    spread_cls_scores does when the checkpoint decodes too few boxes on
    these scenes; 1 IoU launch a request; 20 timed requests and a profile;
    pixor_recordings on the card; then the yaml's B = 4 train step from
    scratch (its loss and AdamW, the dense labels assigned in the step):
    ms, peak memory (B = 2 if B = 4 does not fit, said so). Returns the
    IoU launches of a request and a train step."""
    from coalign_tpu_torch.config.yaml_utils import load_yaml
    from coalign_tpu_torch.inference import (dense_post_process,
                                             make_infer_fn, to_device)
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.ops.bev_raster import BevSpec
    from coalign_tpu_torch.postprocess.dense_bev import DenseBevSpec
    from coalign_tpu_torch.train import build_optimizer, make_train_step
    from coalign_tpu_torch.runtime import configure_cuda
    configure_cuda()            # full float32 before the first forward
    y = load_yaml(os.path.join(HYPES_ROOT, f"{PIXOR_YAML}.yaml"))
    spec = DenseBevSpec(bev=BevSpec.from_config(
        y["model"]["args"]["geometry_param"]))
    post = {"target_args": y["postprocess"]["target_args"],
            "nms_thresh": y["postprocess"]["nms_thresh"],
            "gt_range": y["postprocess"]["gt_range"]}
    batch = pixor_batch(y, 1)
    built = {dev: pixor_setup(dev, y) for dev in ("cuda", "cpu")}
    models = {dev: m for dev, (m, _) in built.items()}

    def forward(dev):
        with torch.no_grad():
            return models[dev](to_device(batch, dev))

    t = time.perf_counter()
    cpu_maps = forward("cpu")
    cpu_s = time.perf_counter() - t
    thr, nms = float(post["target_args"]["score_threshold"]), float(
        post["nms_thresh"])
    tfm = torch.from_numpy(batch["transformation_matrix"])
    ref = dense_post_process(cpu_maps, tfm, spec, thr, nms)
    spread = None
    if int(ref["mask"].sum()) < BASELINE_MIN_BOXES:
        spread = spread_cls_scores(models, cpu_maps["cls_map"])
        cpu_maps = forward("cpu")
        ref = dense_post_process(cpu_maps, tfm, spec, thr, nms)
    check(int(ref["mask"].sum()) >= BASELINE_MIN_BOXES,
          f"PIXOR: {int(ref['mask'].sum())} boxes on the CPU")
    errs = _map_errors(forward("cuda"), cpu_maps)
    for key, e in errs.items():
        check(e["rel_err"] < 2e-3, f"PIXOR {key}: {e}")
    infer = make_infer_fn(models["cuda"], spec, post)
    infer(batch)
    torch.cuda.reset_peak_memory_stats()
    dets, launches = counted_call(infer, batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == 1, f"{launches} IoU launches in a PIXOR request")
    counts, iou, ds = same_box_sets(dets, ref)
    phase("pixor", config=f"coalign_tpu/hypes_yaml/{PIXOR_YAML}.yaml",
          raster=[spec.bev.nx, spec.bev.ny, spec.bev.nz + 1], agents=5,
          points_per_agent=int(batch["point_mask"][0].sum(-1).max()),
          checkpoint="pixor_inter.pth", seeded_keys=built["cpu"][1],
          cls_spread=spread, cpu_forward_s=cpu_s, map_errors=errs,
          boxes=counts, min_matched_iou=iou, max_score_diff=ds,
          rotated_iou_launches=launches, peak_mem_gib=peak,
          **timed_requests(infer, batch), card=card)
    phase("pixor_recordings", bound_ratio=pixor_recordings(), card=card)
    del models, built, infer
    torch.cuda.empty_cache()

    for batch_size in (TRAIN_BATCH, 2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            model, _ = pixor_setup("cuda", y, checkpoint=False)
            opt, sched = build_optimizer(model.parameters(), y["optimizer"])
            step = make_train_step(model, build_loss(y["loss"]), spec, opt,
                                   sched)
            train_batch = pixor_batch(y, batch_size)
            warm, timed = PIXOR_TRAIN_STEPS

            def run_steps():
                terms = [step(train_batch) for _ in range(warm)]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                terms += [step(train_batch) for _ in range(timed)]
                end.record()
                return terms, start, end

            (terms, start, end), n_iou = counted_call(run_steps)
            break
        except torch.cuda.OutOfMemoryError:
            check(batch_size == TRAIN_BATCH,
                  f"the PIXOR step does not fit at B={batch_size}")
            model = opt = step = train_batch = None
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(float(v)) for t in terms for v in t.values()),
          "PIXOR: a loss term is not finite")
    check(n_iou == 0, f"PIXOR: {n_iou} IoU launches in a train step")
    ms = start.elapsed_time(end) / PIXOR_TRAIN_STEPS[1]
    phase("pixor_train", config=f"coalign_tpu/hypes_yaml/{PIXOR_YAML}.yaml",
          batch=batch_size, note=None if batch_size == TRAIN_BATCH else
          f"does not fit at B={TRAIN_BATCH}",
          timed_steps=PIXOR_TRAIN_STEPS[1], ms_per_step=ms,
          frames_per_s=batch_size * 1000.0 / ms, peak_mem_gib=peak,
          first_step={k: float(v) for k, v in terms[0].items()},
          last_step={k: float(v) for k, v in terms[-1].items()}, card=card)
    del model, opt, step, train_batch
    torch.cuda.empty_cache()
    return {"request": launches, "train_step": n_iou}


# The LSS camera family at full width: the OPV2V lss_*.yaml (read in
# place) on 5 agents of SyntheticCameraScenes' rendered rigs, 4 cameras of
# 480 x 640 each (the yamls' final_dim; focal 320 px, a 90 degree view);
# seeded weights (the three LSS recordings are held on the CPU,
# tests/test_torch_lss.py, their .pth kept out of chip copies).
LSS_RANGE = [-48.0, -48.0, -3.0, 48.0, 48.0, 1.0]
LSS_SCENES = dict(num_frames=4, num_agents=5, num_objects=20,
                  lidar_range=LSS_RANGE, points_per_object=8,
                  ground_points=8, seed=31, cam_hw=(480, 640), num_cams=4,
                  focal=320.0)
LSS_YAML = "lss_coalign_fusion"
LSS_SINGLES = ("lss_single_efficientnet", "lss_single_resnet101")
LSS_REQUESTS = 20
LSS_TRAIN_STEPS = (3, 5)                  # warm-up, timed
LSS_MAP_BOUND = 2e-3                      # of each map's largest magnitude
# the tiny LSS of tests/test_torch_lss.py's sizes, for the step parity,
# with lss_single_resnet101.yaml's camera encoder: EfficientNet-b0's expand
# convs follow a train-mode batch norm (a zero-mean input), so their norms'
# running means are 0 in exact arithmetic and rounding noise on either
# device, which train_parity's relative bound on the statistics cannot hold
LSS_TINY_RANGE = [-8.0, -8.0, -3.0, 8.0, 8.0, 1.0]
LSS_TINY = {"core_method": "lift_splat_shoot_intermediate", "args": {
    "camera_encoder": "Resnet101",
    "grid_conf": {"xbound": [-8, 8, 0.4], "ybound": [-8, 8, 0.4],
                  "zbound": [-10, 10, 20.0], "ddiscr": [2, 10, 8],
                  "mode": "LID"},
    "data_aug_conf": {"final_dim": [64, 96]}, "img_features": 16,
    "anchor_number": 2, "supervise_single": True,
    "fusion_args": {"core_method": "att_ms", "att": {"feat_dim": 128}}}}
LSS_TINY_ANCHORS = {"W": 40, "H": 40, "l": 3.9, "w": 1.6, "h": 1.56,
                    "r": [0, 90], "vw": 0.4, "vh": 0.4, "feature_stride": 2,
                    "cav_lidar_range": LSS_TINY_RANGE}
LSS_TINY_LOSS = {"core_method": "point_pillar_loss", "args": {
    k: v for k, v in E2E_LOSS.items() if k != "dir"}}
# OPV2V's camera images are 600 x 800, resized to final_dim on the host
CAMERA_DISK_HW = (600, 800)
CAMERA_DISK_FRAMES = 4


def lss_params(name: str) -> dict:
    from coalign_tpu_torch.config.yaml_utils import load_yaml
    return load_yaml(os.path.join(HYPES, f"{name}.yaml"))


def lss_batch(frames: int = 1, max_cav: int = 5) -> dict:
    """CameraBatcher's batch of the first ``frames`` LSS_SCENES frames."""
    from coalign_tpu_torch.data.camera_batch import CameraBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticCameraScenes
    scenes = SyntheticCameraScenes(**LSS_SCENES)
    return CameraBatcher(max_cav=max_cav, num_cams=4, final_dim=(480, 640),
                         lidar_range=LSS_RANGE).assemble(
        [scenes[i] for i in range(frames)])


def lss_cells_check() -> dict:
    """Fault 12 on the card: the splat's cells (ops/lss.splat_cells) of the
    full-width geometry, lss_coalign_fusion.yaml's frustum (48 LID bins at
    60 x 80) through the 5 agents' rigs of LSS_SCENES (4.6M points), and of
    1M points on and one ulp beside the x and z cell boundaries, CUDA equal
    to the CPU."""
    from coalign_tpu_torch.ops.lss import LSSSpec, get_geometry, splat_cells
    args = lss_params(LSS_YAML)["model"]["args"]
    spec = LSSSpec.from_config(args["grid_conf"], args["data_aug_conf"])
    cams = {k: torch.from_numpy(v[0]) for k, v in
            lss_batch()["image_inputs"].items() if k != "imgs"}
    geom = get_geometry(torch.from_numpy(spec.frustum()), cams["rots"],
                        cams["trans"], cams["intrins"], cams["post_rots"],
                        cams["post_trans"])
    rng = np.random.default_rng(12)
    plane = rng.uniform(LSS_RANGE[:3], LSS_RANGE[3:], (1_000_000, 3)).astype(
        np.float32)
    edges = np.float32(-48.0) + np.float32(0.4) * np.arange(
        241, dtype=np.float32)
    x = edges[rng.integers(0, 241, 500_000)]
    side = rng.integers(0, 3, 500_000)          # on, below, above
    plane[:500_000, 0] = np.where(side == 0, x, np.nextafter(
        x, np.where(side == 1, -np.inf, np.inf).astype(np.float32)))
    z = np.float32(-10.0)                       # the grid's bottom z
    plane[500_000:, 2] = np.where(side == 0, z, np.nextafter(
        z, np.where(side == 1, -np.inf, np.inf).astype(np.float32)))
    out = {}
    for name, pts in (("frustum", geom), ("boundary_plane",
                                          torch.from_numpy(plane)[None])):
        want = splat_cells(pts, spec)
        got = splat_cells(pts.cuda(), spec).cpu()
        torch.cuda.synchronize()
        out[name] = {"points": int(want.numel()),
                     "in_grid": int((want < pts.shape[0] * spec.nz * spec.ny
                                     * spec.nx).sum()),
                     "cells_differing": int((got != want).sum())}
        check(torch.equal(got, want), f"lss cells {name}: "
              f"{out[name]['cells_differing']} differ on the card")
    out["equal"] = True
    return out


class _FixedMaps(torch.nn.Module):
    """A model that gives precomputed maps: the CPU reference's
    post-processing without a second CPU forward."""

    def __init__(self, maps: dict):
        super().__init__()
        self.maps = maps

    def forward(self, batch):
        return self.maps


def lss_parity(name: str, batch: dict) -> tuple:
    """The yaml ``name``'s LSS model (seed 0) on ``batch``, CUDA against
    the CPU: every map within LSS_MAP_BOUND of its largest magnitude, and
    the same box set (match_box_sets' bounds) through the yaml's fusion
    protocol (make_fusion_infer_fn; late for the single-agent yamls). A
    seeded LSS's maps are ~1e-8 (EfficientNet's squeeze gates and swishes
    shrink its features block by block), so every score ties at 0.5: the
    cls head is rescaled as the SECOND phase's (spread_cls_scores) and the
    boxes compared at separated_threshold's score, at least
    BASELINE_MIN_BOXES of them on the CPU. Returns (the fields, the CUDA
    infer fn at that threshold, the CUDA model)."""
    from coalign_tpu_torch.inference import make_fusion_infer_fn, to_device
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.runtime import configure_cuda
    from coalign_tpu_torch.tools.run import postprocess_cfg
    configure_cuda()
    params = lss_params(name)
    post = postprocess_cfg(params)
    fusion = params["fusion"]["core_method"]
    anchors = generate_anchor_box(post["anchor_args"])
    models = {dev: build_model(params["model"], device=dev, seed=0)
              for dev in ("cuda", "cpu")}
    with torch.no_grad():
        shift = spread_cls_scores(
            models, models["cuda"](to_device(batch, "cuda"))["cls_preds"])
        cuda_maps = models["cuda"](to_device(batch, "cuda"))
        t = time.perf_counter()
        cpu_maps = models["cpu"](to_device(batch, "cpu"))
        cpu_s = time.perf_counter() - t
    map_err = {}
    for key, want in cpu_maps.items():
        got = cuda_maps[key].float().cpu()
        check(bool(torch.isfinite(got).all()), f"{name} {key} not finite")
        map_err[key] = float((got - want).abs().max()
                             / want.abs().max().clamp_min(1e-30))
        check(map_err[key] < LSS_MAP_BOUND,
              f"{name} {key}: CUDA vs CPU {map_err[key]:.2e}")
    scores = torch.sigmoid(cuda_maps["cls_preds"].permute(0, 2, 3, 1)
                           .flatten(1)).cpu()
    cpu_scores = torch.sigmoid(cpu_maps["cls_preds"].permute(0, 2, 3, 1)
                               .flatten(1))
    score_diff = float((scores - cpu_scores).abs().max())
    # the seeded boxes are the anchors (reg ~0), which the NMS thins: more
    # candidates until BASELINE_MIN_BOXES survive it, at a threshold ten
    # times the devices' largest score difference from every score
    for least in (48, 128, 256, 480):
        threshold, margin = separated_threshold(
            scores, float(post["target_args"]["score_threshold"]), least,
            min_gap=max(10 * score_diff, 1e-6))
        cfg = {**post, "target_args": {**post["target_args"],
                                       "score_threshold": threshold}}
        ref = make_fusion_infer_fn(_FixedMaps(cpu_maps), anchors, cfg,
                                   fusion, device="cpu")(batch)
        if int(ref["mask"].sum()) >= BASELINE_MIN_BOXES:
            break
    check(int(ref["mask"].sum()) >= BASELINE_MIN_BOXES,
          f"{name}: {int(ref['mask'].sum())} boxes at score {threshold}")
    infer = make_fusion_infer_fn(models["cuda"], anchors, cfg, fusion)
    counts, worst_iou, worst_ds = same_box_sets(infer(batch), ref)
    return ({"yaml": name, "core_method": params["model"]["core_method"],
             "fusion": fusion, "cpu_forward_s": cpu_s,
             "score_threshold": threshold, "threshold_margin": margin,
             "candidates_at_least": least,
             "max_score_diff_maps": score_diff,
             "yaml_score_threshold":
                 float(post["target_args"]["score_threshold"]),
             "cls_scale_shift": shift,
             "map_max_rel_err": map_err, "boxes": counts[0],
             "min_matched_iou": worst_iou, "max_score_diff": worst_ds},
            infer, models["cuda"])


def lss_check(card) -> tuple:
    """The lss phase: lss_coalign_fusion.yaml at full width on LSS_SCENES'
    first frame (B = 1, 5 agents, 20 images of 480 x 640): lss_parity,
    then one request with its IoU-kernel launches counted (exactly 1) and
    its peak memory, LSS_REQUESTS timed requests (CUDA events) and a
    profile by stage (camera_trunk, lift, splat, bev_encoder with its
    fusion, heads, post_process); then lss_single, one line for each of
    LSS_SINGLES (late fusion: 2 IoU launches). Returns (the launches of an
    LSS request, the infer fn, its model, the batch)."""
    batch = lss_batch()
    fields, infer, model = lss_parity(LSS_YAML, batch)
    torch.cuda.reset_peak_memory_stats()
    _, launches = counted_call(infer, batch)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches == 1, f"{launches} IoU launches in an LSS request")
    ms = event_ms(lambda: infer(batch), reps=LSS_REQUESTS)
    phase("lss", **fields, agents=5, cameras=4, image_hw=[480, 640],
          frustum_points=5 * 4 * 48 * 60 * 80, rotated_iou_launches=launches,
          peak_mem_gib=peak, requests=LSS_REQUESTS, ms_per_frame=ms,
          frames_per_s=1000.0 / ms, card=card)
    phase("lss_profile", **profile_calls(lambda: infer(batch)), card=card)
    single_launches = {}
    for name in LSS_SINGLES:
        fields, single, _ = lss_parity(name, batch)
        _, n = counted_call(single, batch)
        check(n == 2, f"{n} IoU launches in a late {name} request")
        single_launches[name] = n
        phase("lss_single", **fields, rotated_iou_launches=n,
              ms_per_frame=event_ms(lambda: single(batch), reps=5),
              card=card)
        del single
    torch.cuda.empty_cache()
    return {"request": launches, **single_launches}, infer, model, batch


def _lss_tiny_batch() -> dict:
    """Two frames of 2 agents of rendered 64 x 96 views (LSS_TINY's
    sizes) with their gt, for the step parity."""
    from coalign_tpu_torch.data.camera_batch import CameraBatcher
    from coalign_tpu_torch.data.synthetic import SyntheticCameraScenes
    scenes = SyntheticCameraScenes(
        num_frames=2, num_agents=2, num_objects=4, lidar_range=LSS_TINY_RANGE,
        points_per_object=8, ground_points=8, seed=13, cam_hw=(64, 96),
        num_cams=2, focal=48.0)
    return CameraBatcher(max_cav=2, num_cams=2, final_dim=(64, 96),
                         max_objects=8, lidar_range=LSS_TINY_RANGE).assemble(
        [scenes[0], scenes[1]])


def lss_train(card) -> int:
    """The lss_train phase: lss_coalign_fusion.yaml's B = 4 train step at
    full width from scratch (its loss, Adam with weight decay, schedule;
    the camera encoder frozen, as the yaml's model does), LSS_TRAIN_STEPS
    warm-up and timed steps (CUDA events, on cuDNN's heuristic algorithms,
    NO_AUTOTUNE_TRAIN): ms, peak memory, the first and
    last loss terms, no IoU launch; then lss_train_parity, the tiny LSS's
    step on CUDA against the CPU (train_parity's bounds). Returns the IoU
    launches of a step."""
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
    from coalign_tpu_torch.train import build_optimizer, make_train_step
    params = lss_params(LSS_YAML)
    post = params["postprocess"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(params["model"], seed=0)
    opt, sched = build_optimizer(model.parameters(), params["optimizer"],
                                 params.get("lr_scheduler"))
    step = make_train_step(model, build_loss(params["loss"]),
                           make_anchor_spec(post["anchor_args"],
                                            post["target_args"]), opt, sched)
    batch = lss_batch(frames=TRAIN_BATCH)
    warm, timed = LSS_TRAIN_STEPS
    # after make_train_step, whose configure_cuda turns it on
    autotune = LSS_YAML not in NO_AUTOTUNE_TRAIN
    torch.backends.cudnn.benchmark = autotune

    def run():
        terms = [step(batch) for _ in range(warm)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        terms += [step(batch) for _ in range(timed)]
        end.record()
        return terms, start, end

    try:
        (terms, start, end), n_iou = counted_call(run)
    finally:
        torch.backends.cudnn.benchmark = True
    ms = start.elapsed_time(end) / timed
    check(all(np.isfinite(float(v)) for t in terms for v in t.values()),
          "lss_train: a loss term is not finite")
    check(n_iou == 0, f"lss_train: {n_iou} IoU launches in a train step")
    phase("lss_train", config=LSS_YAML, batch=TRAIN_BATCH, agents=5,
          cudnn_autotune=autotune, timed_steps=timed, ms_per_step=ms,
          frames_per_s=TRAIN_BATCH * 1000.0 / ms,
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
          first_step={k: float(v) for k, v in terms[0].items()},
          last_step={k: float(v) for k, v in terms[-1].items()}, card=card)
    del model, opt, step, batch
    torch.cuda.empty_cache()
    phase("lss_train_parity", **train_parity(
        _lss_tiny_batch(), LSS_TINY, LSS_TINY_LOSS,
        anchor_args=LSS_TINY_ANCHORS))
    return n_iou


def camera_disk_check(card) -> dict:
    """The camera_disk phase: an OPV2V camera fixture tree written by the
    port (data/fixtures.py, PNGs by data/image_io.write_png) of
    CAMERA_DISK_FRAMES frames of 5 agents, 4 cameras of 600 x 800 (OPV2V's
    size) each; the host's read-and-decode ms a frame (the reader and the
    camera batcher at B = 1: 20 PNGs decoded and resized to 480 x 640);
    then run inference of a reference-style run directory of
    lss_coalign_fusion.yaml on it (seed-0 weights): frames/s of the whole
    command and of its eval loop, 1 IoU launch a frame. Returns the IoU
    launches a CLI frame."""
    from coalign_tpu_torch.config.yaml_utils import save_yaml
    from coalign_tpu_torch.data import build_dataset
    from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
    from coalign_tpu_torch.data.synthetic import SyntheticScenes
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.tools import run
    import shutil
    work = os.path.join(ROOT, "coalign_tpu_torch", "_build", "camera_disk")
    shutil.rmtree(work, ignore_errors=True)
    t = time.perf_counter()
    tree = write_opv2v_fixture(
        os.path.join(work, "tree"), SyntheticScenes(
            num_frames=CAMERA_DISK_FRAMES, num_agents=5, num_objects=20,
            lidar_range=LSS_RANGE, points_per_object=8, ground_points=8,
            seed=41), frames_per_scenario=CAMERA_DISK_FRAMES,
        with_cameras=True, cam_hw=CAMERA_DISK_HW)
    write_s = time.perf_counter() - t
    params = lss_params(LSS_YAML)
    params.update(root_dir=tree, validate_dir=tree, test_dir=None)
    base, batcher = build_dataset(params, train=False)
    t = time.perf_counter()
    for i in range(len(base)):
        batcher.assemble([base[i]])
    read_ms = (time.perf_counter() - t) * 1e3 / len(base)
    ckpt = os.path.join(work, "seed0.pth")
    torch.save(build_model(params["model"], device="cpu", seed=0)
               .state_dict(), ckpt)
    run_dir = write_run_dir(os.path.join(work, "run"), params, ckpt)
    t = time.perf_counter()
    (res, text), launches = counted_call(
        cli, run.main, ["inference", "--model_dir", run_dir])
    cli_s = time.perf_counter() - t
    check('"loaded_checkpoint": "net_epoch1.pth"' in text,
          "camera_disk: the checkpoint was not loaded")
    check(res["frames"] == CAMERA_DISK_FRAMES
          and launches == CAMERA_DISK_FRAMES,
          f"camera_disk: {launches} IoU launches over {res['frames']} "
          "frames")
    save_yaml(res, os.path.join(work, "eval.yaml"))
    phase("camera_disk", frames=CAMERA_DISK_FRAMES, agents=5, cameras=4,
          image_hw=list(CAMERA_DISK_HW), final_hw=[480, 640],
          write_s=write_s, host_read_decode_ms_per_frame=read_ms,
          cli_s=cli_s, cli_frames_per_s=CAMERA_DISK_FRAMES / cli_s,
          eval=res, rotated_iou_launches=launches, card=card)
    return launches / CAMERA_DISK_FRAMES


def bf16_check(card, lss: tuple, tiny) -> dict:
    """The bf16 phase: the full-width flagship (fullscale_multiscale.pth, the
    recorded frame) and the LSS request (``lss``: its infer fn, model and
    batch), each in float32 and under set_compute_dtype(torch.bfloat16):
    ms a request (CUDA events, 20 requests) in each, the mean relative
    distance of cls_preds (mean |bf16 - f32| / mean |f32|), held below
    tests/test_bf16.py's 0.15, every map finite and the heads' outputs
    float32; the IoU launches of a bf16 request and its profile by stage;
    then the AP30/50/70 of the
    train_ap phase's trained tiny flagship (``tiny``) in bf16 beside its
    float32 AP, reported, not held. The policy is set back to
    None afterwards, whatever happens. Returns the IoU launches of the bf16
    requests."""
    from coalign_tpu_torch.inference import make_infer_fn, to_device
    from coalign_tpu_torch.models.layers import set_compute_dtype
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.utils.weights import load_pth
    lss_infer, lss_model, lss_in = lss
    batch, io = fullscale_batch()
    model = build_model({"core_method": "point_pillar_baseline_multiscale",
                         "args": FULL_ARGS})
    load_pth(model, os.path.join(GOLDEN, "fullscale_multiscale.pth"))
    infer = make_infer_fn(model, generate_anchor_box(FULL_ANCHORS), {
        "target_args": {"score_threshold": float(io["score_threshold"])},
        "nms_thresh": float(io["nms_thresh"]),
        "gt_range": FULL_ARGS["lidar_range"], "dir_args": FULL_ARGS["dir_args"],
        "max_num": 100})
    out, launches = {}, {}
    try:
        for name, m, fn, b in (("flagship", model, infer, batch),
                               ("lss", lss_model, lss_infer, lss_in)):
            maps, ms = {}, {}
            for policy in (None, torch.bfloat16):
                set_compute_dtype(policy)
                key = "bf16" if policy else "float32"
                with torch.no_grad():
                    maps[key] = m(to_device(b, "cuda"))
                ms[key] = event_ms(lambda: fn(b), reps=20)
            _, launches[name] = counted_call(fn, b)
            prof = profile_calls(lambda: fn(b))
            set_compute_dtype(None)
            for k, v in maps["bf16"].items():
                if k.endswith("_preds") or k.endswith("_preds_single"):
                    check(v.dtype == torch.float32,
                          f"bf16 {name} {k} is {v.dtype}")
                check(bool(torch.isfinite(v.float()).all()),
                      f"bf16 {name} {k} not finite")
            a, b16 = maps["float32"]["cls_preds"], maps["bf16"]["cls_preds"]
            dist = float((b16 - a).abs().mean() / a.abs().mean())
            check(dist < 0.15, f"bf16 {name}: cls_preds distance {dist:.3f}")
            out[name] = {"ms_float32": ms["float32"], "ms_bf16": ms["bf16"],
                         "speedup": ms["float32"] / ms["bf16"],
                         "cls_preds_mean_rel_dist": dist,
                         "rotated_iou_launches_bf16": launches[name],
                         "bf16_profile": {k: prof[k] for k in (
                             "stages", "device_kernel_ms",
                             "device_busy_share", "device_kernel_launches",
                             "top_kernels")}}
        ap = {}
        from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
        from coalign_tpu_torch.data.synthetic import SyntheticScenes
        from coalign_tpu_torch.inference import evaluate, gt_corners
        from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
        scenes = SyntheticScenes(**E2E_SCENES)
        eb = IntermediateFusionBatcher(**E2E_BATCHER).assemble(
            [scenes[0], scenes[1]])
        spec = make_anchor_spec(E2E_ANCHORS, E2E_POSTPROCESS["target_args"])
        tiny_infer = make_infer_fn(tiny, spec.anchors, E2E_POSTPROCESS)
        for policy in (None, torch.bfloat16):
            set_compute_dtype(policy)
            ap["bf16" if policy else "float32"] = evaluate(
                tiny_infer, [dict(eb, gt_corners=gt_corners(eb))])
    finally:
        set_compute_dtype(None)
    phase("bf16", **out, train_ap_tiny_flagship=ap, card=card)
    return launches


# ---------------------------------------------------------------------------
# The two-stage models: FPV-RCNN and FVoxelRCNN.

FPV_YAMLS = ("fpvrcnn", "fvoxelrcnn")
FPV_MAP_BOUND = 2e-3                      # of each map's largest magnitude
FPV_MIN_BOXES = 10
FPV_TRAIN_STEPS = (1, 3)                  # warm-up, timed
# requests in each model's profile: an FPV-RCNN request launches ~32,600
# kernels (FPS's 4,095 steps), and torch.profiler took 131 s to record and
# read 5 of them, which the script's 1,200 s cannot spare (1,153 s with 5,
# 1,156 s with 2 on a slow host)
FPV_PROFILE_REQUESTS = {"fpvrcnn": 1, "fvoxelrcnn": PROFILE_REQUESTS}
FPV_STAGE1_PREFILTER = 256                # models/fpvrcnn.py's top-K
# stage-1 candidates over the 5 agent frames, at least
FPV_STAGE1_CANDIDATES = 300
# a stage-1 threshold's least distance, in logits, to every logit, and
# the least gap at a frame's top-K cut: ~50x the devices' largest
# difference of the spread logits (~4e-6 of a map's largest, ~10)
FPV_LOGIT_GAP = 2e-3
# the tiny FPV-RCNN of fpvrcnn_parity: second_parity's SECOND-SSFA trunk
# with tests/test_fpvrcnn.py's keypoint stage 2. Its seeded trunk's logits
# are ~1e-6, every score 0.5 within rounding, so stage 1 keeps no box at a
# threshold of 0.99 (the order of tied scores is the devices' rounding;
# spreading them made the step's focal loss ~1e7 and its gradients
# ill-conditioned): the keypoints and their norms train, the RoI grids run
# on empty masks; the fpvrcnn phase holds the RoI path at full width
FPV_TINY = {"core_method": "fpvrcnn", "args": {
    **SECOND_TINY_ARGS, "anchor_args": SECOND_TINY_ANCHORS,
    "stage1_postprocess": {"score_threshold": 0.99, "nms_thresh": 0.15,
                           "max_boxes": 8},
    "max_rois": 8, "roi_hidden": 32,
    "vsa": {"enlarge_selection_boxes": True, "num_keypoints": 64,
            "num_out_features": 16,
            "sa_layer": {"raw_points": {"mlps": [[8, 8], [8, 8]],
                                        "pool_radius": [0.4, 0.8],
                                        "n_sample": [8, 8]}}},
    "roi_head": {"roi_grid_pool": {"grid_size": 4,
                                   "mlps": [[16, 16], [16, 16]],
                                   "pool_radius": [0.8, 1.6],
                                   "n_sample": [8, 8]}}}}
FPV_TINY_LOSS = {"core_method": "fpvrcnn_loss",
                 "args": {**E2E_LOSS, "stage2": {"stage": 2}}}


def fpv_stage1_threshold(models: dict, batch: dict) -> dict:
    """Spread the seeded models' stage-1 scores (a seeded trunk's logits
    are ~1e-5 apart, and every score ties at 0.5 within float32): an
    affine map of each anchor's logits, alike on both devices, that puts
    its empty cells' logit (the most frequent) at -5 and, of every real
    agent frame's 256th largest (the stage-1 top-K), the largest at 0
    (score 0.5). A frame's logits can be ten times another's (a frame of
    fewer points), so spread_cls_scores' one rank over all frames squeezed
    that frame's top towards score 1.
    Then set in both models the lowest stage-1 score threshold whose logit
    lies more than FPV_LOGIT_GAP from every logit of the card's and at
    which every real agent frame either has fewer candidates than the
    top-K or a gap of FPV_LOGIT_GAP between its 256th and 257th logit (the
    top-K's cut is then the same on both devices): the most candidates, so
    that the NMS keeps boxes on many objects (an object's ~24 anchors
    overlap, and the NMS keeps one of them; 160 candidates at the widest
    score gap left 3 to 6 boxes). Returns the logits' scale and shifts,
    the threshold and its logit margin, and the candidates a frame (the
    top-K's at most)."""
    from coalign_tpu_torch.inference import to_device
    real = torch.as_tensor(np.asarray(batch["agent_mask"])).reshape(-1)
    frames, k = int(real.sum()), FPV_STAGE1_PREFILTER

    def logits_of():                                    # (F, H*W, A)
        with torch.no_grad():
            cls = models["cuda"](to_device(batch, "cuda"))["cls_preds_single"]
        return cls.permute(0, 2, 3, 1).flatten(1, 2).cpu()[real]

    logits = logits_of()
    empty = torch.mode(logits.flatten(0, 1), dim=0).values       # (A,)
    pivot = float(torch.topk((logits - empty).flatten(1), k,
                             dim=1).values[:, -1].max())
    scale = 5.0 / max(pivot, 1e-30)
    shift = -5.0 - scale * empty
    for model in models.values():
        conv = model.cls_head
        with torch.no_grad():
            conv.weight.mul_(scale)
            conv.bias.mul_(scale).add_(shift.to(conv.bias.device))
    logits = logits_of().flatten(1)
    top = torch.topk(logits, k + 1, dim=1).values
    cut_ok = top[:, k - 1] - top[:, k] > FPV_LOGIT_GAP           # (F,)
    per_frame = torch.sort(logits, dim=1).values
    values = torch.unique(logits)                          # ascending
    mids = (values[:-1] + values[1:]) / 2
    gaps = (values[1:] - values[:-1]) / 2
    counts = logits.shape[1] - torch.searchsorted(
        per_frame, mids[None].expand(frames, -1).contiguous(), right=True)
    ok = (((counts < k) | cut_ok[:, None]).all(0) & (gaps > FPV_LOGIT_GAP))
    check(bool(ok.any()), "no separated stage-1 score threshold")
    best = int(torch.nonzero(ok)[0])
    kept = torch.clamp(counts[:, best], max=k)
    check(int(kept.sum()) >= FPV_STAGE1_CANDIDATES,
          f"stage-1 candidates {kept.tolist()}")
    threshold = float(torch.sigmoid(mids[best]))
    post = models["cuda"].args["stage1_postprocess"]
    for model in models.values():
        model.args["stage1_postprocess"] = {**post,
                                            "score_threshold": threshold}
    return {"cls_scale_shift": [scale, shift.tolist()],
            "stage1_score_threshold": threshold,
            "stage1_threshold_logit_margin": float(gaps[best]),
            "stage1_candidates_per_frame": kept.tolist()}


def fpv_parity(name: str, batch: dict) -> tuple:
    """The yaml ``name``'s model at full width, seeded (seed 0), on CUDA
    and on the CPU (fpv_stage1_threshold's cls head and stage-1
    threshold)
    through make_infer_fn on ``batch``: the stage-1 maps, ``rois``,
    ``boxes_refined`` and ``roi_cls`` within FPV_MAP_BOUND of each map's
    largest, ``roi_mask`` and the stage-1 validity equal, the final box sets
    at match_box_sets' bounds (fpvrcnn_check holds at least FPV_MIN_BOXES
    of them, after printing the line). Returns (the fields, the CUDA infer
    fn, its model)."""
    from coalign_tpu_torch.inference import make_infer_fn
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.tools.run import postprocess_cfg
    y = second_yaml(name)
    models = {dev: build_model(y["model"], device=dev, seed=0)
              for dev in ("cuda", "cpu")}
    stage1 = fpv_stage1_threshold(models, batch)
    post = postprocess_cfg(y)
    anchors = generate_anchor_box(post["anchor_args"])
    infer, ref = (make_infer_fn(models[dev], anchors, post, device=dev)
                  for dev in ("cuda", "cpu"))
    outs = {"cuda": {}, "cpu": {}}
    hooks = [models[dev].register_forward_hook(
        lambda mod, inputs, out, d=dev: outs[d].update(out))
        for dev in outs]
    got = infer(batch)
    t = time.perf_counter()
    want = ref(batch)
    cpu_s = time.perf_counter() - t
    for hook in hooks:
        hook.remove()
    for key in ("stage1_valid", "roi_mask"):
        check(torch.equal(outs["cuda"][key].cpu(), outs["cpu"][key]),
              f"{name} {key}: CUDA and the CPU differ")
    keys = [k for k in outs["cpu"] if k.endswith("_single")] + [
        "stage1_boxes", "rois", "boxes_refined", "roi_cls"]
    errs = _map_errors({k: outs["cuda"][k] for k in keys},
                       {k: outs["cpu"][k] for k in keys})
    for key, e in errs.items():
        check(e["rel_err"] <= FPV_MAP_BOUND, f"{name} {key}: CUDA vs CPU {e}")
    counts, worst_iou, worst_ds = same_box_sets(got, want)
    out = outs["cuda"]
    fields = {"config": name, "core_method": y["model"]["core_method"],
              "grid": [models["cuda"].spec.nz, models["cuda"].spec.ny,
                       models["cuda"].spec.nx],
              "agents": int(np.asarray(batch["agent_mask"]).sum()),
              "points_per_agent": np.asarray(batch["point_mask"]).sum(
                  -1)[np.asarray(batch["agent_mask"])].tolist(),
              "voxel_cap": models["cuda"].voxel_cap(),
              **stage1,
              "stage1_boxes": int(out["stage1_valid"].sum()),
              "rois": int(out["roi_mask"].sum()), "map_err": errs,
              "cpu_request_s": cpu_s, "boxes": counts,
              "min_matched_iou": worst_iou, "max_score_diff": worst_ds}
    del models["cpu"], ref
    return fields, infer, models["cuda"]


def fpv_request(card, name: str, batch: dict) -> tuple:
    """fpv_parity, then one counted request (2 IoU launches: the stage-1
    NMS of the 5 agent frames, the refined NMS), its peak memory, 20 timed
    requests and a profile over FPV_PROFILE_REQUESTS of them
    (timed_requests). Returns (the fields, the
    launches, the NMS inputs of the counted request, the CUDA model)."""
    fields, infer, model = fpv_parity(name, batch)
    torch.cuda.reset_peak_memory_stats()
    captured, restore = _capture_iou_inputs()
    try:
        _, launches = counted_call(infer, batch)
    finally:
        restore()
    check(launches == 2, f"{launches} IoU launches in a {name} request")
    fields.update(rotated_iou_launches=launches,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  **timed_requests(infer, batch, FPV_PROFILE_REQUESTS[name]),
                  card=card)
    return fields, launches, captured, model


def matcher_ms(model, batch: dict) -> dict:
    """The plain matcher at the request's shape: the stage-1 boxes (1, L *
    32, 7) of ``batch`` through boxes_iou3d_matrix (the 'ref' path's
    intersection areas, which the kernel does not return) and the whole
    match_and_fuse, device ms (profiler) and call ms (CUDA events)."""
    from coalign_tpu_torch.inference import to_device
    from coalign_tpu_torch.models.matcher import (boxes_iou3d_matrix,
                                                  match_and_fuse)
    with torch.no_grad():
        out = model(to_device(batch, "cuda"))
    boxes, scores, valid = (out[k] for k in ("stage1_boxes",
                                             "stage1_scores",
                                             "stage1_valid"))
    args = model.args

    def fuse():
        return match_and_fuse(boxes, scores, valid,
                              args.get("matcher_iou", 0.1),
                              args.get("max_rois", 32),
                              gt_range=args["lidar_range"])
    return {"shape": list(boxes.shape),
            "iou3d_device_ms": device_ms(lambda: boxes_iou3d_matrix(boxes),
                                         10),
            "iou3d_call_ms": event_ms(lambda: boxes_iou3d_matrix(boxes), 20),
            "match_and_fuse_device_ms": device_ms(fuse, 5),
            "match_and_fuse_call_ms": event_ms(fuse, 10)}


def fpvrcnn_check(card) -> tuple:
    """The fpvrcnn and fvoxelrcnn phases: opv2v/fpvrcnn.yaml at full width
    (41 x 800 x 2816 at 0.1 m, the 70,000-voxel eval cap, 4,096 keypoints
    and 32 stage-1 boxes an agent, 32 RoIs, 6 x 6 RoI grids) on 5
    synthetic agents of ~30,000 points (second_batch), fpv_request, with
    the matcher's ms (matcher_ms); then fvoxelrcnn.yaml on the same batch.
    Returns ({name: IoU launches a request}, the FPV-RCNN request's NMS
    inputs: the stage-1 (5, 256) and the refined (1, 32))."""
    from coalign_tpu_torch.runtime import configure_cuda
    configure_cuda()
    batch = second_batch("fpvrcnn")
    launches, shapes = {}, None
    for name in FPV_YAMLS:
        fields, launches[name], captured, model = fpv_request(card, name,
                                                              batch)
        if name == "fpvrcnn":
            shapes = captured
            fields["matcher"] = matcher_ms(model, batch)
        phase(name, **fields)
        check(fields["boxes"][0] >= FPV_MIN_BOXES,
              f"{name}: {fields['boxes'][0]} boxes")
        del model
        torch.cuda.empty_cache()
    check([list(c.shape[:2]) for c in shapes] == [[5, 256], [1, 32]],
          f"NMS inputs {[list(c.shape) for c in shapes]}")
    return launches, shapes


def fpvrcnn_train(card) -> int:
    """The fpvrcnn_train phase: fpvrcnn.yaml's model from scratch (seed 0)
    at full width with its loss (fpvrcnn_loss: stage 1 on the per-agent
    labels; its labels carry no gt boxes, so stage 2 adds no term, as in
    the JAX package), AdamW and schedule on B = 4 synthetic frames of 5
    agents, the train cap max_voxel_train 32,000, on cuDNN's heuristic
    algorithms (no autotuning); FPV_TRAIN_STEPS warm-up and timed steps
    (CUDA events): ms a step, the peak memory of the warm-up and of the
    timed steps, the first
    and last loss terms, every term finite, one IoU launch a step (the
    stage-1 NMS over the 20 agent frames); then fpvrcnn_parity, the tiny
    FPV-RCNN's step (FPV_TINY) on CUDA against the CPU at train_parity's
    bounds. Returns the IoU launches a train step."""
    from coalign_tpu_torch.data.prefetch import prefetch
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
    from coalign_tpu_torch.train import build_optimizer, make_train_step
    y = second_yaml("fpvrcnn")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(y["model"], seed=0)
    opt, sched = build_optimizer(model.parameters(), y["optimizer"],
                                 y.get("lr_scheduler"))
    post = y["postprocess"]
    step = make_train_step(model, build_loss(y["loss"]),
                           make_anchor_spec(post["anchor_args"],
                                            post["target_args"]),
                           opt, sched)
    host = second_batch("fpvrcnn", TRAIN_BATCH, train=True)
    (batch,) = list(prefetch(iter([host])))
    warm, timed = FPV_TRAIN_STEPS
    # after make_train_step, whose configure_cuda turns autotuning on: the
    # 20-frame trunk's shapes are this line's alone (the fpvrcnn phase's 5
    # frames share SECOND's), and autotuning them costs more than the line
    torch.backends.cudnn.benchmark = False
    peaks = []

    def run():
        terms = [step(batch) for _ in range(warm)]
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        terms += [step(batch) for _ in range(timed)]
        end.record()
        return terms, start, end

    try:
        (terms, start, end), n_iou = counted_call(run)
    finally:
        torch.backends.cudnn.benchmark = True
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite(float(v)) for t in terms for v in t.values()),
          "fpvrcnn: a loss term is not finite")
    per_step = n_iou / (warm + timed)
    check(per_step == 1, f"fpvrcnn: {per_step} IoU launches a train step")
    ms = start.elapsed_time(end) / timed
    phase("fpvrcnn_train", config="fpvrcnn", batch=TRAIN_BATCH,
          agent_frames=int(np.asarray(host["agent_mask"]).sum()),
          voxel_cap=model.voxel_cap(), cudnn_autotune=False,
          timed_steps=timed, ms_per_step=ms,
          frames_per_s=TRAIN_BATCH * 1000.0 / ms,
          warmup_peak_mem_gib=peaks[0], peak_mem_gib=peak,
          first_step={k: float(v) for k, v in terms[0].items()},
          last_step={k: float(v) for k, v in terms[-1].items()},
          rotated_iou_launches_per_step=per_step, card=card)
    del model, opt, step, batch, terms
    torch.cuda.empty_cache()

    phase("fpvrcnn_parity", **train_parity(
        _tiny_parity_batch(), FPV_TINY, FPV_TINY_LOSS,
        anchor_args=SECOND_TINY_ANCHORS))
    return per_step


def fpv_shapes(captured: list) -> dict:
    """time_shape of the FPV-RCNN request's two NMS inputs, the stage-1
    (5 agent frames x 256) and the refined (1 x 32), held over the pairs of
    boxes of nonzero area (a masked RoI is a zero box, whose IoUs are
    rounding noise, as late's dropped slots)."""
    from coalign_tpu_torch.utils.iou import polygon_area
    out = {}
    for name, c in zip(("fpv_stage1", "fpv_refined"), captured):
        real = polygon_area(c) > 1e-6
        out[name] = time_shape(c, real[:, :, None] & real[:, None, :])
        out[name]["boxes_of_nonzero_area"] = int(real.sum())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    from coalign_tpu_torch.inference import evaluate, make_infer_fn, to_device
    from coalign_tpu_torch.kernels import rotated_iou as K
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import generate_anchor_box
    from coalign_tpu_torch.utils.iou import rotated_iou_plain, separated_pairs
    from coalign_tpu_torch.utils.weights import load_pth

    card = card_line()
    phase("card", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    # 2. build: nvcc (the IoU kernel) and g++ (the host data plane) at once
    from concurrent.futures import ThreadPoolExecutor

    from coalign_tpu_torch import native
    t = time.time()
    with ThreadPoolExecutor(2) as pool:
        data_plane = pool.submit(native.build)
        lib, log = K.build()
        dp_lib, dp_seconds = data_plane.result()
    native_build = {"seconds": dp_seconds, "library": os.path.relpath(
        dp_lib, ROOT)}
    phase("build", seconds=round(time.time() - t, 3), library=lib.name,
          ptxas=[ln.strip() for ln in log.splitlines() if "Used" in ln
                 or "spill" in ln], data_plane=native_build)

    # 3. kernel against its plain version (1e-4: same f32 function; the
    # kernel keys its sort by a pseudo-angle instead of atan2 and nvcc
    # contracts multiply-adds, which moves results by a few ulp)
    dev = torch.device("cuda")
    cases = {}
    for name in KERNEL_CASES:
        c1, c2 = (c.to(dev) for c in kernel_cases(name))
        got = K.rotated_iou(c1, c2)
        torch.cuda.synchronize()
        cleared = separated_pairs(c1, c2)
        if name == "degenerate":
            check(not bool(cleared.any()), "a degenerate pair was cleared")
            cases[name] = {"shapes": [list(c1.shape), list(c2.shape)],
                           **check_degenerate(got, rotated_iou_plain(c1, c2))}
            continue
        self_iou = K.rotated_iou(c1, c1)
        err = (got - rotated_iou_plain(c1, c2)).abs().max().item()
        diag = (torch.diagonal(self_iou, dim1=-2, dim2=-1) - 1).abs().max()
        check(err <= 1e-4, f"kernel vs plain {name}: {err:.2e}")
        check(diag.item() <= 1e-4, f"self-IoU diagonal {name}: {diag:.2e}")
        check(bool((got[cleared] == 0).all()),
              f"{name}: a cleared pair is not exactly 0")
        if name == "all_cleared":
            check(bool(cleared.all()), "all_cleared: a pair was not cleared")
        if name == "identical":
            check((got - 1).abs().max().item() <= 1e-4,
                  "identical boxes: an IoU is not 1")
        cases[name] = {"shapes": [list(c1.shape), list(c2.shape)],
                       "max_abs_diff": err, "diag_err": diag.item(),
                       "cleared_share": float(cleared.double().mean()),
                       "overlapping_pairs": int((got > 0).sum())}
    phase("kernel", cases=cases)
    phase("periods", **periods_check(), card=card)

    # 4. full width against the reference's recording
    batch, io = fullscale_batch()
    n_agents, n_points = batch["points"].shape[1:3]
    model = build_model({"core_method": "point_pillar_baseline_multiscale",
                         "args": FULL_ARGS})
    load_pth(model, os.path.join(GOLDEN, "fullscale_multiscale.pth"))
    cfg = {"target_args": {"score_threshold": float(io["score_threshold"])},
           "nms_thresh": float(io["nms_thresh"]),
           "gt_range": FULL_ARGS["lidar_range"],
           "dir_args": FULL_ARGS["dir_args"], "max_num": 100}
    infer = make_infer_fn(model, generate_anchor_box(FULL_ANCHORS), cfg)

    # the NMS input of this frame, kept to time the kernel on it below
    captured, restore = _capture_iou_inputs()
    try:
        infer(batch)
    finally:
        restore()

    dets, launches = counted_call(infer, batch)   # the main path, counted
    check(launches >= 1, "the main path launched no rotated_iou kernel")

    with torch.no_grad():
        maps = model(to_device(batch, dev))
    map_err = {}
    for key in ("cls_preds", "reg_preds", "dir_preds"):
        got = maps[key].float().cpu().numpy()
        check(np.isfinite(got).all(), f"{key} not finite")
        check(got.shape == io[key].shape, f"{key} shape {got.shape}")
        map_err[key] = float(np.abs(got - io[key]).max())
        check(map_err[key] < 2e-3, f"{key} max err {map_err[key]:.2e}")
    dets = {k: v.cpu().numpy() for k, v in dets.items()}
    keep = dets["mask"][0]
    worst_iou, worst_ds = match_box_sets(
        dets["corners3d"][0][keep], dets["scores"][0][keep],
        io["pred_corners"], io["pred_scores"])
    phase("full", map_max_abs_err=map_err, boxes=int(keep.sum()),
          min_matched_iou=worst_iou, max_score_diff=worst_ds,
          rotated_iou_launches=launches)

    # 5. serve a few requests
    per_call = event_ms(lambda: infer(batch), reps=20, warmup=3)
    phase("serve", requests=20, ms_per_frame=per_call,
          frames_per_s=1000.0 / per_call, points_per_agent=n_points,
          agents=n_agents, canvas=[200, 704], card=card)
    phase("profile", **profile_calls(lambda: infer(batch)), card=card)

    # 8-10. CoAlign's pose correction: stage-1, the pose graph, the request
    fields, stage1, stage1_nms_input = stage1_check(card)
    phase("stage1", **fields)
    phase("posegraph", **posegraph_check(card))
    coalign, request, frame = coalign_check(card, stage1, infer)
    phase("coalign", **coalign)
    phase("coalign_profile", **profile_calls(lambda: request(frame)),
          card=card)
    del stage1, request

    # 11-12. late and early fusion at full width
    late, late_nms_input, late_candidates = late_check(card)
    phase("late", **late)
    early = early_check(card)
    phase("early", **early)

    # 14. the intermediate-fusion baselines at full width, and two of them
    # against the reference's recordings on the card
    baseline_launches = baselines_check(card)
    phase("baseline_recordings", max_abs_err=baseline_recordings(),
          card=card)

    # 16. the rest of the PointPillars fusions at full width
    rest_launches = fusions_rest_check(card)

    # 6. AP of the tiny flagship on the 10 recorded frames
    io_ap = np.load(os.path.join(GOLDEN, "e2e_ap_io.npz"))
    tiny = build_model({"core_method": "point_pillar_baseline_multiscale",
                        "args": TINY_ARGS})
    load_pth(tiny, os.path.join(GOLDEN, "coalign_multiscale.pth"))
    cfg_ap = {"target_args": {"score_threshold":
                              float(io_ap["score_threshold"])},
              "nms_thresh": float(io_ap["nms_thresh"]),
              "gt_range": TINY_ARGS["lidar_range"],
              "dir_args": TINY_ARGS["dir_args"], "max_num": 100}
    infer_ap = make_infer_fn(tiny, generate_anchor_box(TINY_ANCHORS), cfg_ap)
    frames = []
    for i in range(int(io_ap["num_frames"])):
        frame = golden_batch(io_ap, (f"ego_points_{i}", f"cav_points_{i}"),
                             io_ap[f"pairwise_{i}"], 512)
        frame["gt_corners"] = [io_ap[f"gt_corners_{i}"]]
        frames.append(frame)
    ap = evaluate(infer_ap, frames)
    for key in ("ap30", "ap50", "ap70"):
        ref = float(io_ap[key])
        check(abs(ap[key] - ref) <= 0.005,
              f"{key}: {ap[key]:.4f} vs reference {ref:.4f}")
    phase("ap", **ap, reference={k: float(io_ap[k])
                                 for k in ("ap30", "ap50", "ap70")})

    # 7. training: full width, its profile, CUDA against CPU, train to AP
    train, (model, loss, spec, batcher, scenes, step, train_batch) = \
        train_full(card)
    phase("train", **train)
    train.update(train_eval(model, loss, spec, batcher, scenes, train_batch))
    phase("train_eval", **{k: train[k] for k in (
        "val_loss", "boxes_kept", "launches_per_eval_batch")})
    phase("train_profile", **profile_calls(lambda: step(train_batch), 1),
          card=card)
    del model, step, train_batch
    phase("train_parity", **train_parity())
    gate, ap_launches = counted_call(train_to_ap)
    losses = gate.pop("losses")
    check(losses[-1] < 0.05 * losses[0],
          f"loss did not drop: {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(gate["frames"] == 2, f"evaluated {gate['frames']} frames")
    check(gate["ap30"] > 0.8 and gate["ap50"] > 0.6,
          f"AP too low after training: {gate}")
    check(ap_launches >= 1, "the AP evaluation launched no rotated_iou")
    tiny_flagship = gate.pop("model")
    phase("train_ap", steps=250, first_loss=losses[0], last_loss=losses[-1],
          loss_every_50=losses[::50], **gate,
          rotated_iou_launches=ap_launches)

    # 13. CoAlign's stage-1 training: full width, its profile, CUDA against
    # the CPU, tests/test_late_inference.py's gate, then the noise sweep
    stage1_train, step, train_batch = stage1_train_full(card)
    phase("stage1_train", **stage1_train)
    phase("stage1_train_profile",
          **profile_calls(lambda: step(train_batch), 1), card=card)
    del step, train_batch
    phase("stage1_parity", **train_parity(
        _tiny_stage1_batch(),
        {"core_method": "point_pillar_uncertainty", "args": E2E_STAGE1_ARGS},
        {"core_method": "point_pillar_uncertainty_loss", "args": E2E_LOSS}))
    tiny = stage1_to_ap()
    losses, late_ap, no_ap = tiny.pop("losses"), *tiny.pop("ap").values()
    check(late_ap["frames"] == no_ap["frames"] == 4,
          f"evaluated {late_ap['frames']} / {no_ap['frames']} frames")
    check(late_ap["ap30"] > 0.05 and late_ap["ap30"] >= no_ap["ap30"] - 0.05,
          f"stage-1 AP30: late {late_ap['ap30']:.4f}, no {no_ap['ap30']:.4f}")
    stage1_tiny = tiny.pop("stage1")
    phase("stage1_ap", steps=80, first_loss=losses[0], last_loss=losses[-1],
          late=late_ap, no=no_ap, **tiny)
    phase("noise_sweep", **sweep_check(tiny_flagship, stage1_tiny),
          card=card)

    # 22-25. the LSS camera family at full width (fault 12's cells, serving,
    # training), its camera data from disk, and the bf16 compute policy on
    # the flagship, the LSS request and the tiny flagship's AP
    phase("lss_cells", **lss_cells_check(), card=card)
    lss_launches, lss_infer, lss_model, lss_in = lss_check(card)
    lss_train_launches = lss_train(card)
    camera_disk_launches = camera_disk_check(card)
    bf16_launches = bf16_check(card, (lss_infer, lss_model, lss_in),
                               tiny_flagship)
    del tiny_flagship, stage1_tiny, lss_infer, lss_model, lss_in
    torch.cuda.empty_cache()

    # 17. their training at full width; the tiny twins' CUDA steps against
    # the CPU
    rest_train_launches = train_rest(card)
    phase("rest_parity", **rest_parity())

    # 19. the seven OPV2V baselines trained at full width; their learned
    # fusions' tiny twins on CUDA against the CPU; DiscoNet's twin to AP
    baselines_train_launches = baselines_train(card)

    # 18. the SECOND family at full width: serving, the recordings on the
    # card, training and the tiny step against the CPU's
    second_launches = second_check(card)
    phase("second_recordings", bound_ratio=second_recordings(), card=card)
    second_train_launches = second_train(card)
    phase("second_parity", **second_step_parity())

    # 26. the two-stage models on the SECOND trunk (after the SECOND
    # phases, whose cuDNN autotuning of the trunk's shapes they share):
    # serving FPV-RCNN and FVoxelRCNN, training FPV-RCNN
    fpv_launches, fpv_nms_inputs = fpvrcnn_check(card)
    fpv_train_launches = fpvrcnn_train(card)

    # 20-21. DAIR-V2X and V2X-Sim from disk, CoAlign on DAIR; PIXOR
    dataset_launches, dair_nms_input = datasets_check(card)
    pixor_launches = pixor_check(card)

    # 15. the on-disk data path and the run CLI at full width
    disk = disk_check(card, per_call, native_build)

    # the kernel on the main path's own input (one frame's 512 boxes), on
    # that input stacked 8 times (the NMS of a B=8 batch, one launch), on
    # 8 frames of boxes packed into 20 m x 20 m (the cull's worst case) and
    # on the stage-1 NMS input (5 agent frames, one launch)
    c = captured[0]
    shapes = {"main_path": c,
              "batch8": c.expand(8, -1, -1, -1).contiguous(),
              "dense": torch.from_numpy(np.stack(
                  [seeded_corners(c.shape[1], s) for s in range(8)])).to(dev),
              "stage1": stage1_nms_input,
              "dair_stage1": dair_nms_input}
    timed = {name: time_shape(x) for name, x in shapes.items()}
    # the late request's joint NMS input, its error over the pairs of two
    # candidate boxes (late_check)
    timed["late"] = time_shape(late_nms_input, late_candidates[:, :, None]
                               & late_candidates[:, None, :])
    timed.update(fpv_shapes(fpv_nms_inputs))
    # per call with CUDA events (host launch overhead included)
    kernel_call_ms = event_ms(lambda: K.rotated_iou(c, c), reps=200)
    plain_call_ms = event_ms(lambda: rotated_iou_plain(c, c), reps=20)
    main = timed["main_path"]
    print(json.dumps({"kernels": [{
        "name": "rotated_iou",
        "route": "cuda",
        "source": "coalign_tpu_torch/csrc/rotated_iou.cu",
        "replaces": "coalign_tpu/ops/pallas_iou.py:220",
        "tpu_kernel": "coalign_tpu/ops/pallas_iou.py:_iou_kernel",
        "shape": main["shape"],
        "launches": launches,
        "launches_per_frame": launches,
        "launches_per_train_step": train["launches_per_train_step"],
        "launches_per_eval_batch": train["launches_per_eval_batch"],
        "launches_per_coalign_request":
            coalign["rotated_iou_launches_per_request"],
        "launches_per_late_request": late["late"]["rotated_iou_launches"],
        "launches_per_early_request": early["rotated_iou_launches"],
        "launches_per_baseline_request": baseline_launches,
        "launches_per_stage1_train_step":
            stage1_train["launches_per_train_step"],
        "launches_per_fusions_rest_request": rest_launches,
        "launches_per_rest_train_step": rest_train_launches,
        "launches_per_second_request": second_launches,
        "launches_per_second_train_step": second_train_launches,
        "launches_per_baselines_train_step": baselines_train_launches,
        "launches_per_dataset_cli_frame": {
            k: v for k, v in dataset_launches.items() if "/" in k},
        "launches_per_dair_coalign_request":
            dataset_launches["dairv2x_coalign_request"],
        "launches_per_pixor_request": pixor_launches["request"],
        "launches_per_pixor_train_step": pixor_launches["train_step"],
        "launches_per_lss_request": lss_launches["request"],
        "launches_per_lss_single_request": {
            k: v for k, v in lss_launches.items() if k != "request"},
        "launches_per_lss_train_step": lss_train_launches,
        "launches_per_camera_disk_frame": camera_disk_launches,
        "launches_per_bf16_request": bf16_launches,
        "launches_per_fpvrcnn_request": fpv_launches["fpvrcnn"],
        "launches_per_fvoxelrcnn_request": fpv_launches["fvoxelrcnn"],
        "launches_per_fpvrcnn_train_step": fpv_train_launches,
        **disk,
        "max_abs_err": main["max_abs_err"],
        "max_abs_diff": main["max_abs_err"],
        "ms": main["kernel_ms"],
        "kernel_ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        "ms_source": "cuda events around launches queued behind a sleep",
        "call_ms": kernel_call_ms,
        "plain_call_ms": plain_call_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "share": main["share"],
        "cleared_share": main["cleared_share"],
        "write_floor_ms": main["write_floor_ms"],
        "library_ms": None,
        "shapes": timed,
        "card": card,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
