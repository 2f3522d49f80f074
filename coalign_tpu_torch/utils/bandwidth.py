"""Eval-time communication-bandwidth accounting.

The port's copy of coalign_tpu/utils/bandwidth.py. It reproduces the
reference's published bandwidth table (ref docs/md_files/lidar_benchmark.md:
26-28, per-link transmission size in log2(MB)) as live numbers in
``inference.evaluate_dataset``'s results:

  early         raw points actually shipped by the non-ego agents
  late          detection boxes (max_num x 8 floats: 7 box + score)
  intermediate  the feature tensors crossing the channel, from the model
                config: per-scale maps for a model whose class name says
                multiscale, the shrunk/compressed single-scale map
                otherwise, scaled by the measured where2comm comm_rate when
                the model emits one.

All sizes assume float32 on the wire, like the reference table. The
multiscale count keys on the class name, as the JAX package's does: the
flagship yaml's point_pillar_baseline_multiscale counts per scale, but the
same model built under the reference's alias point_pillar_coalign (class
``CoAlign`` in both packages) counts single-scale (ROADMAP §3 lists this
among the JAX package's departures from the reference).
"""

from __future__ import annotations

import math

import numpy as np


def _bev_hw(model_args: dict):
    lr = model_args["lidar_range"]
    vx, vy = model_args["voxel_size"][0], model_args["voxel_size"][1]
    w = int(round((lr[3] - lr[0]) / vx))
    h = int(round((lr[4] - lr[1]) / vy))
    return h, w


def intermediate_feature_bytes(model_args: dict,
                               multiscale: bool = False) -> float:
    """Per-link bytes of the intermediate-fusion feature transmission."""
    h, w = _bev_hw(model_args)
    bb = model_args.get("base_bev_backbone", {})
    if multiscale:
        # per-scale fusion: each trunk scale crosses the channel
        total = 0.0
        for i, (c, s) in enumerate(zip(bb.get("num_filters", []),
                                       np.cumprod(bb.get("layer_strides",
                                                         [])))):
            total += c * (h // int(s)) * (w // int(s))
        return total * 4.0
    # single-scale: fusion input is the post-shrink (and post-compressor)
    # 2x-downsampled map (ref point_pillar_baseline.py:120-127)
    if "shrink_header" in model_args:
        c = model_args["shrink_header"]["dim"][-1]
    else:
        c = sum(bb.get("num_upsample_filter", [])) or 256
    if model_args.get("compression"):
        c = max(1, c // int(model_args["compression"]))
    return c * (h // 2) * (w // 2) * 4.0


def frame_comm_bytes(fusion_method: str, batch: dict, model=None,
                     max_num: int = 100, comm_rate=None) -> float:
    """Per-frame transmitted bytes (sum over non-ego links), best-effort.

    Returns nan when the transmission volume cannot be derived (custom
    model without an args dict).
    """
    if "agent_mask" not in batch:
        return float("nan")
    agent_mask = np.asarray(batch["agent_mask"])  # (B, L)
    links = max(int(agent_mask.sum()) - agent_mask.shape[0], 0)
    if fusion_method == "early":
        if "shipped_points" in batch:
            # per-frame count recorded by EarlyFusionBatcher at merge time
            # (the merged single-virtual-agent batch hides the split)
            return float(np.sum(np.asarray(batch["shipped_points"]))) * 4 \
                * 4.0
        pm = np.asarray(batch.get("point_mask", np.zeros((1, 1, 0))))
        non_ego = pm[:, 1:].sum() if pm.ndim == 3 else 0.0
        return float(non_ego) * 4 * 4.0
    if fusion_method in ("late", "no", "no_w_uncertainty", "single"):
        return links * max_num * 8 * 4.0
    args = getattr(model, "args", None)
    if not isinstance(args, dict):
        return float("nan")
    if "geometry_param" in args and "voxel_size" not in args:
        # PIXOR family: BEV grid from geometry_param, fused at the
        # backbone's downsampled resolution
        g = args["geometry_param"]
        h = int(round((g["L2"] - g["L1"]) / g["res"]))
        w = int(round((g["W2"] - g["W1"]) / g["res"]))
        ds = int(g.get("downsample_rate", 4))
        c = (args.get("att", {}).get("feat_dim") or [128])
        c = c[-1] if isinstance(c, (list, tuple)) else int(c)
        return links * float(c * (h // ds) * (w // ds) * 4.0)
    if "lidar_range" not in args:
        return float("nan")
    multiscale = "multiscale" in type(model).__name__.lower() or \
        "Multiscale" in type(model).__name__
    per_link = intermediate_feature_bytes(args, multiscale=multiscale)
    if comm_rate is not None:
        per_link *= float(np.mean(comm_rate))
    return links * per_link


def summarize_bandwidth(total_bytes: float, frames: int) -> dict:
    """The reference-table format: MB per frame + log2(MB)."""
    if frames == 0 or not math.isfinite(total_bytes):
        return {}
    mb = total_bytes / frames / 2**20
    return {"bandwidth_mb_per_frame": round(mb, 6),
            "bandwidth_log2_mb": round(math.log2(mb), 3) if mb > 0 else None}
