"""Inference and evaluation: forward + post-processing, AP accumulation.

Port of the anchor path of coalign_tpu/inference.py:37-116 (ref
opencood/tools/inference.py, inference_utils.inference_intermediate_fusion).
The forward and the whole post-processing run on the device; only the final
fixed-size (max_keep) box tensors come back to the host for AP.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from coalign_tpu_torch.postprocess.decode import post_process
from coalign_tpu_torch.runtime import configure_cuda, resolve_device
from coalign_tpu_torch.utils import eval_utils as E
from coalign_tpu_torch.utils.box_utils import boxes_to_corners_3d

_BATCH_DTYPES = {"points": torch.float32, "point_mask": torch.bool,
                 "agent_mask": torch.bool,
                 "pairwise_t_matrix": torch.float32,
                 "transformation_matrix": torch.float32}


def to_device(batch: dict, device, float_dtype=torch.float32) -> dict:
    """The batch keys the model reads, as tensors on ``device``; the float
    ones as ``float_dtype`` (a float64 model's inputs are float64)."""
    out = {}
    for key, dtype in _BATCH_DTYPES.items():
        if key in batch:
            dtype = float_dtype if dtype.is_floating_point else dtype
            out[key] = torch.as_tensor(batch[key], dtype=dtype, device=device)
    return out


def gt_corners(batch: dict) -> list:
    """A batcher's padded gt (gt_boxes (B, M, 7) hwl, gt_mask (B, M)) as
    evaluate's ``gt_corners``: one (M_b, 8, 3) array per frame, as the JAX
    package's evaluate builds them."""
    return [boxes_to_corners_3d(np.asarray(b)[np.asarray(m)], "hwl")
            for b, m in zip(batch["gt_boxes"], batch["gt_mask"])]


def make_infer_fn(model, anchors, postprocess_cfg: dict, device=None):
    """(batch) -> detections of each frame.

    ``batch`` is the JAX package's batch dict (numpy arrays or tensors):
    points (B, L, N, 4), point_mask (B, L, N), agent_mask (B, L),
    pairwise_t_matrix (B, L, L, 4, 4), transformation_matrix (B, 4, 4).
    ``anchors`` is the (H, W, A, 7) anchor grid. Returns tensors on the
    device: corners3d (B, max_num, 8, 3), boxes7 (B, max_num, 7),
    scores (B, max_num), mask (B, max_num). On CUDA it sets the
    process-wide full-float32 and cuDNN-autotuning policy
    (runtime.configure_cuda).
    """
    dev = resolve_device(device)
    model.to(dev).eval()
    if dev.type == "cuda":
        configure_cuda()
    anchors = torch.as_tensor(np.asarray(anchors), dtype=torch.float32,
                              device=dev)
    dir_args = postprocess_cfg.get("dir_args", {})
    kwargs = dict(
        score_threshold=float(postprocess_cfg["target_args"]
                              ["score_threshold"]),
        nms_threshold=float(postprocess_cfg["nms_thresh"]),
        gt_range=tuple(postprocess_cfg["gt_range"]),
        max_keep=int(postprocess_cfg.get("max_num", 100)),
        dir_offset=float(dir_args.get("dir_offset", 0.7853)),
        num_bins=int(dir_args.get("num_bins", 2)))

    @torch.no_grad()
    def infer(batch: dict) -> dict:
        b = to_device(batch, dev)
        out = model(b)
        with record_function("stage/post_process"):
            return post_process(out["cls_preds"], out["reg_preds"], anchors,
                                b["transformation_matrix"],
                                dir_preds=out.get("dir_preds"), **kwargs)

    return infer


def evaluate(infer, frames, batch_hook=None) -> dict:
    """AP over ``frames``: each a batch dict for ``infer`` plus
    ``gt_corners``, a list with one (M, 8, 3) array per sample of the
    batch. Returns {'ap30', 'ap50', 'ap70', 'frames'}.

    ``batch_hook(batch, frame_ids) -> batch`` maps each batch before
    ``infer``; ``frame_ids`` are the running indices of its samples (as
    coalign_tpu/inference.py:253-256). CoAlign's pose correction is such a
    hook: online, ``lambda batch, ids: correct_batch_poses(batch,
    stage1(batch), cfg)``; offline, ``correct_batch_poses_from_json`` on a
    stage-1 json's content (tools/stage1.py)."""
    stat = E.new_result_stat()
    count = 0
    for frame in frames:
        if batch_hook is not None:
            frame = batch_hook(frame, list(range(
                count, count + len(frame["gt_corners"]))))
        dets = {k: v.cpu().numpy() for k, v in infer(frame).items()}
        for bi, gt in enumerate(frame["gt_corners"]):
            keep = dets["mask"][bi]
            for t in (0.3, 0.5, 0.7):
                E.accumulate_tp_fp(dets["corners3d"][bi][keep],
                                   dets["scores"][bi][keep], gt, stat, t)
            count += 1
    result = E.eval_final_results(stat)
    result["frames"] = count
    return result
