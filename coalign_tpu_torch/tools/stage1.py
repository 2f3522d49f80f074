"""CoAlign's first pass: per-agent detections with uncertainty, then the
pose graph's corrected poses and pairwise transforms.

Port of coalign_tpu/tools/stage1.py. The reference runs a frozen
single-agent detector with an uncertainty head over the dataset, dumps
``stage1_boxes.json`` (ref opencood/tools/pose_graph_pre_calc.py:36) and the
intermediate dataset reads it per item (intermediate_fusion_dataset.py:
301-328). Here, as in the JAX package, the stage-1 model runs on the device
over every agent frame of a batch, the pose graph solves on the device
(posegraph/box_align.py) and the corrected pairwise transforms feed the
flagship, with no json on the way; a json dump and its loader remain for
the offline pass.
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch.profiler import record_function

from coalign_tpu_torch.inference import infer_setup, to_device
from coalign_tpu_torch.posegraph import BoxAlignConfig, align_poses_batch
from coalign_tpu_torch.postprocess.decode import post_process
from coalign_tpu_torch.runtime import resolve_device
from coalign_tpu_torch.utils.transforms import get_pairwise_transformation


def make_stage1_fn(model, anchors, postprocess_cfg: dict, max_boxes=24,
                   device=None):
    """(batch) -> per-agent stage-1 detections, on ``device`` (CUDA unless
    named; runtime.resolve_device; on CUDA the process-wide full-float32
    policy of runtime.configure_cuda).

    ``model`` is a single-agent detector with an uncertainty head
    (``point_pillar_uncertainty``): it sees each agent's own points, so its
    boxes lie in each agent's frame, which is what the pose graph needs.
    The B*L agent frames go through one post_process call, and so through
    one launch of the IoU kernel, with the identity as their transform.

    Returns tensors on the device: box_poses (B, L, K, 3) x, y, yaw
    (radians) in the agent's frame, box_mask (B, L, K) (ANDed with the
    agent mask) and uncertainty (B, L, K, 3), K = ``max_boxes``; and, to
    evaluate the detector, its boxes7 (B, L, K, 7) and scores (B, L, K).
    Slots that post_process drops are zero; a padded agent's slots hold
    what the detector made of its empty canvas, with box_mask False, as in
    the JAX package."""
    dev, anchors, kwargs = infer_setup(model, anchors, postprocess_cfg, device)

    @torch.no_grad()
    def stage1(batch: dict) -> dict:
        b = to_device(batch, dev)
        n_b, n_l = b["agent_mask"].shape
        with record_function("stage/stage1"):
            out = model(b)                                  # (B*L, ...) maps
            cls = out["cls_preds"]
            eye = torch.eye(4, device=dev).expand(cls.shape[0], 4, 4)
            det = post_process(cls, out["reg_preds"], anchors, eye,
                               dir_preds=out.get("dir_preds"),
                               unc_preds=out["unc_preds"],
                               max_keep=max_boxes, **kwargs)
            mask = det["mask"].reshape(n_b, n_l, -1)
            boxes = det["boxes7"].reshape(n_b, n_l, -1, 7)
            return {"box_poses": torch.cat([boxes[..., :2], boxes[..., 6:]],
                                           dim=-1),
                    "box_mask": mask & b["agent_mask"][..., None],
                    "uncertainty": det["uncertainty"].reshape(
                        boxes.shape[:3] + (-1,)),
                    "boxes7": boxes,
                    "scores": det["scores"].reshape(mask.shape)}

    return stage1


def correct_batch_poses(batch: dict, stage1_dets: dict,
                        cfg: BoxAlignConfig = BoxAlignConfig(),
                        device=None) -> dict:
    """The batch with its poses corrected by the pose graph: ``lidar_pose``
    (B, L, 6) and ``pairwise_t_matrix`` (B, L, L, 4, 4) float32 recomputed
    from them, as tensors on ``device`` (CUDA unless named); the other keys
    as they were. Mirrors the dataset integration (ref
    intermediate_fusion_dataset.py:301-332)."""
    dev = resolve_device(device)
    with record_function("stage/pose_graph"):
        refined = align_poses_batch(
            stage1_dets["box_poses"], stage1_dets["box_mask"],
            stage1_dets["uncertainty"], batch["lidar_pose"],
            batch["agent_mask"], cfg, device=dev)
        agent_mask = torch.as_tensor(batch["agent_mask"], device=dev)
        out = dict(batch)
        out["lidar_pose"] = refined
        out["pairwise_t_matrix"] = get_pairwise_transformation(
            refined, agent_mask).to(torch.float32)
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def dump_stage1_json(stage1_dets: dict, frame_ids, path: str):
    """Write the detections as a ``stage1_boxes.json``-style file: per frame
    id, per agent, the kept boxes' poses and uncertainties (ref
    pose_graph_pre_calc.py:136-150)."""
    poses = _host(stage1_dets["box_poses"])
    masks = _host(stage1_dets["box_mask"])
    uncs = _host(stage1_dets["uncertainty"])
    out = {}
    for i, fid in enumerate(frame_ids):
        out[str(fid)] = [{"box_poses": poses[i, a][masks[i, a]].tolist(),
                          "uncertainty": uncs[i, a][masks[i, a]].tolist()}
                         for a in range(poses.shape[1])]
    with open(path, "w") as f:
        json.dump(out, f)


def load_stage1_json(path: str):
    """A ``stage1_boxes.json`` dump -> its per-frame content."""
    with open(path) as f:
        return json.load(f)


def stage1_content_to_arrays(content, frame_ids, max_cav: int,
                             max_boxes: int = 24) -> dict:
    """Per-frame json content -> padded CPU tensors for
    :func:`correct_batch_poses`: box_poses (B, L, K, 3), box_mask (B, L, K),
    uncertainty (B, L, K, 3). Frames with more than ``max_boxes`` boxes are
    cut to the first ``max_boxes``."""
    b = len(frame_ids)
    poses = np.zeros((b, max_cav, max_boxes, 3), np.float32)
    masks = np.zeros((b, max_cav, max_boxes), bool)
    uncs = np.zeros((b, max_cav, max_boxes, 3), np.float32)
    for i, fid in enumerate(frame_ids):
        for a, rec in enumerate(content.get(str(fid), [])[:max_cav]):
            bp = np.asarray(rec.get("box_poses", []), np.float32)
            un = np.asarray(rec.get("uncertainty", []), np.float32)
            k = min(len(bp), max_boxes)
            if k:
                poses[i, a, :k] = bp[:k]
                masks[i, a, :k] = True
                if un.size:
                    uncs[i, a, :k] = un.reshape(len(un), -1)[:k, :3]
    return {"box_poses": torch.from_numpy(poses),
            "box_mask": torch.from_numpy(masks),
            "uncertainty": torch.from_numpy(uncs)}


def correct_batch_poses_from_json(batch: dict, content, frame_ids,
                                  cfg: BoxAlignConfig = BoxAlignConfig(),
                                  max_boxes: int = 24, device=None) -> dict:
    """The offline second pass: correct a batch from a stage-1 json's
    content, keyed by dataset frame index."""
    max_cav = int(np.shape(batch["agent_mask"])[1])
    dets = stage1_content_to_arrays(content, frame_ids, max_cav, max_boxes)
    return correct_batch_poses(batch, dets, cfg, device=device)
