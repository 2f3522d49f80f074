"""Inference and evaluation: forward + post-processing, AP accumulation.

Port of coalign_tpu/inference.py:37-185 (ref
opencood/tools/inference.py, inference_utils.inference_intermediate_fusion,
inference_late_fusion, inference_no_fusion): intermediate and early fusion
decode the fused output (make_infer_fn); late and no fusion decode each
agent's output and merge the agents by a joint NMS in the ego frame
(make_late_infer_fn); make_fusion_infer_fn picks one by the yaml's fusion
method. The forward and the whole post-processing run on the device; only
the final fixed-size box tensors come back to the host for AP.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch
from torch.profiler import record_function

from coalign_tpu_torch.data.prefetch import prefetch
from coalign_tpu_torch.postprocess.decode import (post_process,
                                                  post_process_refined)
from coalign_tpu_torch.postprocess.dense_bev import (DenseBevSpec,
                                                     decode_dense_map)
from coalign_tpu_torch.runtime import configure_cuda, resolve_device
from coalign_tpu_torch.utils import eval_utils as E
from coalign_tpu_torch.utils.bandwidth import (frame_comm_bytes,
                                               summarize_bandwidth)
from coalign_tpu_torch.utils.box_utils import (boxes_to_corners_3d,
                                               project_boxes7_by_tfm)
from coalign_tpu_torch.utils.nms import nms_rotated

# fusion methods served by make_late_infer_fn, each with the mode it runs:
# 'no_w_uncertainty' and 'single' give what 'no' gives (the detections carry
# no uncertainty, as in the JAX package)
LATE_MODES = {"late": "late", "no": "no", "no_w_uncertainty": "no",
              "single": "no"}

_BATCH_DTYPES = {"points": torch.float32, "point_mask": torch.bool,
                 "agent_mask": torch.bool,
                 "pairwise_t_matrix": torch.float32,
                 "transformation_matrix": torch.float32,
                 # robust V2VNet's pose target, DiscoNet's teacher's input
                 "lidar_pose_clean": torch.float32,
                 "teacher_points": torch.float32,
                 "teacher_point_mask": torch.bool}


def to_device(batch: dict, device, float_dtype=torch.float32) -> dict:
    """The batch keys the model reads, as tensors on ``device``; the float
    ones as ``float_dtype`` (a float64 model's inputs are float64), the
    camera batch's nested ``image_inputs`` (all float) too."""
    out = {}
    for key, dtype in _BATCH_DTYPES.items():
        if key in batch:
            dtype = float_dtype if dtype.is_floating_point else dtype
            out[key] = torch.as_tensor(batch[key], dtype=dtype, device=device)
    if "image_inputs" in batch:
        out["image_inputs"] = {
            k: torch.as_tensor(v, dtype=float_dtype, device=device)
            for k, v in batch["image_inputs"].items()}
    return out


def gt_corners(batch: dict) -> list:
    """A batcher's padded gt (gt_boxes (B, M, 7) hwl, gt_mask (B, M)) as
    evaluate's ``gt_corners``: one (M_b, 8, 3) array per frame, as the JAX
    package's evaluate builds them."""
    return [boxes_to_corners_3d(np.asarray(b)[np.asarray(m)], "hwl")
            for b, m in zip(batch["gt_boxes"], batch["gt_mask"])]


def infer_setup(model, anchors, postprocess_cfg: dict, device):
    """The entry points' common set-up: the device (CUDA unless named, with
    runtime.configure_cuda's policy there), the model on it in eval mode,
    the anchors on it and post_process's keyword arguments, max_keep
    aside."""
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
        dir_offset=float(dir_args.get("dir_offset", 0.7853)),
        num_bins=int(dir_args.get("num_bins", 2)))
    return dev, anchors, kwargs


def make_infer_fn(model, anchors, postprocess_cfg: dict, device=None):
    """(batch) -> detections of each frame.

    ``batch`` is the JAX package's batch dict (numpy arrays or tensors):
    points (B, L, N, 4), point_mask (B, L, N), agent_mask (B, L),
    pairwise_t_matrix (B, L, L, 4, 4), transformation_matrix (B, 4, 4);
    a camera model's ``image_inputs`` (models/camera.py) in place of the
    points.
    ``anchors`` is the (H, W, A, 7) anchor grid, or a DenseBevSpec for the
    anchor-free PIXOR family (decode_dense_map). Returns tensors on the
    device: corners3d (B, max_num, 8, 3), boxes7 (B, max_num, 7),
    scores (B, max_num), mask (B, max_num); for the two-stage models
    (FPV-RCNN, FVoxelRCNN) the R refined RoIs of each frame instead
    (decode.post_process_refined: the config's score and NMS thresholds,
    no max_num cap); and the model's ``comm_rate``
    (a 0-dim tensor) where it gives one (Where2comm; coalign_tpu/
    inference.py:111-112). On CUDA it sets the
    process-wide full-float32 and cuDNN-autotuning policy
    (runtime.configure_cuda).
    """
    if isinstance(anchors, DenseBevSpec):
        return _make_dense_infer_fn(model, anchors, postprocess_cfg, device)
    dev, anchors, kwargs = infer_setup(model, anchors, postprocess_cfg, device)
    max_keep = int(postprocess_cfg.get("max_num", 100))

    @torch.no_grad()
    def infer(batch: dict) -> dict:
        b = to_device(batch, dev)
        out = model(b)
        if "cls_preds" not in out and "boxes_refined" in out:
            # the two-stage models emit RoI-refined boxes, not anchor maps
            # (coalign_tpu/inference.py:83-97; ref
            # fpvrcnn_postprocessor.py:21-246)
            with record_function("stage/post_process"):
                return post_process_refined(
                    out["boxes_refined"], out["roi_cls"], out["roi_mask"],
                    b["transformation_matrix"],
                    score_threshold=kwargs["score_threshold"],
                    nms_threshold=kwargs["nms_threshold"],
                    gt_range=kwargs["gt_range"])
        with record_function("stage/post_process"):
            dets = post_process(out["cls_preds"], out["reg_preds"], anchors,
                                b["transformation_matrix"],
                                dir_preds=out.get("dir_preds"),
                                max_keep=max_keep, **kwargs)
        if "comm_rate" in out:
            dets["comm_rate"] = out["comm_rate"]
        return dets

    return infer


def _make_dense_infer_fn(model, spec, postprocess_cfg: dict, device=None):
    """make_infer_fn of the anchor-free PIXOR family (coalign_tpu/
    inference.py:53-75): each frame's maps decoded by decode_dense_map at
    the config's score and NMS thresholds (one IoU launch a batch, max_keep
    its default 100), its boxes projected by ``transformation_matrix``
    into the ego frame. No range mask, as in the JAX package."""
    dev = resolve_device(device)
    model.to(dev).eval()
    if dev.type == "cuda":
        configure_cuda()
    score_thr = float(postprocess_cfg["target_args"]["score_threshold"])
    nms_thr = float(postprocess_cfg["nms_thresh"])

    @torch.no_grad()
    def infer(batch: dict) -> dict:
        b = to_device(batch, dev)
        out = model(b)
        with record_function("stage/post_process"):
            return dense_post_process(out, b["transformation_matrix"], spec,
                                      score_thr, nms_thr)

    return infer


def dense_post_process(out: dict, transformation_matrix: torch.Tensor, spec,
                       score_threshold: float, nms_threshold: float) -> dict:
    """The dense infer fn's post-processing of a PIXOR model's maps
    (``out``: cls_map, reg_map): decode_dense_map, the boxes projected by
    ``transformation_matrix`` (B, 4, 4) into the ego frame; corners3d,
    boxes7, scores and mask, zero where not kept."""
    det = decode_dense_map(out["cls_map"], out["reg_map"], spec,
                           score_threshold=score_threshold,
                           nms_threshold=nms_threshold)
    boxes = project_boxes7_by_tfm(det["boxes"],
                                  transformation_matrix[:, None], "hwl")
    keep = det["valid"]
    return {"corners3d": boxes_to_corners_3d(boxes, "hwl")
            * keep[..., None, None],
            "boxes7": boxes * keep[..., None],
            "scores": torch.where(keep, det["scores"], 0.0),
            "mask": keep}


def make_late_infer_fn(model, anchors, postprocess_cfg: dict,
                       mode: str = "late", device=None):
    """(batch) -> late- or no-fusion detections of each frame (port of
    coalign_tpu/inference.py:118-185; ref inference_utils.py:17
    inference_late_fusion, :97 inference_no_fusion).

    ``model`` is a single-agent detector: it gives each of the B*L agent
    frames its own maps. One post_process over all of them (one IoU launch)
    keeps 100 boxes an agent, projected into the ego frame by the batch's
    ``transformation_matrix``: (B, L, 4, 4) per agent
    (data/batch.late_transforms), or (B, 4, 4), the same for every agent.
    A box stays a candidate if post_process kept it and its agent is real;
    in the mode 'no' only if it is the ego's. One joint NMS over the
    (B, L*100) candidates (a second IoU launch) merges the agents.

    Returns tensors on the device (CUDA unless named): corners3d
    (B, L*100, 8, 3), scores (B, L*100) and mask (B, L*100), ranked by
    score, zero where not kept."""
    if mode not in ("late", "no"):
        raise ValueError(f"unknown late inference mode {mode!r}")
    dev, anchors, kwargs = infer_setup(model, anchors, postprocess_cfg, device)
    ego_only = mode == "no"

    @torch.no_grad()
    def infer(batch: dict) -> dict:
        b = to_device(batch, dev)
        n_b, n_l = b["agent_mask"].shape
        out = model(b)                                   # (B*L, ...) maps
        with record_function("stage/post_process"):
            tfm = b["transformation_matrix"]
            if tfm.ndim == 3:
                tfm = tfm[:, None].expand(n_b, n_l, 4, 4)
            dets = post_process(out["cls_preds"], out["reg_preds"], anchors,
                                tfm.reshape(n_b * n_l, 4, 4),
                                dir_preds=out.get("dir_preds"), **kwargs)
            # a padded agent's slots hold boxes of its empty canvas: they
            # leave before the joint NMS, or they would suppress real ones
            valid = dets["mask"] & b["agent_mask"].reshape(-1, 1)
            if ego_only:
                valid = valid & (torch.arange(n_b * n_l, device=dev)
                                 % n_l == 0)[:, None]
            k = n_l * valid.shape[1]
            corners = dets["corners3d"].reshape(n_b, k, 8, 3)
            scores = torch.where(valid, dets["scores"], 0.0).reshape(n_b, k)
        with record_function("stage/joint_nms"):
            order, keep = nms_rotated(corners[..., :4, :2], scores,
                                      valid.reshape(n_b, k),
                                      kwargs["nms_threshold"])
            corners = torch.gather(corners, 1, order[..., None, None].expand(
                -1, -1, 8, 3))
            return {"corners3d": corners * keep[..., None, None],
                    "scores": torch.where(keep, torch.gather(scores, 1, order),
                                          0.0),
                    "mask": keep}

    return infer


def make_fusion_infer_fn(model, anchors, postprocess_cfg: dict,
                         fusion_method: str = "intermediate", device=None):
    """The infer fn of the yaml's ``fusion.core_method`` (the dispatch of
    coalign_tpu/inference.py:232-236): 'intermediate' and 'early' decode
    the model's fused output (make_infer_fn; early fusion's batch holds one
    merged agent, data/batch.EarlyFusionBatcher); 'late' merges per-agent
    detections (make_late_infer_fn), and 'no', 'no_w_uncertainty' and
    'single' keep the ego's (its mode 'no')."""
    if fusion_method in LATE_MODES:
        return make_late_infer_fn(model, anchors, postprocess_cfg,
                                  LATE_MODES[fusion_method], device=device)
    if fusion_method in ("intermediate", "early"):
        return make_infer_fn(model, anchors, postprocess_cfg, device=device)
    raise ValueError(f"unknown fusion method {fusion_method!r}")


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


def dump_detections_npy(dets: dict, batch: dict, out_dir: str, idx: int,
                        cav_box=None, lidar_agent_record=None):
    """Save one batch's detections (corners3d, scores, mask) and its padded
    gt (gt_boxes, gt_mask) as ``<idx:05d>_<name>.npy`` files under
    ``out_dir``, for offline visualization (ref inference_utils.py:176;
    coalign_tpu/inference.py:188); for a heterogeneous run also the per-CAV
    marker boxes (``cav_box``) and the lidar-agent record (ref
    tools/inference.py:195)."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = {"pred_corners": dets["corners3d"], "pred_scores": dets["scores"],
              "pred_mask": dets["mask"], "gt_boxes": batch["gt_boxes"],
              "gt_mask": batch["gt_mask"]}
    if cav_box is not None:
        arrays = {"cav_box": cav_box, "lidar_agent": lidar_agent_record,
                  **arrays}
    for name, value in arrays.items():
        if isinstance(value, torch.Tensor):
            value = value.cpu().numpy()
        np.save(os.path.join(out_dir, f"{idx:05d}_{name}.npy"),
                np.asarray(value))
    return out_dir


def save_vis(dets: dict, batch: dict, lidar_range, path: str,
             left_hand: bool = False) -> str:
    """The BEV rendering of a batch's first frame (coalign_tpu/inference.py:
    283-297): its kept detections, its gt and the ego agent's points (none
    for a camera batch), written as a PNG at ``path``."""
    from coalign_tpu_torch.visualization import visualize

    mask = np.asarray(dets["mask"][0])
    gt = np.asarray(batch["gt_boxes"][0])[np.asarray(batch["gt_mask"][0])]
    pts = (np.asarray(batch["points"][0, 0])[np.asarray(
        batch["point_mask"][0, 0])] if "points" in batch
        else np.zeros((0, 3)))
    return visualize(np.asarray(dets["corners3d"][0])[mask],
                     boxes_to_corners_3d(gt, "hwl"), pts, lidar_range, path,
                     method="bev", left_hand=left_hand)


def evaluate_dataset(model, batcher, dataset, anchors, postprocess_cfg, *,
                     batch_size: int = 1, max_frames: int | None = None,
                     fusion_method: str = "intermediate",
                     npy_dir: str | None = None, vis_dir: str | None = None,
                     vis_interval: int = 40, lidar_range=None,
                     batch_hook=None, left_hand: bool = False,
                     heter_selector=None, device=None) -> dict:
    """The eval protocol over a dataset (coalign_tpu/inference.py:215-306;
    ref tools/inference.py:40-227): ``batcher``'s batches of ``dataset`` in
    order, through the infer fn of ``fusion_method``
    (make_fusion_infer_fn) on ``device`` (CUDA unless named), and AP
    against the batches' gt_boxes/gt_mask. Returns evaluate's {'ap30',
    'ap50', 'ap70', 'frames'} and the bandwidth per frame
    (utils/bandwidth.py), scaled by the model's ``comm_rate`` where it
    gives one (Where2comm; coalign_tpu/inference.py:262).

    Batches are assembled a step ahead in a side thread and stay on the
    host (data/prefetch.py). ``batch_hook(batch, frame_ids)`` maps each
    batch before inference (the offline CoAlign correction of
    tools/run.py). ``max_frames`` stops after the batch that reaches it.
    With ``npy_dir`` each batch's detections and gt are saved there
    (dump_detections_npy), numbered by batch; with a ``heter_selector``
    (utils/heter.AgentSelector) also its first frame's per-CAV marker boxes
    and each agent's modality (get_cav_box). With ``vis_dir`` every
    ``vis_interval // batch_size``-th batch's first frame is rendered there
    as ``bev_<batch>.png`` (save_vis) over ``lidar_range`` (the gt range by
    default), its y flipped when ``left_hand``."""
    infer = make_fusion_infer_fn(model, anchors, postprocess_cfg,
                                 fusion_method, device=device)
    max_num = int(postprocess_cfg.get("max_num", 100))
    batches = prefetch(batcher.batches(dataset, batch_size, shuffle=False,
                                       drop_last=False),
                       size=2, to_device=False)
    if max_frames:
        batches = itertools.islice(batches, -(-max_frames // batch_size))
    comm_bytes = []
    batch_ids = itertools.count()
    vis_every = max(vis_interval // batch_size, 1)

    def infer_and_record(batch: dict) -> dict:
        idx = next(batch_ids)
        dets = infer(batch)
        rate = dets.get("comm_rate")
        comm_bytes.append(frame_comm_bytes(
            fusion_method, batch, model=model, max_num=max_num,
            comm_rate=None if rate is None else float(rate)))
        if npy_dir:
            cav_box = record = None
            if heter_selector is not None:
                from coalign_tpu_torch.utils.heter import get_cav_box
                amask = np.asarray(batch["agent_mask"][0])
                cav_box, record = get_cav_box(
                    np.asarray(batch["lidar_pose"][0]), amask,
                    heter_selector.select(int(amask.sum())))
            dump_detections_npy(dets, batch, npy_dir, idx, cav_box=cav_box,
                                lidar_agent_record=record)
        if vis_dir and idx % vis_every == 0:
            os.makedirs(vis_dir, exist_ok=True)
            save_vis({k: v.cpu().numpy() for k, v in dets.items()
                      if k in ("corners3d", "mask")}, batch,
                     lidar_range or postprocess_cfg["gt_range"],
                     os.path.join(vis_dir, f"bev_{idx:05d}.png"), left_hand)
        return dets

    result = evaluate(infer_and_record,
                      (dict(b, gt_corners=gt_corners(b)) for b in batches),
                      batch_hook=batch_hook)
    result.update(summarize_bandwidth(sum(comm_bytes), result["frames"]))
    return result
