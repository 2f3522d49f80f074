"""How much the pose graph reduces relative pose error.

Port of coalign_tpu/tools/pose_graph_eval.py (ref
opencood/tools/pose_graph_evaluate.py:129): the translation (m) and
rotation (degrees) error of every non-ego agent relative to the ego, before
and after correction, with summary statistics, and its command line
(:83), which evaluates a stage-1 run directory:

  python -m coalign_tpu_torch.tools.pose_graph_eval --model_dir <run> \
      [--pos_std 0.4] [--rot_std 0.4] [--device cpu]

The numpy functions are copies of the JAX package's.
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np

from coalign_tpu_torch.posegraph import BoxAlignConfig
from coalign_tpu_torch.tools.stage1 import correct_batch_poses, make_stage1_fn


def relative_pose_errors(poses, poses_clean, agent_mask):
    """Per-agent errors relative to the ego.

    poses, poses_clean (B, L, 6) [x, y, z, roll, yaw, pitch], degrees.
    Returns (trans_err (K,), rot_err_deg (K,)) over the valid non-ego
    agents."""
    rel = poses[:, :, :2] - poses[:, :1, :2]
    rel_c = poses_clean[:, :, :2] - poses_clean[:, :1, :2]
    terr = np.linalg.norm(rel - rel_c, axis=-1)
    yaw = poses[:, :, 4] - poses[:, :1, 4]
    yaw_c = poses_clean[:, :, 4] - poses_clean[:, :1, 4]
    rerr = np.abs((yaw - yaw_c + 180.0) % 360.0 - 180.0)
    m = np.asarray(agent_mask, dtype=bool).copy()
    m[:, 0] = False  # ego is the reference
    return terr[m], rerr[m]


def summarize(trans_err, rot_err, cdf_points=(0.5, 0.9, 0.95)):
    out = {
        "trans_mean": float(np.mean(trans_err)) if len(trans_err) else 0.0,
        "rot_mean": float(np.mean(rot_err)) if len(rot_err) else 0.0,
    }
    for q in cdf_points:
        out[f"trans_p{int(q * 100)}"] = (
            float(np.quantile(trans_err, q)) if len(trans_err) else 0.0)
        out[f"rot_p{int(q * 100)}"] = (
            float(np.quantile(rot_err, q)) if len(rot_err) else 0.0)
    return out


def evaluate_pose_graph(model, batcher, dataset, anchors, postprocess_cfg,
                        align_cfg=None, batch_size=4, max_frames=None,
                        device=None) -> dict:
    """Stage-1 detection and the pose graph over ``dataset`` (batches of
    ``batcher`` with noisy ``lidar_pose`` and ``lidar_pose_clean``), on
    ``device`` (CUDA unless named); the pose errors' statistics before and
    after correction."""
    align_cfg = align_cfg or BoxAlignConfig()
    stage1 = make_stage1_fn(model, anchors, postprocess_cfg, device=device)
    errs = {"before": ([], []), "after": ([], [])}
    frames = 0
    for batch in batcher.batches(dataset, batch_size, shuffle=False,
                                 drop_last=False):
        corrected = correct_batch_poses(batch, stage1(batch), align_cfg,
                                        device=device)
        for key, poses in (("before", batch["lidar_pose"]),
                           ("after", corrected["lidar_pose"].cpu().numpy())):
            t, r = relative_pose_errors(np.asarray(poses),
                                        batch["lidar_pose_clean"],
                                        batch["agent_mask"])
            errs[key][0].append(t)
            errs[key][1].append(r)
        frames += len(batch["agent_mask"])
        if max_frames and frames >= max_frames:
            break

    def cat(xs):
        return np.concatenate(xs) if xs else np.zeros(0)
    return {**{key: summarize(cat(t), cat(r))
               for key, (t, r) in errs.items()}, "frames": frames}


def main(argv=None):
    """Load a stage-1 (uncertainty) run directory (tools/run.
    _load_model_dir), add pose noise, print the pose errors before and
    after the pose graph and save them as ``eval_pose_graph.yaml`` in the
    run directory (ref tools/pose_graph_evaluate.py). Returns
    evaluate_pose_graph's result."""
    from coalign_tpu_torch.config.yaml_utils import save_yaml
    from coalign_tpu_torch.runtime import resolve_device
    from coalign_tpu_torch.tools.run import (_load_model_dir,
                                             _pose_graph_threads,
                                             postprocess_cfg)

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--pos_std", type=float, default=0.4)
    p.add_argument("--rot_std", type=float, default=0.4)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--eval_frames", type=int, default=None)
    p.add_argument("--root_dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device; CUDA when not given")
    opt = p.parse_args(argv)
    opt.device = resolve_device(opt.device)

    def hook(params):
        params = copy.deepcopy(params)
        params["noise_setting"] = {"add_noise": True,
                                   "args": {"pos_std": opt.pos_std,
                                            "rot_std": opt.rot_std,
                                            "pos_mean": 0, "rot_mean": 0}}
        # the stage-1 detector trains on one agent a frame (late fusion),
        # but the pose graph needs a frame's agents together with their
        # noisy poses: evaluate on the intermediate batcher (ref
        # pose_graph_evaluate.py builds the intermediate dataset)
        params["fusion"] = dict(params["fusion"], core_method="intermediate")
        return params

    params, base, batcher, model, spec, dev = _load_model_dir(opt, hook)
    _pose_graph_threads(dev)
    res = evaluate_pose_graph(model, batcher, base, spec.anchors,
                              postprocess_cfg(params),
                              batch_size=opt.batch_size,
                              max_frames=opt.eval_frames, device=dev)
    print(json.dumps(res))
    save_yaml(res, os.path.join(opt.model_dir, "eval_pose_graph.yaml"))
    return res


if __name__ == "__main__":
    main()
