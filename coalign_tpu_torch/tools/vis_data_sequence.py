"""Dataset sequence viewer: the ground truth and the merged point clouds of
a dataset's first N frames, rendered to BEV (or 3D-projected) PNGs.

Port of coalign_tpu/tools/vis_data_sequence.py (ref
opencood/visualization/vis_data_sequence_*.py): one tool driven by the
``visualization.yaml`` configs (coalign_tpu/hypes_yaml/{opv2v,dairv2x,
v2xsim}/visualization.yaml), with the numpy canvases of
coalign_tpu_torch/visualization/ and the port's PNG writer. Host-side only.

Usage:
  python -m coalign_tpu_torch.tools.vis_data_sequence -y \\
      coalign_tpu/hypes_yaml/opv2v/visualization.yaml \\
      --out vis_out --frames 40 [--method bev|3d]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from coalign_tpu_torch.utils.box_utils import boxes_to_corners_3d


def render_frame(batch: dict, lidar_range, save_path: str,
                 method: str = "bev", left_hand: bool = False) -> None:
    """One assembled batch (B=1) -> PNG: every agent's points in the ego
    frame and the gt boxes (ref vis_data_sequence_opv2v.py)."""
    from coalign_tpu_torch.visualization.simple_vis import visualize

    pts = np.asarray(batch["points"][0])               # (L, P, 4)
    mask = np.asarray(batch["point_mask"][0]) > 0      # (L, P)
    pair = np.asarray(batch["pairwise_t_matrix"][0])   # (L, L, 4, 4)
    agent_mask = np.asarray(batch["agent_mask"][0]) > 0

    merged = []
    for a in range(pts.shape[0]):
        if not agent_mask[a]:
            continue
        p = pts[a][mask[a]][:, :3]
        if not len(p):
            continue
        t = pair[0, a]  # agent a -> ego
        merged.append(p @ t[:3, :3].T + t[:3, 3])
    points = (np.concatenate(merged, axis=0)
              if merged else np.zeros((0, 3), np.float32))

    gt = np.asarray(batch["gt_boxes"][0])[np.asarray(batch["gt_mask"][0]) > 0]
    gt_corners = boxes_to_corners_3d(gt, "hwl") if len(gt) else None
    visualize(None, gt_corners, points, lidar_range, save_path,
              method=method, left_hand=left_hand)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-y", "--hypes_yaml", required=True)
    p.add_argument("--out", default="vis_sequence")
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--method", default="bev", choices=["bev", "3d"])
    opt = p.parse_args(argv)

    from coalign_tpu_torch.config.yaml_utils import load_yaml
    from coalign_tpu_torch.data import build_dataset
    from coalign_tpu_torch.tools.run import left_hand

    params = load_yaml(opt.hypes_yaml)
    # the viewer wants every agent's own points: intermediate batches carry
    # per-agent clouds and the pairwise transforms
    params = dict(params)
    params["fusion"] = dict(params["fusion"], core_method="intermediate")
    base, batcher = build_dataset(params, train=False)
    lidar_range = params["preprocess"]["cav_lidar_range"]

    os.makedirs(opt.out, exist_ok=True)
    n = min(opt.frames, len(base))
    written = []
    for i in range(n):
        batch = batcher.assemble([base[i]])
        path = os.path.join(opt.out, f"frame_{i:05d}_{opt.method}.png")
        render_frame(batch, lidar_range, path, method=opt.method,
                     left_hand=left_hand(params))
        written.append(path)
    print(f"wrote {len(written)} frames to {opt.out}")
    return written


if __name__ == "__main__":
    main()
