"""Pose-noise robustness sweep, CoAlign's headline experiment.

Port of the sweep function of coalign_tpu/tools/noise_sweep.py:21-69 (ref
opencood/tools/inference_w_noise.py:70-120): AP at pose-noise levels
sigma_pos / sigma_rot (m / degrees), each level with batches drawn anew,
optionally with CoAlign's stage-1 detection and pose-graph correction before
fusion; and its command line (:72), which sweeps a run directory's model:

  python -m coalign_tpu_torch.tools.noise_sweep --model_dir <run> \
      [--levels 0,0.2,0.4,0.6] [--also_laplace] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os

from coalign_tpu_torch.inference import evaluate, gt_corners, make_infer_fn
from coalign_tpu_torch.posegraph import BoxAlignConfig
from coalign_tpu_torch.tools.stage1 import correct_batch_poses

NOISE_LEVELS = ((0.0, 0.0), (0.2, 0.2), (0.4, 0.4), (0.6, 0.6))


def noise_sweep(model, batcher_factory, dataset, anchors, postprocess_cfg, *,
                stage1=None, align_cfg=None, levels=NOISE_LEVELS,
                batch_size=4, max_frames=None, batch_hook=None,
                device=None) -> dict:
    """{(pos_std, rot_std): evaluate's {'ap30', 'ap50', 'ap70', 'frames'}}
    of the intermediate-fusion ``model`` on ``device`` (CUDA unless named).

    ``batcher_factory(pos_std, rot_std)`` returns a fresh batcher, so that
    each level draws its poses anew (ref inference_w_noise.py rebuilds the
    dataset per level, seed 303). At a level with noise, each batch is
    first mapped by ``batch_hook(batch, frame_ids)`` (the offline
    correction from a stage-1 json), then, with ``stage1`` (a
    tools/stage1.make_stage1_fn), corrected by the pose graph with
    ``align_cfg`` (BoxAlignConfig's defaults when None). ``max_frames``
    stops after the batch that reaches it."""
    infer = make_infer_fn(model, anchors, postprocess_cfg, device=device)
    cfg = align_cfg or BoxAlignConfig()

    def correct(batch, frame_ids):
        if batch_hook is not None:
            batch = batch_hook(batch, frame_ids)
        if stage1 is not None:
            batch = correct_batch_poses(batch, stage1(batch), cfg,
                                        device=device)
        return batch

    results = {}
    for pos_std, rot_std in levels:
        batches = batcher_factory(pos_std, rot_std).batches(
            dataset, batch_size, shuffle=False, drop_last=False)
        if max_frames:
            batches = itertools.islice(batches, -(-max_frames // batch_size))
        noisy = pos_std > 0 or rot_std > 0
        results[(pos_std, rot_std)] = evaluate(
            infer, (dict(b, gt_corners=gt_corners(b)) for b in batches),
            batch_hook=correct if noisy else None)
    return results


def main(argv=None):
    """Load a run directory (tools/run._load_model_dir), draw the pose
    noise anew at each level, print the AP of each and save them as
    ``eval_noise_sweep.yaml`` in the run directory (ref
    tools/inference_w_noise.py). A config whose ``box_align`` points at a
    stage-1 json corrects the noisy levels from it. Returns
    noise_sweep's results."""
    from coalign_tpu_torch.config.yaml_utils import save_yaml
    from coalign_tpu_torch.data import build_dataset
    from coalign_tpu_torch.runtime import resolve_device
    from coalign_tpu_torch.tools.run import (_box_align_hook,
                                             _load_model_dir, postprocess_cfg)

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_dir", required=True,
                   help="run directory: config.yaml and net_epoch*.pth")
    p.add_argument("--levels", default="0,0.2,0.4,0.6",
                   help="comma-separated sigmas (m and degrees, paired)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--eval_frames", type=int, default=None)
    p.add_argument("--root_dir", default=None)
    p.add_argument("--also_laplace", action="store_true",
                   help="sweep Laplace-distributed noise too (ref "
                        "inference_w_noise.py also_laplace)")
    p.add_argument("--device", default=None,
                   help="torch device; CUDA when not given")
    opt = p.parse_args(argv)
    opt.device = resolve_device(opt.device)

    params, base, _, model, spec, dev = _load_model_dir(opt)

    def make_factory(laplace: bool):
        def batcher_factory(pos_std, rot_std):
            p2 = copy.deepcopy(params)
            p2["noise_setting"] = {
                "add_noise": pos_std > 0 or rot_std > 0,
                "args": {"pos_std": pos_std, "rot_std": rot_std,
                         "pos_mean": 0, "rot_mean": 0, "laplace": laplace}}
            return build_dataset(p2, train=False)[1]
        return batcher_factory

    levels = tuple((float(s), float(s))
                   for s in opt.levels.split(",") if s != "")
    hook = _box_align_hook(params, dev)
    kinds = [("", False)] + ([("laplace_", True)] if opt.also_laplace else [])
    results, out = {}, {}
    for prefix, laplace in kinds:
        res = noise_sweep(model, make_factory(laplace), base, spec.anchors,
                          postprocess_cfg(params), levels=levels,
                          batch_size=opt.batch_size,
                          max_frames=opt.eval_frames, batch_hook=hook,
                          device=dev)
        if not laplace:
            results = res
        out.update({f"{prefix}{k[0]:g}_{k[1]:g}": v for k, v in res.items()})
    print(json.dumps(out))
    save_yaml(out, os.path.join(opt.model_dir, "eval_noise_sweep.yaml"))
    return results


if __name__ == "__main__":
    main()
