"""Pose-noise robustness sweep, CoAlign's headline experiment.

Port of the sweep function of coalign_tpu/tools/noise_sweep.py:21-69 (ref
opencood/tools/inference_w_noise.py:70-120): AP at pose-noise levels
sigma_pos / sigma_rot (m / degrees), each level with batches drawn anew,
optionally with CoAlign's stage-1 detection and pose-graph correction before
fusion. The command line (the JAX package's ``main``) waits for the port of
tools/run.py's model-directory loader.
"""

from __future__ import annotations

import itertools

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
