"""Config-driven CLI: train, inference, precalc and config_generate from a
hypes yaml.

Port of coalign_tpu/tools/run.py (ref opencood/tools/train.py:32-194,
inference.py:40-227, pose_graph_pre_calc.py, config_generate.py): one entry
point builds the dataset, batcher, model, loss and anchors from the yaml,
trains with the port's step, checkpoints as the reference does
(``net_epoch{N}.pth``, ``net_epoch_bestval_at{N}.pth``: model state dicts)
and evaluates AP@0.3/0.5/0.7.

Usage:
  python -m coalign_tpu_torch.tools.run train -y <hypes.yaml> \\
      [--model_dir out] [--root_dir <dataset>] [--epochs N]
  python -m coalign_tpu_torch.tools.run inference --model_dir out \\
      [--fusion_method intermediate] [--save_npy] [--eval_frames N]
  python -m coalign_tpu_torch.tools.run precalc -y <precalc.yaml>
  python -m coalign_tpu_torch.tools.run config_generate -y <hypes.yaml>

Every subcommand runs on CUDA unless ``--device`` names another device, and
raises without a GPU unless given ``--device cpu``. A run directory holds
its ``config.yaml`` and ``net_epoch*.pth`` files: a reference (opencood) run
directory loads as it is, its checkpoint strictly. The JAX package's orbax
``step_*`` checkpoints are not read (utils/weights.from_jax_params converts
their variables to a state dict).
"""

from __future__ import annotations

import argparse
import json
import os
import zipfile

import numpy as np
import torch

from coalign_tpu_torch.config.yaml_utils import load_yaml, save_yaml
from coalign_tpu_torch.data import build_dataset
from coalign_tpu_torch.inference import evaluate_dataset
from coalign_tpu_torch.loss import build_loss
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.ops.bev_raster import BevSpec
from coalign_tpu_torch.postprocess.anchors import (generate_anchor_box,
                                                   make_anchor_spec)
from coalign_tpu_torch.postprocess.dense_bev import DenseBevSpec
from coalign_tpu_torch.runtime import resolve_device
from coalign_tpu_torch.train import (build_optimizer, inference_checkpoint,
                                     latest_checkpoint, load_checkpoint,
                                     save_checkpoint, train_epochs)

# options of the JAX package's CLI that the port does not have yet, each
# with the ROADMAP item that brings it
_REFUSED_FLAGS = {
    "save_vis": "visualization/ (ROADMAP item 9)",
    "profile": "utils/profiling.py's device trace (ROADMAP item 9)",
}
# yaml blocks of the JAX package's inference that the port does not read
# yet: evaluating such a config would give another AP without a word
_REFUSED_BLOCKS = {
    "heter": "utils/heter.py's agent selector (ROADMAP item 9)",
}


def _refuse_blocks(params: dict) -> dict:
    """``params`` unchanged, or NotImplementedError for a block that the
    port's inference does not read (_REFUSED_BLOCKS)."""
    for block, what in _REFUSED_BLOCKS.items():
        if params.get(block):
            raise NotImplementedError(f"the yaml's {block!r} block waits "
                                      f"for {what}")
    return params


def build_all(params: dict, train: bool = True, device=None):
    """yaml params -> (base dataset, batcher, model on ``device``, loss fn,
    anchor spec: an AnchorSpec, or a DenseBevSpec for the PIXOR family's
    BevPostprocessor)."""
    post = params["postprocess"]
    # the model first: a model the port has not yet is refused before any
    # dataset is read
    model = build_model(params["model"], device=device)
    base, batcher = build_dataset(params, train=train)
    loss_fn = build_loss(params["loss"])
    if post.get("core_method") == "BevPostprocessor":
        # the anchor-free PIXOR family: dense label maps, no anchor grid
        # (ref bev_postprocessor.py; coalign_tpu/tools/run.py:37-44)
        spec = DenseBevSpec(bev=BevSpec.from_config(
            params["model"]["args"]["geometry_param"]))
    else:
        spec = make_anchor_spec(post["anchor_args"], post["target_args"],
                                post.get("order", "hwl"))
    return base, batcher, model, loss_fn, spec


def _anchors(spec):
    """What the infer fns take: an AnchorSpec's anchor grid, or the
    DenseBevSpec itself."""
    return getattr(spec, "anchors", spec)


def postprocess_cfg(params: dict) -> dict:
    """The yaml's ``postprocess`` with the gt range and the direction args
    the infer fns read."""
    post = dict(params["postprocess"])
    post.setdefault("gt_range", params["preprocess"]["cav_lidar_range"])
    if "dir_args" in params.get("model", {}).get("args", {}):
        post.setdefault("dir_args", params["model"]["args"]["dir_args"])
    return post


def _backup_source(model_dir: str):
    """Snapshot the port's source (.py, .yaml, .cu) into the run directory
    as ``scripts_backup.zip`` (ref train_utils.py:16-27 backup_script), so
    every run can be reproduced from its own directory."""
    import coalign_tpu_torch

    pkg = os.path.dirname(os.path.abspath(coalign_tpu_torch.__file__))
    out = os.path.join(model_dir, "scripts_backup.zip")
    try:
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
            for root, dirs, files in os.walk(pkg):
                dirs[:] = [d for d in dirs if d != "_build"]
                for name in files:
                    if name.endswith((".py", ".yaml", ".cu")):
                        full = os.path.join(root, name)
                        zf.write(full, os.path.relpath(full,
                                                       os.path.dirname(pkg)))
    except OSError as e:  # a backup never stops a training run
        print(json.dumps({"scripts_backup_failed": str(e)}))


def _pose_graph_threads(device: torch.device):
    """torch's CPU batched LU raises or hangs with more than one thread
    (ROADMAP §3), so the pose graph runs on one thread on the CPU."""
    if device.type == "cpu":
        torch.set_num_threads(1)


def _fusion_method(params: dict) -> str:
    """The eval protocol of a config's fusion: late and early decode their
    own way, everything else as intermediate fusion."""
    kind = params.get("fusion", {}).get("core_method", "intermediate")
    return kind if kind in ("late", "early") else "intermediate"


def cmd_train(opt):
    """Train the yaml's model on its dataset (``--root_dir`` overrides the
    root), resuming from the run directory's numerically latest
    ``net_epoch{N}.pth`` at epoch N; save ``net_epoch{N+epochs}.pth``, then
    evaluate with the config's fusion protocol. Returns (model, eval
    result)."""
    dev = resolve_device(opt.device)
    params = load_yaml(opt.hypes_yaml)
    if opt.root_dir:
        params["root_dir"] = opt.root_dir
    # the port trains with pad slots outside the pillar max; the run's
    # config says so, and _load_model_dir then tells its checkpoints from a
    # reference run's
    vfe = params["model"]["args"].get("pillar_vfe")
    if vfe is not None:
        vfe.setdefault("pad_parity", False)
    base, batcher, model, loss_fn, spec = build_all(params, train=True,
                                                    device=dev)
    tp = params["train_params"]

    model_dir = opt.model_dir or os.path.join("logs", params.get("name",
                                                                 "exp"))
    os.makedirs(model_dir, exist_ok=True)
    save_yaml(params, os.path.join(model_dir, "config.yaml"))
    _backup_source(model_dir)

    start_epoch = 0
    resumed = latest_checkpoint(model_dir)
    if resumed is not None:
        start_epoch, path = resumed
        load_checkpoint(model, path)
        print(json.dumps({"resumed_from": os.path.basename(path)}))
    steps_per_epoch = max(1, len(base) // tp["batch_size"])
    optimizer, scheduler = build_optimizer(
        model.parameters(), params["optimizer"], params.get("lr_scheduler"),
        steps_per_epoch, start_step=start_epoch * steps_per_epoch)

    val_base = None
    val_dir = params.get("validate_dir")
    if val_dir and os.path.isdir(str(val_dir)):
        val_base, _ = build_dataset(dict(params, root_dir=val_dir),
                                    train=False)

    epochs = opt.epochs or tp["epoches"]
    train_epochs(model, loss_fn, spec, optimizer, scheduler, batcher, base,
                 epochs=epochs, batch_size=tp["batch_size"],
                 ckpt_dir=model_dir, save_freq=tp.get("save_freq", 0),
                 callback=lambda m: print(json.dumps(m)),
                 val_dataset=val_base, eval_freq=tp.get("eval_freq", 0),
                 start_epoch=start_epoch, device=dev)
    path = save_checkpoint(model, model_dir, start_epoch + epochs)
    print(json.dumps({"saved": path}))

    # the end-of-train eval follows the config's fusion protocol (ref
    # train.py:187-194 runs inference.py with the matching fusion flag)
    res = evaluate_dataset(model, batcher, base, _anchors(spec),
                           postprocess_cfg(params),
                           max_frames=opt.eval_frames,
                           fusion_method=_fusion_method(params), device=dev)
    print(json.dumps({"eval": res}))
    return model, res


def _load_model_dir(opt, params_hook=None):
    """A run directory -> (params, base dataset, batcher, model with its
    checkpoint, anchor spec, device). Shared by inference, noise_sweep and
    pose_graph_eval.

    ``--root_dir`` points both ``root_dir`` and ``validate_dir`` at a
    dataset (build_dataset(train=False) reads validate_dir first).
    ``params_hook(params) -> params`` rewrites the config (a forced
    noise_setting) before the dataset and the model are built. The
    checkpoint is inference_checkpoint's (bestval first), loaded strictly.
    A config without ``pillar_vfe.pad_parity`` is a reference run's, whose
    pad slots take part in the pillar max: it gets pad_parity True (the
    port's own runs write False, cmd_train)."""
    dev = resolve_device(opt.device)
    params = load_yaml(os.path.join(opt.model_dir, "config.yaml"))
    if opt.root_dir:
        params["root_dir"] = opt.root_dir
        params["validate_dir"] = opt.root_dir
    if params_hook is not None:
        params = params_hook(params)
    found = inference_checkpoint(opt.model_dir)
    if found is None:
        if any(d.startswith("step_") for d in os.listdir(opt.model_dir)):
            raise FileNotFoundError(
                f"{opt.model_dir} holds only the JAX package's orbax step_* "
                "checkpoints, which the port does not read: convert their "
                "variables with coalign_tpu_torch.utils.weights."
                "from_jax_params and save the state dict as net_epoch{N}.pth")
        raise FileNotFoundError(f"no net_epoch*.pth in {opt.model_dir}")
    vfe = params["model"]["args"].get("pillar_vfe")
    if vfe is not None:
        vfe.setdefault("pad_parity", True)
    base, batcher, model, _, spec = build_all(params, train=False,
                                              device=dev)
    load_checkpoint(model, found[1])
    print(json.dumps({"loaded_checkpoint": os.path.basename(found[1])}))
    return params, base, batcher, model, spec, dev


def _box_align_hook(params: dict, device):
    """CoAlign's offline second pass for eval: when the config's
    ``box_align`` block points at an existing stage-1 json (``val_result``
    or ``test_result``; ref pointpillar_coalign.yaml:34-44,
    intermediate_fusion_dataset.py:301-328), a batch hook that corrects
    each batch's noisy poses by the pose graph before inference; else
    None."""
    from coalign_tpu_torch.posegraph import BoxAlignConfig
    from coalign_tpu_torch.tools.stage1 import (correct_batch_poses_from_json,
                                                load_stage1_json)

    ba = params.get("box_align") or {}
    path = ba.get("val_result") or ba.get("test_result")
    if not path or not os.path.exists(str(path)):
        return None
    content = load_stage1_json(str(path))
    cfg = BoxAlignConfig.from_yaml(ba.get("args", {}))
    _pose_graph_threads(device)

    def hook(batch, frame_ids):
        return correct_batch_poses_from_json(batch, content, frame_ids, cfg,
                                             device=device)

    print(json.dumps({"box_align_json": str(path)}))
    return hook


def cmd_inference(opt):
    """Evaluate a run directory's checkpoint on its dataset; the result is
    printed and saved as ``eval_<fusion>.yaml`` in the run directory, and
    with ``--save_npy`` each frame's detections and gt under ``npy/``. A
    config with a ``heter`` block is refused (_REFUSED_BLOCKS)."""
    params, base, batcher, model, spec, dev = _load_model_dir(
        opt, params_hook=_refuse_blocks)
    if not opt.fusion_method:
        # a late or early run is decoded with its own protocol
        opt.fusion_method = _fusion_method(params)
        print(json.dumps({"fusion_method": opt.fusion_method}))
    npy_dir = os.path.join(opt.model_dir, "npy") if opt.save_npy else None
    res = evaluate_dataset(model, batcher, base, _anchors(spec),
                           postprocess_cfg(params),
                           fusion_method=opt.fusion_method,
                           max_frames=opt.eval_frames, npy_dir=npy_dir,
                           batch_hook=_box_align_hook(params, dev),
                           device=dev)
    print(json.dumps({"eval": res}))
    save_yaml(res, os.path.join(opt.model_dir,
                                f"eval_{opt.fusion_method}.yaml"))
    return res


def cmd_precalc(opt):
    """CoAlign's stage-1 precompute (ref tools/pose_graph_pre_calc.py:
    36-150): the yaml's ``box_align_pre_calc`` stage-1 detector over the
    train, validate and test splits that exist, one
    ``<out>/<split>/stage1_boxes.json`` each (read back by the box_align
    hook of inference). ``stage1_model_path`` is a ``.pth`` state dict,
    loaded strictly; without one the detector keeps its seeded weights.
    Returns the json paths."""
    from coalign_tpu_torch.tools.stage1 import dump_stage1_json, make_stage1_fn

    dev = resolve_device(opt.device)
    params = load_yaml(opt.hypes_yaml)
    pc = params["box_align_pre_calc"]
    model = build_model({"core_method": pc["stage1_model"],
                         "args": pc["stage1_model_config"]}, device=dev)
    ckpt = pc.get("stage1_model_path") or ""
    if ckpt:
        load_checkpoint(model, ckpt)
        print(json.dumps({"loaded_checkpoint": ckpt}))
    post = params["postprocess"]
    stage1 = make_stage1_fn(model, generate_anchor_box(
        post["anchor_args"], post.get("order", "hwl")),
        postprocess_cfg(params), max_boxes=int(pc.get("max_boxes", 24)),
        device=dev)

    out_dir = opt.model_dir or pc.get("output_save_path", "precalc_out")
    bs = int(pc.get("batch_size", 4))
    written = []
    for split, key in (("train", "root_dir"), ("val", "validate_dir"),
                       ("test", "test_dir")):
        root = params.get(key)
        if not root or not os.path.exists(str(root)):
            continue
        # build_dataset reads validate_dir when train=False: pin the split
        base, batcher = build_dataset(
            dict(params, root_dir=root, validate_dir=root), train=False)
        dets, ids = [], []
        for start in range(0, len(base), bs):
            idxs = list(range(start, min(start + bs, len(base))))
            d = stage1(batcher.assemble([base[i] for i in idxs]))
            dets.append({k: v.cpu().numpy() for k, v in d.items()})
            ids.extend(idxs)
        merged = {k: np.concatenate([d[k] for d in dets]) for k in dets[0]}
        split_dir = os.path.join(out_dir, split)
        os.makedirs(split_dir, exist_ok=True)
        path = os.path.join(split_dir, "stage1_boxes.json")
        dump_stage1_json(merged, ids, path)
        written.append(path)
        print(json.dumps({"split": split, "frames": len(ids), "json": path}))
    return written


def cmd_config_generate(opt):
    """Expand a yaml through its parser and dump it (ref
    tools/config_generate.py:9-23)."""
    params = load_yaml(opt.hypes_yaml)
    out = opt.output or opt.hypes_yaml.replace(".yaml", "_full.yaml")
    save_yaml(params, out)
    print(out)
    return out


def _apply_bf16(opt):
    """``--bf16``: the bfloat16 compute policy for the run (models/layers.
    set_compute_dtype, as coalign_tpu/tools/run.py:424-432 sets it);
    parameters, batch-norm statistics and geometry stay float32."""
    if opt.bf16:
        from coalign_tpu_torch.models.layers import set_compute_dtype
        set_compute_dtype(torch.bfloat16)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("train", "inference", "config_generate", "precalc",
                 "export"):
        s = sub.add_parser(name)
        s.add_argument("-y", "--hypes_yaml", default=None)
        s.add_argument("--model_dir", default=None)
        s.add_argument("--root_dir", default=None,
                       help="override the dataset root")
        s.add_argument("--fusion_method", default=None,
                       help="late/early/intermediate/no/no_w_uncertainty/"
                            "single; defaults to the config's fusion kind")
        s.add_argument("--epochs", type=int, default=None)
        s.add_argument("--eval_frames", type=int, default=None)
        s.add_argument("--output", default=None)
        s.add_argument("--device", default=None,
                       help="torch device; CUDA when not given")
        s.add_argument("--save_npy", action="store_true",
                       help="save each frame's detections and gt under "
                            "<model_dir>/npy (ref inference_utils.py:176)")
        s.add_argument("--save_vis", action="store_true",
                       help="not ported yet (ROADMAP item 9)")
        s.add_argument("--profile", default=None,
                       help="not ported yet (ROADMAP item 9)")
        s.add_argument("--bf16", action="store_true",
                       help="bfloat16 compute policy for the convs and "
                            "linears (ref train.py --half; parameters stay "
                            "float32)")
    opt = p.parse_args(argv)
    if opt.cmd == "export":
        raise NotImplementedError(
            "export waits for the port of serving.py (ROADMAP item 9)")
    for flag, what in _REFUSED_FLAGS.items():
        if getattr(opt, flag):
            raise NotImplementedError(f"--{flag} waits for {what}")
    opt.device = resolve_device(opt.device)
    _apply_bf16(opt)
    return {"train": cmd_train, "inference": cmd_inference,
            "precalc": cmd_precalc,
            "config_generate": cmd_config_generate}[opt.cmd](opt)


if __name__ == "__main__":
    main()
