"""DiscoNet knowledge-distillation training.

Port of coalign_tpu/tools/train_kd.py (ref opencood/tools/train_w_kd.py:
32-112): a DiscoNet student (``point_pillar_disconet``) trains against a
frozen early-fusion teacher (``point_pillar_disconet_teacher``, the same
model args) that sees the merged ego-frame cloud of each frame
(data/batch.KDFusionBatcher).

Usage:
  python -m coalign_tpu_torch.tools.train_kd -y <kd.yaml> \\
      [--model_dir out] [--teacher_dir dir] [--epochs N] [--root_dir d]
      [--device cuda|cpu]

The teacher comes from ``--teacher_dir``'s checkpoint (bestval first, else
the numerically latest ``net_epoch{N}.pth``: a reference run's or the
port's own, loaded strictly), or, without one, from the seed. The CLI
prints one JSON line an epoch (the loss terms of its last step) and saves
the student as ``net_epoch{epochs}.pth`` beside the run's config.yaml.
"""

from __future__ import annotations

import argparse
import json
import os

from coalign_tpu_torch.train import make_train_step


def make_kd_train_step(student, teacher, loss_fn, anchor_spec, optimizer,
                       scheduler=None, device=None):
    """(batch) -> loss terms of one distillation step (coalign_tpu/tools/
    train_kd.py:20-48): the teacher in eval mode without gradients, the
    student in train mode, ``loss_fn`` (a loss/disconet_loss.DiscoNetLoss)
    on the student's outputs merged with the teacher's, then the
    student's optimizer step (train.make_train_step with a teacher)."""
    return make_train_step(student, loss_fn, anchor_spec, optimizer,
                           scheduler, device=device, teacher=teacher)


def load_teacher(model_args: dict, teacher_dir: str | None, device):
    """(the frozen teacher on ``device``, the checkpoint it loaded or
    None). A checkpoint dir's model uses its config.yaml's
    ``pillar_vfe.pad_parity`` where the config sets it, else True (a
    reference checkpoint's pad slots take part in the pillar max;
    coalign_tpu/tools/train_kd.py:98-104)."""
    from coalign_tpu_torch.config.yaml_utils import load_yaml
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.train import inference_checkpoint, load_checkpoint

    found = inference_checkpoint(teacher_dir) if teacher_dir else None
    if teacher_dir and found is None:
        raise FileNotFoundError(
            f"no net_epoch*.pth teacher in {teacher_dir} (a JAX package's "
            "step_* checkpoint converts with utils/weights.from_jax_params)")
    args = dict(model_args)
    if found is not None:
        pad_parity = True
        cfg = os.path.join(teacher_dir, "config.yaml")
        if os.path.exists(cfg):
            pad_parity = load_yaml(cfg)["model"]["args"].get(
                "pillar_vfe", {}).get("pad_parity", True)
        args["pillar_vfe"] = dict(args.get("pillar_vfe", {}),
                                  pad_parity=pad_parity)
    teacher = build_model({"core_method": "point_pillar_disconet_teacher",
                           "args": args}, device=device, seed=1)
    if found is not None:
        load_checkpoint(teacher, found[1])
    return teacher, None if found is None else found[1]


def main(argv=None):
    from coalign_tpu_torch.config.yaml_utils import load_yaml, save_yaml
    from coalign_tpu_torch.data import build_dataset
    from coalign_tpu_torch.data.batch import KDFusionBatcher
    from coalign_tpu_torch.data.prefetch import prefetch
    from coalign_tpu_torch.loss import build_loss
    from coalign_tpu_torch.models.zoo import build_model
    from coalign_tpu_torch.postprocess.anchors import make_anchor_spec
    from coalign_tpu_torch.runtime import resolve_device
    from coalign_tpu_torch.train import build_optimizer, save_checkpoint

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-y", "--hypes_yaml", required=True)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--teacher_dir", default=None,
                   help="run directory of the frozen teacher's checkpoint")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--root_dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device; CUDA when not given")
    opt = p.parse_args(argv)
    dev = resolve_device(opt.device)

    params = load_yaml(opt.hypes_yaml)
    if opt.root_dir:
        params["root_dir"] = opt.root_dir
    margs = params["model"]["args"]
    vfe = margs.get("pillar_vfe")
    if vfe is not None:   # the port trains with pad slots outside the max
        vfe.setdefault("pad_parity", False)
    base, inter = build_dataset(params, train=True)
    # the teacher's merged view beside the student's batch, with the
    # augmentor and noise build_dataset configured
    batcher = KDFusionBatcher(
        max_cav=params["train_params"].get("max_cav", 5),
        max_points=inter.max_points, max_objects=inter.max_objects,
        lidar_range=params["preprocess"]["cav_lidar_range"],
        comm_range=params.get("comm_range", 70.0),
        pos_std=inter.pos_std, rot_std=inter.rot_std,
        augmentor=inter.augmentor, train=True, native=inter.native)

    student = build_model({"core_method": "point_pillar_disconet",
                           "args": margs}, device=dev)
    teacher, t_path = load_teacher(margs, opt.teacher_dir, dev)
    if t_path is not None:
        print(json.dumps({"imported_reference_teacher": t_path}))
    loss_fn = build_loss(params["loss"])
    post = params["postprocess"]
    spec = make_anchor_spec(post["anchor_args"], post["target_args"],
                            post.get("order", "hwl"))
    tp = params["train_params"]
    optimizer, scheduler = build_optimizer(
        student.parameters(), params["optimizer"],
        params.get("lr_scheduler"), max(1, len(base) // tp["batch_size"]))
    step = make_kd_train_step(student, teacher, loss_fn, spec, optimizer,
                              scheduler, device=dev)

    model_dir = opt.model_dir or os.path.join("logs",
                                              params.get("name", "kd"))
    os.makedirs(model_dir, exist_ok=True)
    save_yaml(params, os.path.join(model_dir, "config.yaml"))
    history = []
    for epoch in range(opt.epochs or tp["epoches"]):
        terms = None
        for batch in prefetch(batcher.batches(base, tp["batch_size"]),
                              size=2, device=dev):
            terms = step(batch)
        if terms is None:   # fewer frames than a batch (drop_last)
            print(json.dumps({"epoch": epoch, "batches": 0}))
            continue
        m = {k: float(v) for k, v in terms.items()}
        m["epoch"] = epoch
        history.append(m)
        print(json.dumps(m))
    save_checkpoint(student, model_dir, len(history))
    return student, history


if __name__ == "__main__":
    main()
