"""The robust V2VNet's three-stage training curriculum.

Port of coalign_tpu/tools/train_robust.py (ref point_pillar_v2vnet_robust.py
:72-139, backbone_fix / unfix):
  stage 0  train everything but the pose and attention nets (plain V2VNet);
  stage 1  train only the pose regression net, the attention net and alpha;
  stage 2  train everything.
A parameter belongs to the robust nets when its name contains
``pose_regression``, ``attention`` or ``alpha`` (models/fuse/robust.py
names them so), as the JAX package labels its parameter paths. A frozen
parameter takes no update and no weight decay (optax.set_to_zero): the
optimizer is built over the trainable ones only, and the frozen ones stop
taking gradients. Batch-norm statistics of the frozen modules still move
in training, as in the JAX package, whose batch_stats always update: the
model is not put in eval mode. As in the JAX CLI, ``tools/run.py train``
applies no stage: the curriculum is this module's, for a caller's loop.
"""

from __future__ import annotations

from torch import nn

from coalign_tpu_torch.train import build_optimizer

ROBUST_KEYS = ("pose_regression", "attention", "alpha")


def is_robust(name: str) -> bool:
    return any(k in name for k in ROBUST_KEYS)


def stage_param_labels(model: nn.Module, stage: int) -> dict:
    """{parameter name: 'train' or 'freeze'} at ``stage`` (0, 1 or 2)."""
    def label(name):
        if stage == 0:
            return "freeze" if is_robust(name) else "train"
        if stage == 1:
            return "train" if is_robust(name) else "freeze"
        return "train"
    return {name: label(name) for name, _ in model.named_parameters()}


def apply_stage(model: nn.Module, stage: int) -> list:
    """Freeze the parameters ``stage`` freezes (requires_grad off) and free
    the others; returns the trainable parameters."""
    labels = stage_param_labels(model, stage)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
        if labels[name] == "train":
            trainable.append(p)
    return trainable


def staged_optimizer(model: nn.Module, stage: int, opt_cfg: dict,
                     sched_cfg: dict | None = None,
                     steps_per_epoch: int = 1000, start_step: int = 0):
    """apply_stage, then train.build_optimizer over the stage's trainable
    parameters: (optimizer, scheduler)."""
    return build_optimizer(apply_stage(model, stage), opt_cfg, sched_cfg,
                           steps_per_epoch, start_step)
