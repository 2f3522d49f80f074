"""Training: label assignment, forward, loss, backward and an AdamW step.

Port of coalign_tpu/train.py (ref opencood/tools/train.py:32-194). As in
the JAX package, labels are assigned on the device from the padded gt
boxes, so the host only feeds raw padded points. The model's parameters
and running statistics, and the optimizer's state, live in the torch
objects that the step updates in place; checkpoints are torch state dicts
under the reference's file names.

Data parallelism (parallel/mesh.py): with a ``mesh``, the step is the
single-process step on the global batch, as the JAX step over a batch
sharded on its mesh is. Each rank runs forward and backward on its slice
of the batch (shard_batch, which train_epochs applies on the host before
the copy to the device); inside the step's global_sums block the batch
norms' statistics and the losses' batch-wide sums are all-reduced over
the mesh's group on the autograd graph
(parallel/distributed.global_sum), so every rank holds the global loss.
The rule for the gradients is the mean: the backward of those
all-reduces sums every rank's copy of the global loss, so the ranks'
parameter gradients sum to world x its gradient; the step all-reduces
them and divides by the world, after which every rank holds the global
loss's gradient on the whole batch and runs the same optimizer step, and
the parameters stay equal without a broadcast. Only rank 0 writes
checkpoints.
"""

from __future__ import annotations

import contextlib
import os
import re

import torch

from coalign_tpu_torch.data.prefetch import prefetch
from coalign_tpu_torch.inference import to_device
from coalign_tpu_torch.parallel.distributed import global_sums
from coalign_tpu_torch.parallel.mesh import shard_batch
from coalign_tpu_torch.postprocess.anchors import (AnchorSpec,
                                                   assign_targets,
                                                   assign_targets_per_agent)
from coalign_tpu_torch.postprocess.dense_bev import (DenseBevSpec,
                                                     assign_dense_targets)
from coalign_tpu_torch.runtime import configure_cuda, resolve_device
from coalign_tpu_torch.utils.profiling import stage
from coalign_tpu_torch.utils.weights import load_pth

_LABEL_DTYPES = {"gt_boxes": torch.float32, "gt_mask": torch.bool}


def assign_labels(gt_boxes, gt_mask, spec, dtype=torch.float32) -> dict:
    """The step's labels from the gt boxes taken in ``dtype``, the model's,
    as the JAX package's labels follow its batch's float dtype: the anchor
    targets of an AnchorSpec (postprocess/anchors.assign_targets, float32
    as the JAX package casts them), or the dense label map (in ``dtype``)
    of the anchor-free PIXOR family's DenseBevSpec (postprocess/dense_bev.
    assign_dense_targets; coalign_tpu/train.py:98-107)."""
    gt_boxes = gt_boxes.to(dtype)
    if isinstance(spec, DenseBevSpec):
        return {"label_map": assign_dense_targets(gt_boxes, gt_mask, spec)}
    return assign_targets(gt_boxes, gt_mask, spec)


def lr_factor(sched_cfg: dict | None, steps_per_epoch: int = 1000):
    """step count -> factor of the base learning rate, for the yaml
    ``lr_scheduler`` subtree: the reference's three schedulers (ref
    train_utils.py:209-246: MultiStepLR, StepLR, ExponentialLR, each
    stepping once an epoch), counted in steps as the JAX package's optax
    schedules count them. Step ``count`` (0 for the first update) uses
    factor(count):
      multistep    gamma ** (number of boundaries e * steps_per_epoch
                   that count has reached; optax.piecewise_constant_schedule)
      step         gamma ** floor(count / (step_size * steps_per_epoch))
      exponential  gamma ** floor(count / steps_per_epoch)
    (optax.exponential_decay with staircase=True)."""
    if not sched_cfg:
        return lambda count: 1.0
    method = sched_cfg.get("core_method", "multistep")
    if method == "multistep":
        gamma = sched_cfg.get("gamma", 0.1)
        bounds = [int(e) * steps_per_epoch
                  for e in sched_cfg.get("step_size", [])]
        return lambda count: gamma ** sum(count >= b for b in bounds)
    if method in ("step", "exponential"):
        every = steps_per_epoch * (int(sched_cfg.get("step_size", 1))
                                   if method == "step" else 1)
        gamma = sched_cfg.get("gamma", 0.1 if method == "step" else 0.98)
        return lambda count: gamma ** (count // every)
    return lambda count: 1.0


def build_optimizer(params, opt_cfg: dict, sched_cfg: dict | None = None,
                    steps_per_epoch: int = 1000, start_step: int = 0):
    """(optimizer, scheduler) from the yaml ``optimizer`` and
    ``lr_scheduler`` subtrees (coalign_tpu/train.py:28). A ``weight_decay``
    selects AdamW, whose decay is applied to the weights apart from the
    gradient, as optax.adamw's is; without one, Adam. ``eps`` is the
    yaml's (1e-10 for the flagship). The scheduler is stepped once per
    optimizer step (lr_factor); a resumed run passes the steps it has
    taken as ``start_step``, so that its schedule goes on from there."""
    lr = opt_cfg.get("lr", 1e-3)
    args = opt_cfg.get("args", {})
    wd = float(args.get("weight_decay", 0.0))
    eps = float(args.get("eps", 1e-8))
    if wd:
        opt = torch.optim.AdamW(params, lr=lr, eps=eps, weight_decay=wd)
    else:
        opt = torch.optim.Adam(params, lr=lr, eps=eps)
    factor = lr_factor(sched_cfg, steps_per_epoch)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: factor(count + start_step))
    return opt, sched


def reduce_gradients(params, mesh):
    """All-reduce the gradients of ``params`` over the mesh's group in one
    flat buffer and divide them by the world: the mean rule of the module
    docstring. Every parameter has a gradient (make_train_step fills the
    missing ones with zeros first)."""
    import torch.distributed as dist

    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(model, loss_fn, anchor_spec: AnchorSpec, optimizer,
                    scheduler=None, device=None, teacher=None, mesh=None):
    """(batch) -> loss terms of one training step on ``device`` (CUDA unless
    named; on CUDA it sets runtime.configure_cuda's policy).

    ``batch`` is the batcher's dict (numpy arrays or tensors). The step
    assigns labels from ``gt_boxes``/``gt_mask`` on the device
    (assign_labels: anchor targets, or PIXOR's dense label map; for a loss
    that ``wants_single_labels``, the two-stage models', each agent's own
    ``*_single`` targets too, assign_targets_per_agent), runs the
    model in train mode, the loss, the backward pass, ``optimizer.step()``
    and ``scheduler.step()``. The terms come back as 0-dim tensors on the
    device, detached: reading them (``float``) is the caller's sync. The
    stage/labels, stage/loss, stage/backward and stage/optimizer ranges
    name the step's stages in a torch.profiler trace, beside the model's
    own. The batch's float inputs take the model's float dtype.

    With a ``teacher`` (knowledge distillation, tools/train_kd.py) the
    frozen teacher runs on the batch in eval mode without gradients before
    the model, and the loss takes its outputs merged into the model's.

    With a ``mesh`` (parallel/mesh.make_mesh, its process group open) the
    step is data-parallel: it takes this rank's slice of the global batch
    (parallel/mesh.shard_batch), runs the model and the loss with the
    mesh's global sums on, combines the gradients over the mesh's group
    by the module docstring's rule and returns the global loss terms.
    Every rank must hold the same weights first (parallel/mesh.replicate)."""
    dev = resolve_device(device)
    model.to(dev)
    if teacher is not None:
        teacher.to(dev).eval()
    if dev.type == "cuda":
        configure_cuda()
    spec = anchor_spec.to(dev)

    def step(batch: dict) -> dict:
        float_dtype = next(model.parameters()).dtype
        b = to_device(batch, dev, float_dtype)
        with stage("stage/labels"):
            for key, dtype in _LABEL_DTYPES.items():
                b[key] = torch.as_tensor(batch[key], dtype=dtype, device=dev)
            labels = assign_labels(b["gt_boxes"], b["gt_mask"], spec,
                                   float_dtype)
            if getattr(loss_fn, "wants_single_labels", False):
                # each agent's own labels for its *_single maps (the
                # two-stage loss; coalign_tpu/train.py:111-123)
                singles = assign_targets_per_agent(
                    b["gt_boxes"].to(float_dtype), b["gt_mask"],
                    b["lidar_pose_clean"], b["agent_mask"], spec)
                labels.update({k + "_single": v for k, v in singles.items()})
        t_out = {}
        if teacher is not None:
            with torch.no_grad(), stage("stage/teacher"):
                t_out = teacher(b)
        model.train()
        with (contextlib.nullcontext() if mesh is None
              else global_sums(mesh)):
            out = dict(model(b), **t_out)
            with stage("stage/loss"):
                total, terms = loss_fn(out, labels)
        optimizer.zero_grad(set_to_none=True)
        with stage("stage/backward"):
            total.backward()
        with stage("stage/optimizer"):
            # a parameter the loss does not reach (Where2comm's single
            # heads under point_pillar_loss) gets a zero gradient, as in
            # JAX, so that AdamW still decays it as optax.adamw does
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            if mesh is not None:
                reduce_gradients([p for group in optimizer.param_groups
                                  for p in group["params"]], mesh)
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
        return {k: v.detach() for k, v in terms.items()}

    return step


def checkpoint_path(ckpt_dir: str, epoch: int, bestval: bool = False) -> str:
    """The reference's file names (ref train.py:153-168):
    net_epoch{N}.pth, net_epoch_bestval_at{N}.pth."""
    name = (f"net_epoch_bestval_at{epoch}.pth" if bestval
            else f"net_epoch{epoch}.pth")
    return os.path.join(ckpt_dir, name)


def save_checkpoint(model, ckpt_dir: str, epoch: int,
                    bestval: bool = False) -> str:
    """The model's state dict (parameters and running statistics) under
    checkpoint_path; a new bestval file replaces the previous one, as the
    reference's does. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, epoch, bestval)
    if bestval:
        for name in os.listdir(ckpt_dir):
            if name.startswith("net_epoch_bestval_at"):
                os.remove(os.path.join(ckpt_dir, name))
    torch.save(model.state_dict(), path)
    return path


_EPOCH_FILE = re.compile(r"^net_epoch(\d+)\.pth$")
_BESTVAL_FILE = re.compile(r"^net_epoch_bestval_at(\d+)\.pth$")


def _numbered(ckpt_dir: str, pattern) -> list:
    """(epoch, path) of the files of ``ckpt_dir`` that ``pattern`` names,
    in numeric order of the epoch (net_epoch9 before net_epoch10)."""
    found = [(int(m.group(1)), os.path.join(ckpt_dir, name))
             for name in os.listdir(ckpt_dir)
             if (m := pattern.match(name))]
    return sorted(found)


def latest_checkpoint(ckpt_dir: str):
    """(epoch, path) of the numerically latest ``net_epoch{N}.pth`` in
    ``ckpt_dir``, where a run resumes, or None."""
    found = _numbered(ckpt_dir, _EPOCH_FILE)
    return found[-1] if found else None


def inference_checkpoint(ckpt_dir: str):
    """The checkpoint to evaluate, as the reference's load_saved_model
    picks it (ref train_utils.py:29-74): ``net_epoch_bestval_at{N}.pth``
    when there is one, else the numerically latest ``net_epoch{N}.pth``;
    (epoch, path), or None."""
    best = _numbered(ckpt_dir, _BESTVAL_FILE)
    return best[-1] if best else latest_checkpoint(ckpt_dir)


def load_checkpoint(model, path: str):
    """Load a checkpoint strictly into ``model`` (utils/weights.load_pth);
    the reference's own checkpoints load the same way."""
    return load_pth(model, path)


@torch.no_grad()
def validate(model, loss_fn, anchor_spec: AnchorSpec, batcher, dataset,
             batch_size: int, device=None):
    """Mean validation loss with the running statistics (ref
    train.py:129-150), over ``dataset`` in order on ``device`` (CUDA unless
    named). The model's train/eval mode is restored afterwards. Its sums
    are this process's own: under a data-parallel run every rank
    validates the whole set and gets the single-process value, as the JAX
    package validates outside its mesh."""
    dev = resolve_device(device)
    spec = anchor_spec.to(dev)
    was_training = model.training
    model.to(dev).eval()
    losses = []
    try:
        for batch in prefetch(batcher.batches(dataset, batch_size,
                                              shuffle=False, drop_last=False),
                              size=2, device=dev):
            labels = assign_labels(batch["gt_boxes"], batch["gt_mask"],
                                   spec)
            total, _ = loss_fn(model(to_device(
                batch, dev, next(model.parameters()).dtype)), labels)
            losses.append(total)
    finally:
        model.train(was_training)
    return float(torch.stack(losses).mean()) if losses else 0.0


def train_epochs(model, loss_fn, anchor_spec: AnchorSpec, optimizer,
                 scheduler, batcher, dataset, *, epochs: int,
                 batch_size: int, log_every: int = 10,
                 ckpt_dir: str | None = None, save_freq: int = 0,
                 callback=None, val_dataset=None, eval_freq: int = 0,
                 start_epoch: int = 0, device=None, mesh=None):
    """Epoch loop with periodic validation and the bestval checkpoint (ref
    train.py:102-171; coalign_tpu/train.py:201). Batches are assembled and
    copied to the device a step ahead (data/prefetch.py). Every
    ``log_every`` steps the loss terms are read to the host and recorded
    (and passed to ``callback``); each ``eval_freq`` epochs the
    validation loss is, and a lower one saves the bestval checkpoint;
    each ``save_freq`` epochs a checkpoint is saved. ``start_epoch``
    numbers the epochs of a resumed run after the earlier run's. Returns
    the history.

    With a ``mesh`` the steps are data-parallel (make_train_step): every
    rank draws the same global batches from its batcher (the same seed),
    keeps its slice on the host (shard_batch) and copies only that to its
    device; the validation loss is every rank's own (validate); rank 0
    alone saves checkpoints."""
    dev = resolve_device(device)
    step_fn = make_train_step(model, loss_fn, anchor_spec, optimizer,
                              scheduler, device=dev, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        ckpt_dir = None
    history = []
    step = 0
    best_val = float("inf")
    for e in range(start_epoch, start_epoch + epochs):
        batches = batcher.batches(dataset, batch_size)
        if mesh is not None:
            batches = (shard_batch(b, mesh) for b in batches)
        for batch in prefetch(batches, size=2, device=dev):
            terms = step_fn(batch)
            step += 1
            if step % log_every == 0:
                m = {k: float(v) for k, v in terms.items()}
                m.update(epoch=e, step=step)
                history.append(m)
                if callback:
                    callback(m)
        if val_dataset is not None and eval_freq and (e + 1) % eval_freq == 0:
            vl = validate(model, loss_fn, anchor_spec, batcher, val_dataset,
                          batch_size, device=dev)
            history.append({"epoch": e, "step": step, "val_loss": vl})
            if callback:
                callback(history[-1])
            if vl < best_val and ckpt_dir:
                best_val = vl
                save_checkpoint(model, ckpt_dir, e + 1, bestval=True)
        if ckpt_dir and save_freq and (e + 1) % save_freq == 0:
            save_checkpoint(model, ckpt_dir, e + 1)
    return history
