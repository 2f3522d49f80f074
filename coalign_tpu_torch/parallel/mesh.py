"""Data parallelism over a torch.distributed process group.

Port of coalign_tpu/parallel/mesh.py (ref opencood/tools/train_ddp.py:
45-110): the JAX package shards the batch over the ``data`` axis of a Mesh
and replicates the parameters, and XLA reduces the gradients. The port's
data axis is the default process group: ``make_mesh`` names it, with this
process's rank and the world; ``shard_batch`` takes this rank's slice of
the batch; ``replicate`` makes every rank's parameters rank 0's.
train.make_train_step(mesh=...) runs the step on the slice and combines
the gradients (its docstring states the rule).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from coalign_tpu_torch.parallel.distributed import get_dist_info


class Mesh(NamedTuple):
    """The data axis: the process group (None: the default one, or none
    at all at world 1), this process's rank in it and its size."""
    group: object
    rank: int
    world: int


def make_mesh(group=None) -> Mesh:
    """The data axis over ``group`` (the default process group unless
    named); rank 0 of 1 when no group is initialized."""
    if group is not None:
        return Mesh(group, dist.get_rank(group), dist.get_world_size(group))
    rank, world = get_dist_info()
    return Mesh(None, rank, world)


def _slice(x, mesh: Mesh, where: str):
    n = len(x)
    if n % mesh.world:
        raise ValueError(f"batch leaf {where}: leading dimension {n} is not "
                         f"divisible by the {mesh.world} ranks")
    k = n // mesh.world
    return x[mesh.rank * k:(mesh.rank + 1) * k]


def shard_batch(batch: dict, mesh: Mesh, where: str = "") -> dict:
    """This rank's slice of every leaf's leading dimension, as the JAX
    package's NamedSharding(P("data")) places it; raises when a leading
    dimension is not divisible by the world.

    Every leaf of the port's batches leads with the sample axis B: the
    batchers' points (B, L, N, 4), masks, pairwise and per-agent matrices,
    poses, gt, early fusion's shipped_points (B,), the KD teacher's merged
    cloud (B, 1, L*N, 4), the camera batch's image_inputs (B, L, ncam,
    ...). The flattened (B*L, ...) agent rows exist only inside a model's
    forward, made from the sliced batch, and the anchor grid lives in the
    AnchorSpec, not in the batch, so slicing every leaf is slicing by
    sample. Scalar leaves stay whole."""
    out = {}
    for key, value in batch.items():
        name = f"{where}{key}"
        if isinstance(value, dict):
            out[key] = shard_batch(value, mesh, name + ".")
        elif isinstance(value, (np.ndarray, torch.Tensor)) and value.ndim:
            out[key] = _slice(value, mesh, name)
        else:
            out[key] = value
    return out


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: Mesh | None = None):
    """Broadcast ``model``'s parameters and buffers from rank 0 over the
    mesh's group, so that every rank starts from the same weights and
    running statistics. Returns the model."""
    mesh = mesh or make_mesh()
    if mesh.world == 1:
        return model
    src = (0 if mesh.group is None
           else dist.get_global_rank(mesh.group, 0))
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src, group=mesh.group)
    return model
