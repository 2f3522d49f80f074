"""Process groups: environment detection, initialization, batch-wide sums.

Port of coalign_tpu/parallel/distributed.py (ref opencood/tools/
multi_gpu_utils.py:16-38): the JAX package forms one multi-host device mesh
with jax.distributed.initialize; the port opens a torch.distributed
process group, NCCL on CUDA and gloo on the CPU, from the same variables
(RANK / WORLD_SIZE as torchrun sets them, or SLURM_PROCID /
SLURM_NTASKS; the address from COORDINATOR_ADDRESS or MASTER_ADDR and
MASTER_PORT).

global_sum is what makes a data-parallel step the single-process step on
the global batch (the JAX step over a sharded batch computes its batch
norms' statistics and its loss normalizers over the whole batch): inside a
``global_sums(mesh)`` block, which train.make_train_step(mesh=...) opens
around its forward and loss, every batch-wide sum of the batch norms
(models/layers._masked_moments) and of the losses (loss/) is all-reduced
over the mesh's group, on the autograd graph. Outside such a block it is
the identity, with or without a process group, and nothing the port
computes changes.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

_MESHES: list = []     # the meshes of the open global_sums blocks


def detect_env():
    """(rank, world_size, coordinator "host:port") from the environment, or
    None (the JAX package's detect_env, same variables and defaults)."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    elif "SLURM_PROCID" in os.environ:
        rank = int(os.environ["SLURM_PROCID"])
        world = int(os.environ.get("SLURM_NTASKS", "1"))
    else:
        return None
    coord = os.environ.get("COORDINATOR_ADDRESS",
                           os.environ.get("MASTER_ADDR", "127.0.0.1")
                           + ":" + os.environ.get("MASTER_PORT", "8476"))
    return rank, world, coord


def local_rank() -> int:
    """This process's device index on its host: LOCAL_RANK (torchrun),
    SLURM_LOCALID, else 0."""
    return int(os.environ.get("LOCAL_RANK",
                              os.environ.get("SLURM_LOCALID", "0")))


def init_distributed_mode(backend: str | None = None, device=None) -> dict:
    """Open the default process group when the environment names a world of
    more than one process; a no-op otherwise, as in the JAX package.

    ``backend``: NCCL unless ``device`` is the CPU (gloo), unless named.
    A failed initialization raises; nothing carries on as one process.
    Returns {'rank', 'world_size', 'distributed'}."""
    env = detect_env()
    if env is None or env[1] <= 1:
        return {"rank": 0, "world_size": 1, "distributed": False}
    rank, world, coord = env
    if backend is None:
        cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if cpu else "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            rank=rank, world_size=world)
    return {"rank": rank, "world_size": world, "distributed": True}


def get_dist_info() -> tuple:
    """(rank, world_size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@contextlib.contextmanager
def global_sums(mesh):
    """A block whose batch-wide sums (global_sum, global_mean) are the
    whole batch's over ``mesh``'s group (parallel/mesh.Mesh), whose
    process group must be open; the step of a data-parallel run
    (train.make_train_step) runs its forward and loss in one."""
    _MESHES.append(mesh)
    try:
        yield
    finally:
        _MESHES.pop()


def summing_mesh():
    """The mesh of the innermost open global_sums block; None outside
    one."""
    return _MESHES[-1] if _MESHES else None


class _AllReduceSum(torch.autograd.Function):
    """An all-reduce (sum) over ``group`` whose backward all-reduces the
    gradient over the same group, as torch.distributed.nn.functional.
    all_reduce's does."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the group of the open global_sums block, on the
    autograd graph (the backward all-reduces the gradient: every rank's
    copy of a global loss is differentiated, so the ranks' parameter
    gradients sum to world x the global loss's, train.make_train_step);
    ``t`` itself outside a block."""
    if not _MESHES:
        return t
    return _AllReduceSum.apply(t, _MESHES[-1].group)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``t`` over the open block's batch:
    the ranks' means summed over the world (shard_batch gives every rank
    as many elements), so that at world 1 it is ``t.mean()`` to the bit;
    ``t.mean()`` outside a block."""
    mesh = summing_mesh()
    if mesh is None:
        return t.mean()
    return global_sum(t.mean()) / mesh.world
