"""Pairwise rotated-BEV IoU: the CUDA kernel, its build and its wrapper.

The kernel (``csrc/rotated_iou.cu``) replaces the TPU kernel
``coalign_tpu/ops/pallas_iou.py:_iou_kernel``. It is compiled by ``nvcc``
into a shared library with a plain C interface, in ``coalign_tpu_torch/_build/``
under a name keyed by the hash of its source and flags, and loaded with
``ctypes``. Nothing is built or loaded when this module is imported: the first
call on a CUDA tensor does it.

The kernel is the registered op ``torch.ops.coalign_tpu_torch.rotated_iou``
((B, N, 4, 2), (B, M, 4, 2) -> (B, N, M) float32), registered when this
module is imported: its CUDA implementation is the ctypes launch on the
current stream (so a CUDA graph captures it as it is), its CPU
implementation the plain PyTorch version
(:func:`coalign_tpu_torch.utils.iou.rotated_iou_plain`), and its fake
implementation gives ``torch.export`` the output's shape, so an exported
program holds the kernel as one node. :func:`rotated_iou` calls the op on
CUDA or CPU tensors and raises for any other device.
``rotated_iou.launches`` counts the kernel's launches by the op's CUDA
implementation (a replayed CUDA graph launches it without Python and is not
counted).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from coalign_tpu_torch.utils.iou import rotated_iou_plain

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rotated_iou.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the loaded library, built once per process at the first launch: hashing
# the source on every call would cost the NMS more host time than the kernel
# takes on the device
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the rotated-IoU kernel is built "
                       "with the CUDA toolkit's nvcc")


def build(timeout: float = 300.0) -> tuple[Path, str]:
    """Compile the kernel unless a library for this source already exists.

    Returns (path of the shared library, nvcc's output; empty when the
    library was already built)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"rotated_iou_{key}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True,
                              timeout=timeout, check=True)
        os.replace(tmp, lib)
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{err.stderr}") \
            from err
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    lib = _loaded.get("rotated_iou")
    if lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.rotated_iou_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _loaded["rotated_iou"] = lib
    return lib


def _check(corners1: torch.Tensor, corners2: torch.Tensor):
    """The op's input contract: (B, N, 4, 2) and (B, M, 4, 2) float32 on
    one device, contiguous on CUDA (the kernel reads them by pointer)."""
    for name, c in (("corners1", corners1), ("corners2", corners2)):
        if c.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {c.dtype}")
        if c.ndim != 4 or tuple(c.shape[-2:]) != (4, 2):
            raise ValueError(f"{name} must be (B, N, 4, 2), got "
                             f"{tuple(c.shape)}")
        if c.device.type == "cuda" and not c.is_contiguous():
            raise ValueError(f"{name} must be contiguous on cuda")
    if corners1.shape[0] != corners2.shape[0]:
        raise ValueError(f"batch dims differ: {tuple(corners1.shape)} vs "
                         f"{tuple(corners2.shape)}")
    if corners1.device != corners2.device:
        raise ValueError(f"devices differ: {corners1.device} vs "
                         f"{corners2.device}")


@torch.library.custom_op("coalign_tpu_torch::rotated_iou", mutates_args=(),
                         device_types="cuda")
def rotated_iou_op(corners1: torch.Tensor, corners2: torch.Tensor
                   ) -> torch.Tensor:
    """The kernel on (B, N, 4, 2), (B, M, 4, 2) contiguous float32 CUDA
    tensors -> (B, N, M), launched on the current stream. Every
    implementation checks its inputs (_check): an exported program calls
    the op directly, without :func:`rotated_iou`."""
    _check(corners1, corners2)
    b, n, m = corners1.shape[0], corners1.shape[1], corners2.shape[1]
    out = torch.empty((b, n, m), dtype=torch.float32, device=corners1.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(corners1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().rotated_iou_launch(
            corners1.data_ptr(), corners2.data_ptr(), out.data_ptr(), b, n, m,
            stream)
    if err != 0:
        raise RuntimeError(f"rotated_iou kernel launch failed: CUDA error "
                           f"{err}")
    rotated_iou.launches += 1
    return out


@rotated_iou_op.register_kernel("cpu")
def _rotated_iou_cpu(corners1, corners2):
    _check(corners1, corners2)
    return rotated_iou_plain(corners1, corners2)


@rotated_iou_op.register_fake
def _rotated_iou_fake(corners1, corners2):
    _check(corners1, corners2)
    return corners1.new_empty((corners1.shape[0], corners1.shape[1],
                               corners2.shape[1]), dtype=torch.float32)


def rotated_iou(corners1: torch.Tensor, corners2: torch.Tensor) -> torch.Tensor:
    """IoU matrix of rotated BEV boxes, through the registered op.

    corners1 (N, 4, 2), corners2 (M, 4, 2) -> (N, M); or with a leading
    batch dim, (B, N, 4, 2), (B, M, 4, 2) -> (B, N, M). float32.
    """
    if corners1.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rotated_iou runs on cuda or cpu tensors, got "
                         f"{corners1.device}")
    if corners1.ndim != corners2.ndim or corners1.ndim not in (3, 4):
        raise ValueError(f"corners must be (N, 4, 2) or (B, N, 4, 2), got "
                         f"{tuple(corners1.shape)} and "
                         f"{tuple(corners2.shape)}")
    # the IoU has no gradient on either device: the kernel has no backward
    c1, c2 = corners1.detach(), corners2.detach()
    if c1.ndim == 4:
        return rotated_iou_op(c1, c2)
    return rotated_iou_op(c1[None], c2[None])[0]


rotated_iou.launches = 0
