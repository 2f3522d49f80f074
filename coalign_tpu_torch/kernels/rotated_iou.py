"""Pairwise rotated-BEV IoU: the CUDA kernel, its build and its wrapper.

The kernel (``csrc/rotated_iou.cu``) replaces the TPU kernel
``coalign_tpu/ops/pallas_iou.py:_iou_kernel``. It is compiled by ``nvcc``
into a shared library with a plain C interface, in ``coalign_tpu_torch/_build/``
under a name keyed by the hash of its source and flags, and loaded with
``ctypes``. Nothing is built or loaded when this module is imported: the first
call on a CUDA tensor does it.

:func:`rotated_iou` runs the kernel on CUDA tensors and the plain PyTorch
version (:func:`coalign_tpu_torch.utils.iou.rotated_iou_plain`) on CPU
tensors; for any other device it raises. ``rotated_iou.launches`` counts the
kernel's launches.
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
    for name, c in (("corners1", corners1), ("corners2", corners2)):
        if c.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {c.dtype}")
        if c.ndim not in (3, 4) or tuple(c.shape[-2:]) != (4, 2):
            raise ValueError(f"{name} must be (N, 4, 2) or (B, N, 4, 2), "
                             f"got {tuple(c.shape)}")
    if corners1.ndim != corners2.ndim or (
            corners1.ndim == 4 and corners1.shape[0] != corners2.shape[0]):
        raise ValueError(f"batch dims differ: {tuple(corners1.shape)} vs "
                         f"{tuple(corners2.shape)}")
    if corners1.device != corners2.device:
        raise ValueError(f"devices differ: {corners1.device} vs "
                         f"{corners2.device}")


def rotated_iou(corners1: torch.Tensor, corners2: torch.Tensor) -> torch.Tensor:
    """IoU matrix of rotated BEV boxes.

    corners1 (N, 4, 2), corners2 (M, 4, 2) -> (N, M); or with a leading
    batch dim, (B, N, 4, 2), (B, M, 4, 2) -> (B, N, M). float32.
    """
    _check(corners1, corners2)
    if corners1.device.type == "cpu":
        return rotated_iou_plain(corners1, corners2)
    if corners1.device.type != "cuda":
        raise ValueError(f"rotated_iou runs on cuda or cpu tensors, got "
                         f"{corners1.device}")
    if not (corners1.is_contiguous() and corners2.is_contiguous()):
        raise ValueError("rotated_iou needs contiguous corner tensors")
    batched = corners1.ndim == 4
    c1 = corners1 if batched else corners1[None]
    c2 = corners2 if batched else corners2[None]
    b, n, m = c1.shape[0], c1.shape[1], c2.shape[1]
    out = torch.empty((b, n, m), dtype=torch.float32, device=c1.device)
    if out.numel() == 0:
        return out if batched else out[0]
    with torch.cuda.device(c1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().rotated_iou_launch(
            c1.data_ptr(), c2.data_ptr(), out.data_ptr(), b, n, m, stream)
    if err != 0:
        raise RuntimeError(f"rotated_iou kernel launch failed: CUDA error "
                           f"{err}")
    rotated_iou.launches += 1
    return out if batched else out[0]


rotated_iou.launches = 0
