"""Bandwidth accounting and the optional Draco point-compression measure.

Port of coalign_tpu/utils/compression.py (ref
opencood/utils/draco_compression.py, docs/md_files/lidar_benchmark.md): the
transmitted feature sizes are computed from shapes (the communication is
simulated in-tensor); a Draco measurement shells out only when the
``draco_encoder`` binary exists. Host-side numpy, as in the JAX package.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np


def feature_map_bytes(shape, dtype_bits: int = 32,
                      compression_ratio: float = 1.0) -> float:
    """Bytes to transmit one BEV feature map (through the NaiveCompressor
    bottleneck's ratio, optionally)."""
    numel = float(np.prod(shape))
    return numel * dtype_bits / 8.0 / max(compression_ratio, 1e-9)


def comm_volume_mbits(shape, dtype_bits: int = 32,
                      compression_ratio: float = 1.0) -> float:
    """Mbit per agent per frame (lidar_benchmark.md's accounting)."""
    return feature_map_bytes(shape, dtype_bits, compression_ratio) * 8 / 1e6


def masked_comm_volume_mbits(mask_rate: float, shape,
                             dtype_bits: int = 32) -> float:
    """Where2comm's sparse transmission: only the masked pixels move."""
    return comm_volume_mbits(shape, dtype_bits) * float(mask_rate)


def draco_available() -> bool:
    return shutil.which("draco_encoder") is not None


def draco_compressed_bytes(points: np.ndarray, qp: int = 14) -> int:
    """Compress (N, 3) points with the Draco command line and return the
    encoded size. Raises RuntimeError when draco_encoder is not installed
    (the accounting above is the default path)."""
    if not draco_available():
        raise RuntimeError("draco_encoder binary not found")
    with tempfile.TemporaryDirectory() as d:
        ply = os.path.join(d, "pts.ply")
        drc = os.path.join(d, "pts.drc")
        with open(ply, "w") as f:
            f.write("ply\nformat ascii 1.0\n"
                    f"element vertex {len(points)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "end_header\n")
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        subprocess.run(["draco_encoder", "-point_cloud", "-i", ply,
                        "-o", drc, "-qp", str(qp)],
                       check=True, capture_output=True)
        return os.path.getsize(drc)
