"""The port's host data plane: ctypes loader of data_plane.cpp.

The port's copy of coalign_tpu/native/__init__.py. The C++ library parses
PCD files (one, or many in parallel threads), range-masks, subsamples and
pads points into the batch buffers, projects points and builds pillar
tables. ``g++`` builds it at the first call, into ``coalign_tpu_torch/
_build/`` under a name keyed by the hash of its source and flags; nothing is
built when this module is imported. A failed build raises, with the
compiler's output: unlike the JAX loader, this one never gives way to numpy
on its own. The numpy path is the caller's choice (``native=False`` on the
reader and the batchers, data/opv2v.py and data/batch.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "data_plane.cpp"
BUILD_DIR = _PKG / "_build"
COMPILER = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_loaded: dict[str, ctypes.CDLL] = {}


def build(timeout: float = 300.0) -> tuple[Path, float]:
    """Compile the library unless one for this source and these flags
    exists. Returns (its path, the seconds the compile took; 0 when it was
    already built). Raises RuntimeError if the compiler cannot be run or
    fails, with what it printed."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join((COMPILER,) + CXX_FLAGS).encode()
                         ).hexdigest()[:16]
    lib = BUILD_DIR / f"data_plane_{key}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        t = time.perf_counter()
        subprocess.run([COMPILER, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                       capture_output=True, text=True, timeout=timeout,
                       check=True)
        seconds = time.perf_counter() - t
        os.replace(tmp, lib)
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"{COMPILER} failed on {SOURCE.name}:\n"
                           f"{err.stderr}") from err
    except OSError as err:
        raise RuntimeError(f"cannot run {COMPILER!r} to build "
                           f"{SOURCE.name}: {err}") from err
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, seconds


def load() -> ctypes.CDLL:
    """The library, built and loaded once a process, with the JAX loader's
    signatures (coalign_tpu/native/__init__.py:32-66)."""
    lib = _loaded.get("data_plane")
    if lib is not None:
        return lib
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    i64, f32, ptr = ctypes.c_int64, ctypes.c_float, ctypes.c_void_p
    lib.parse_pcd.restype = i64
    lib.parse_pcd.argtypes = [ctypes.c_char_p, ptr, i64]
    lib.parse_pcd_batch.restype = i64
    lib.parse_pcd_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), i64,
                                    ptr, ptr, i64, i64]
    lib.mask_pad_points.restype = i64
    lib.mask_pad_points.argtypes = [ptr, i64, ptr, f32, f32, ptr, ptr, i64]
    lib.transform_points.restype = None
    lib.transform_points.argtypes = [ptr, i64, ptr]
    lib.voxelize_pillars.restype = i64
    lib.voxelize_pillars.argtypes = [ptr, i64, ptr, f32, f32, i64, i64, i64,
                                     i64, ptr, ptr, ptr, ptr, ptr,
                                     ctypes.c_int32]
    _loaded["data_plane"] = lib
    return lib


def parse_pcd(path: str, max_points: int = 200000) -> np.ndarray:
    """A PCD file's x, y, z, intensity as (N, 4) float32 (rows with a NaN
    coordinate dropped, at most ``max_points``)."""
    out = np.empty((max_points, 4), dtype=np.float32)
    n = load().parse_pcd(path.encode(), out.ctypes.data, max_points)
    if n < 0:
        raise IOError(f"parse_pcd failed for {path}")
    return out[:n].copy()


def parse_pcd_batch(paths, max_points: int = 200000,
                    n_threads: int = 0) -> list:
    """Parse many PCD files in parallel C++ threads (``n_threads``, 0 for
    one a core; the reference's DataLoader workers, ref tools/train.py:42).
    Returns one (N_i, 4) float32 view a file into one shared buffer (copy
    before writing to it). Raises on the first unreadable file."""
    n = len(paths)
    if n == 0:
        return []
    out = np.empty((n, max_points, 4), dtype=np.float32)
    counts = np.empty(n, dtype=np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    load().parse_pcd_batch(arr, n, out.ctypes.data, counts.ctypes.data,
                           max_points, n_threads)
    bad = np.nonzero(counts < 0)[0]
    if len(bad):
        raise IOError(f"parse_pcd failed for {paths[int(bad[0])]}")
    return [out[i, :counts[i]] for i in range(n)]


def mask_pad_points(points: np.ndarray, lidar_range, max_out: int,
                    ego_x_radius: float = 0.0, ego_y_radius: float = 0.0):
    """Range mask (x in [xmin, xmax), y in [ymin, ymax), z in [zmin, zmax],
    outside the ego box |x| < ego_x_radius and |y| < ego_y_radius), then a
    deterministic stride subsample down to ``max_out`` and zero padding.
    Returns (padded (max_out, 4) float32, mask (max_out,) bool)."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    rng6 = np.asarray(lidar_range, dtype=np.float32)
    out = np.zeros((max_out, 4), dtype=np.float32)
    mask = np.zeros(max_out, dtype=np.uint8)
    load().mask_pad_points(pts.ctypes.data, len(pts), rng6.ctypes.data,
                           ctypes.c_float(ego_x_radius),
                           ctypes.c_float(ego_y_radius),
                           out.ctypes.data, mask.ctypes.data, max_out)
    return out, mask.astype(bool)


def transform_points(points: np.ndarray, tfm: np.ndarray) -> np.ndarray:
    """A copy of (N, 4) points with x, y, z projected by the row-major 4x4
    ``tfm``; the fourth column is kept."""
    pts = np.ascontiguousarray(points, dtype=np.float32).copy()
    t = np.ascontiguousarray(tfm, dtype=np.float32)
    load().transform_points(pts.ctypes.data, len(pts), t.ctypes.data)
    return pts


class PillarVoxelizer:
    """Host voxelizer: points -> a fixed-capacity pillar table. Its scratch
    grid is reset lazily by an epoch count (no clear a call). One instance
    a worker; not thread-safe."""

    def __init__(self, lidar_range, voxel_size, max_pillars=32000,
                 max_pts=32):
        self.lib = load()
        self.range6 = np.asarray(lidar_range, dtype=np.float32)
        self.vx, self.vy = float(voxel_size[0]), float(voxel_size[1])
        self.nx = int(round((lidar_range[3] - lidar_range[0]) / self.vx))
        self.ny = int(round((lidar_range[4] - lidar_range[1]) / self.vy))
        self.max_pillars = max_pillars
        self.max_pts = max_pts
        self.grid_slot = np.zeros(self.nx * self.ny, dtype=np.int32)
        self.grid_epoch = np.full(self.nx * self.ny, -1, dtype=np.int32)
        self.epoch = 0

    def __call__(self, points: np.ndarray):
        """(pillar points (M, P, 4), coords (M, 2) iy/ix, points a pillar
        (M,), pillar count) with M = max_pillars, zero padded."""
        pts = np.ascontiguousarray(points, dtype=np.float32)
        out = np.zeros((self.max_pillars, self.max_pts, 4), dtype=np.float32)
        coords = np.zeros((self.max_pillars, 2), dtype=np.int32)
        npts = np.zeros(self.max_pillars, dtype=np.int32)
        self.epoch += 1
        count = self.lib.voxelize_pillars(
            pts.ctypes.data, len(pts), self.range6.ctypes.data,
            ctypes.c_float(self.vx), ctypes.c_float(self.vy),
            self.nx, self.ny, self.max_pillars, self.max_pts,
            out.ctypes.data, coords.ctypes.data, npts.ctypes.data,
            self.grid_slot.ctypes.data, self.grid_epoch.ctypes.data,
            ctypes.c_int32(self.epoch))
        return out, coords, npts, int(count)
