"""Minimal .pcd point-cloud IO, numpy only.

The port's copy of coalign_tpu/data/pcd_io.py. The reference reads OPV2V
lidar with pypcd (ref opencood/utils/pcd_utils.py pcd_to_np); this reads the
subset of PCD v0.7 that OPV2V uses (fields x y z intensity, ascii or binary
data) and writes the same subset for fixture trees. The JAX package's reader
takes a C++ parser when it builds; that parser is held equal to this numpy
one (tests/test_native.py), so both packages read the same frames.
"""

from __future__ import annotations

import numpy as np

_PCD_TYPE = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
}


def read_pcd(path: str) -> np.ndarray:
    """Read a .pcd file -> (N, num_fields) float32 array (xyz[i] order).

    NaN rows (pypcd's convention for invalid returns) are dropped, matching
    ref pcd_utils.pcd_to_np which masks ``np.isnan``.
    """
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="ignore").strip()
            if line.startswith("#") or not line:
                continue
            key, _, value = line.partition(" ")
            header[key.upper()] = value.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        npts = int(header["POINTS"][0])
        data_mode = header["DATA"][0].lower()

        dtype = np.dtype([
            (name if cnt == 1 else f"{name}", _PCD_TYPE[(t, s)], (cnt,))
            if cnt > 1 else (name, _PCD_TYPE[(t, s)])
            for name, s, t, cnt in zip(fields, sizes, types, counts)
        ])
        if data_mode == "ascii":
            body = np.loadtxt(f, dtype=np.float64, max_rows=npts)
            body = body.reshape(npts, -1)
            arr = body.astype(np.float32)
        elif data_mode == "binary":
            raw = np.frombuffer(f.read(dtype.itemsize * npts), dtype=dtype,
                                count=npts)
            arr = np.stack(
                [raw[name].astype(np.float32) for name in dtype.names],
                axis=-1)
        else:
            raise ValueError(f"unsupported PCD DATA mode {data_mode!r}")

    arr = arr[~np.isnan(arr).any(axis=1)]
    return np.ascontiguousarray(arr, dtype=np.float32)


def write_pcd(path: str, points: np.ndarray, binary: bool = True):
    """Write (N, 4) [x y z intensity] points as a PCD v0.7 file."""
    points = np.asarray(points, dtype=np.float32)
    assert points.ndim == 2 and points.shape[1] == 4, points.shape
    n = len(points)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z intensity\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(points).tobytes())
        else:
            np.savetxt(f, points, fmt="%.6f")
