"""Pack per-timestamp camera PNGs into one ``<ts>_imgs.hdf5`` per frame.

Port of coalign_tpu/tools/img2hdf5.py (ref opencood/utils/img2hdf5.py):
the camera batcher (data/camera_batch.py) reads a frame's pack, where one
lies beside its PNGs, in place of the PNGs. The port decodes the PNGs with
data/image_io.read_png (the arrays Pillow's ``np.asarray(Image.open(p))``
gives: (H, W, 3) for the RGB camera images, (H, W) for grayscale depth
images; a PNG form it lacks raises) and writes the pack with
utils/hdf5.write_datasets, not h5py: datasets ``camera{i}`` and
``depth{i}``, deflate level 1 as the JAX package's gzip level 1. h5py and
the JAX package read its packs, and it reads theirs.

Usage: python -m coalign_tpu_torch.tools.img2hdf5 --root <opv2v_root>
"""

from __future__ import annotations

import argparse
import glob
import os

from coalign_tpu_torch.data.image_io import read_png
from coalign_tpu_torch.utils.hdf5 import read_datasets, write_datasets


def pack_path(cav_dir: str, ts: str) -> str:
    return os.path.join(cav_dir, f"{ts}_imgs.hdf5")


def pack_frame(cav_dir: str, ts: str, num_cams: int = 4) -> str | None:
    """Write the pack of one agent's frame when all ``num_cams`` camera
    PNGs are there (and each depth PNG that is); its path, else None."""
    paths = [os.path.join(cav_dir, f"{ts}_camera{i}.png")
             for i in range(num_cams)]
    if not all(os.path.exists(p) for p in paths):
        return None
    arrays = {}
    for i, p in enumerate(paths):
        arrays[f"camera{i}"] = read_png(p)
        dp = os.path.join(cav_dir, f"{ts}_depth{i}.png")
        if os.path.exists(dp):
            arrays[f"depth{i}"] = read_png(dp)
    out = pack_path(cav_dir, ts)
    write_datasets(out, arrays, level=1)
    return out


def pack_root(root: str, num_cams: int = 4) -> int:
    """Pack every agent frame of an OPV2V tree (``<root>/<scenario>/<cav>/
    <ts>.yaml``); the number of packs written."""
    n = 0
    for yaml_path in sorted(glob.glob(os.path.join(root, "*", "*",
                                                   "*.yaml"))):
        if "_" in os.path.basename(yaml_path):
            continue
        cav_dir = os.path.dirname(yaml_path)
        ts = os.path.basename(yaml_path)[:-5]
        if pack_frame(cav_dir, ts, num_cams):
            n += 1
    return n


def read_frame_hdf5(cav_dir: str, ts: str, num_cams: int = 4):
    """The frame's camera arrays [camera0, camera1, ...] (those the pack
    has, in order), or None when the frame is not packed. A pack that
    cannot be read raises (utils/hdf5.HDF5FormatError)."""
    path = pack_path(cav_dir, ts)
    if not os.path.exists(path):
        return None
    names = [f"camera{i}" for i in range(num_cams)]
    got = read_datasets(path, names)
    return [got[n] for n in names if n in got]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--num_cams", type=int, default=4)
    opt = p.parse_args(argv)
    print(f"packed {pack_root(opt.root, opt.num_cams)} frames")


if __name__ == "__main__":
    main()
