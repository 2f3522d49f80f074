"""The port's hdf5 image packs (utils/hdf5.py, tools/img2hdf5.py, the camera
batcher's pack read) against h5py and the JAX package, on the CPU.

All bounds are exact (the arrays are uint8 images):
  * packs written by the JAX package's pack_frame (h5py and Pillow) read
    by the port's reader: 24 x 32 x 3 images (one chunk) and 600 x 800 x 3
    images (96 chunks of 75 x 200 x 1, more than a B-tree leaf's 64), with
    a grayscale depth image beside them;
  * datasets h5py writes with explicit chunks that leave partial edge
    chunks, with the shuffle filter, of 16-bit values, and with chunks
    never written (the fill value);
  * the port's packs read back by h5py and by the JAX package's
    read_frame_hdf5;
  * the port's pack_root on a camera fixture tree, then the port's
    CameraBatcher on the packed tree against the JAX batcher's (which reads
    the packs with h5py), with and without the augmentor;
  * packs the reader does not read (another filter, superblock version 2 of
    libver 'latest', a float datatype, a compact layout) raise and name
    what they hold.
"""

import os

import h5py
import numpy as np
import pytest
from PIL import Image

from coalign_tpu.data import camera_batch as JCB
from coalign_tpu.data.opv2v import OPV2VBaseDataset as JOPV2V
from coalign_tpu.tools import img2hdf5 as JPACK
from coalign_tpu_torch.data import camera_batch as CB
from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
from coalign_tpu_torch.data.opv2v import OPV2VBaseDataset
from coalign_tpu_torch.data.synthetic import SyntheticScenes
from coalign_tpu_torch.tools import img2hdf5 as PACK
from coalign_tpu_torch.utils.hdf5 import (HDF5FormatError, read_datasets,
                                          write_datasets)

LR = [-8.0, -8.0, -3.0, 8.0, 8.0, 1.0]


def _frame_pngs(cav_dir, hw, seed, depth=True):
    """Seeded camera (and depth) PNGs of one agent frame, written by
    Pillow; the arrays."""
    rng = np.random.default_rng(seed)
    os.makedirs(cav_dir, exist_ok=True)
    arrays = {}
    for i in range(4):
        # smooth images and noise, so that the encoder's filters vary
        img = (rng.integers(0, 256, hw + (3,)) if i % 2 else np.add.outer(
            np.arange(hw[0]), np.arange(hw[1]))[..., None]
            * np.array([1, 2, 3])) % 256
        arrays[f"camera{i}"] = img.astype(np.uint8)
        Image.fromarray(arrays[f"camera{i}"]).save(
            os.path.join(cav_dir, f"000000_camera{i}.png"))
        if depth:
            arrays[f"depth{i}"] = rng.integers(0, 256, hw).astype(np.uint8)
            Image.fromarray(arrays[f"depth{i}"]).save(
                os.path.join(cav_dir, f"000000_depth{i}.png"))
    return arrays


@pytest.mark.parametrize("hw", [(24, 32), (600, 800)],
                         ids=["one_chunk", "96_chunks"])
def test_reads_the_jax_packers_packs(hw, tmp_path):
    cav = str(tmp_path / "cav")
    arrays = _frame_pngs(cav, hw, seed=hw[0])
    path = JPACK.pack_frame(cav, "000000")
    with h5py.File(path, "r") as f:
        chunks = f["camera0"].id.get_num_chunks()
    assert chunks == (1 if hw == (24, 32) else 96)
    got = read_datasets(path)
    assert set(got) == set(arrays)
    for name, want in arrays.items():
        assert got[name].dtype == np.uint8
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    cams = PACK.read_frame_hdf5(cav, "000000")
    assert len(cams) == 4
    for i, cam in enumerate(cams):
        np.testing.assert_array_equal(cam, arrays[f"camera{i}"])


def test_reads_h5py_edge_chunks_shuffle_and_fill(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    wide = rng.integers(0, 65536, (20, 30)).astype(np.uint16)
    path = str(tmp_path / "h.hdf5")
    with h5py.File(path, "w") as f:
        f.create_dataset("edge", data=img, chunks=(7, 10, 2),
                         compression="gzip", compression_opts=4)
        f.create_dataset("shuffled", data=wide, chunks=(6, 7), shuffle=True,
                         compression="gzip")
        f.create_dataset("plain", data=img)
        part = f.create_dataset("partial", shape=(16, 16), dtype=np.int16,
                                chunks=(4, 4), fillvalue=-7)
        part[:5, :3] = 11
    got = read_datasets(path)
    np.testing.assert_array_equal(got["edge"], img)
    np.testing.assert_array_equal(got["shuffled"], wide)
    assert got["shuffled"].dtype == np.uint16
    np.testing.assert_array_equal(got["plain"], img)
    want = np.full((16, 16), -7, np.int16)
    want[:5, :3] = 11
    np.testing.assert_array_equal(got["partial"], want)
    assert read_datasets(path, ["edge", "missing"]).keys() == {"edge"}


def test_port_packs_read_back_by_h5py_and_the_jax_reader(tmp_path):
    cav = str(tmp_path / "cav")
    arrays = _frame_pngs(cav, (60, 80), seed=9)
    path = PACK.pack_frame(cav, "000000")
    assert os.path.basename(path) == "000000_imgs.hdf5"
    with h5py.File(path, "r") as f:
        assert set(f) == set(arrays)
        for name, want in arrays.items():
            assert f[name].compression == "gzip"
            np.testing.assert_array_equal(f[name][()], want, err_msg=name)
    jcams = JPACK.read_frame_hdf5(cav, "000000")
    for i, cam in enumerate(jcams):
        np.testing.assert_array_equal(cam, arrays[f"camera{i}"])
    # a frame without all of its cameras is not packed, as in JAX
    os.remove(os.path.join(cav, "000000_camera3.png"))
    assert PACK.pack_frame(cav, "000000") is None
    assert PACK.read_frame_hdf5(str(tmp_path), "000000") is None


@pytest.mark.parametrize("augment", [False, True])
def test_camera_batcher_on_a_packed_tree_matches_jax(augment, tmp_path):
    scenes = SyntheticScenes(num_frames=2, num_agents=2, num_objects=3,
                             lidar_range=LR, points_per_object=16,
                             ground_points=32, seed=3)
    tree = write_opv2v_fixture(str(tmp_path / "tree"), scenes,
                               frames_per_scenario=2, with_cameras=True,
                               cam_hw=(30, 40))
    assert PACK.pack_root(tree) == 4
    kw = dict(max_cav=2, num_cams=4, final_dim=(48, 64), max_objects=8,
              lidar_range=LR)
    aug = dict(resize_lim=(1.6, 2.0), rand_flip=True, seed=11)
    got_b = CB.CameraBatcher(**kw, augmentor=CB.CameraAugmentor(
        (48, 64), **aug) if augment else None)
    want_b = JCB.CameraBatcher(**kw, augmentor=JCB.CameraAugmentor(
        (48, 64), **aug) if augment else None)
    ds = OPV2VBaseDataset(tree, train=False, load_camera=True, native=False)
    jds = JOPV2V(tree, train=False, load_camera=True)
    got = got_b.assemble([ds[0], ds[1]])
    want = want_b.assemble([jds[0], jds[1]])
    gi, wi = got["image_inputs"], want["image_inputs"]
    assert gi["imgs"].shape == (2, 2, 4, 48, 64, 3) and gi["imgs"].any()
    np.testing.assert_array_equal(gi["imgs"], wi["imgs"])
    for key in ("post_rots", "post_trans"):
        np.testing.assert_array_equal(gi[key], wi[key], err_msg=key)
    for key in ("rots", "trans", "intrins"):
        np.testing.assert_allclose(gi[key], wi[key], atol=1e-6, err_msg=key)


@pytest.mark.parametrize("case,match", [
    ("lzf", "filter 32000"), ("latest", "superblock version"),
    ("float", "datatype class 1"), ("compact", "layout class 0")])
def test_unreadable_packs_raise_and_name_it(case, match, tmp_path):
    path = str(tmp_path / "000000_imgs.hdf5")
    img = np.zeros((8, 8, 3), np.uint8)
    kw = {"libver": "latest"} if case == "latest" else {}
    with h5py.File(path, "w", **kw) as f:
        if case == "lzf":
            f.create_dataset("camera0", data=img, compression="lzf")
        elif case == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            f.create_dataset("camera0", data=img, dcpl=dcpl)
        else:
            f.create_dataset("camera0", data=img.astype(
                np.float32 if case == "float" else np.uint8))
    with pytest.raises(HDF5FormatError, match=match):
        read_datasets(path)
    with pytest.raises(HDF5FormatError, match=match):
        PACK.read_frame_hdf5(str(tmp_path), "000000")


def test_writer_refuses_what_it_does_not_write(tmp_path):
    with pytest.raises(ValueError, match="integer"):
        write_datasets(str(tmp_path / "x.hdf5"),
                       {"camera0": np.zeros((2, 2), np.float32)})
