"""The port's camera feed (data/image_io.py, data/camera_batch.py, the
camera fixtures, SyntheticCameraScenes, build_dataset's camera branch)
against Pillow and the JAX package, on the CPU.

Bounds, all exact:
  * read_png equals Pillow's decode of PNGs Pillow wrote (grayscale, RGB,
    RGBA; noise and smooth images, so that its encoder picks every filter)
    and of the port's own (RGB) PNGs; write_png's files decode in Pillow to
    the same pixels;
  * resize_bilinear equals Pillow's ``resize(BILINEAR)`` on seeded images,
    up and down, every value to the bit (uint8);
  * img_transform and CameraAugmentor equal the JAX package's (its Pillow
    path) on the same images and seeds;
  * the port's camera fixture tree equals the JAX package's writer's, file
    for file (pixels and yaml camera blocks);
  * CameraBatcher on that tree (with and without an augmentor, images
    resized) and on SyntheticCameraScenes' rendered views equals
    coalign_tpu's: images exactly, calibration within 1e-6 (the JAX
    package composes the extrinsics in float32, the port in float64);
  * build_dataset's camera branch reads a frame's hdf5 image pack (the
    port's tools/img2hdf5.py) in place of its PNGs: the same batch once the
    tree is packed, and a pack it cannot read raises rather than falling
    back to the PNGs (tests/test_torch_img2hdf5.py holds the packs
    against h5py and the JAX package).
"""

import os

import numpy as np
import pytest
import yaml
from PIL import Image

from coalign_tpu.data import camera_batch as JCB
from coalign_tpu.data import fixtures as JFIX
from coalign_tpu.data import synthetic as JSYN
from coalign_tpu.data.opv2v import OPV2VBaseDataset as JOPV2V
from coalign_tpu_torch.data import build_dataset
from coalign_tpu_torch.data import camera_batch as CB
from coalign_tpu_torch.data import image_io as IO
from coalign_tpu_torch.data.fixtures import write_opv2v_fixture
from coalign_tpu_torch.data.opv2v import OPV2VBaseDataset
from coalign_tpu_torch.data.synthetic import (SyntheticCameraScenes,
                                              SyntheticScenes)

LR = [-8.0, -8.0, -3.0, 8.0, 8.0, 1.0]
SCENES = dict(num_frames=2, num_agents=2, num_objects=3, lidar_range=LR,
              points_per_object=16, ground_points=32, seed=3)


def _images(rng, shape):
    """A noise image and a smooth one (cumulative sums) of ``shape``."""
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    smooth = np.cumsum(noise.astype(np.int64) // 16, axis=1).astype(np.uint8)
    return noise, smooth


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_codec_matches_pillow(channels, tmp_path):
    rng = np.random.default_rng(channels)
    shape = (23, 37) if channels == 1 else (23, 37, channels)
    for i, img in enumerate(_images(rng, shape)):
        path = str(tmp_path / f"pil{i}.png")
        Image.fromarray(img).save(path)
        np.testing.assert_array_equal(IO.read_png(path),
                                      np.asarray(Image.open(path)))
        if channels == 3:
            own = str(tmp_path / f"own{i}.png")
            IO.write_png(own, img)
            np.testing.assert_array_equal(np.asarray(Image.open(own)), img)
            np.testing.assert_array_equal(IO.read_png(own), img)
    gray = str(tmp_path / "pil0.png")
    assert IO.read_rgb(gray).shape[-1] == 3


def test_resize_matches_pillow_bit_for_bit():
    rng = np.random.default_rng(0)
    for _ in range(40):
        h0, w0, h, w = (int(v) for v in rng.integers(2, 160, 4))
        img = rng.integers(0, 256, (h0, w0, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((w, h),
                                                      Image.BILINEAR))
        np.testing.assert_array_equal(IO.resize_bilinear(img, (h, w)), want,
                                      err_msg=f"{(h0, w0)} -> {(h, w)}")
    # OPV2V's 600 x 800 to the yamls' 480 x 640
    img = rng.integers(0, 256, (600, 800, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        IO.resize_bilinear(img, (480, 640)),
        np.asarray(Image.fromarray(img).resize((640, 480), Image.BILINEAR)))


def test_img_transform_and_augmentor_match_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    for resize, crop, flip in ((1.0, (0, 0), False), (1.25, (7, 3), True),
                               (0.9, (2, 5), False)):
        got = CB.img_transform(img, resize, crop, flip, (48, 64))
        want = JCB.img_transform(Image.fromarray(img), resize, crop, flip,
                                 (48, 64))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    a = CB.CameraAugmentor((48, 64), resize_lim=(0.9, 1.4), rand_flip=True,
                           seed=7)
    b = JCB.CameraAugmentor((48, 64), resize_lim=(0.9, 1.4), rand_flip=True,
                            seed=7)
    assert [a.sample(80, 60) for _ in range(50)] == \
        [b.sample(80, 60) for _ in range(50)]


def _camera_trees(tmp_path):
    port = write_opv2v_fixture(str(tmp_path / "port"), SyntheticScenes(
        **SCENES), frames_per_scenario=2, with_cameras=True, cam_hw=(30, 40))
    jax = JFIX.write_opv2v_fixture(str(tmp_path / "jax"), JSYN.SyntheticScenes(
        **SCENES), frames_per_scenario=2, with_cameras=True, cam_hw=(30, 40))
    return port, jax


def test_camera_fixture_matches_jax_writer(tmp_path):
    port, jax = _camera_trees(tmp_path)
    files = sorted(os.path.relpath(os.path.join(d, f), port)
                   for d, _, fs in os.walk(port) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), jax)
                           for d, _, fs in os.walk(jax) for f in fs)
    pngs = [f for f in files if f.endswith(".png")]
    assert len(pngs) == 2 * 2 * 4
    for rel in pngs:
        np.testing.assert_array_equal(IO.read_png(os.path.join(port, rel)),
                                      np.asarray(Image.open(
                                          os.path.join(jax, rel))))
    for rel in (f for f in files if f.endswith(".yaml")):
        with open(os.path.join(port, rel)) as f:
            got = yaml.safe_load(f)
        with open(os.path.join(jax, rel)) as f:
            want = yaml.safe_load(f)
        assert {k: got[k] for k in got if k.startswith("camera")} == \
            {k: want[k] for k in want if k.startswith("camera")}


def _assert_same_batches(got: dict, want: dict):
    assert set(got) == set(want)
    for key in ("agent_mask", "gt_boxes", "gt_mask", "pairwise_t_matrix"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6)
    gi, wi = got["image_inputs"], want["image_inputs"]
    assert set(gi) == set(wi)
    np.testing.assert_array_equal(gi["imgs"], wi["imgs"])
    for key in ("rots", "trans", "intrins", "post_rots", "post_trans"):
        np.testing.assert_allclose(gi[key], wi[key], atol=1e-6, err_msg=key)


@pytest.mark.parametrize("augment", [False, True])
def test_camera_batcher_on_disk_matches_jax(augment, tmp_path):
    """The port's tree read by both packages' readers and batchers, the
    40 x 30 images resized to 48 x 64 (or resized, cropped and flipped)."""
    port, _ = _camera_trees(tmp_path)
    kw = dict(max_cav=2, num_cams=4, final_dim=(48, 64), max_objects=8,
              lidar_range=LR)
    aug = dict(resize_lim=(1.6, 2.0), rand_flip=True, seed=11)
    got_b = CB.CameraBatcher(**kw, augmentor=CB.CameraAugmentor(
        (48, 64), **aug) if augment else None)
    want_b = JCB.CameraBatcher(**kw, augmentor=JCB.CameraAugmentor(
        (48, 64), **aug) if augment else None)
    ds = OPV2VBaseDataset(port, train=False, load_camera=True, native=False)
    jds = JOPV2V(port, train=False, load_camera=True)
    got = got_b.assemble([ds[0], ds[1]])
    want = want_b.assemble([jds[0], jds[1]])
    assert got["image_inputs"]["imgs"].shape == (2, 2, 4, 48, 64, 3)
    assert got["image_inputs"]["imgs"].any()
    _assert_same_batches(got, want)


def test_camera_batcher_on_rendered_views_matches_jax():
    kw = dict(num_frames=2, num_agents=2, num_objects=3, lidar_range=LR,
              points_per_object=8, ground_points=8, seed=5, cam_hw=(40, 56),
              num_cams=2, focal=40.0)
    bkw = dict(max_cav=2, num_cams=2, final_dim=(32, 48), max_objects=8,
               lidar_range=LR)
    port, jax = SyntheticCameraScenes(**kw), JSYN.SyntheticCameraScenes(**kw)
    got = CB.CameraBatcher(**bkw).assemble([port[0], port[1]])
    want = JCB.CameraBatcher(**bkw).assemble([jax[0], jax[1]])
    _assert_same_batches(got, want)


def test_build_dataset_reads_cameras_and_refuses_hdf5_packs(tmp_path):
    port, _ = _camera_trees(tmp_path)
    params = {"fusion": {"core_method": "intermediate", "dataset": "opv2v"},
              "root_dir": port, "input_source": ["camera"],
              "train_params": {"max_cav": 2},
              "preprocess": {"cav_lidar_range": LR},
              "model": {"args": {"data_aug_conf": {"final_dim": [48, 64]}}}}
    base, batcher = build_dataset(params, train=True, native=False)
    assert isinstance(batcher, CB.CameraBatcher) and base.load_camera
    batch = next(batcher.batches(base, 2))
    assert batch["image_inputs"]["imgs"].shape == (2, 2, 4, 48, 64, 3)
    frame = base[0]
    want = batcher.assemble([frame])
    pack = CB.hdf5_pack(frame["agents"][0]["camera_files"][0])
    assert os.path.basename(pack) == "000000_imgs.hdf5"
    from coalign_tpu_torch.tools.img2hdf5 import pack_root
    assert pack_root(port) == 2 * 2
    assert os.path.exists(pack)
    # the PNGs of the packed frame's first agent are gone: what it reads
    # comes from the pack
    for path in frame["agents"][0]["camera_files"]:
        os.remove(path)
    got = batcher.assemble([frame])
    np.testing.assert_array_equal(got["image_inputs"]["imgs"],
                                  want["image_inputs"]["imgs"])
    for key in ("post_rots", "post_trans"):
        np.testing.assert_array_equal(got["image_inputs"][key],
                                      want["image_inputs"][key])
    with open(pack, "wb") as f:
        f.write(b"\x89HDF\r\n\x1a\n")
    from coalign_tpu_torch.utils.hdf5 import HDF5FormatError
    with pytest.raises(HDF5FormatError):
        batcher.assemble([frame])
