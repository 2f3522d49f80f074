"""Camera batches: images and calibration -> padded ``image_inputs``.

Port of coalign_tpu/data/camera_batch.py (ref intermediate_fusion_
dataset.py:133-214, camera_utils.py:33-62, opv2v_basedataset.py:436-447):
each agent's camera images are resized to the network's ``final_dim`` (or
resized, cropped and flipped by a CameraAugmentor), the image transform is
folded into (post_rots, post_trans), and the extrinsics come from the OPV2V
yaml's camera blocks: T_lidar<-camera = the camera's world pose, seen from
the lidar's, then the UE4 -> OpenCV axis permutation.

The images are PNGs read and resized by data/image_io.py (Pillow's
bilinear resize, bit for bit), not by Pillow. A frame packed into an hdf5
file beside its PNGs (``<ts>_imgs.hdf5``, tools/img2hdf5.py, or the JAX
package's) is read from the pack instead, once per agent frame, by
utils/hdf5.py (no h5py), then resized or augmented exactly as from the
PNGs (coalign_tpu/data/camera_batch.py:173-190). A pack that cannot be
read raises; nothing falls back to the PNGs.
"""

from __future__ import annotations

import os

import numpy as np

from coalign_tpu_torch.data.batch import IntermediateFusionBatcher
from coalign_tpu_torch.data.image_io import read_rgb, resize_bilinear
from coalign_tpu_torch.tools.img2hdf5 import read_frame_hdf5
from coalign_tpu_torch.utils.transforms import inverse_tfm, pose_to_tfm

# UE4 camera axes -> OpenCV's (ref opv2v_basedataset.py:441-443)
UE4_TO_CV = np.array([[0, 0, 1, 0], [1, 0, 0, 0],
                      [0, -1, 0, 0], [0, 0, 0, 1]], dtype=np.float32)


def camera_to_lidar_ext(camera_cords, lidar_pose) -> np.ndarray:
    """T_lidar<-camera(OpenCV) (4, 4) float32 from the camera's and the
    lidar's world poses."""
    t_wc = pose_to_tfm(np.asarray(camera_cords, dtype=np.float64))
    t_lw = inverse_tfm(pose_to_tfm(np.asarray(lidar_pose, dtype=np.float64)))
    return (t_lw @ t_wc @ UE4_TO_CV).astype(np.float32)


def _scale_rot(w, w0, h, h0) -> np.ndarray:
    pr = np.eye(3, dtype=np.float32)
    pr[0, 0] = w / w0
    pr[1, 1] = h / h0
    return pr


def load_image(path: str, final_hw):
    """A camera PNG resized to ``final_hw``: (img (H, W, 3) float32 in
    [0, 1], post_rot (3, 3), post_trans (3,)) of the resize."""
    img = read_rgb(path)
    h0, w0 = img.shape[:2]
    h, w = final_hw
    arr = resize_bilinear(img, (h, w)).astype(np.float32) / 255.0
    return arr, _scale_rot(w, w0, h, h0), np.zeros(3, dtype=np.float32)


def img_transform(img: np.ndarray, resize: float, crop, flip: bool,
                  final_hw):
    """Resize, crop and (optionally) flip a (H0, W0, 3) uint8 image as the
    JAX package's img_transform does with Pillow (ref camera_utils.py:62):
    returns (array (H, W, 3) float32 in [0, 1], post_rot, post_trans) with
    ``aug_pix = post_rot @ orig_pix + post_trans``, the map get_geometry
    inverts. The crop pads with black beyond the resized image, as
    Pillow's ``crop``."""
    h0, w0 = img.shape[:2]
    h, w = final_hw
    img = resize_bilinear(img, (int(round(h0 * resize)),
                                int(round(w0 * resize))))
    x0, y0 = crop
    out = np.zeros((h, w, img.shape[2]), np.uint8)
    ys, xs = slice(max(y0, 0), min(y0 + h, img.shape[0])), \
        slice(max(x0, 0), min(x0 + w, img.shape[1]))
    out[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = img[ys, xs]
    post_rot = np.eye(3, dtype=np.float32)
    post_rot[0, 0] = resize
    post_rot[1, 1] = resize
    post_trans = np.array([-x0, -y0, 0.0], dtype=np.float32)
    if flip:
        # x' = (w - 1) - x: R = diag(-1, 1), T = (w - 1, 0) on the left
        out = out[:, ::-1]
        post_rot[0, :] = -post_rot[0, :]
        post_trans[0] = (w - 1) - post_trans[0]
    return out.astype(np.float32) / 255.0, post_rot, post_trans


class CameraAugmentor:
    """Random resize, crop and flip (ref camera_utils.py:33
    sample_augmentation), drawn from ``default_rng(seed)`` in the JAX
    package's order: the resize, the crop's x and y, then the flip (drawn
    only with ``rand_flip``)."""

    def __init__(self, final_dim, resize_lim=(1.0, 1.0), rand_flip=False,
                 seed: int = 303):
        self.final_dim = tuple(final_dim)
        self.resize_lim = resize_lim
        self.rand_flip = rand_flip
        self.rng = np.random.default_rng(seed)

    def sample(self, w0: int, h0: int):
        h, w = self.final_dim
        min_resize = max(w / w0, h / h0)
        resize = max(float(self.rng.uniform(*self.resize_lim)), min_resize)
        new_w, new_h = int(round(w0 * resize)), int(round(h0 * resize))
        x0 = int(self.rng.integers(0, max(new_w - w, 0) + 1))
        y0 = int(self.rng.integers(0, max(new_h - h, 0) + 1))
        flip = bool(self.rand_flip and self.rng.integers(0, 2))
        return resize, (x0, y0), flip


def hdf5_pack(image_path: str) -> str:
    """The hdf5 pack beside a camera image (``<ts>_imgs.hdf5``)."""
    ts = os.path.basename(image_path).split("_")[0]
    return os.path.join(os.path.dirname(image_path), f"{ts}_imgs.hdf5")


class CameraBatcher:
    """Assemble ``image_inputs`` batches from frames with camera data (the
    readers' ``load_camera=True``: ``cameras`` and ``camera_files``; or
    SyntheticCameraScenes' in-memory ``camera_arrays``). The poses, the gt
    and the pairwise transforms are an IntermediateFusionBatcher's (its
    numpy path: the frames have no points)."""

    def __init__(self, max_cav=5, num_cams=4, final_dim=(480, 640),
                 max_objects=100, lidar_range=(-48, -48, -3, 48, 48, 1),
                 comm_range=70.0, pos_std=0.0, rot_std=0.0, seed=303,
                 augmentor: CameraAugmentor | None = None, laplace=False):
        self.max_cav = max_cav
        self.num_cams = num_cams
        self.final_dim = tuple(final_dim)
        self.augmentor = augmentor
        self.base = IntermediateFusionBatcher(
            max_cav=max_cav, max_points=1, max_objects=max_objects,
            lidar_range=lidar_range, comm_range=comm_range, pos_std=pos_std,
            rot_std=rot_std, seed=seed, laplace=laplace, native=False)

    def _array_image(self, arr):
        """A synthetic float image: resized (through uint8, as the JAX
        package does with Pillow) when it is not ``final_dim``."""
        arr = np.asarray(arr, dtype=np.float32)
        h0, w0 = arr.shape[:2]
        h, w = self.final_dim
        if (h0, w0) == (h, w):
            return arr, None
        arr8 = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        arr = resize_bilinear(arr8, (h, w)).astype(np.float32) / 255.0
        return arr, _scale_rot(w, w0, h, h0)

    def _pack(self, files: list):
        """The camera arrays of the agent frame's hdf5 pack, or None when
        the frame is not packed."""
        if not files:
            return None
        return read_frame_hdf5(os.path.dirname(files[0]),
                               os.path.basename(files[0]).split("_")[0],
                               self.num_cams)

    def _file_image(self, path: str, packed=None):
        """(img, post_rot, post_trans) of a camera PNG, or of ``packed``,
        its array from the frame's pack, where given."""
        if packed is None:
            img = read_rgb(path)
        elif packed.ndim == 2:
            img = np.repeat(packed[..., None], 3, axis=-1)
        else:
            img = packed[..., :3]
        if self.augmentor is not None:
            rs, crop, flip = self.augmentor.sample(img.shape[1], img.shape[0])
            return img_transform(img, rs, crop, flip, self.final_dim)
        h, w = self.final_dim
        arr = resize_bilinear(img, (h, w)).astype(np.float32) / 255.0
        return arr, _scale_rot(w, img.shape[1], h, img.shape[0]), \
            np.zeros(3, dtype=np.float32)

    def assemble(self, frames: list) -> dict:
        stub_frames = []
        for frame in frames:
            agents = [dict(ag) if "points" in ag else
                      dict(ag, points=np.zeros((1, 4), dtype=np.float32))
                      for ag in frame["agents"]]
            stub_frames.append({"agents": agents,
                                "objects": frame["objects"]})
        batch = self.base.assemble(stub_frames)

        b, l, n = len(frames), self.max_cav, self.num_cams
        h, w = self.final_dim
        imgs = np.zeros((b, l, n, h, w, 3), dtype=np.float32)
        rots = np.tile(np.eye(3, dtype=np.float32), (b, l, n, 1, 1))
        trans = np.zeros((b, l, n, 3), dtype=np.float32)
        intrins = np.tile(np.eye(3, dtype=np.float32), (b, l, n, 1, 1))
        post_rots = np.tile(np.eye(3, dtype=np.float32), (b, l, n, 1, 1))
        post_trans = np.zeros((b, l, n, 3), dtype=np.float32)

        for bi, frame in enumerate(frames):
            for ai, ag in enumerate(frame["agents"][:l]):
                cams = ag.get("cameras", {})
                files = ag.get("camera_files", [])
                arrays = ag.get("camera_arrays", [])
                packed = self._pack(files) if not arrays else None
                for ci in range(min(n, len(cams))):
                    cam = cams.get(f"camera{ci}")
                    if cam is None:
                        continue
                    ext = camera_to_lidar_ext(cam["cords"], ag["pose"])
                    rots[bi, ai, ci] = ext[:3, :3]
                    trans[bi, ai, ci] = ext[:3, 3]
                    intrins[bi, ai, ci] = cam["intrinsic"]
                    if ci < len(arrays):
                        img, pr = self._array_image(arrays[ci])
                        imgs[bi, ai, ci] = img
                        if pr is not None:
                            post_rots[bi, ai, ci] = pr
                    elif ci < len(files):
                        (imgs[bi, ai, ci], post_rots[bi, ai, ci],
                         post_trans[bi, ai, ci]) = self._file_image(
                            files[ci], packed[ci] if packed
                            and ci < len(packed) else None)

        batch["image_inputs"] = {
            "imgs": imgs, "rots": rots, "trans": trans, "intrins": intrins,
            "post_rots": post_rots, "post_trans": post_trans}
        batch.pop("points", None)
        batch.pop("point_mask", None)
        return batch

    def batches(self, dataset, batch_size, shuffle=True, drop_last=True):
        """Assembled batches of ``batch_size`` frames of ``dataset``, in an
        order shuffled by the base batcher's generator."""
        idx = np.arange(len(dataset))
        if shuffle:
            self.base.rng.shuffle(idx)
        for start in range(0, len(idx), batch_size):
            chunk = idx[start:start + batch_size]
            if drop_last and len(chunk) < batch_size:
                return
            yield self.assemble([dataset[i] for i in chunk])
