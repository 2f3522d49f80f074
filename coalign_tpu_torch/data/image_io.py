"""PNG images and Pillow's bilinear resize in numpy, for the camera feed.

The JAX package decodes and resizes its camera images with Pillow
(coalign_tpu/data/camera_batch.py); the port runs where Pillow may be
absent, so it carries its own:

* read_png / write_png: 8-bit grayscale, RGB and RGBA PNGs, not
  interlaced, through the standard library's zlib; every scanline filter
  (None, Sub, Up, Average, Paeth) is undone. write_png writes RGB with the
  None filter.
* resize_bilinear: Pillow's ``Image.resize(size, Image.BILINEAR)`` of a
  uint8 image, to the bit (tests/test_torch_camera_data.py holds it equal
  to Pillow's): a triangle filter whose support scales with the
  downscaling factor, weights normalized per output pixel and rounded to
  22-bit fixed point, the horizontal pass first, each pass rounded to
  uint8. Pillow resizes an RGBA image with premultiplied alpha; read_rgb
  drops the alpha channel first, which is the same for opaque images (the
  camera feeds') and not for translucent ones.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}      # PNG colour type -> channels
_PRECISION_BITS = 32 - 8 - 2        # Pillow's Resample.c


def read_png(path: str) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 array of an 8-bit PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"{path}: only 8-bit non-interlaced grayscale, RGB and RGBA "
            f"PNGs are read (depth {depth}, colour type {ctype}, "
            f"interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + w * c)
    img = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, c))
    return img[..., 0] if c == 1 else img


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftype: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Undo the PNG scanline filters of (H, W, C) bytes, ``ftype`` (H,).
    Rows of None, Sub and Up go one at a time, each in one numpy step;
    Average and Paeth depend on the pixel to the left, so an image with
    them goes one anti-diagonal of pixels at a time."""
    h, w, c = x.shape
    if np.any(ftype > 4):
        raise ValueError(f"unknown PNG filter types {set(ftype) - set(range(5))}")
    if not np.any(ftype >= 3):
        out = np.empty_like(x)
        prev = np.zeros((w, c), np.uint8)
        for r in range(h):
            t = ftype[r]
            if t == 1:
                row = np.cumsum(x[r], axis=0, dtype=np.uint8)
            elif t == 2:
                row = x[r] + prev
            else:
                row = x[r]
            out[r] = prev = row
        return out
    # pad a zero row above and a zero column on the left
    out = np.zeros((h + 1, w + 1, c), np.int32)
    xi = x.astype(np.int32)
    ft = ftype.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        i = d - r
        a, b, cc = out[r + 1, i], out[r, i + 1], out[r, i]
        t = ft[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) // 2, _paeth(a, b, cc)], 0)
        out[r + 1, i + 1] = (xi[r, i] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def write_png(path: str, img: np.ndarray):
    """Write a (H, W, 3) uint8 image as an RGB PNG (filter None, zlib
    level 6)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png writes RGB images, got {c} channels")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                             0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG: grayscale repeated, alpha dropped."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


def _coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs for the bilinear filter, then
    normalize_coeffs_8bpc: (first source pixel, taps, int weights
    (out_size, ksize))."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmin = np.zeros(out_size, np.int64)
    xlen = np.zeros(out_size, np.int64)
    k = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size) - lo
        # as Resample.c: times 1 / filterscale, summed left to right
        taps = (np.arange(hi) + lo - center + 0.5) * (1.0 / filterscale)
        wts = np.maximum(1.0 - np.abs(taps), 0.0)
        total = 0.0
        for v in wts:
            total += v
        if total != 0.0:
            wts = wts / total
        xmin[xx], xlen[xx], k[xx, :hi] = lo, hi, wts
    fixed = np.where(k < 0, np.trunc(-0.5 + k * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + k * (1 << _PRECISION_BITS)))
    return xmin, xlen, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` (0 rows, 1 columns) of an (H, W, C) uint8
    image, rounded to uint8 as Pillow's 8bpc pass."""
    in_size = img.shape[axis]
    xmin, _, k = _coeffs(in_size, out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    src = img.astype(np.int64)
    acc = np.full(1, 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):     # a tap beyond a pixel's taps weighs 0
        idx = np.minimum(xmin + j, in_size - 1)
        acc = acc + np.take(src, idx, axis=axis) * k[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, out_hw) -> np.ndarray:
    """Pillow's ``Image.resize((w, h), Image.BILINEAR)`` of an (H, W, C)
    uint8 image: the horizontal pass, then the vertical, each only where
    that size changes."""
    h, w = out_hw
    if img.shape[1] != w:
        img = _resample_axis(img, w, 1)
    if img.shape[0] != h:
        img = _resample_axis(img, h, 0)
    return img
