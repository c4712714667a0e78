"""Qualitative image dumps (port of vwfd_tpu/utils/images.py; reference:
utils/__init__.py:68-96 ``stitch_images`` / ``imsave``, utils/util.py:98-132
``tensor2img`` / ``save_img``), numpy and the standard library only.

``stitch_images`` returns the uint8 canvas (H, W, 3) where the JAX module
returns a PIL image of it, and PNGs are written by a small encoder of
their own (``save_png``: 8-bit gray or RGB, filter 0, ``zlib``), since the
machines the port runs on need not have an image library. ``read_png``
decodes what ``save_png`` writes.
"""

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2}  # channels -> PNG colour type (gray, RGB)


def tensor_to_uint8(img01):
    """NHWC [0,1] float → uint8, ``np.round`` (half to even) as the JAX
    module's dumps (models/IRNcrop_model.py:612-616)."""
    x = np.asarray(img01)
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


def stitch_images(*image_groups, img_per_row: int = 1, gap: int = 5
                  ) -> np.ndarray:
    """Montage: each group is an NHWC batch; batch items become rows
    (chunked by ``img_per_row``), groups become columns, ``gap`` white
    columns after each image. Returns the uint8 canvas (H, W, 3)."""
    groups = [tensor_to_uint8(g) for g in image_groups]
    b = groups[0].shape[0]
    h, w = groups[0].shape[1], groups[0].shape[2]
    cols = len(groups) * img_per_row
    rows = (b + img_per_row - 1) // img_per_row
    canvas = np.full((rows * h, cols * (w + gap), 3), 255, dtype=np.uint8)
    for i in range(b):
        r, c0 = divmod(i, img_per_row)
        for g_idx, g in enumerate(groups):
            img = g[i]
            if img.shape[-1] == 1:
                img = np.repeat(img, 3, axis=-1)
            c = c0 * len(groups) + g_idx
            canvas[r * h:(r + 1) * h, c * (w + gap):c * (w + gap) + w] = img
    return canvas


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, img) -> None:
    """Write a uint8 (H, W), (H, W, 1) or (H, W, 3) array as an 8-bit PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise TypeError(f"save_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"save_png: expected (H, W[, 1 | 3]), got "
                         f"{arr.shape}")
    h, w, c = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),  # filter 0 a row
                          np.ascontiguousarray(arr).reshape(h, w * c)], 1)
    data = (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                          _COLOR_TYPES[c], 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit gray or RGB PNG whose rows all use filter 0 (what
    ``save_png`` writes): (H, W, C) uint8, CRCs checked."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    c = {v: k for k, v in _COLOR_TYPES.items()}.get(ctype)
    if depth != 8 or c is None or interlace:
        raise ValueError(f"{path}: only 8-bit gray or RGB, not interlaced")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    if raw[:, 0].any():
        raise ValueError(f"{path}: only filter 0 is decoded")
    return raw[:, 1:].reshape(h, w, c).copy()


def save_image(img01, path):
    """A [0, 1] image (H, W, C) or the first of a batch (N, H, W, C) as a
    PNG (a one-channel image as gray)."""
    arr = tensor_to_uint8(img01)
    if arr.ndim == 4:
        arr = arr[0]
    save_png(path, arr)


def crop_to_multiple(img, d: int = 32):
    """Center-crop (H, W, C) or (B, H, W, C) so H and W divide ``d``
    (utils/image_io.py:13-56 crop_image/crop_np_image family, NHWC)."""
    h, w = img.shape[-3], img.shape[-2]
    nh, nw = (h // d) * d, (w // d) * d
    y0, x0 = (h - nh) // 2, (w - nw) // 2
    return img[..., y0:y0 + nh, x0:x0 + nw, :]


def create_augmentations(img):
    """8-fold dihedral augmentations of an (H, W, C) image: original,
    rot90×{1,2,3}, flip, flip∘rot90×{1,2,3} (utils/image_io.py:160-171,
    axes adapted to HWC)."""
    img = np.asarray(img)
    aug = [img.copy()] + [np.rot90(img, k, (0, 1)).copy() for k in (1, 2, 3)]
    flipped = img[:, ::-1].copy()
    aug += [flipped] + [np.rot90(flipped, k, (0, 1)).copy() for k in (1, 2, 3)]
    return aug


def create_video_augmentations(video):
    """The same 8-fold augmentations applied per clip, (T, H, W, C)
    (utils/image_io.py:173-185)."""
    video = np.asarray(video)
    aug = [video.copy()] + [np.rot90(video, k, (1, 2)).copy()
                            for k in (1, 2, 3)]
    flipped = video[:, :, ::-1].copy()
    aug += [flipped] + [np.rot90(flipped, k, (1, 2)).copy() for k in (1, 2, 3)]
    return aug
