"""Image helpers (port of drt_tpu/utils/images.py; capability of reference
save_torch / torch2pil, DiffRender.py:551-559): min-max normalize to uint8,
save or convert.

`save_image` writes its PNG with the standard library (zlib, struct): the
GPU machines the port runs on need neither imageio nor PIL. It writes the
pixels that the JAX package hands to `imageio.imsave`, 8-bit grey or RGB.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_COLOR_TYPE = {1: 0, 3: 2}      # channels -> grey, RGB


def normalize_to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, dtype=np.float64)
    lo, hi = img.min(), img.max()
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    return ((img - lo) * scale).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write a uint8 [H,W] (grey) or [H,W,3] (RGB) array as an 8-bit PNG:
    one IDAT chunk, every row with filter type 0."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    channels = arr.shape[2] if arr.ndim == 3 else 1
    if arr.ndim not in (2, 3) or channels not in _PNG_COLOR_TYPE:
        raise ValueError(f"write_png: cannot write an image of shape "
                         f"{arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[channels],
                         0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(_png_chunk(b"IHDR", header))
        fh.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(_png_chunk(b"IEND", b""))


def save_image(path: str, img, resy: int | None = None,
               resx: int | None = None) -> None:
    """Save a flat or 2D array as an image (min-max normalized)."""
    arr = np.asarray(img)
    if arr.ndim == 1 and resy and resx:
        arr = arr.reshape(resy, resx)
    elif arr.ndim == 2 and arr.shape[1] in (1, 3) and resy and resx:
        arr = arr.reshape(resy, resx, -1)
    arr = normalize_to_uint8(arr)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    write_png(path, arr)


def to_pil(img, resy: int | None = None, resx: int | None = None):
    from PIL import Image

    arr = np.asarray(img)
    if arr.ndim == 1 and resy and resx:
        arr = arr.reshape(resy, resx)
    arr = normalize_to_uint8(arr)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    return Image.fromarray(arr)
