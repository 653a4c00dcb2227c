"""Dependency-free PNG writer for frame export (counterpart of
carle_tpu/utils/png.py; numpy on the host).

The reference shells out to scikit-image for its frame dumps (env.py:504-513);
a 40-line encoder avoids that dependency entirely.  Supports 8-bit grayscale
[H, W] and RGB [H, W, 3] arrays.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def png_bytes(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        color_type = 0  # grayscale
        h, w = arr.shape
        raw = arr[:, :, None]
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color_type = 2  # RGB
        h, w = arr.shape[:2]
        raw = arr
    else:
        raise ValueError(f"unsupported image shape {arr.shape}")

    # prepend filter byte 0 to each scanline
    scanlines = np.concatenate(
        [np.zeros((h, 1), dtype=np.uint8), raw.reshape(h, -1)], axis=1
    )
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(scanlines.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(arr))
