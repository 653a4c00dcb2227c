"""Dependency-free animated GIF writer for episode artifacts (counterpart of
carle_tpu/utils/gif.py; numpy on the host).

The reference exports single PNG frames of instance 0 (env.py:504-513,
skimage.io.imsave); the natural artifact for an open-ended creativity
challenge is the whole episode as an animation.  This is a minimal GIF89a
encoder (global palette, per-frame graphic-control delay, NETSCAPE looping,
real LZW compression) with zero dependencies, like utils/png.py.

Intended use: ``write_gif(path, frames)`` with ``frames`` a [T, H, W] uint8
array of palette indices (binary CA universes: 0 = dead, 1 = alive), e.g.
collected by ``Rollout.run_gif`` or the server's ``/gif``.
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

import numpy as np

from .. import native

Palette = Sequence[Tuple[int, int, int]]

# dead = near-black, alive = carle-ish green; index 2+ free for overlays
DEFAULT_PALETTE: Palette = ((10, 10, 14), (72, 220, 130), (220, 80, 80),
                            (240, 240, 240))


def _lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    """LZW-compress a flat uint8 index stream (GIF variant: variable code
    width, CLEAR/END codes, table reset at 4096).

    The native encoder (native/gif_lzw.cpp) while ``native.NATIVE`` is on,
    else :func:`_lzw_encode_py`, its twin, which writes the same bytes."""
    if native.NATIVE:
        return native.lzw_encode(indices, min_code_size)
    return _lzw_encode_py(indices, min_code_size)


def _lzw_encode_py(indices: np.ndarray, min_code_size: int) -> bytes:
    clear = 1 << min_code_size
    end = clear + 1

    out = bytearray()
    bitbuf = 0
    nbits = 0

    def emit(code: int, width: int) -> None:
        nonlocal bitbuf, nbits
        bitbuf |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(bitbuf & 0xFF)
            bitbuf >>= 8
            nbits -= 8

    table = {(i,): i for i in range(clear)}
    next_code = end + 1
    width = min_code_size + 1
    emit(clear, width)

    prefix: Tuple[int, ...] = ()
    for pix in indices.tolist():
        cand = prefix + (pix,)
        if cand in table:
            prefix = cand
            continue
        emit(table[prefix], width)
        table[cand] = next_code
        next_code += 1
        if next_code > (1 << width) and width < 12:
            width += 1
        if next_code >= 4096:
            emit(clear, width)
            table = {(i,): i for i in range(clear)}
            next_code = end + 1
            width = min_code_size + 1
        prefix = (pix,)
    if prefix:
        emit(table[prefix], width)
    emit(end, width)
    if nbits:
        out.append(bitbuf & 0xFF)
    return bytes(out)


def _color_table(palette: Palette) -> Tuple[bytes, int]:
    n = max(2, len(palette))
    size_exp = max(1, (n - 1).bit_length())  # table holds 2**size_exp entries
    table = bytearray()
    for i in range(1 << size_exp):
        r, g, b = palette[i] if i < len(palette) else (0, 0, 0)
        table += bytes((r & 0xFF, g & 0xFF, b & 0xFF))
    return bytes(table), size_exp


def write_gif(
    path: str,
    frames: np.ndarray,
    fps: float = 20.0,
    palette: Palette = DEFAULT_PALETTE,
    scale: int = 1,
    loop: bool = True,
) -> str:
    """Write ``frames`` ([T, H, W] palette indices, uint8/bool) as an
    animated GIF.  ``scale`` integer-upscales via pixel repetition.
    Returns ``path``."""
    with open(path, "wb") as f:
        f.write(encode_gif(frames, fps=fps, palette=palette, scale=scale,
                           loop=loop))
    return path


def encode_gif(
    frames: np.ndarray,
    fps: float = 20.0,
    palette: Palette = DEFAULT_PALETTE,
    scale: int = 1,
    loop: bool = True,
) -> bytes:
    """Encode ``frames`` to GIF89a bytes (the in-memory core of
    :func:`write_gif`; the serving daemon's /gif endpoint sends them)."""
    arr = np.asarray(frames)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError(f"frames must be [T, H, W], got shape {arr.shape}")
    arr = arr.astype(np.uint8)
    if scale > 1:
        arr = np.repeat(np.repeat(arr, scale, axis=1), scale, axis=2)
    t, h, w = arr.shape
    if h > 0xFFFF or w > 0xFFFF:
        raise ValueError(f"frame geometry {h}x{w} exceeds the GIF limit")

    table, size_exp = _color_table(palette)
    if int(arr.max(initial=0)) >= (1 << size_exp):
        raise ValueError("frame indices exceed the palette")
    min_code_size = max(2, size_exp)
    delay_cs = max(1, int(round(100.0 / max(fps, 1e-6))))

    out = bytearray()
    out += b"GIF89a"
    # logical screen descriptor: global color table, 2**(size_exp) colors
    out += struct.pack("<HHBBB", w, h, 0x80 | ((size_exp - 1) & 0x7), 0, 0)
    out += table
    if loop:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop forever
    for i in range(t):
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay_cs) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHH", 0, 0, w, h) + b"\x00"
        out.append(min_code_size)
        data = _lzw_encode(arr[i].reshape(-1), min_code_size)
        for off in range(0, len(data), 255):
            block = data[off:off + 255]
            out.append(len(block))
            out += block
        out.append(0)  # block terminator
    out += b"\x3b"  # trailer
    return bytes(out)
