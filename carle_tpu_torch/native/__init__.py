"""ctypes bindings for the native host codecs (counterpart of
carle_tpu/native/__init__.py): the RLE codec (``rle_codec.cpp``) and the GIF
LZW encoder (``gif_lzw.cpp``).

The package keeps its own copies of both sources and builds each at its
first use with ``g++ -O3 -fPIC -shared -std=c++17`` into
``carle_tpu_torch_native/`` under the build root (builddir.py: the
checkout's ``build/``, ``$CARLE_TPU_TORCH_BUILD_DIR`` or the user's cache),
named by a hash of the source and the flags, so an edited source is rebuilt and a built one is
reused.  A failed build raises with the compiler's output: there is no quiet
fallback.  ``NATIVE = False`` selects the numpy codec in ``rle.py`` and the
Python LZW loop in ``utils/gif.py`` on purpose; both write the same bytes.

Nothing here builds at import: a build starts on the first call that needs
the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..builddir import build_dir as _build_dir

# False routes rle.py and utils/gif.py to their numpy / Python twins
NATIVE = True

SRC = Path(__file__).resolve().parent
# None: builddir.build_dir("carle_tpu_torch_native"), resolved at each build
BUILD_DIR: Optional[Path] = None
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "rle_codec": {
        "rle_encode": (ctypes.c_int, [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_long]),
        "rle_decode": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_long, _U8P,
                                      ctypes.c_int, ctypes.c_int]),
    },
    "gif_lzw": {
        "gif_lzw_encode": (ctypes.c_long, [_U8P, ctypes.c_long, ctypes.c_int, _U8P,
                                           ctypes.c_long]),
    },
}


def build_dir() -> Path:
    """The directory the libraries build into: ``BUILD_DIR`` where it is
    set, else the build root's (builddir.py)."""
    return BUILD_DIR if BUILD_DIR is not None else _build_dir("carle_tpu_torch_native")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives, keyed by its source and the flags."""
    digest = hashlib.sha256((SRC / f"{name}.cpp").read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``name``.cpp unless its library is built; raises with the
    compiler's output when the build fails.  Written to a temporary name and
    renamed, so processes that build at once never load a partial file."""
    path = library_path(name)
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native codecs of carle_tpu_torch build "
                           "with a C++17 compiler (or set native.NATIVE = False)")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC / f"{name}.cpp")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build of {name}.cpp failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``.cpp, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build(name)))
            for symbol, (restype, argtypes) in _SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.restype, fn.argtypes = restype, argtypes
            _LIBS[name] = lib
        return _LIBS[name]


def available() -> bool:
    """Whether the codecs route to the native libraries (``NATIVE``); the RLE
    library is built here if it is not yet, and a failed build raises."""
    if NATIVE:
        library("rle_codec")
    return NATIVE


def gif_available() -> bool:
    """As :func:`available`, for the LZW library."""
    if NATIVE:
        library("gif_lzw")
    return NATIVE


def encode_body(grid: np.ndarray, wrap: int = 69) -> str:
    """A 2-D 0/1 grid's RLE body (rle.py's wire format)."""
    g = np.ascontiguousarray(np.asarray(grid) != 0, dtype=np.uint8)
    h, w = g.shape
    cap = 16 * h * w + 1024  # worst case: alternating cells
    buf = ctypes.create_string_buffer(cap)
    n = library("rle_codec").rle_encode(g.ctypes.data_as(_U8P), h, w, wrap, buf, cap)
    if n < 0:
        raise RuntimeError(f"native RLE encode of a {h}x{w} grid overflowed {cap} bytes")
    return buf.raw[:n].decode("ascii")


def decode_body(body: str, height: int, width: int) -> np.ndarray:
    """An RLE body decoded into a uint8 [height, width] grid (content outside
    the grid clipped)."""
    grid = np.zeros((height, width), dtype=np.uint8)
    raw = body.encode("ascii", errors="ignore")
    library("rle_codec").rle_decode(raw, len(raw), grid.ctypes.data_as(_U8P), height, width)
    return grid


def lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF-variant LZW compression of a flat uint8 index stream, byte for byte
    ``utils/gif.py:_lzw_encode_py``'s.  An index past the palette raises
    ``ValueError``."""
    arr = np.ascontiguousarray(indices, dtype=np.uint8).reshape(-1)
    # worst case: one 12-bit code per pixel plus CLEAR/END and slack
    cap = 2 * max(arr.size, 1) + 1024
    buf = (ctypes.c_uint8 * cap)()
    n = library("gif_lzw").gif_lzw_encode(arr.ctypes.data_as(_U8P), arr.size,
                                          min_code_size, buf, cap)
    if n == -2:
        raise ValueError(f"palette index out of range for min_code_size={min_code_size}")
    if n < 0:
        raise ValueError(f"native LZW rejected min_code_size={min_code_size} "
                         f"({arr.size} indices)")
    return ctypes.string_at(buf, n)
