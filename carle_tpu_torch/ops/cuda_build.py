"""Build the hand-written CUDA kernels in ``csrc/`` and bind them by ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
a shared library of its own with a plain C interface: no PyTorch headers, so
one source builds in seconds.  The libraries land in
``build/carle_tpu_torch_kernels/`` beside the package, named by a hash of
their sources and flags, so an edited source is rebuilt and a built one is
reused.  :func:`build_all` starts one ``nvcc`` per missing library, all at
once, and waits for them; the first launch of any kernel calls it.  A kernel
whose rule is fixed at compile time (``bit_multi_step_static``,
``bit_multi_step_static_words``, ``bit_multi_step_static_cm`` and
``bit_multi_step_static_cm_words``) builds one more library per rule mask, on
the first launch with that mask, with ``-DSTATIC_RULE=<mask>``; its file name
carries the mask.

Nothing here runs at import: the CPU tests import every module, and only a
launch on a CUDA tensor needs ``nvcc`` and a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "carle_tpu_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("ca_step", "bit_multi_step", "ca_multi_step", "encoder_fwd", "ae_loss_fwd",
           "encoder_bwd", "ae_loss_bwd", "ae2d_fwd", "ae2d_bwd", "enc3_fwd", "enc3_bwd",
           "head_fwd", "head_bwd", "head2_bwd", "tail", "tail2_fwd", "tail2_bwd",
           "loss_tail2_fwd", "decoder_loss_fwd", "decoder_loss_bwd", "dec2_fwd", "dec2_bwd",
           "halo_step")

_LOCK = threading.Lock()
_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def built_plans(source: str, macro: str) -> Tuple[Tuple[int, ...], ...]:
    """The instantiations that csrc/``source`` builds, read from its
    ``macro`` list (``#define <macro>(X) X(a, b) X(c, d) ...``), as tuples of
    ints."""
    text = (CSRC / source).read_text()
    body = re.search(rf"#define {macro}\(X\)(.*?)\n\n", text, re.S).group(1)
    return tuple(tuple(int(v) for v in m.split(",")) for m in re.findall(r"X\(([^)]*)\)", body))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "carle_tpu_torch build on a machine with the CUDA toolkit")
    return path


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Where ``name``'s library lives: keyed by its source, every shared
    header in ``csrc/``, the flags and the ``-D`` defines, so an edited
    header rebuilds; the defines also name the file."""
    digest = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(part.read_bytes())
    digest.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    tag = "".join(f"-{d.lower().replace('=', '')}" for d in defines)
    return BUILD_DIR / f"{name}{tag}-{digest.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES,
              defines: Tuple[str, ...] = ()) -> Dict[str, Path]:
    """Compile every library in ``names`` (with ``-D`` for each of
    ``defines``) that is not built yet, one nvcc process each, all started
    together.  Raises with the compiler's output when one fails; writes each
    build's ``-Xptxas -v`` report (registers, shared memory, spills) beside
    its library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name, defines) for name in names}
    jobs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            continue
        paths[name].with_suffix(".log").write_text(out)
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def library(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of source ``name``, building all kernels on first
    use (and a library with ``defines`` on its own first use)."""
    key = (name, tuple(defines))
    with _LOCK:
        if key not in _LIBS:
            paths = build_all([name], key[1]) if defines else build_all()
            lib = ctypes.CDLL(str(paths[name]))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIBS[key] = lib
        return _LIBS[key]


P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
D, ULL = ctypes.c_double, ctypes.c_ulonglong


class CudaKernel:
    """One kernel's C launcher and its count of launches.

    :meth:`launch` adds the kernel launches the launcher made (``count``:
    one, or one a generation where it loops over generations) to
    :attr:`launches` after it returned without error, and nowhere else;
    the launcher's own ``cudaGetLastError()`` after the launch becomes a
    ``RuntimeError``.
    ``source`` names the ``csrc/<source>.cu`` that holds the launcher (the
    kernel's own name unless several launchers share a source); ``defines``
    of a launch select a library of that source built with them.
    :attr:`packed_launches` counts the launches that read the packed universe
    (uint32 words) as cells."""

    def __init__(self, name: str, symbol: str, argtypes, source: str = "") -> None:
        self.name = name
        self.source = source or name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.packed_launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None
        self._variants: Dict[Tuple[str, ...], Tuple[ctypes.CDLL, ctypes._CFuncPtr]] = {}

    def _bind(self, defines: Tuple[str, ...]):
        lib = library(self.source, defines)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return lib, fn

    def launch(self, *args, defines: Tuple[str, ...] = (), packed: bool = False,
               count: int = 1) -> None:
        if defines:
            if defines not in self._variants:
                self._variants[defines] = self._bind(defines)
            lib, fn = self._variants[defines]
        else:
            if self._fn is None:
                self._lib, self._fn = self._bind(())
            lib, fn = self._lib, self._fn
        rc = fn(*args)
        if rc != 0:
            msg = lib.cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed: {msg} ({rc})")
        self.launches += count
        self.packed_launches += count * int(packed)


# argtypes mirror the extern "C" launchers in csrc/; every pointer and the
# stream are c_void_p so ctypes passes them whole
KERNELS: Dict[str, CudaKernel] = {
    k.name: k for k in (
        CudaKernel("ca_step", "ca_step_launch",
                   [P, P, P, I, P, P] + [I] * 9 + [P]),
        CudaKernel("ca_step_words", "ca_step_words_launch",
                   [P, P, P, I, P, P] + [I] * 11 + [P], source="ca_step"),
        CudaKernel("bit_multi_step", "bit_multi_step_launch",
                   [P, P, I, P, P, I, I, I, I, I, I, P]),
        CudaKernel("bit_multi_step_words", "bit_words_launch",
                   [P, P, I, P, P] + [I] * 13 + [P], source="bit_multi_step"),
        CudaKernel("bit_multi_step_cm", "bit_multi_step_cm_launch",
                   [P, P, I, P, P, I, I, I, I, I, I, P], source="bit_multi_step"),
        CudaKernel("bit_multi_step_static", "bit_multi_step_static_launch",
                   [P, P, P] + [I] * 7 + [P], source="bit_multi_step"),
        CudaKernel("bit_multi_step_static_words", "bit_static_words_launch",
                   [P, P, P] + [I] * 13 + [P], source="bit_multi_step"),
        CudaKernel("bit_multi_step_static_cm", "bit_multi_step_static_launch",
                   [P, P, P] + [I] * 7 + [P], source="bit_multi_step"),
        CudaKernel("bit_multi_step_static_cm_words", "bit_static_cm_words_launch",
                   [P, P] + [I] * 6 + [P], source="bit_multi_step"),
        CudaKernel("ca_multi_step", "ca_multi_step_launch",
                   [P, P, I, P, P, I, I, I, I, I, I, P]),
        CudaKernel("ca_multi_step_bits", "ca_bits_launch",
                   [P, P, I, P] + [I] * 8 + [P], source="ca_multi_step"),
        CudaKernel("encoder_fwd", "encoder_fwd_launch",
                   [P] * 7 + [I] * 9 + [LL, I, D, ULL, I, P]),
        CudaKernel("ae_loss_fwd", "ae_loss_fwd_launch",
                   [P] * 12 + [I] * 8 + [LL, I, I, D, ULL, I, P]),
        CudaKernel("encoder_bwd", "encoder_bwd_launch",
                   [P] * 11 + [I] * 11 + [LL, LL, I, D, ULL, I, P]),
        CudaKernel("ae_loss_bwd", "ae_loss_bwd_launch",
                   [P] * 18 + [I] * 10 + [LL, LL, LL, I, I, D, ULL, I, P]),
        CudaKernel("ae2d_fwd", "ae2d_fwd_launch",
                   [P] * 16 + [I] * 4 + [LL, I, I, D, ULL, I, P]),
        CudaKernel("ae2d_bwd", "ae2d_bwd_launch",
                   [P] * 19 + [I] * 5 + [LL, LL, I, I, D, I, P]),
        CudaKernel("enc3_fwd", "enc3_fwd_launch",
                   [P] * 9 + [I] * 9 + [LL, I, D, ULL, I, P]),
        CudaKernel("enc3_bwd", "enc3_bwd_launch",
                   [P] * 11 + [I] * 9 + [LL, I, D, I, P]),
        CudaKernel("head_fwd", "head_fwd_launch",
                   [P] * 4 + [I] * 8 + [LL, I, I, D, ULL, I, P]),
        CudaKernel("head_bwd", "head_bwd_launch",
                   [P] * 8 + [I] * 8 + [LL, I, I, D, ULL, I, P]),
        CudaKernel("head2_bwd", "head2_bwd_launch",
                   [P] * 8 + [I] * 9 + [LL, I, I, D, ULL, I, P]),
        CudaKernel("tail_fwd", "tail_fwd_launch",
                   [P] * 4 + [I] * 6 + [LL, I, I, D, ULL, I, P], source="tail"),
        CudaKernel("tail_bwd", "tail_bwd_launch",
                   [P] * 7 + [I] * 6 + [LL, I, I, D, ULL, I, P], source="tail"),
        CudaKernel("tail2_fwd", "tail2_fwd_launch",
                   [P] * 5 + [I] * 6 + [LL, I, I, D, ULL, I, P]),
        CudaKernel("tail2_bwd", "tail2_bwd_launch",
                   [P] * 8 + [I] * 6 + [LL, I, I, D, ULL, I, P]),
        CudaKernel("loss_tail_fwd", "loss_tail_fwd_launch",
                   [P] * 6 + [I] * 6 + [LL, I, I, I, D, ULL, I, P], source="tail"),
        CudaKernel("loss_tail_bwd", "loss_tail_bwd_launch",
                   [P] * 8 + [I] * 6 + [LL, I, I, I, D, ULL, I, P], source="tail"),
        CudaKernel("loss_tail2_fwd", "loss_tail2_fwd_launch",
                   [P] * 6 + [I] * 6 + [LL, I, I, I, D, ULL, I, P]),
        CudaKernel("decoder_loss_fwd", "decoder_loss_fwd_launch",
                   [P] * 9 + [I] * 8 + [LL, I, D, ULL, I, P]),
        CudaKernel("decoder_loss_bwd", "decoder_loss_bwd_launch",
                   [P] * 12 + [I] * 8 + [LL, I, D, ULL, I, P]),
        CudaKernel("dec2_fwd", "dec2_fwd_launch",
                   [P] * 10 + [I] * 5 + [LL, I, D, ULL, I, P]),
        CudaKernel("dec2_bwd", "dec2_bwd_launch",
                   [P] * 12 + [I] * 5 + [LL, I, D, I, P]),
        CudaKernel("spatial_ca_step", "halo_step_launch",
                   [I, P, P, P, P, I, I, P] + [I] * 8 + [P], source="halo_step"),
        CudaKernel("spatial_multi_step", "halo_step_launch",
                   [I, P, P, P, P, I, I, P] + [I] * 8 + [P], source="halo_step"),
        CudaKernel("bit_spatial_multi_step", "halo_step_launch",
                   [I, P, P, P, P, I, I, P] + [I] * 8 + [P], source="halo_step"),
        CudaKernel("bit_spatial_words", "bit_halo_words_launch",
                   [P, P, P, P, I, I, P] + [I] * 13 + [P], source="halo_step"),
        CudaKernel("spatial_multi_step_bits", "u8_halo_bits_launch",
                   [P, P, P, P, I, I, P] + [I] * 13 + [P], source="halo_step"),
    )
}


def stream_args(t: torch.Tensor):
    """(device index, raw stream) for a launch beside tensor ``t``."""
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(t.device).cuda_stream


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.packed_launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def packed_launch_counts() -> Dict[str, int]:
    """Launches that read packed words as cells, by kernel."""
    return {name: k.packed_launches for name, k in KERNELS.items() if k.packed_launches}
