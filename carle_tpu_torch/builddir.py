"""Where the package builds its native libraries.

The CUDA kernels (ops/cuda_build.py) and the host codecs (native/) compile
at their first use, each into a directory of its own under one root.  The
root is chosen when a build asks for it, never at import:

1. ``$CARLE_TPU_TORCH_BUILD_DIR``, if it is set;
2. else the checkout's ``build/`` (the package's parent directory holds the
   repository's ``setup.py``), where it can be written;
3. else ``$XDG_CACHE_HOME/carle_tpu_torch`` (``~/.cache/carle_tpu_torch`` by
   default): an installed package lies in ``site-packages``, which may not
   be writable and is no place for build products.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "CARLE_TPU_TORCH_BUILD_DIR"
CHECKOUT = Path(__file__).resolve().parent.parent


def _writable(path: Path) -> bool:
    """Whether ``path``, or its nearest existing ancestor where it does not
    exist yet, can be written."""
    while not path.exists() and path != path.parent:
        path = path.parent
    return os.access(path, os.W_OK | os.X_OK)


def root() -> Path:
    """The root every library's directory lies under (module note)."""
    chosen = os.environ.get(ENV_VAR)
    if chosen:
        return Path(chosen).expanduser()
    build = CHECKOUT / "build"
    if (CHECKOUT / "setup.py").is_file() and _writable(build):
        return build
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "carle_tpu_torch"


def build_dir(name: str) -> Path:
    """The directory that the libraries of ``name`` build into."""
    return root() / name


__all__ = ["ENV_VAR", "build_dir", "root"]
