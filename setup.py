"""Packaging (reference setup.py:1-15 packages carle/tests/evaluation).

``pip install .`` builds the native codecs (carle_tpu/native: RLE + GIF
LZW) as plain ctypes shared libraries — NOT CPython extension modules, so
there is no Python C-API surface and the exact same ``librle.so`` /
``libgif.so`` the Makefile produces lands inside the wheel.  The build is
``optional``: a box without a C++ toolchain still installs cleanly and the
package falls back to the pure-numpy codecs (identical wire format,
parity-tested in tests/test_native.py).  ``make -C carle_tpu/native`` keeps
working for in-tree development.
"""

import os

from setuptools import Extension, find_packages, setup
from setuptools.command.build_ext import build_ext


class CTypesLibrary(Extension):
    """A shared library consumed via ctypes (no PyInit_* entry point)."""


class build_ctypes(build_ext):
    def get_export_symbols(self, ext):
        # default build_ext injects PyInit_<name>, which these libs lack
        if isinstance(ext, CTypesLibrary):
            return ext.export_symbols
        return super().get_export_symbols(ext)

    def get_ext_filename(self, ext_name):
        # carle_tpu.native.librle -> carle_tpu/native/librle.so (the exact
        # path carle_tpu/native/__init__.py dlopens — no ABI suffix).
        # build_ext passes the bare last segment ("librle") for non-inplace
        # builds, so match on that too.
        for ext in self.extensions:
            if isinstance(ext, CTypesLibrary) and ext_name in (
                    ext.name, ext.name.rsplit(".", 1)[-1]):
                return os.path.join(*ext_name.split(".")) + ".so"
        return super().get_ext_filename(ext_name)


_NATIVE = [
    CTypesLibrary(
        "carle_tpu.native.librle",
        sources=["carle_tpu/native/rle_codec.cpp"],
        extra_compile_args=["-O3", "-std=c++17"],
        optional=True,  # no toolchain -> pure-python fallback, not a failure
    ),
    CTypesLibrary(
        "carle_tpu.native.libgif",
        sources=["carle_tpu/native/gif_lzw.cpp"],
        extra_compile_args=["-O3", "-std=c++17"],
        optional=True,
    ),
]

setup(
    name="carle_tpu",
    version="0.1.0",
    description=(
        "TPU-native Cellular Automata Reinforcement Learning Environment "
        "(JAX/XLA/Pallas re-design of the capabilities of riveSunder/carle)"
    ),
    packages=find_packages(include=["carle_tpu", "carle_tpu.*", "evaluation",
                                    "carle_tpu_torch", "carle_tpu_torch.*"]),
    package_data={"carle_tpu": ["patterns/*.rle", "native/*.so"],
                  "carle_tpu_torch": ["csrc/*", "evaluation/*.npz"]},
    ext_modules=_NATIVE,
    cmdclass={"build_ext": build_ctypes},
    install_requires=["jax", "numpy", "optax"],
    python_requires=">=3.10",
)
