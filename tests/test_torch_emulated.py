"""The net kernels' own bodies, run on the CPU: ``csrc/*.cu`` compiled as
plain C++ against a stand-in ``<cuda_runtime.h>`` (tests/cuda_emulation/) that
runs every block with one thread, so ``__syncthreads()`` is a no-op and the
kernels' index arithmetic, halos, Philox counters and partial sums can be held
against the plain twins where there is no card and no ``nvcc``.  What the
device compiler refuses, and anything that depends on threads running
together, shows only on the card (tests/test_torch_kernels.py).

Needs ``g++``; skips without it.  Tolerance: 1e-4 of each output's largest
entry (float32 sums in another order than the twins').
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from carle_tpu_torch.ops import cuda_build, cuda_head

KERNELS = ("encoder_fwd", "ae_loss_fwd", "encoder_bwd", "ae_loss_bwd")
SHIM = cuda_build.CSRC.parents[1] / "tests" / "cuda_emulation"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The four net kernels built for the host, bound in place of the CUDA
    libraries for this module's tests."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = tmp_path_factory.mktemp("emulated_kernels")
    jobs = {name: subprocess.Popen(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-I", str(SHIM),
         "-I", str(cuda_build.CSRC), "-o", str(out / f"{name}.so"),
         str(cuda_build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in KERNELS}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name} does not compile as C++:\n{log}"

    def library(name):
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        return lib

    patch = pytest.MonkeyPatch()
    patch.setattr(cuda_build, "library", library)
    patch.setattr(cuda_head, "stream_args", lambda t: (0, None))
    for name in KERNELS:   # drop any bound launcher, here and afterwards
        patch.setattr(cuda_build.KERNELS[name], "_fn", None)
    yield
    patch.undo()


def _params(rng, shapes):
    return [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3) for s in shapes]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


@pytest.mark.parametrize("drop_p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("geom", [  # p1, p2, c1, c2, n, h, w
    (4, 2, 4, 1, 2, 32, 32),    # RND predictor
    (2, 2, 4, 2, 2, 24, 40),    # AE encoder, a ragged last band
    (2, 2, 5, 3, 1, 16, 16),    # two Philox channel groups
    (4, 4, 2, 2, 1, 32, 32),
    (4, 2, 4, 1, 1, 80, 32),    # several bands a universe
])
def test_encoder_kernels_emulated(emulated, geom, drop_p):
    p1, p2, c1, c2, n, h, w = geom
    rng = np.random.RandomState(7 * h + c1)
    x = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    x[0, 0, : h // 2] = 0   # a blank band: whole pool windows tie
    ps = _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])
    ps[1], ps[3] = ps[1].abs(), ps[3].abs()
    g = torch.from_numpy(rng.randn(n, c2, h // (p1 * p2), w // (p1 * p2)).astype(np.float32))
    seed = 1234567891011 + h
    launches = cuda_head.ENCODER.launches
    got = cuda_head._encoder_fwd_kernel(x, *ps, (p1, p2), drop_p, seed)
    assert cuda_head.ENCODER.launches == launches + 1
    want = cuda_head.encoder_fwd_plain(x, *ps, (p1, p2), drop_p, seed)
    assert float(want.abs().max()) > 0 and _rel(got, want) < 1e-4
    grads = cuda_head._encoder_bwd_kernel(x, *ps, g, (p1, p2), drop_p, seed)
    twin = cuda_head.encoder_bwd_plain(x, *ps, g, (p1, p2), drop_p, seed)
    assert [tuple(t.shape) for t in grads] == [tuple(t.shape) for t in twin]
    assert max(_rel(a, b) for a, b in zip(grads, twin)) < 1e-4


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("geom", [  # n, h, w, (c1, c2, cmid, cout)
    (2, 32, 32, (4, 2, 1, 1)),      # AE2D
    (1, 24, 40, (4, 2, 1, 1)),      # a ragged last band
    (2, 16, 48, (3, 2, 2, 2)),
    (1, 72, 16, (4, 2, 1, 1)),      # several bands a universe
])
def test_ae_loss_kernels_emulated(emulated, geom, drop_p):
    n, h, w, (c1, c2, cm, co) = geom
    rng = np.random.RandomState(h)
    src = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    src[0, 0, : h // 2] = 0
    obs = torch.from_numpy((rng.rand(n, co, h, w) < 0.3).astype(np.uint8))
    ps = _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,), (c2, cm, 4, 4),
                       (cm,), (cm, co, 4, 4), (co,)])
    ps[1] = ps[1].abs()
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32))
    seed = 987654321012345 + w
    got = cuda_head._ae_loss_fwd_kernel(src, *ps, obs, (2, 2), drop_p, seed)
    want = cuda_head.ae_loss_fwd_plain(src, *ps, obs, (2, 2), drop_p, seed)
    assert _rel(got, want) < 1e-4
    grads = cuda_head._ae_loss_bwd_kernel(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    twin = cuda_head.ae_loss_bwd_plain(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    assert len(grads) == 8 and max(_rel(a, b) for a, b in zip(grads, twin)) < 1e-4


def test_emulated_dropout_draws_the_twin_s_mask(emulated):
    """Zero weights and a last bias of 40: a kept cell reconstructs 1.0 and a
    dropped cell 0.5, so the error against blank cells counts the kernel's
    dropped cells exactly."""
    n, h, w, p, seed = 3, 32, 48, 0.25, 42
    blank = torch.zeros((n, 1, h, w), dtype=torch.uint8)
    ps = [torch.zeros(s) for s in [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4),
                                   (1,), (1, 1, 4, 4), (1,)]]
    ps[7] = ps[7] + 40.0
    err = cuda_head._ae_loss_fwd_kernel(blank, *ps, blank, (2, 2), p, seed)
    keep = cuda_head.philox_keep_mask(seed, cuda_head.STAGE_DEC2, (n, 1, h, w), p, "cpu")
    dropped = (~keep).sum(dim=(1, 2, 3)).double()
    assert torch.equal((h * w - err.double()) / 0.75, dropped)
