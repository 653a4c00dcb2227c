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

from carle_tpu_torch.ops import cuda_build, cuda_head, cuda_stages

SOURCES = ("encoder_fwd", "ae_loss_fwd", "encoder_bwd", "ae_loss_bwd", "head_fwd",
           "head_bwd", "tail", "decoder_loss_fwd", "decoder_loss_bwd")
SHIM = cuda_build.CSRC.parents[1] / "tests" / "cuda_emulation"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The net kernels built for the host, bound in place of the CUDA
    libraries for this module's tests."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = tmp_path_factory.mktemp("emulated_kernels")
    jobs = {name: subprocess.Popen(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-I", str(SHIM),
         "-I", str(cuda_build.CSRC), "-o", str(out / f"{name}.so"),
         str(cuda_build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in SOURCES}
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
    for module in (cuda_head, cuda_stages):
        patch.setattr(module, "stream_args", lambda t: (0, None))
    for kernel in cuda_build.KERNELS.values():   # drop any bound launcher, here and afterwards
        if kernel.source in SOURCES:
            patch.setattr(kernel, "_fn", None)
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


@pytest.mark.parametrize("drop_p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("geom", [  # pool, c, o, n, h, w, cells, stage
    (2, 1, 4, 2, 32, 32, True, 0),     # AE conv1 on cells, two bands
    (2, 4, 2, 2, 48, 24, False, 1),    # AE conv2 on floats, three bands
    (4, 1, 4, 1, 80, 32, True, 0),     # RND conv1, a ragged last band
    (2, 4, 1, 1, 16, 40, False, 1),    # RND conv2
    (8, 3, 5, 1, 80, 16, False, 0),    # two Philox channel groups, ragged
])
def test_head_kernels_emulated(emulated, geom, drop_p):
    pool, c, o, n, h, w, cells, stage = geom
    rng = np.random.RandomState(11 * h + c)
    if cells:
        x = torch.from_numpy((rng.rand(n, c, h, w) < 0.3).astype(np.uint8))
    else:   # relu output of a previous stage: zeros tie constantly
        x = torch.from_numpy(np.maximum(rng.randn(n, c, h, w), 0).astype(np.float32))
    x[0, :, : h // 2] = 0   # a blank band: whole pool windows tie
    wt, b = _params(rng, [(o, c, 3, 3), (o,)])
    b = b.abs()
    g = torch.from_numpy(rng.randn(n, o, h // pool, w // pool).astype(np.float32))
    seed = 20240301 + h
    launches = cuda_stages.HEAD_FWD.launches
    got = cuda_stages._head_fwd_kernel(x, wt, b, pool, drop_p, seed, stage)
    assert cuda_stages.HEAD_FWD.launches == launches + 1
    want = cuda_stages.head_fwd_plain(x, wt, b, pool, drop_p, seed, stage)
    assert float(want.abs().max()) > 0 and _rel(got, want) < 1e-4
    for need_dx in (False, True):
        grads = cuda_stages._head_bwd_kernel(x, wt, b, g, pool, drop_p, seed, stage, need_dx)
        twin = cuda_stages.head_bwd_plain(x, wt, b, g, pool, drop_p, seed, stage, need_dx)
        assert (grads[2] is None) == (not need_dx)
        pairs = [(a, t) for a, t in zip(grads, twin) if a is not None]
        assert max(_rel(a, t) for a, t in pairs) < 1e-4


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("act", ["relu", "sigmoid"])
@pytest.mark.parametrize("geom", [  # n, cin, cout, h, w, stage
    (2, 2, 1, 16, 16, 2),     # AE deconv1, two bands forward and backward
    (1, 1, 1, 20, 24, 3),     # AE deconv2, ragged bands
    (1, 3, 5, 12, 8, 2),      # two Philox channel groups
])
def test_tail_kernels_emulated(emulated, geom, act, drop_p):
    n, cin, cout, h, w, stage = geom
    rng = np.random.RandomState(13 * h + cin)
    x = torch.from_numpy(np.maximum(rng.randn(n, cin, h, w), 0).astype(np.float32))
    wt, b = _params(rng, [(cin, cout, 4, 4), (cout,)])
    g = torch.from_numpy(rng.randn(n, cout, 2 * h, 2 * w).astype(np.float32))
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32))
    seed = 77001 + w
    got = cuda_stages._tail_fwd_kernel(x, wt, b, act, drop_p, seed, stage)
    want = cuda_stages.tail_fwd_plain(x, wt, b, act, drop_p, seed, stage)
    assert _rel(got, want) < 1e-4
    grads = cuda_stages._tail_bwd_kernel(x, wt, b, g, act, drop_p, seed, stage)
    twin = cuda_stages.tail_bwd_plain(x, wt, b, g, act, drop_p, seed, stage)
    assert max(_rel(a, t) for a, t in zip(grads, twin)) < 1e-4
    cells = (rng.rand(n, cout, 2 * h, 2 * w) < 0.3)
    for obs in (torch.from_numpy(cells.astype(np.uint8)),
                torch.from_numpy(rng.rand(n, cout, 2 * h, 2 * w).astype(np.float32))):
        err = cuda_stages._loss_tail_fwd_kernel(x, wt, b, obs, act, drop_p, seed, stage)
        assert _rel(err, cuda_stages.loss_tail_fwd_plain(x, wt, b, obs, act, drop_p, seed,
                                                         stage)) < 1e-4
        grads = cuda_stages._loss_tail_bwd_kernel(x, wt, b, obs, gbar, act, drop_p, seed, stage)
        twin = cuda_stages.loss_tail_bwd_plain(x, wt, b, obs, gbar, act, drop_p, seed, stage)
        assert max(_rel(a, t) for a, t in zip(grads, twin)) < 1e-4


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("geom", [  # n, h, w (output), (c2, cmid, cout)
    (2, 32, 32, (2, 1, 1)),      # AE2D, two bands
    (1, 24, 40, (2, 1, 1)),      # a ragged last band
    (1, 72, 16, (3, 2, 5)),      # several bands, two Philox channel groups
])
def test_decoder_loss_kernels_emulated(emulated, geom, drop_p):
    n, h, w, (c2, cm, co) = geom
    rng = np.random.RandomState(h + w)
    x = torch.from_numpy(np.maximum(rng.randn(n, c2, h // 4, w // 4), 0).astype(np.float32))
    ps = _params(rng, [(c2, cm, 4, 4), (cm,), (cm, co, 4, 4), (co,)])
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32))
    seed = 555000111 + h
    for obs in (torch.from_numpy((rng.rand(n, co, h, w) < 0.3).astype(np.uint8)),
                torch.from_numpy(rng.rand(n, co, h, w).astype(np.float32))):
        got = cuda_stages._decoder_loss_fwd_kernel(x, *ps, obs, drop_p, seed)
        want = cuda_stages.decoder_loss_fwd_plain(x, *ps, obs, drop_p, seed)
        assert _rel(got, want) < 1e-4
        grads = cuda_stages._decoder_loss_bwd_kernel(x, *ps, obs, gbar, drop_p, seed)
        twin = cuda_stages.decoder_loss_bwd_plain(x, *ps, obs, gbar, drop_p, seed)
        assert len(grads) == 5 and max(_rel(a, t) for a, t in zip(grads, twin)) < 1e-4


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
def test_emulated_routes_agree(emulated, drop_p):
    """The autoencoder's error and gradients through one kernel, two (encoder
    + decoder loss) and four (head, head, tail, loss tail): one seed, one
    mask."""
    n, h, w, seed = 2, 32, 40, 31337
    rng = np.random.RandomState(5)
    src = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    obs = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    ps = _params(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4), (1,),
                       (1, 1, 4, 4), (1,)])
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32))
    one = cuda_head._ae_loss_fwd_kernel(src, *ps, obs, (2, 2), drop_p, seed)
    g_one = cuda_head._ae_loss_bwd_kernel(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    emb = cuda_head._encoder_fwd_kernel(src, *ps[:4], (2, 2), drop_p, seed)
    two = cuda_stages._decoder_loss_fwd_kernel(emb, *ps[4:], obs, drop_p, seed)
    *g_dec, gx = cuda_stages._decoder_loss_bwd_kernel(emb, *ps[4:], obs, gbar, drop_p, seed)
    g_two = (*cuda_head._encoder_bwd_kernel(src, *ps[:4], gx, (2, 2), drop_p, seed), *g_dec)
    x1 = cuda_stages._head_fwd_kernel(src, ps[0], ps[1], 2, drop_p, seed, 0)
    x2 = cuda_stages._head_fwd_kernel(x1, ps[2], ps[3], 2, drop_p, seed, 1)
    mid = cuda_stages._tail_fwd_kernel(x2, ps[4], ps[5], "relu", drop_p, seed, 2)
    four = cuda_stages._loss_tail_fwd_kernel(mid, ps[6], ps[7], obs, "sigmoid", drop_p, seed, 3)
    dw4, db4, gmid = cuda_stages._loss_tail_bwd_kernel(mid, ps[6], ps[7], obs, gbar, "sigmoid",
                                                       drop_p, seed, 3)
    dw3, db3, gx2 = cuda_stages._tail_bwd_kernel(x2, ps[4], ps[5], gmid, "relu", drop_p, seed, 2)
    dw2, db2, gx1 = cuda_stages._head_bwd_kernel(x1, ps[2], ps[3], gx2, 2, drop_p, seed, 1, True)
    dw1, db1, _ = cuda_stages._head_bwd_kernel(src, ps[0], ps[1], gx1, 2, drop_p, seed, 0, False)
    g_four = (dw1, db1, dw2, db2, dw3, db3, dw4, db4)
    assert _rel(two, one) < 1e-5 and _rel(four, one) < 1e-5
    assert max(_rel(a, t) for a, t in zip(g_two, g_one)) < 1e-4
    assert max(_rel(a, t) for a, t in zip(g_four, g_one)) < 1e-4
