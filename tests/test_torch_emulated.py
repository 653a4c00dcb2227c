"""The kernels' own bodies, run on the CPU: ``csrc/*.cu`` compiled as
plain C++ against a stand-in ``<cuda_runtime.h>`` (tests/cuda_emulation/) that
runs every block with one thread, so ``__syncthreads()`` is a no-op and the
kernels' index arithmetic, halos, Philox counters and partial sums can be held
against the plain twins where there is no card and no ``nvcc``.  What the
device compiler refuses, and anything that depends on threads running
together, shows only on the card (tests/test_torch_kernels.py).

Needs ``g++``; skips without it.  Tolerance: 1e-4 of each output's largest
entry (float32 sums in another order than the twins').
"""

import concurrent.futures
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

from carle_tpu_torch import EnvConfig, rules
from carle_tpu_torch.ops import bitpack, cuda_bitpack, cuda_build, cuda_ca, cuda_head, cuda_stages
from carle_tpu_torch.parallel import cuda_halo
from carle_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SOURCES = ("encoder_fwd", "ae_loss_fwd", "encoder_bwd", "ae_loss_bwd", "ae2d_fwd", "ae2d_bwd",
           "enc3_fwd", "enc3_bwd", "head_fwd", "head2_fwd", "head_bwd", "head2_bwd", "tail",
           "tail2_fwd", "tail2_bwd", "loss_tail2_fwd", "loss_tail2_bwd",
           "decoder_loss_fwd", "decoder_loss_bwd", "dec2_fwd", "dec2_bwd",
           "bit_multi_step", "ca_multi_step", "halo_step", "halo_words", "ca_step")
SHIM = cuda_build.CSRC.parents[1] / "tests" / "cuda_emulation"
_BUILDS = {}   # (source, defines) -> the Future of its library's path, for this process
_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=len(SOURCES))


def _includes(path, seen):
    """The csrc headers ``path`` includes, and theirs, into ``seen``."""
    for name in re.findall(r'#include "([^"]+)"', path.read_text()):
        header = cuda_build.CSRC / name
        if header not in seen:
            seen.add(header)
            _includes(header, seen)
    return seen


def _build(out, gxx, name, defines):
    """The host build of csrc/``name``.cu with ``defines``, under ``out``: one
    library for a run's every process, named by a hash of the source, the
    headers it includes, the shim and the command.  A file lock makes one
    process build it while the others wait for it."""
    source = cuda_build.CSRC / f"{name}.cu"
    flags = ["-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", *(f"-D{d}" for d in defines),
             "-I", str(SHIM), "-I", str(cuda_build.CSRC)]
    digest = hashlib.sha256(" ".join([gxx, *flags]).encode())
    for part in (source, *sorted(_includes(source, set())), SHIM / "cuda_runtime.h"):
        digest.update(part.read_bytes())
    tag = "".join(f"-{d}" for d in defines).replace("=", "")
    target = out / f"{name}{tag}-{digest.hexdigest()[:16]}.so"
    with open(target.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not target.exists():
            tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            run = subprocess.run([gxx, *flags, "-o", str(tmp), str(source)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            assert run.returncode == 0, f"{name} does not compile as C++:\n{run.stdout}"
            os.replace(tmp, target)
    return target


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernels built for the host, bound in place of the CUDA libraries
    for this module's tests.  Each (source, defines) library is built once a
    test run, in a directory the run's xdist workers share
    (``_build``); every source's build starts with the first module that
    asks, and a test waits only for the libraries it launches (a library
    with ``-D`` defines, such as a fixed-rule engine, starts on its first
    use)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = tmp_path_factory.getbasetemp().parent / "emulated_kernels"
    out.mkdir(exist_ok=True)

    def built(name, defines=()):
        key = (name, tuple(defines))
        if key not in _BUILDS:
            _BUILDS[key] = _POOL.submit(_build, out, gxx, name, key[1])
        return _BUILDS[key]

    for name in SOURCES:
        built(name)

    def library(name, defines=()):
        lib = ctypes.CDLL(str(built(name, defines).result()))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        return lib

    patch = pytest.MonkeyPatch()
    patch.setattr(cuda_build, "library", library)
    for module in (cuda_head, cuda_stages, cuda_bitpack, cuda_ca, cuda_halo):
        patch.setattr(module, "stream_args", lambda t: (0, None))
    for kernel in cuda_build.KERNELS.values():   # drop any bound launcher, here and afterwards
        if kernel.source in SOURCES:
            patch.setattr(kernel, "_fn", None)
            patch.setattr(kernel, "_variants", {})
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
    kernel = (cuda_head.ENC3_FWD if cuda_head.encoder_route(h, w, (c1, c2), (p1, p2))
              else cuda_head.ENCODER)   # the widths' route
    launches = kernel.launches
    got = cuda_head._encoder_fwd_kernel(x, *ps, (p1, p2), drop_p, seed)
    assert kernel.launches == launches + 1
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
    kernel = (cuda_stages.HEAD2_FWD if cuda_stages.head_fwd_route(
        c, o, pool, w, cuda_head.cell_kind(x)) else cuda_stages.HEAD_FWD)   # the widths' route
    launches = kernel.launches
    got = cuda_stages._head_fwd_kernel(x, wt, b, pool, drop_p, seed, stage)
    assert kernel.launches == launches + 1
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
def test_decoder_loss_kernels_emulated(emulated, monkeypatch, geom, drop_p):
    n, h, w, (c2, cm, co) = geom
    monkeypatch.setattr(cuda_stages, "DEC2_KERNELS", False)   # the generic kernel at every width
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


RULESETS = [([3], [2, 3]), ([3, 6, 8], [2, 4, 5]), ([3, 6, 7, 8], [3, 4, 6, 7, 8]),
            ([3], [0, 2, 3]), ([1, 3, 5, 7], [1, 3, 5, 7])]


def _rule_mask(birth, survive):
    return rules.pack_rule_bits(birth, survive)


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("shape", [(3, 64, 96), (2, 32, 32)])
def test_engine_kernels_emulated(emulated, monkeypatch, shape, resident):
    """Rows 2, 10, 11a, 11b and 12: the four packed engines and the uint8
    engine against their twins, bit for bit, resident and per generation,
    scalar and per-universe rules."""
    n, h, w = shape
    monkeypatch.setattr(cuda_bitpack, "resident", lambda a, b, pad=0: resident)
    rng = np.random.RandomState(h + w + resident)
    grid = torch.from_numpy((rng.rand(n, h, w) < 0.4).astype(np.uint8))
    rm, cm = bitpack.pack_grid(grid), bitpack.pack_grid_cm(grid)
    vec = torch.tensor([_rule_mask(*RULESETS[i % 5]) for i in range(n)], dtype=torch.int32)
    steps = 5
    for birth, survive in RULESETS[:2]:
        got = cuda_bitpack._static_rule(cuda_bitpack.KERNEL_STATIC, rm, birth, survive, steps,
                                        False, "")
        assert torch.equal(got, bitpack.bit_multi_step_static(rm, birth, survive, steps))
        got = cuda_bitpack._static_rule(cuda_bitpack.KERNEL_STATIC_CM, cm, birth, survive,
                                        steps, True, "")
        assert torch.equal(got, bitpack.bit_multi_step_static_cm(cm, birth, survive, steps))
    for rule in (torch.tensor(_rule_mask(*RULESETS[2]), dtype=torch.int32), vec):
        got = cuda_bitpack._data_rule(cuda_bitpack.KERNEL, rm, rule, steps, False, "")
        assert torch.equal(got, bitpack.bit_multi_step(rm, rule, steps))
        got = cuda_bitpack._data_rule(cuda_bitpack.KERNEL_CM, cm, rule, steps, True, "")
        assert torch.equal(got, bitpack.bit_multi_step_cm(cm, rule, steps))
        monkeypatch.setattr(cuda_ca, "_SMEM_BYTES", 227 * 1024 if resident else 0)
        got = cuda_ca._ca_multi_step_kernel(grid, rule, steps)
        assert torch.equal(got, cuda_ca.ca_multi_step_plain(grid, rule, steps))
    # every engine on one grid: one checksum (bench.py's check)
    life = _rule_mask([3], [2, 3])
    sums = {int(bitpack.unpack_grid(cuda_bitpack._data_rule(cuda_bitpack.KERNEL, rm, life, steps,
                                                            False, ""), w).sum()),
            int(bitpack.unpack_grid_cm(cuda_bitpack._data_rule(cuda_bitpack.KERNEL_CM, cm, life,
                                                               steps, True, ""), h).sum()),
            int(cuda_ca._ca_multi_step_kernel(grid, life, steps).sum())}
    assert len(sums) == 1


ACTION_VALUES = np.array([0, 1, 2, 128, 255], dtype=np.uint8)


@pytest.mark.parametrize("geom", [  # n, h, w, ah, aw, plan (rows, strip, threads) or None
    (2, 40, 64, 20, 26, None),          # the window from column 19 (mid-word), AW % 4 = 2
    (1, 42, 48, 13, 7, (16, 4, 64)),    # N = 1, H not a multiple of the band, c0 = 20
    (3, 24, 32, 24, 32, (8, 3, 32)),    # the window the whole universe, ragged strips
    (2, 9, 80, 5, 33, (4, 2, 64)),      # a last band of one row, rows 2-5, from column 23
    (2, 20, 16, 6, 5, (6, 2, 32)),      # one 16-byte column: west and east wrap into it
    (3, 30, 64, 12, 32, (30, 8, 128)),  # a window on 16-byte columns (c0 = 16, AW = 32)
    (1, 6, 96, 1, 1, None),             # one band the whole universe, one cell at c0 = 47
    (2, 33, 112, 33, 3, (11, 11, 32)),  # window rows 0-31: the wrapped halo row 0 toggles
])
def test_ca_step_kernels_emulated(emulated, geom):
    """Row 1: the word kernel and the byte kernel against ca_step_plain, bit
    for bit: action values 0, 1, 2, 128 and 255, the master reset set and
    unset, scalar and per-universe rules."""
    n, h, w, ah, aw, plan = geom
    cfg = EnvConfig(width=w, height=h, action_width=aw, action_height=ah, instances=n)
    rng = np.random.RandomState(h * w + n)
    grid = torch.from_numpy((rng.rand(n, h, w) < 0.4).astype(np.uint8))
    shape = cfg.action_shape   # an odd height shrinks the window a row
    action = torch.from_numpy(np.where(rng.rand(*shape) < 0.5, 0,
                                       rng.choice(ACTION_VALUES, shape)).astype(np.uint8))
    vec = torch.tensor([_rule_mask(*RULESETS[i % 5]) for i in range(n)], dtype=torch.int32)
    for rule in (torch.tensor(_rule_mask(*RULESETS[1]), dtype=torch.int32), vec):
        for reset in (None, torch.tensor(False), torch.tensor(True)):
            want = cuda_ca.ca_step_plain(grid, action, rule, cfg, reset)
            got = cuda_ca._ca_step_words_kernel(grid, action, rule, cfg, reset, plan)
            assert torch.equal(got, want)
            assert torch.equal(cuda_ca._ca_step_bytes_kernel(grid, action, rule, cfg, reset),
                               want)
            if reset is not None and bool(reset):
                assert not want.any()
            else:
                assert want.any()


def test_ca_step_launch_counts_emulated(emulated):
    """One launch a call, counted under the kernel that ran."""
    cfg = EnvConfig(width=32, height=16, action_width=8, action_height=8, instances=2)
    grid = torch.zeros(cfg.grid_shape, dtype=torch.uint8)
    action = torch.ones(cfg.action_shape, dtype=torch.uint8)
    words, words_n = cuda_ca.KERNEL_WORDS, cuda_ca.KERNEL_WORDS.launches
    byte_n = cuda_ca.KERNEL.launches
    cuda_ca._ca_step_words_kernel(grid, action, rules.LIFE, cfg)
    assert (words.launches, cuda_ca.KERNEL.launches) == (words_n + 1, byte_n)
    cuda_ca._ca_step_bytes_kernel(grid, action, rules.LIFE, cfg)
    assert (words.launches, cuda_ca.KERNEL.launches) == (words_n + 1, byte_n + 1)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b) if x is not None)
    return torch.equal(a, b)


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
def test_packed_cell_loader_emulated(emulated, drop_p):
    """Every kernel that reads cells gives, fed the packed words, the bits it
    gives fed the same cells as uint8: the encoder and its backward, the
    autoencoder with src and obs each packed or not, the decoder loss, the
    head and the loss tail, forward and backward."""
    n, h, w, seed = 2, 32, 64, 4242
    rng = np.random.RandomState(9)
    u8 = torch.from_numpy((rng.rand(n, 1, h, w) < 0.35).astype(np.uint8))
    obs8 = torch.from_numpy((rng.rand(n, 1, h, w) < 0.35).astype(np.uint8))
    u32, obs32 = bitpack.pack_grid(u8), bitpack.pack_grid(obs8)
    assert u32.shape == (n, 1, h, w // 32)
    ps = _params(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4), (1,),
                       (1, 1, 4, 4), (1,)])
    ps[1] = ps[1].abs()
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32))
    g = torch.from_numpy(rng.randn(n, 2, h // 4, w // 4).astype(np.float32))
    ch, cs = cuda_head, cuda_stages
    assert _same(ch._encoder_fwd_kernel(u32, *ps[:4], (2, 2), drop_p, seed),
                 ch._encoder_fwd_kernel(u8, *ps[:4], (2, 2), drop_p, seed))
    assert _same(ch._encoder_bwd_kernel(u32, *ps[:4], g, (2, 2), drop_p, seed),
                 ch._encoder_bwd_kernel(u8, *ps[:4], g, (2, 2), drop_p, seed))
    want = ch._ae_loss_fwd_kernel(u8, *ps, obs8, (2, 2), drop_p, seed)
    want_g = ch._ae_loss_bwd_kernel(u8, *ps, obs8, gbar, (2, 2), drop_p, seed)
    for src, obs in ((u32, obs8), (u8, obs32), (u32, obs32)):
        assert _same(ch._ae_loss_fwd_kernel(src, *ps, obs, (2, 2), drop_p, seed), want)
        assert _same(ch._ae_loss_bwd_kernel(src, *ps, obs, gbar, (2, 2), drop_p, seed), want_g)
    emb = ch._encoder_fwd_kernel(u8, *ps[:4], (2, 2), drop_p, seed)
    assert _same(cs._decoder_loss_fwd_kernel(emb, *ps[4:], obs32, drop_p, seed),
                 cs._decoder_loss_fwd_kernel(emb, *ps[4:], obs8, drop_p, seed))
    assert _same(cs._decoder_loss_bwd_kernel(emb, *ps[4:], obs32, gbar, drop_p, seed),
                 cs._decoder_loss_bwd_kernel(emb, *ps[4:], obs8, gbar, drop_p, seed))
    gh = torch.from_numpy(rng.randn(n, 4, h // 2, w // 2).astype(np.float32))
    assert _same(cs._head_fwd_kernel(u32, ps[0], ps[1], 2, drop_p, seed, 0),
                 cs._head_fwd_kernel(u8, ps[0], ps[1], 2, drop_p, seed, 0))
    assert _same(cs._head_bwd_kernel(u32, ps[0], ps[1], gh, 2, drop_p, seed, 0, False),
                 cs._head_bwd_kernel(u8, ps[0], ps[1], gh, 2, drop_p, seed, 0, False))
    mid = torch.from_numpy(np.maximum(rng.randn(n, 1, h // 2, w // 2), 0).astype(np.float32))
    assert _same(cs._loss_tail_fwd_kernel(mid, ps[6], ps[7], obs32, "sigmoid", drop_p, seed, 3),
                 cs._loss_tail_fwd_kernel(mid, ps[6], ps[7], obs8, "sigmoid", drop_p, seed, 3))
    assert _same(
        cs._loss_tail_bwd_kernel(mid, ps[6], ps[7], obs32, gbar, "sigmoid", drop_p, seed, 3),
        cs._loss_tail_bwd_kernel(mid, ps[6], ps[7], obs8, gbar, "sigmoid", drop_p, seed, 3))
    # and the twins agree with the kernels on the packed input
    assert _rel(ch._ae_loss_fwd_kernel(u32, *ps, obs32, (2, 2), drop_p, seed),
                ch.ae_loss_fwd_plain(u32, *ps, obs32, (2, 2), drop_p, seed)) < 1e-4


def _max_rel(got, want):
    return max(_rel(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("pools, c1, c2", [((2, 2), 4, 2), ((4, 2), 4, 1)])
def test_encoder_column_tiles_and_mask_emulated(emulated, monkeypatch, pools, c1, c2,
                                                packed, drop_p):
    """The encoder's kernels with the width cut into tiles of 48 cells (a
    256-wide universe in six tiles, the last ragged, every edge inside a
    packed word) against the one-tile launch and the twins, with and without
    a stage-1 row mask; a mask of ones is no mask, bit for bit."""
    p1, p2 = pools
    n, h, w, seed = 2, 32, 256, 8080 + p1
    rng = np.random.RandomState(31 + p1)
    u8 = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    u8[0, 0, :, : w // 3] = 0   # a blank stretch: pool windows tie across a tile edge
    x = bitpack.pack_grid(u8) if packed else u8
    ps = _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])
    ps[1], ps[3] = ps[1].abs(), ps[3].abs()
    g = torch.from_numpy(rng.randn(n, c2, h // (p1 * p2), w // (p1 * p2)).astype(np.float32))
    mask = torch.from_numpy((rng.rand(n, h // p1) < 0.7).astype(np.float32))
    ch = cuda_head
    one_f = ch._encoder_fwd_kernel(x, *ps, pools, drop_p, seed)
    one_b = ch._encoder_bwd_kernel(x, *ps, g, pools, drop_p, seed)
    monkeypatch.setattr(ch, "TILE_CELLS", 48)
    assert ch._encoder_fwd_plan(h, w, c1, c2, p1, p2, 48)[1] == 48 // (p1 * p2)
    tiled_f = ch._encoder_fwd_kernel(x, *ps, pools, drop_p, seed)
    tiled_b = ch._encoder_bwd_kernel(x, *ps, g, pools, drop_p, seed)
    assert torch.equal(tiled_f, one_f)
    assert _max_rel(tiled_b, one_b) < 1e-5
    assert _max_rel(tiled_b, ch.encoder_bwd_plain(x, *ps, g, pools, drop_p, seed)) < 1e-4
    ones = torch.ones(n, h // p1)
    assert torch.equal(ch._encoder_fwd_kernel(x, *ps, pools, drop_p, seed, ones), tiled_f)
    assert _same(ch._encoder_bwd_kernel(x, *ps, g, pools, drop_p, seed, ones), tiled_b)
    got_f = ch._encoder_fwd_kernel(x, *ps, pools, drop_p, seed, mask)
    want_f = ch.encoder_fwd_plain(x, *ps, pools, drop_p, seed, mask)
    assert not torch.equal(got_f, tiled_f) and _rel(got_f, want_f) < 1e-4
    got_b = ch._encoder_bwd_kernel(x, *ps, g, pools, drop_p, seed, mask)
    assert _max_rel(got_b, ch.encoder_bwd_plain(x, *ps, g, pools, drop_p, seed, mask)) < 1e-4
    monkeypatch.setattr(ch, "TILE_CELLS", None)
    assert torch.equal(ch._encoder_fwd_kernel(x, *ps, pools, drop_p, seed, mask), got_f)
    assert _max_rel(ch._encoder_bwd_kernel(x, *ps, g, pools, drop_p, seed, mask), got_b) < 1e-5


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("obs_kind", ["uint8", "packed", "float32"])
def test_decoder_loss_column_tiles_and_row_weights_emulated(emulated, monkeypatch, obs_kind,
                                                           drop_p):
    """The decoder loss's kernels with the width cut into tiles of 48 output
    columns against the one-tile launch and the twins, with and without error
    row weights em; an em of ones is no em, bit for bit.  The generic kernels
    (tests/test_torch_decoder2.py holds the specialised ones)."""
    monkeypatch.setattr(cuda_stages, "DEC2_KERNELS", False)
    n, h, w, seed = 2, 32, 256, 6060
    rng = np.random.RandomState(17)
    x = torch.from_numpy(np.maximum(rng.randn(n, 2, h // 4, w // 4), 0).astype(np.float32))
    ps = _params(rng, [(2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)])
    cells = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    obs = {"uint8": cells, "packed": bitpack.pack_grid(cells),
           "float32": torch.from_numpy(rng.rand(n, 1, h, w).astype(np.float32))}[obs_kind]
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32))
    em = torch.from_numpy(np.where(rng.rand(n, h) < 0.3, 0.0,
                                   rng.rand(n, h) + 0.5).astype(np.float32))
    cs = cuda_stages
    one_f = cs._decoder_loss_fwd_kernel(x, *ps, obs, drop_p, seed)
    one_b = cs._decoder_loss_bwd_kernel(x, *ps, obs, gbar, drop_p, seed)
    monkeypatch.setattr(cuda_head, "TILE_CELLS", 48)
    assert cs._decoder_bands(h, w, 2, 1, 1, 48)[1][1] == 12
    tiled_f = cs._decoder_loss_fwd_kernel(x, *ps, obs, drop_p, seed)
    tiled_b = cs._decoder_loss_bwd_kernel(x, *ps, obs, gbar, drop_p, seed)
    assert _rel(tiled_f, one_f) < 1e-5 and _max_rel(tiled_b, one_b) < 1e-5
    assert _max_rel(tiled_b, cs.decoder_loss_bwd_plain(x, *ps, obs, gbar, drop_p, seed)) < 1e-4
    ones = torch.ones(n, h)
    assert torch.equal(cs._decoder_loss_fwd_kernel(x, *ps, obs, drop_p, seed, ones), tiled_f)
    assert _same(cs._decoder_loss_bwd_kernel(x, *ps, obs, gbar, drop_p, seed, ones), tiled_b)
    got_f = cs._decoder_loss_fwd_kernel(x, *ps, obs, drop_p, seed, em)
    assert _rel(got_f, cs.decoder_loss_fwd_plain(x, *ps, obs, drop_p, seed, em)) < 1e-4
    got_b = cs._decoder_loss_bwd_kernel(x, *ps, obs, gbar, drop_p, seed, em)
    assert _max_rel(got_b, cs.decoder_loss_bwd_plain(x, *ps, obs, gbar, drop_p, seed, em)) < 1e-4
    monkeypatch.setattr(cuda_head, "TILE_CELLS", None)
    assert torch.equal(cs._decoder_loss_fwd_kernel(x, *ps, obs, drop_p, seed, ones), one_f)
    assert _same(cs._decoder_loss_bwd_kernel(x, *ps, obs, gbar, drop_p, seed, ones), one_b)
    assert _rel(cs._decoder_loss_fwd_kernel(x, *ps, obs, drop_p, seed, em), got_f) < 1e-5


@pytest.mark.parametrize("slots", [1, 2, 4])
@pytest.mark.parametrize("steps", [1, 2, 5])
def test_halo_kernels_emulated(emulated, slots, steps):
    """Rows 13-15: the halo kernels on every slot of one device, against the
    twins and the single-device engines, bit for bit; uint8 and packed, the
    rule a scalar, a per-universe vector or fixed at compile time, the ring's
    edges (one and two slots)."""
    n, h, w = 3, 64, 96
    rng = np.random.RandomState(slots * 10 + steps)
    grid = torch.from_numpy((rng.rand(n, h, w) < 0.35).astype(np.uint8))
    words = bitpack.pack_grid(grid)
    mesh = make_mesh([torch.device("cpu")] * slots, "space")
    vec = torch.tensor([_rule_mask(*RULESETS[i]) for i in range(n)], dtype=torch.int32)
    life = _rule_mask([3], [2, 3])
    for rule in (torch.tensor(life, dtype=torch.int32), vec):
        kernel = cuda_halo.KERNEL_STEP if steps == 1 else cuda_halo.KERNEL_MULTI
        launches = kernel.launches
        got = cuda_halo._launch(kernel, shard_rows(grid, mesh), rule, steps, cuda_halo.KIND_U8)
        assert kernel.launches == launches + steps   # one launch a generation
        assert torch.equal(gather_rows(got), cuda_ca.ca_multi_step_plain(grid, rule, steps))
        twin = cuda_halo.spatial_multi_step_plain(shard_rows(grid, mesh), rule, steps)
        assert all(torch.equal(a, b) for a, b in zip(got.parts, twin.parts))
        got = cuda_halo._launch(cuda_halo.KERNEL_BIT, shard_rows(words, mesh), rule, steps,
                                cuda_halo.KIND_U32)
        assert torch.equal(gather_rows(got), bitpack.bit_multi_step(words, rule, steps))
    got = cuda_halo._launch(cuda_halo.KERNEL_BIT, shard_rows(words, mesh), life, steps,
                            cuda_halo.KIND_U32, defines=(f"STATIC_RULE={life:#07x}",))
    assert torch.equal(gather_rows(got), bitpack.bit_multi_step_static(words, [3], [2, 3], steps))


@pytest.mark.parametrize("geom", [  # n, slots, h, w, ah, aw, plan (rows, strip, threads) or None
    (2, 1, 32, 48, 8, 8, None),         # one slot: its own rows are its ghost rows
    (3, 3, 48, 32, 8, 8, (5, 2, 32)),   # the window inside slot 1, a ragged last band
    (2, 2, 32, 48, 8, 12, (4, 4, 32)),  # rows 12-19 across the edge at 16: ghost rows toggle
    (2, 8, 64, 32, 32, 16, (3, 1, 32)),  # rows 16-47: slots 2-5 whole, bands of 3 over 8 rows
    (1, 8, 64, 16, 64, 5, (1, 1, 32)),  # the whole height, one 16-byte column, c0 = 5
    (2, 3, 63, 32, 9, 9, None),         # an odd height: the window cut to 8 rows
])
def test_halo_words_emulated(emulated, geom):
    """Row 14's kernel (halo_words.cu) on every slot of one device against
    the env step's twin, the single-device twin on the gathered grid and the
    present kernel, bit for bit: action values 0, 1, 2, 128 and 255, the
    master reset none, unset and set, scalar and per-universe rules, the
    bare generation without an action; one launch a call."""
    from carle_tpu_torch.ops.ca import ca_step_with_action

    n, slots, h, w, ah, aw, plan = geom
    cfg = EnvConfig(width=w, height=h, action_width=aw, action_height=ah, instances=n)
    rng = np.random.RandomState(h * w + slots)
    grid = torch.from_numpy((rng.rand(n, h, w) < 0.4).astype(np.uint8))
    shape = cfg.action_shape
    action = torch.from_numpy(np.where(rng.rand(*shape) < 0.5, 0,
                                       rng.choice(ACTION_VALUES, shape)).astype(np.uint8))
    x = shard_rows(grid, make_mesh([torch.device("cpu")] * slots, "space"))
    vec = torch.tensor([_rule_mask(*RULESETS[i % 5]) for i in range(n)], dtype=torch.int32)
    kernel = cuda_halo.KERNEL_WORDS
    for rule in (torch.tensor(_rule_mask(*RULESETS[1]), dtype=torch.int32), vec):
        for reset in (None, torch.tensor(False), torch.tensor(True)):
            launches = kernel.launches
            got = cuda_halo._launch_halo_words(x, rule, action, cfg, reset, plan)
            assert kernel.launches == launches + 1
            twin = cuda_halo.spatial_env_step_plain(x, action, rule, cfg, reset)
            assert all(torch.equal(a, b) for a, b in zip(got.parts, twin.parts))
            assert torch.equal(gather_rows(got), ca_step_with_action(grid, action, rule, cfg,
                                                                     reset))
            assert bool(gather_rows(got).any()) == (reset is None or not bool(reset))
        got = cuda_halo._launch_halo_words(x, rule, plan=plan)
        assert torch.equal(gather_rows(got), cuda_ca.ca_multi_step_plain(grid, rule, 1))
        present = cuda_halo._launch(cuda_halo.KERNEL_STEP, x, rule, 1, cuda_halo.KIND_U8)
        assert all(torch.equal(a, b) for a, b in zip(got.parts, present.parts))


def test_one_generation_routes_emulated(emulated, monkeypatch):
    """One uint8 generation (spatial_ca_step_cuda, spatial_multi_step_cuda at
    K = 1, the env step) takes halo_words where the route holds and the
    present kernel where it does not or HALO_U8_WORDS is off; the env step
    then XORs clones of the window's slots and applies the flag after."""
    cfg = EnvConfig(width=32, height=32, action_width=8, action_height=8, instances=2)
    rng = np.random.RandomState(9)
    grid = torch.from_numpy((rng.rand(2, 32, 32) < 0.4).astype(np.uint8))
    action = torch.from_numpy((rng.rand(2, 8, 8) < 0.5).astype(np.uint8))
    x = shard_rows(grid, make_mesh([torch.device("cpu")] * 4, "space"))
    # CPU slots standing in for a card's: the wrappers launch the emulated kernels
    monkeypatch.setattr(cuda_halo, "_check", lambda *a: "cuda")
    words, step = cuda_halo.KERNEL_WORDS, cuda_halo.KERNEL_STEP
    reset = torch.tensor(True)
    for on, counted in ((True, words), (False, step)):
        monkeypatch.setattr(cuda_halo, "HALO_U8_WORDS", on)
        assert cuda_halo.halo_words_route(8, 32) == ("words" if on else "present")
        before = (words.launches, step.launches)
        want = cuda_ca.ca_multi_step_plain(grid, rules.LIFE, 1)
        assert torch.equal(gather_rows(cuda_halo.spatial_ca_step_cuda(x, rules.LIFE)), want)
        assert torch.equal(gather_rows(cuda_halo.spatial_multi_step_cuda(x, rules.LIFE, 1)),
                           want)
        got = cuda_halo.spatial_env_step_cuda(x, action, rules.LIFE, cfg)
        assert all(torch.equal(a, b) for a, b in zip(
            got.parts, cuda_halo.spatial_env_step_plain(x, action, rules.LIFE, cfg).parts))
        assert not gather_rows(cuda_halo.spatial_env_step_cuda(x, action, rules.LIFE, cfg,
                                                               reset)).any()
        after = (words.launches, step.launches)
        assert counted.launches - before[counted is step] == 4   # one launch a call
        assert after[counted is words] == before[counted is words]
    assert cuda_halo.halo_words_route(8, 40) == "present"   # 40 % 16 != 0


def test_env_layout_step_emulated(emulated, monkeypatch):
    """The env step on parallel.mesh.shard_carry's instance shards (4 rings
    of one slot: each universe's rows wrap onto itself) by the emulated
    halo_words kernel, one launch a ring, against the single-device twin on
    the whole batch, bit for bit: a per-universe rule, the reset flag unset
    and set (one flag for every ring)."""
    from carle_tpu_torch.ops.ca import ca_step_with_action
    from carle_tpu_torch.parallel.mesh import env_layout

    cfg = EnvConfig(width=32, height=32, action_width=8, action_height=8, instances=4)
    rng = np.random.RandomState(12)
    grid = torch.from_numpy((rng.rand(4, 32, 32) < 0.4).astype(np.uint8))
    action = torch.from_numpy(np.where(rng.rand(4, 8, 8) < 0.5, 0,
                                       rng.choice(ACTION_VALUES, (4, 8, 8))).astype(np.uint8))
    x = shard_rows(grid, env_layout(make_mesh([torch.device("cpu")] * 4, "env")), "space", "env")
    vec = torch.tensor([_rule_mask(*RULESETS[i]) for i in range(4)], dtype=torch.int32)
    monkeypatch.setattr(cuda_halo, "_check", lambda *a: "cuda")   # the emulated kernel
    words = cuda_halo.KERNEL_WORDS
    for reset in (torch.tensor(False), torch.tensor(True)):
        before = words.launches
        got = cuda_halo.spatial_env_step_cuda(x, action, vec, cfg, reset)
        assert words.launches == before + 4   # a launch a ring
        assert torch.equal(gather_rows(got), ca_step_with_action(grid, action, vec, cfg, reset))


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["uint8", "packed", "float32"])
@pytest.mark.parametrize("pool, c, o", [(2, 1, 4), (4, 4, 1)])
def test_head_column_tiles_emulated(emulated, monkeypatch, pool, c, o, kind, drop_p):
    """The head's kernels with the width cut into tiles of 48 cells (a
    256-wide universe, the last tile ragged, every edge inside a packed word)
    against the one-tile launch, bit for bit forward and within 1e-5 of each
    leaf backward (the input cotangent bit for bit), and against the twins."""
    n, h, w, seed = 2, 16, 256, 4242 + pool
    rng = np.random.RandomState(7 + pool + c)
    if kind == "float32":
        x = torch.from_numpy(np.maximum(rng.randn(n, c, h, w), 0).astype(np.float32))
    else:
        u8 = torch.from_numpy((rng.rand(n, c, h, w) < 0.3).astype(np.uint8))
        u8[0, :, :, : w // 3] = 0   # a blank stretch: pool windows tie across a tile edge
        x = bitpack.pack_grid(u8) if kind == "packed" else u8
    wt, b = _params(rng, [(o, c, 3, 3), (o,)])
    b = b.abs()
    g = torch.from_numpy(rng.randn(n, o, h // pool, w // pool).astype(np.float32))
    cs = cuda_stages
    one_f = cs._head_fwd_kernel(x, wt, b, pool, drop_p, seed, 0)
    one_b = cs._head_bwd_kernel(x, wt, b, g, pool, drop_p, seed, 0, True)
    monkeypatch.setattr(cuda_head, "TILE_CELLS", 48)
    assert cs._head_bands(c, o, h, w, pool, 48)[0][1] == 48 // pool
    tiled_f = cs._head_fwd_kernel(x, wt, b, pool, drop_p, seed, 0)
    tiled_b = cs._head_bwd_kernel(x, wt, b, g, pool, drop_p, seed, 0, True)
    assert torch.equal(tiled_f, one_f)
    assert torch.equal(tiled_b[2], one_b[2])
    assert _max_rel(tiled_b[:2], one_b[:2]) < 1e-5
    assert _rel(tiled_f, cs.head_fwd_plain(x, wt, b, pool, drop_p, seed, 0)) < 1e-4
    twin = cs.head_bwd_plain(x, wt, b, g, pool, drop_p, seed, 0, True)
    assert _max_rel(tiled_b, twin) < 1e-4
