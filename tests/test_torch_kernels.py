"""The CUDA kernels of carle_tpu_torch against their plain twins.

These tests need an NVIDIA card and the CUDA toolkit; without a card they
skip.  They import neither JAX nor carle_tpu, so they also run where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Integer kernels must equal their twins exactly; float kernels agree within
rtol/atol 1e-4 (the twins run cuDNN in full float32, TF32 off, summing in
other orders); the AE error must also be bit-for-bit repeatable.  Gradients
agree within 1e-4 of each leaf's largest entry and are bit-for-bit repeatable;
with dropout the kernels and the twins draw the same Philox mask, or nothing
would agree.  The non-kernel checks at the end run everywhere.
"""

import numpy as np
import pytest
import torch

from carle_tpu_torch import EnvConfig, rules
from carle_tpu_torch.ops import (bitpack, cuda_bitpack, cuda_build, cuda_ca, cuda_head,
                                 cuda_stages)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False       # the plain twins are the
    torch.backends.cuda.matmul.allow_tf32 = False  # reference: full float32
    return torch.device("cuda")


def _soup(seed, shape, density=0.35):
    return (np.random.RandomState(seed).rand(*shape) < density).astype(np.uint8)


def _params(rng, shapes):
    return [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(64, 64, 16, 16, 2), (23, 37, 8, 9, 3),
                                  (24, 40, 7, 12, 2), (256, 256, 64, 64, 16)])
def test_ca_step_kernel_matches_plain(cuda, geom):
    h, w, ah, aw, n = geom
    cfg = EnvConfig(h, w, ah, aw, n)
    rng = np.random.RandomState(h)
    grid = torch.from_numpy(_soup(h, cfg.grid_shape)).to(cuda)
    action = torch.from_numpy(
        rng.randint(0, 4, size=cfg.action_shape).astype(np.uint8)).to(cuda)
    for rule in (torch.tensor(rules.LIFE, dtype=torch.int32),
                 torch.from_numpy(rng.randint(0, 1 << 18, size=n).astype(np.int32))):
        rule = rule.to(cuda)
        kernel = (cuda_ca.KERNEL_WORDS if cuda_ca.ca_step_route(h, w) == "words"
                  else cuda_ca.KERNEL)
        before = kernel.launches
        got = cuda_ca.ca_step(grid, action, rule, cfg)
        assert kernel.launches == before + 1
        assert torch.equal(got, cuda_ca.ca_step_plain(grid, action, rule, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(256, 256, 64, 64, 160), (256, 256, 64, 64, 1),
                                  (64, 80, 20, 26, 3), (42, 48, 13, 7, 2)])
def test_ca_step_words_matches_bytes_and_plain(cuda, geom):
    """The word kernel (its own plan and a forced one of 16-row bands)
    against the byte kernel forced and the twin, bit for bit: action values
    0, 1, 2, 128, 255 in a window that may start mid-word, the master reset
    set and unset, scalar and per-universe rules."""
    h, w, ah, aw, n = geom
    cfg = EnvConfig(h, w, ah, aw, n)
    rng = np.random.RandomState(h + n)
    grid = torch.from_numpy(_soup(h + n, cfg.grid_shape)).to(cuda)
    values = np.array([0, 1, 2, 128, 255], dtype=np.uint8)
    action = torch.from_numpy(np.where(rng.rand(*cfg.action_shape) < 0.5, 0,
                                       rng.choice(values, cfg.action_shape))
                              .astype(np.uint8)).to(cuda)
    vec = torch.from_numpy(rng.randint(0, 1 << 18, size=n).astype(np.int32)).to(cuda)
    for rule in (torch.tensor(rules.MORLEY, dtype=torch.int32, device=cuda), vec):
        for reset in (None, torch.tensor(False, device=cuda), torch.tensor(True, device=cuda)):
            want = cuda_ca.ca_step_plain(grid, action, rule, cfg, reset)
            for plan in (None, (16, 4, 64)):
                got = cuda_ca._ca_step_words_kernel(grid, action, rule, cfg, reset, plan)
                assert torch.equal(got, want)
            assert torch.equal(cuda_ca._ca_step_bytes_kernel(grid, action, rule, cfg, reset),
                               want)
            assert bool(want.any()) == (reset is None or not bool(reset))


@pytest.mark.cuda
@pytest.mark.parametrize("geom,route", [((256, 256), "words"), ((64, 64), "words"),
                                        ((23, 37), "bytes"), ((24, 40), "bytes")])
def test_ca_step_route_launches_once(cuda, monkeypatch, geom, route):
    """A call launches its route's kernel once and the other kernel never;
    CA_STEP_WORDS = False sends every width to the byte kernel."""
    h, w = geom
    cfg = EnvConfig(h, w, 8, 8, 2)
    grid = torch.from_numpy(_soup(w, cfg.grid_shape)).to(cuda)
    action = torch.ones(cfg.action_shape, dtype=torch.uint8, device=cuda)
    assert cuda_ca.ca_step_route(h, w) == route
    for forced in (False, True):
        monkeypatch.setattr(cuda_ca, "CA_STEP_WORDS", not forced)
        runs = cuda_ca.KERNEL_WORDS if route == "words" and not forced else cuda_ca.KERNEL
        idle = cuda_ca.KERNEL if runs is cuda_ca.KERNEL_WORDS else cuda_ca.KERNEL_WORDS
        before = (runs.launches, idle.launches)
        got = cuda_ca.ca_step(grid, action, rules.LIFE, cfg)
        assert (runs.launches, idle.launches) == (before[0] + 1, before[1])
        assert torch.equal(got, cuda_ca.ca_step_plain(grid, action, rules.LIFE, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,nw", [(8, 256, 8), (2, 512, 16), (1, 1024, 32),
                                    (3, 16, 1)])
def test_bit_multi_step_kernel_matches_plain(cuda, n, h, nw):
    """Resident 256x256 and 512x512, the per-generation fallback at
    1024x1024, and a one-word universe."""
    rng = np.random.RandomState(n + h)
    packed = bitpack.pack_grid(torch.from_numpy(_soup(n + h, (n, h, 32 * nw)))).to(cuda)
    for rule in (torch.tensor(rules.LIFE, dtype=torch.int32),
                 torch.from_numpy(rng.randint(0, 1 << 18, size=n).astype(np.int32))):
        rule = rule.to(cuda)
        for steps in (0, 1, 5):
            got = cuda_bitpack.bit_multi_step(packed, rule, steps)
            want = cuda_bitpack.bit_multi_step_plain(packed, rule, steps)
            assert torch.equal(got.to(torch.int64), want.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,nw", [(8, 256, 8), (2, 512, 16), (1, 1024, 32),
                                    (3, 16, 1)])
def test_bit_words_kernels_match_present_and_plain(cuda, n, h, nw):
    """Row 2's redesigned kernels (bit_multi_step_words) against the present
    kernels forced (BIT_WORDS = False) and the twin, bit for bit, at
    test_bit_multi_step_kernel_matches_plain's shapes and K in {0, 1, 5,
    256}: by the route, and by each plan forced, the cluster split over 16
    blocks (CL = 16) and its size-1 instance, one and two generations an
    exchange among them."""
    rng = np.random.RandomState(n + h + 1)
    packed = bitpack.pack_grid(torch.from_numpy(_soup(n + h, (n, h, 32 * nw)))).to(cuda)
    plans = [("stream", v, s, t) for v in (1, 4) if nw % v == 0
             for s, t in ((1, 64), (4, 256))]
    for v, l, r, cl, g in cuda_bitpack.REGS_PLANS:
        per = h // cl // r * l
        if (v * l == nw and h % (cl * r) == 0 and per <= 256 and (l == 1 or per % 32 == 0)
                and h // cl // r >= g):
            plans.append(("regs", v, l, r, cl, g,
                          per if cl > 1 else per * min(n, 256 // per)))
    for rule in (torch.tensor(rules.LIFE, dtype=torch.int32),
                 torch.from_numpy(rng.randint(0, 1 << 18, size=n).astype(np.int32))):
        rule = rule.to(cuda)
        for steps in (0, 1, 5, 256):
            want = cuda_bitpack.bit_multi_step_plain(packed, rule, steps).to(torch.int64)
            cuda_bitpack.BIT_WORDS = False
            try:
                present = cuda_bitpack.bit_multi_step(packed, rule, steps)
            finally:
                cuda_bitpack.BIT_WORDS = True
            assert torch.equal(present.to(torch.int64), want)
            assert torch.equal(cuda_bitpack.bit_multi_step(packed, rule, steps).to(torch.int64),
                               want)
            for plan in plans:
                if plan[0] == "regs" or steps <= 5:
                    got = cuda_bitpack._words_kernel(packed, rule, steps, plan)
                    assert torch.equal(got.to(torch.int64), want), (plan, steps)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,nw", [(8, 256, 8), (2, 512, 16), (1, 1024, 32), (3, 16, 1),
                                    (300, 256, 8)])
def test_static_words_kernels_match_present_and_plain(cuda, n, h, nw):
    """Row 10's redesigned kernels (bit_multi_step_static_words: row 2's
    kernels with the rule folded) against the present fixed-rule kernel
    forced (BIT_WORDS = False) and the twin, bit for bit, at K in {0, 1, 5,
    64}: by the route (one launch held in registers, the cluster split for
    fewer universes than multiprocessors) and by each register-resident plan
    forced, one and two generations an exchange among them."""
    packed = bitpack.pack_grid(torch.from_numpy(_soup(n + h + 2, (n, h, 32 * nw)))).to(cuda)
    plans = [None]
    for v, l, r, cl, g in cuda_bitpack.REGS_PLANS:
        per = h // cl // r * l
        if (v * l == nw and h % (cl * r) == 0 and per <= 256 and (l == 1 or per % 32 == 0)
                and h // cl // r >= g):
            plans.append(("regs", v, l, r, cl, g, per if cl > 1 else per * min(n, 256 // per)))
    for birth, survive in (([3], [2, 3]), ([3, 6, 8], [2, 4, 5]), ([0, 3], [2, 3])):
        for steps in (0, 1, 5, 64):
            want = cuda_bitpack.bit_multi_step_static_plain(packed, birth, survive, steps)
            cuda_bitpack.BIT_WORDS = False
            try:
                present = cuda_bitpack.bit_multi_step_static(packed, birth, survive, steps)
            finally:
                cuda_bitpack.BIT_WORDS = True
            assert torch.equal(present.to(torch.int64), want.to(torch.int64))
            before = cuda_bitpack.KERNEL_STATIC_WORDS.launches
            got = cuda_bitpack.bit_multi_step_static(packed, birth, survive, steps)
            assert torch.equal(got.to(torch.int64), want.to(torch.int64))
            plan = cuda_bitpack.words_plan(n, h, nw, steps, cuda_ca._multiprocessors(cuda),
                                           True, True)
            if plan is not None and steps > 0 and (steps == 1 or plan[0] == "regs"):
                assert cuda_bitpack.KERNEL_STATIC_WORDS.launches == before + 1
            for plan in plans[1:] if steps > 1 else ():
                got = cuda_bitpack._words_kernel(packed, None, steps, plan, (birth, survive))
                assert torch.equal(got.to(torch.int64), want.to(torch.int64)), (plan, steps)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w", [(8, 256, 256), (3, 32, 64), (70, 16, 32), (300, 256, 256),
                                   (2, 256, 128), (3, 64, 96)])
def test_u8_bits_kernel_matches_present_and_plain(cuda, n, h, w):
    """Row 12's redesigned kernel (ca_multi_step_bits: packed on the load,
    the generations in registers, unpacked on the store) against the present
    kernel forced (CA_MULTI_BITS = False) and the twin, bit for bit, at K in
    {0, 1, 5, 64}, Life and a rule vector: by the route (one launch a call
    where bits_plan holds the shape, the present kernel elsewhere) and by
    each plan of whole universes a block forced."""
    rng = np.random.RandomState(n + h + 3)
    grid = torch.from_numpy(_soup(n + h + 3, (n, h, w), 0.4)).to(cuda)
    plans = []
    for v, r in cuda_ca.BITS_PLANS:
        if 32 * v == w and h % r == 0:
            threads = cuda_ca.bits_threads(n, h // r)
            if threads:
                plans.append(("regs", v, r, threads))
    for rule in (torch.tensor(rules.LIFE, dtype=torch.int32),
                 torch.from_numpy(rng.randint(0, 1 << 18, size=n).astype(np.int32))):
        rule = rule.to(cuda)
        for steps in (0, 1, 5, 64):
            want = cuda_ca.ca_multi_step_plain(grid, rule, steps)
            cuda_ca.CA_MULTI_BITS = False
            try:
                assert torch.equal(cuda_ca.ca_multi_step(grid, rule, steps), want)
            finally:
                cuda_ca.CA_MULTI_BITS = True
            before = (cuda_ca.KERNEL_BITS.launches, cuda_ca.KERNEL_MULTI.launches)
            assert torch.equal(cuda_ca.ca_multi_step(grid, rule, steps), want)
            routed = cuda_ca.bits_plan(n, h, w, steps) is not None
            assert cuda_ca.KERNEL_BITS.launches == before[0] + int(routed)
            assert cuda_ca.KERNEL_MULTI.launches == before[1] + int(not routed)
            for plan in plans:
                got = cuda_ca._ca_multi_bits_kernel(grid, rule, steps, plan)
                assert torch.equal(got, want), (plan, steps)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,hw,w", [(8, 8, 256), (3, 1, 32), (300, 8, 256), (5, 2, 512),
                                    (2, 4, 128), (2, 16, 256)])
def test_static_cm_words_kernel_matches_present_and_plain(cuda, n, hw, w):
    """Row 11a's redesigned kernel (bit_multi_step_static_cm_words: the
    column-major words held in registers, 8 columns a thread, lane shuffles
    for the neighbour columns) against the present kernel forced (BIT_WORDS
    = False) and the twin, bit for bit, at K in {0, 1, 5, 64}: by the route
    (one launch a call where cm_plan holds the shape; universes wider than a
    warp and word rows no instantiation has keep the present kernel) and by
    blocks of one warp and of 256 threads forced."""
    cells = torch.from_numpy(_soup(n + hw + 5, (n, 32 * hw, w), 0.4)).to(cuda)
    packed = bitpack.pack_grid_cm(cells)
    lanes = w // cuda_bitpack.CM_COLUMNS
    fits = (hw,) in cuda_bitpack.CM_PLANS and lanes <= 32 and not lanes & (lanes - 1)
    plans = [("cm", hw, 32), ("cm", hw, 256)] if fits else []
    for birth, survive in (([3], [2, 3]), ([3, 6, 8], [2, 4, 5]), ([0, 3], [2, 3])):
        for steps in (0, 1, 5, 64):
            want = cuda_bitpack.bit_multi_step_static_cm_plain(packed, birth, survive, steps)
            cuda_bitpack.BIT_WORDS = False
            try:
                present = cuda_bitpack.bit_multi_step_static_cm(packed, birth, survive, steps)
            finally:
                cuda_bitpack.BIT_WORDS = True
            assert torch.equal(present.to(torch.int64), want.to(torch.int64))
            before = cuda_bitpack.KERNEL_STATIC_CM_WORDS.launches
            got = cuda_bitpack.bit_multi_step_static_cm(packed, birth, survive, steps)
            assert torch.equal(got.to(torch.int64), want.to(torch.int64))
            routed = cuda_bitpack.cm_plan(n, hw, w, steps) is not None
            assert cuda_bitpack.KERNEL_STATIC_CM_WORDS.launches == before + int(routed)
            for plan in plans if steps else ():
                got = cuda_bitpack._cm_words_kernel(packed, birth, survive, steps, plan)
                assert torch.equal(got.to(torch.int64), want.to(torch.int64)), (plan, steps)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("case", ["AE conv1 u8", "AE conv1 u32", "AE conv1 f32", "RND conv1 u8",
                                  "AE conv2 gx", "AE conv2"])
def test_head2_bwd_matches_generic_and_plain(cuda, case, drop_p):
    """Row 9b's specialised backward (head2_bwd, the route at the package's
    three widths) against the generic kernel forced (HEAD2_KERNELS = False):
    each leaf within 1e-5 of its largest entry (the weight-gradient sums run
    in another order), gx bit for bit; against the twin within 1e-4; the same
    bits twice; one launch a call; universes half blank, so whole pool
    windows tie."""
    n, seed = 8, 31337
    rng = np.random.RandomState(len(case))
    cells = torch.from_numpy(_soup(n, (n, 1, 256, 256))).to(cuda)
    cells[: n // 2, :, :128] = 0
    if case.startswith("AE conv2"):
        x = torch.relu(torch.from_numpy(rng.randn(n, 4, 128, 128).astype(np.float32))).to(cuda)
        x[: n // 2, :, :64] = 0
        c, o, pool, stage = 4, 2, 2, 1
    else:
        x = {"u8": cells, "u32": bitpack.pack_grid(cells[:, 0])[:, None],
             "f32": cells.float()}[case.split()[-1]]
        c, o, pool, stage = 1, 4, (4 if case.startswith("RND") else 2), 0
    need_dx = case.endswith("gx")
    w, b = (t.to(cuda) for t in _params(rng, [(o, c, 3, 3), (o,)]))
    b = b.abs()
    hw = 256 if c == 1 else 128
    g = torch.from_numpy(rng.randn(n, o, hw // pool, hw // pool).astype(np.float32)).to(cuda)
    args = (x, w, b, g, pool, drop_p, seed, stage, need_dx)
    before = cuda_stages.HEAD2_BWD.launches
    got = cuda_stages.head_bwd(*args)
    assert cuda_stages.HEAD2_BWD.launches == before + 1
    assert all(torch.equal(a, t) for a, t in zip(got, cuda_stages.head_bwd(*args))
               if a is not None)
    cuda_stages.HEAD2_KERNELS = False
    try:
        generic = cuda_stages.head_bwd(*args)
    finally:
        cuda_stages.HEAD2_KERNELS = True
    twin = cuda_stages.head_bwd_plain(*args)
    for a, t, p in zip(got, generic, twin):
        if a is None:
            continue
        scale = t.abs().max()
        assert float((a - t).abs().max() / scale) < 1e-5
        assert float((a - p).abs().max() / p.abs().max()) < 1e-4
    if need_dx:
        assert torch.equal(got[2], generic[2])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_bit_halo_words_match_present_and_plain(cuda, slots):
    """Row 15's redesigned launcher (bit_spatial_words) against the present
    kernel forced (BIT_HALO_BLOCKS = False), the twin and the engine, bit for
    bit, at test_halo_kernels_match_plain's shapes: K = 1 and 6, scalar and
    per-universe rules, the default plan and chunks of T = 2, 3 and 4, and
    the fixed-rule build."""
    from carle_tpu_torch.parallel import cuda_halo
    from carle_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_rows

    mesh = make_mesh([cuda] * slots, "space")
    words = bitpack.pack_grid(torch.from_numpy(_soup(slots, (3, 4 * 64, 128))).to(cuda))
    vec = torch.tensor([rules.LIFE, rules.MORLEY, rules.DAY_AND_NIGHT], dtype=torch.int32,
                       device=cuda)
    hl = 4 * 64 // slots
    for rule in (rules.LIFE, vec):
        for steps in (1, 6):
            w = shard_rows(words, mesh)
            want = cuda_bitpack.bit_multi_step(words, rule, steps)
            twin = cuda_halo.bit_spatial_multi_step_plain(w, rule, steps)
            cuda_halo.BIT_HALO_BLOCKS = False
            try:
                present = cuda_halo.bit_spatial_multi_step_cuda(w, rule, steps)
            finally:
                cuda_halo.BIT_HALO_BLOCKS = True
            assert all(torch.equal(a, b) for a, b in zip(present.parts, twin.parts))
            for plan in (None, (2, 4, 8, 2, 64), (3, 1, 5, 3, 256), (4, 4, hl, 4, 512)):
                got = cuda_halo._launch_words(w, rule, steps, plan=plan)
                assert all(torch.equal(a, b) for a, b in zip(got.parts, twin.parts)), plan
                assert torch.equal(gather_rows(got), want)
    got = cuda_halo.bit_spatial_multi_step_cuda(shard_rows(words, mesh), 0, 5, ([3], [2, 3]))
    assert torch.equal(gather_rows(got), cuda_bitpack.bit_multi_step_static(words, [3], [2, 3], 5))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("pools,c1,c2,shape", [
    ((4, 2), 4, 1, (16, 256, 256)),   # RND predictor
    ((4, 2), 2, 1, (5, 256, 256)),    # RND target
    ((2, 2), 4, 2, (16, 256, 256)),   # AE encoder
    ((2, 2), 4, 2, (3, 32, 64)),
    ((4, 2), 4, 1, (2, 40, 24)),
])
def test_encoder_kernel_matches_plain(cuda, pools, c1, c2, shape):
    n, h, w = shape
    rng = np.random.RandomState(n * h)
    x = torch.from_numpy(_soup(n, (n, 1, h, w), 0.3)).to(cuda)
    ps = [p.to(cuda) for p in _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])]
    got = cuda_head.encoder_fwd(x, *ps, pools)
    torch.testing.assert_close(got, cuda_head.encoder_fwd_plain(x, *ps, pools),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 256, 256), (3, 32, 64), (2, 44, 20)])
def test_ae_loss_kernel_matches_plain(cuda, shape):
    n, h, w = shape
    rng = np.random.RandomState(n * h)
    x = torch.from_numpy(_soup(n, (n, 1, h, w), 0.3)).to(cuda)
    ps = [p.to(cuda) for p in _params(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,),
                                            (2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)])]
    got = cuda_head.ae_loss_fwd(x, *ps, x)
    assert torch.equal(got, cuda_head.ae_loss_fwd(x, *ps, x))  # fixed-order sums
    torch.testing.assert_close(got, cuda_head.ae_loss_fwd_plain(x, *ps, x),
                               rtol=1e-4, atol=1e-4)


def _assert_leaves_close(got, want, tol=1e-4):
    for a, b in zip(got, want):
        scale = float(b.abs().max()) or 1.0
        torch.testing.assert_close(a / scale, b / scale, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("pools,c1,c2,shape", [
    ((4, 2), 4, 1, (8, 256, 256)),    # RND predictor
    ((2, 2), 4, 2, (8, 256, 256)),    # AE encoder
    ((2, 2), 5, 3, (3, 24, 40)),      # ragged bands, two Philox groups
    ((4, 4), 2, 2, (2, 80, 32)),
])
def test_encoder_dropout_and_backward_kernels_match_plain(cuda, pools, c1, c2, shape,
                                                          drop_p):
    n, h, w = shape
    rng = np.random.RandomState(n * h + c1)
    x = torch.from_numpy(_soup(n, (n, 1, h, w), 0.3)).to(cuda)
    x[0, 0, : h // 2] = 0   # a blank band: whole pool windows tie
    ps = [p.to(cuda) for p in _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])]
    ps[1] = ps[1].abs()
    g = torch.from_numpy(rng.randn(n, c2, h // (pools[0] * pools[1]),
                                   w // (pools[0] * pools[1])).astype(np.float32)).to(cuda)
    seed = 1234567891011 + h
    got = cuda_head.encoder_fwd(x, *ps, pools, drop_p, seed)
    torch.testing.assert_close(got, cuda_head.encoder_fwd_plain(x, *ps, pools, drop_p, seed),
                               rtol=1e-4, atol=1e-4)
    kernel = (cuda_head.ENC3_BWD if cuda_head.encoder_route(h, w, (c1, c2), pools)
              else cuda_head.ENCODER_BWD)   # the widths' route
    before = kernel.launches
    grads = cuda_head.encoder_bwd(x, *ps, g, pools, drop_p, seed)
    assert kernel.launches == before + 1
    again = cuda_head.encoder_bwd(x, *ps, g, pools, drop_p, seed)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # fixed-order sums
    _assert_leaves_close(grads, cuda_head.encoder_bwd_plain(x, *ps, g, pools, drop_p, seed))
    # through autograd: the Function's backward is the kernel
    leaves = [p.clone().requires_grad_(True) for p in ps]
    out = cuda_head.encoder(x, *leaves, pools, drop_p, seed)
    auto = torch.autograd.grad((out * g).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(auto, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("shape,chans", [((8, 256, 256), (4, 2, 1, 1)),
                                         ((3, 24, 40), (4, 2, 1, 1)),
                                         ((2, 16, 48), (3, 2, 2, 2)),
                                         ((1, 72, 16), (5, 2, 1, 1))])
def test_ae_loss_dropout_and_backward_kernels_match_plain(cuda, shape, chans, drop_p):
    n, h, w = shape
    c1, c2, cm, co = chans
    rng = np.random.RandomState(n * h)
    src = torch.from_numpy(_soup(n, (n, 1, h, w), 0.3)).to(cuda)
    src[0, 0, : h // 2] = 0
    obs = torch.from_numpy(_soup(n + 1, (n, co, h, w), 0.3)).to(cuda)
    ps = [p.to(cuda) for p in _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,),
                                            (c2, cm, 4, 4), (cm,), (cm, co, 4, 4), (co,)])]
    ps[1] = ps[1].abs()
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    seed = 987654321012345 + w
    got = cuda_head.ae_loss_fwd(src, *ps, obs, (2, 2), drop_p, seed)
    torch.testing.assert_close(
        got, cuda_head.ae_loss_fwd_plain(src, *ps, obs, (2, 2), drop_p, seed),
        rtol=1e-4, atol=1e-4)
    grads = cuda_head.ae_loss_bwd(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    again = cuda_head.ae_loss_bwd(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    _assert_leaves_close(grads, cuda_head.ae_loss_bwd_plain(src, *ps, obs, gbar, (2, 2),
                                                           drop_p, seed))
    leaves = [p.clone().requires_grad_(True) for p in ps]
    err = cuda_head.ae_loss(src, *leaves, obs, (2, 2), drop_p, seed)
    auto = torch.autograd.grad((err * gbar).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(auto, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("kinds", ["u8", "u32 src", "u32 obs"])
def test_ae2d_kernels_match_plain_and_generic(cuda, monkeypatch, kinds, drop_p):
    """The AE2D kernels at 8 universes of 256² (a quarter blank: exact pool
    ties) against the twins (1e-4) and the generic kernels at the same widths
    (the error within 1e-6 relative, each leaf within 1e-5 of its largest
    entry)."""
    n, h, w, seed = 8, 256, 256, 8888
    rng = np.random.RandomState(n)
    src = torch.from_numpy(_soup(3, (n, 1, h, w), 0.3)).to(cuda)
    src[: n // 4, :, : h // 2] = 0
    obs = torch.from_numpy(_soup(4, (n, 1, h, w), 0.3)).to(cuda)
    src = bitpack.pack_grid(src) if kinds == "u32 src" else src
    obs = bitpack.pack_grid(obs) if kinds == "u32 obs" else obs
    ps = [p.to(cuda) for p in _params(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,),
                                            (2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)])]
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    fwd = lambda: cuda_head.ae_loss_fwd(src, *ps, obs, (2, 2), drop_p, seed)
    bwd = lambda: cuda_head.ae_loss_bwd(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    before = cuda_head.AE2D_FWD.launches, cuda_head.AE2D_BWD.launches
    err, grads = fwd(), _repeatable(bwd)
    # the forward, each backward's saving forward, and the two backwards
    assert (cuda_head.AE2D_FWD.launches, cuda_head.AE2D_BWD.launches) == (before[0] + 3,
                                                                          before[1] + 2)
    torch.testing.assert_close(
        err, cuda_head.ae_loss_fwd_plain(src, *ps, obs, (2, 2), drop_p, seed), rtol=1e-4, atol=0)
    _assert_leaves_close(grads, cuda_head.ae_loss_bwd_plain(src, *ps, obs, gbar, (2, 2),
                                                           drop_p, seed))
    monkeypatch.setattr(cuda_head, "AE2D_KERNELS", False)
    err0, grads0 = fwd(), bwd()
    assert float(((err - err0).abs() / err0.abs()).max()) < 1e-6
    assert max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(grads, grads0)) < 1e-5


@pytest.mark.cuda
def test_ae2d_training_step_draws_each_bit_once(cuda):
    """Through autograd (the training path) the AE2D forward saves the keep
    bits, philox_keep_mask stage by stage, and the backward reads them: one
    forward launch for the step, and the gradients of the backward that draws
    them itself, bit for bit."""
    n, h, w, seed, drop_p = 8, 256, 256, 4321, 0.1
    rng = np.random.RandomState(1)
    src = torch.from_numpy(_soup(5, (n, 1, h, w), 0.3)).to(cuda)
    ps = [p.to(cuda) for p in _params(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,),
                                            (2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)])]
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    _, saved = cuda_head._ae_fwd_launch(src, ps, src, (2, 2), drop_p, seed, True)
    for stage, mask in enumerate(cuda_head.saved_keep_masks(saved)):
        assert torch.equal(mask, cuda_head.philox_keep_mask(seed, stage, tuple(mask.shape),
                                                            drop_p, cuda))
    leaves = [p.clone().requires_grad_(True) for p in ps]
    before = cuda_head.AE2D_FWD.launches
    err = cuda_head.ae_loss(src, *leaves, src, (2, 2), drop_p, seed)
    auto = torch.autograd.grad((err * gbar).sum(), leaves)
    assert cuda_head.AE2D_FWD.launches == before + 1
    drawn = cuda_head.ae_loss_bwd(src, *ps, src, gbar, (2, 2), drop_p, seed)
    assert all(torch.equal(a, b) for a, b in zip(auto, drawn))


@pytest.mark.cuda
@pytest.mark.parametrize("banded", [False, True], ids=["plain", "banded"])
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["u8", "u32"])
def test_dec2_kernels_match_plain_and_generic(cuda, monkeypatch, kind, drop_p, banded):
    """The decoder-loss kernels at the decoder's width on 8 outputs of 256²
    and on 16 of Prediction's bands (80 x 8192, row weights with zero
    margins) against the twins (1e-4) and the generic kernels (the error
    within 1e-6 relative, gx bit for bit, each leaf within 1e-5 of its largest
    entry); the training forward's keep bits against philox_keep_mask on the
    weighted rows."""
    n, h, w, seed = (16, 80, 8192, 606) if banded else (8, 256, 256, 505)
    rng = np.random.RandomState(n)
    x = torch.from_numpy(np.maximum(rng.randn(n, 2, h // 4, w // 4), 0)
                         .astype(np.float32)).to(cuda)
    ps = [p.to(cuda) for p in _params(rng, [(2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)])]
    obs = torch.from_numpy(_soup(n, (n, 1, h, w), 0.3)).to(cuda)
    obs = bitpack.pack_grid(obs) if kind == "u32" else obs
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    em = None
    if banded:
        em = torch.ones((n, h), device=cuda)
        em[:, :8], em[:, h - 8:] = 0.0, 0.0
    fwd = lambda: cuda_stages.decoder_loss_fwd(x, *ps, obs, drop_p, seed, em)
    bwd = lambda: cuda_stages.decoder_loss_bwd(x, *ps, obs, gbar, drop_p, seed, em)
    before = cuda_stages.DEC2_FWD.launches, cuda_stages.DEC2_BWD.launches
    err, grads = fwd(), _repeatable(bwd)
    # the forward, with dropout each backward's saving forward, and the two backwards
    assert (cuda_stages.DEC2_FWD.launches, cuda_stages.DEC2_BWD.launches) == (
        before[0] + 1 + 2 * (drop_p > 0), before[1] + 2)
    torch.testing.assert_close(
        err, cuda_stages.decoder_loss_fwd_plain(x, *ps, obs, drop_p, seed, em), rtol=1e-4, atol=0)
    _assert_leaves_close(grads, cuda_stages.decoder_loss_bwd_plain(x, *ps, obs, gbar, drop_p,
                                                                    seed, em))
    if drop_p > 0:
        _, saved = cuda_stages._decoder_fwd_launch(x, ps, obs, drop_p, seed, em, True)
        rows = torch.ones((n, h), dtype=torch.bool, device=cuda) if em is None else em != 0
        keep1, keep2 = cuda_stages.dec2_keep_masks(saved)
        want2 = cuda_head.philox_keep_mask(seed, cuda_head.STAGE_DEC2, tuple(keep2.shape),
                                           drop_p, cuda)
        assert torch.equal(keep2[:, 0][rows], want2[:, 0][rows])
        mid = rows[:, 1::2] | rows[:, 0::2]   # the middle rows the weighted outputs read
        mid[:, 1:] |= rows[:, 1:-1:2]
        want1 = cuda_head.philox_keep_mask(seed, cuda_head.STAGE_DEC1, tuple(keep1.shape),
                                           drop_p, cuda)
        assert torch.equal(keep1[:, 0][mid], want1[:, 0][mid])
    monkeypatch.setattr(cuda_stages, "DEC2_KERNELS", False)
    err0, grads0 = fwd(), bwd()
    assert float(((err - err0).abs() / err0.abs()).max()) < 1e-6
    assert torch.equal(grads[4], grads0[4])
    assert max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(grads, grads0)) < 1e-5


@pytest.mark.cuda
def test_dec2_training_step_draws_each_bit_once(cuda):
    """Through autograd (the training path) the decoder-loss forward saves the
    keep bits and the backward reads them: one forward launch for the step,
    and the gradients of the backward that draws them itself, bit for bit."""
    n, h, w, seed, drop_p = 8, 256, 256, 4321, 0.1
    rng = np.random.RandomState(2)
    x = torch.from_numpy(np.maximum(rng.randn(n, 2, h // 4, w // 4), 0)
                         .astype(np.float32)).to(cuda)
    ps = [p.to(cuda) for p in _params(rng, [(2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)])]
    obs = torch.from_numpy(_soup(7, (n, 1, h, w), 0.3)).to(cuda)
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, *ps)]
    before = cuda_stages.DEC2_FWD.launches
    err = cuda_stages.decoder_loss(*leaves, obs, drop_p, seed)
    auto = torch.autograd.grad((err * gbar).sum(), leaves)
    assert cuda_stages.DEC2_FWD.launches == before + 1
    *drawn, gx = cuda_stages.decoder_loss_bwd(x, *ps, obs, gbar, drop_p, seed)
    assert all(torch.equal(a, b) for a, b in zip(auto, (gx, *drawn)))


def _repeatable(fn):
    """fn() twice: the same bits, returned once."""
    first, again = fn(), fn()
    assert all(torch.equal(a, b) for a, b in zip(first, again) if a is not None)
    return first


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("geom", [  # pool, c, o, n, h, w, cells, stage
    (2, 1, 4, 8, 256, 256, True, 0),     # AE conv1 on cells
    (2, 4, 2, 8, 128, 128, False, 1),    # AE conv2 (need_dx)
    (4, 1, 4, 8, 256, 256, True, 0),     # RND conv1
    (2, 4, 1, 8, 64, 64, False, 1),      # RND conv2
    (8, 3, 5, 2, 80, 48, False, 0),      # ragged bands, two Philox groups
    (2, 8, 8, 1, 256, 256, False, 1),    # the widest stage: the band shrinks
])
def test_head_kernels_match_plain(cuda, geom, drop_p):
    pool, c, o, n, h, w, cells, stage = geom
    rng = np.random.RandomState(11 * h + c)
    if cells:
        x = torch.from_numpy(_soup(n, (n, c, h, w), 0.3)).to(cuda)
    else:
        x = torch.from_numpy(np.maximum(rng.randn(n, c, h, w), 0).astype(np.float32)).to(cuda)
    x[0, :, : h // 2] = 0   # a blank band: whole pool windows tie
    wt, b = (p.to(cuda) for p in _params(rng, [(o, c, 3, 3), (o,)]))
    b = b.abs()
    g = torch.from_numpy(rng.randn(n, o, h // pool, w // pool).astype(np.float32)).to(cuda)
    seed = 20240301 + h
    before = cuda_stages.HEAD_FWD.launches
    got = cuda_stages.head_fwd(x, wt, b, pool, drop_p, seed, stage)
    assert cuda_stages.HEAD_FWD.launches == before + 1
    torch.testing.assert_close(got, cuda_stages.head_fwd_plain(x, wt, b, pool, drop_p, seed, stage),
                               rtol=1e-4, atol=1e-4)
    for need_dx in (False, True):
        grads = _repeatable(lambda: cuda_stages.head_bwd(x, wt, b, g, pool, drop_p, seed, stage,
                                                         need_dx))
        twin = cuda_stages.head_bwd_plain(x, wt, b, g, pool, drop_p, seed, stage, need_dx)
        assert (grads[2] is None) == (not need_dx)
        _assert_leaves_close([a for a in grads if a is not None],
                             [t for t in twin if t is not None])
    if not cells:   # through autograd: the Function's backward is the kernel
        leaves = [t.clone().requires_grad_(True) for t in (x, wt, b)]
        out = cuda_stages.head(*leaves, pool, drop_p, seed, stage, need_dx=True)
        auto = torch.autograd.grad((out * g).sum(), leaves)
        assert all(torch.equal(a, t) for a, t in zip(auto, (grads[2], grads[0], grads[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("act", ["relu", "sigmoid"])
@pytest.mark.parametrize("geom", [  # n, cin, cout, h, w, stage
    (8, 2, 1, 64, 64, 2),       # AE deconv1
    (8, 1, 1, 128, 128, 3),     # AE deconv2
    (2, 3, 5, 20, 24, 2),       # ragged bands, two Philox groups
])
def test_tail_kernels_match_plain(cuda, geom, act, drop_p):
    n, cin, cout, h, w, stage = geom
    rng = np.random.RandomState(13 * h + cin)
    x = torch.from_numpy(np.maximum(rng.randn(n, cin, h, w), 0).astype(np.float32)).to(cuda)
    wt, b = (p.to(cuda) for p in _params(rng, [(cin, cout, 4, 4), (cout,)]))
    g = torch.from_numpy(rng.randn(n, cout, 2 * h, 2 * w).astype(np.float32)).to(cuda)
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    seed = 77001 + w
    args = (act, drop_p, seed, stage)
    torch.testing.assert_close(cuda_stages.tail_fwd(x, wt, b, *args),
                               cuda_stages.tail_fwd_plain(x, wt, b, *args), rtol=1e-4, atol=1e-4)
    grads = _repeatable(lambda: cuda_stages.tail_bwd(x, wt, b, g, *args))
    _assert_leaves_close(grads, cuda_stages.tail_bwd_plain(x, wt, b, g, *args))
    leaves = [t.clone().requires_grad_(True) for t in (x, wt, b)]
    auto = torch.autograd.grad((cuda_stages.tail(*leaves, *args) * g).sum(), leaves)
    assert all(torch.equal(a, t) for a, t in zip(auto, (grads[2], grads[0], grads[1])))
    for obs in (torch.from_numpy(_soup(n, (n, cout, 2 * h, 2 * w), 0.3)).to(cuda),
                torch.from_numpy(rng.rand(n, cout, 2 * h, 2 * w).astype(np.float32)).to(cuda)):
        err = cuda_stages.loss_tail_fwd(x, wt, b, obs, *args)
        assert torch.equal(err, cuda_stages.loss_tail_fwd(x, wt, b, obs, *args))
        torch.testing.assert_close(err, cuda_stages.loss_tail_fwd_plain(x, wt, b, obs, *args),
                                   rtol=1e-4, atol=1e-4)
        grads = _repeatable(lambda: cuda_stages.loss_tail_bwd(x, wt, b, obs, gbar, *args))
        _assert_leaves_close(grads, cuda_stages.loss_tail_bwd_plain(x, wt, b, obs, gbar, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("geom", [  # n, cin, h, w, act, stage
    (8, 2, 64, 64, "relu", 2),           # AE deconv1
    (8, 1, 128, 128, "sigmoid", 3),      # AE deconv2
    (2, 2, 37, 90, "sigmoid", 3),        # ragged bands and tiles
])
def test_tail2_kernels_match_generic(cuda, geom, drop_p):
    """The decoder-stage kernels at the package's widths against the generic
    kernel forced (TAIL2_KERNELS = False): the forward and gx bit for bit, dW
    and db within 1e-5 of each leaf; the training forward's keep bits against
    the twin's mask and the backward from them the same bits as drawing them."""
    n, cin, h, w, act, stage = geom
    rng = np.random.RandomState(11 * h + cin)
    x = torch.from_numpy(np.maximum(rng.randn(n, cin, h, w), 0).astype(np.float32)).to(cuda)
    wt, b = (p.to(cuda) for p in _params(rng, [(cin, 1, 4, 4), (1,)]))
    g = torch.from_numpy(rng.randn(n, 1, 2 * h, 2 * w).astype(np.float32)).to(cuda)
    args = (act, drop_p, 4321, stage)
    assert cuda_stages.tail_route(cin, 1, w)
    counts = cuda_stages.TAIL2_FWD.launches, cuda_stages.TAIL2_BWD.launches
    y = cuda_stages.tail_fwd(x, wt, b, *args)
    dw, db, gx = cuda_stages.tail_bwd(x, wt, b, g, *args)
    assert (cuda_stages.TAIL2_FWD.launches, cuda_stages.TAIL2_BWD.launches) == (
        counts[0] + 1, counts[1] + 1)
    try:
        cuda_stages.TAIL2_KERNELS = False
        y0 = cuda_stages.tail_fwd(x, wt, b, *args)
        dw0, db0, gx0 = cuda_stages.tail_bwd(x, wt, b, g, *args)
    finally:
        cuda_stages.TAIL2_KERNELS = True
    assert torch.equal(y, y0) and torch.equal(gx, gx0)
    _assert_leaves_close((dw, db), (dw0, db0), tol=1e-5)
    y_s, keep = cuda_stages._tail_fwd_launch(x, wt, b, *args, True)
    assert torch.equal(y_s, y) and (keep is None) == (drop_p == 0)
    if drop_p > 0:
        want = cuda_head.philox_keep_mask(4321, stage, tuple(y.shape), drop_p, cuda)
        assert torch.equal(cuda_stages.tail2_keep_mask(keep), want)
        fed = cuda_stages._tail2_bwd_kernel(x, wt, b, g, *args, keep=keep)
        assert all(torch.equal(a, t) for a, t in zip(fed, (dw, db, gx)))


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("shape,chans", [((8, 256, 256), (2, 1, 1)),
                                         ((3, 24, 40), (2, 1, 1)),
                                         ((1, 72, 16), (3, 2, 5))])
def test_decoder_loss_kernels_match_plain(cuda, shape, chans, drop_p):
    n, h, w = shape
    c2, cm, co = chans
    rng = np.random.RandomState(h + w)
    x = torch.from_numpy(np.maximum(rng.randn(n, c2, h // 4, w // 4), 0)
                         .astype(np.float32)).to(cuda)
    ps = [p.to(cuda) for p in _params(rng, [(c2, cm, 4, 4), (cm,), (cm, co, 4, 4), (co,)])]
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    seed = 555000111 + h
    for obs in (torch.from_numpy(_soup(n, (n, co, h, w), 0.3)).to(cuda),
                torch.from_numpy(rng.rand(n, co, h, w).astype(np.float32)).to(cuda)):
        got = cuda_stages.decoder_loss_fwd(x, *ps, obs, drop_p, seed)
        assert torch.equal(got, cuda_stages.decoder_loss_fwd(x, *ps, obs, drop_p, seed))
        torch.testing.assert_close(
            got, cuda_stages.decoder_loss_fwd_plain(x, *ps, obs, drop_p, seed),
            rtol=1e-4, atol=1e-4)
        grads = _repeatable(lambda: cuda_stages.decoder_loss_bwd(x, *ps, obs, gbar, drop_p, seed))
        _assert_leaves_close(grads, cuda_stages.decoder_loss_bwd_plain(x, *ps, obs, gbar,
                                                                        drop_p, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_cells", [None, 48])
@pytest.mark.parametrize("pools,c1,c2,w", [((4, 2), 4, 1, 8192), ((2, 2), 4, 2, 8192),
                                           ((4, 2), 4, 1, 256), ((2, 2), 4, 2, 256)])
def test_column_tiled_and_masked_encoder_kernels_match_plain(cuda, monkeypatch, pools, c1,
                                                             c2, w, tile_cells):
    """Widths whose one band of the whole width does not fit shared memory
    (8192) and tiles forced at 256 (48 cells, edges inside packed words), with
    and without a stage-1 row mask: kernel vs twin, packed words vs cells,
    a tiled forward vs the one-tile forward bit for bit."""
    monkeypatch.setattr(cuda_head, "TILE_CELLS", tile_cells)
    p1, p2 = pools
    n, h = 2, 32
    rng = np.random.RandomState(w + c2)
    x = torch.from_numpy(_soup(n, (n, 1, h, w), 0.3)).to(cuda)
    words = bitpack.pack_grid(x)
    ps = [p.to(cuda) for p in _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])]
    ps[1] = ps[1].abs()
    g = torch.from_numpy(rng.randn(n, c2, h // (p1 * p2), w // (p1 * p2))
                         .astype(np.float32)).to(cuda)
    mask = torch.from_numpy((rng.rand(n, h // p1) < 0.7).astype(np.float32)).to(cuda)
    for m in (None, mask):
        got = cuda_head.encoder_fwd(x, *ps, pools, 0.1, 99, m)
        torch.testing.assert_close(got, cuda_head.encoder_fwd_plain(x, *ps, pools, 0.1, 99, m),
                                   rtol=1e-4, atol=1e-4)
        assert torch.equal(cuda_head.encoder_fwd(words, *ps, pools, 0.1, 99, m), got)
        grads = _repeatable(lambda: cuda_head.encoder_bwd(x, *ps, g, pools, 0.1, 99, m))
        _assert_leaves_close(grads, cuda_head.encoder_bwd_plain(x, *ps, g, pools, 0.1, 99, m))
        assert all(torch.equal(a, b) for a, b in
                   zip(cuda_head.encoder_bwd(words, *ps, g, pools, 0.1, 99, m), grads))
        monkeypatch.setattr(cuda_head, "TILE_CELLS", None)
        assert torch.equal(cuda_head.encoder_fwd(x, *ps, pools, 0.1, 99, m), got)
        monkeypatch.setattr(cuda_head, "TILE_CELLS", tile_cells)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_cells", [None, 48])
@pytest.mark.parametrize("w", [8192, 256])
def test_column_tiled_and_row_weighted_decoder_loss_kernels_match_plain(cuda, monkeypatch, w,
                                                                        tile_cells):
    """The decoder loss at an output width whose backward's band of the
    whole width does not fit (8192) and in tiles forced at 256, with and
    without error row weights; weights of ones are the unweighted kernel."""
    monkeypatch.setattr(cuda_head, "TILE_CELLS", tile_cells)
    n, h = 2, 32
    rng = np.random.RandomState(w)
    x = torch.from_numpy(np.maximum(rng.randn(n, 2, h // 4, w // 4), 0)
                         .astype(np.float32)).to(cuda)
    ps = [p.to(cuda) for p in _params(rng, [(2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)])]
    obs = torch.from_numpy(_soup(n, (n, 1, h, w), 0.3)).to(cuda)
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    em = torch.from_numpy(rng.rand(n, h).astype(np.float32)).to(cuda)
    ones = torch.ones_like(em)
    for e in (None, em):
        got = cuda_stages.decoder_loss_fwd(x, *ps, obs, 0.1, 77, e)
        torch.testing.assert_close(
            got, cuda_stages.decoder_loss_fwd_plain(x, *ps, obs, 0.1, 77, e), rtol=1e-4, atol=1e-4)
        grads = _repeatable(lambda: cuda_stages.decoder_loss_bwd(x, *ps, obs, gbar, 0.1, 77, e))
        _assert_leaves_close(grads, cuda_stages.decoder_loss_bwd_plain(x, *ps, obs, gbar, 0.1,
                                                                        77, e))
    assert torch.equal(cuda_stages.decoder_loss_fwd(x, *ps, obs, 0.1, 77, ones),
                       cuda_stages.decoder_loss_fwd(x, *ps, obs, 0.1, 77))
    assert all(torch.equal(a, b) for a, b in
               zip(cuda_stages.decoder_loss_bwd(x, *ps, obs, gbar, 0.1, 77, ones),
                   cuda_stages.decoder_loss_bwd(x, *ps, obs, gbar, 0.1, 77)))


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
def test_ae_routes_agree_on_the_card(cuda, drop_p):
    """One, two and four kernels, src != obs, through autograd: the
    embedding's cotangent flows from DecoderLossFn into EncoderFn."""
    from carle_tpu_torch import nets

    n, h, w, seed = 4, 64, 96, 31337
    rng = np.random.RandomState(5)
    src = torch.from_numpy(_soup(1, (n, 1, h, w), 0.3)).to(cuda)
    obs = torch.from_numpy(_soup(2, (n, 1, h, w), 0.3)).to(cuda)
    names = ("conv1", "conv2", "deconv1", "deconv2")
    shapes = [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)]
    flat = [p.to(cuda) for p in _params(rng, shapes)]
    results = []
    for route in ("one", "two", "four"):
        leaves = [p.clone().requires_grad_(True) for p in flat]
        params = {k: {"w": leaves[2 * i], "b": leaves[2 * i + 1]} for i, k in enumerate(names)}
        kw = dict(drop_p=drop_p, train=True, seed=seed)
        if route == "one":
            err = nets.conv_ae_loss(src, *params.values(), obs, pools=(2, 2), **kw)
        elif route == "two":
            emb = nets.conv_encoder(src, params["conv1"], params["conv2"], pools=(2, 2), **kw)
            err = nets.conv_decoder_loss(emb, params["deconv1"], params["deconv2"], obs, **kw)
        else:
            err = nets.ae_loss_by_stages(params, src, obs, **kw)
        results.append((err.detach(), torch.autograd.grad(err.mean(), leaves)))
    for err, grads in results[1:]:
        torch.testing.assert_close(err, results[0][0], rtol=1e-4, atol=0)
        _assert_leaves_close(grads, results[0][1])
    with torch.no_grad():   # the same error, src != obs, against the twin
        want = cuda_head.ae_loss_fwd_plain(src, *flat, obs, (2, 2), drop_p, seed)
    torch.testing.assert_close(results[0][0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    cfg = EnvConfig(32, 32, 8, 8, 2)
    grid = torch.zeros(cfg.grid_shape, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        cuda_ca.ca_step(grid, torch.zeros(cfg.action_shape, device=cuda),
                        rules.LIFE, cfg)
    with pytest.raises(ValueError, match="uint8"):  # float cells: not the kernel's
        cuda_head.encoder_fwd(grid[:, None].float(), *[p.to(cuda) for p in _params(
            np.random.RandomState(0), [(4, 1, 3, 3), (4,), (1, 4, 3, 3), (1,)])], (4, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w", [(8, 256, 256), (2, 512, 512), (1, 1024, 1024), (3, 64, 96)])
def test_engine_kernels_match_plain(cuda, n, h, w):
    """Rows 10, 11a, 11b and 12: resident universes, the per-generation
    fallback at 1024 x 1024, scalar and per-universe rules, bit for bit; one
    checksum across the engines."""
    rng = np.random.RandomState(n + h)
    grid = torch.from_numpy(_soup(n + h, (n, h, w), 0.5)).to(cuda)
    rm, cm = bitpack.pack_grid(grid), bitpack.pack_grid_cm(grid)
    vec = torch.from_numpy(rng.randint(0, 1 << 18, size=n).astype(np.int32)).to(cuda)
    for birth, survive in (([3], [2, 3]), ([3, 6, 8], [2, 4, 5])):
        for fn, plain, words in (
                (cuda_bitpack.bit_multi_step_static, cuda_bitpack.bit_multi_step_static_plain, rm),
                (cuda_bitpack.bit_multi_step_static_cm,
                 cuda_bitpack.bit_multi_step_static_cm_plain, cm)):
            got = fn(words, birth, survive, 5)
            assert torch.equal(got.to(torch.int64),
                               plain(words, birth, survive, 5).to(torch.int64))
    for rule in (torch.tensor(rules.DAY_AND_NIGHT, dtype=torch.int32, device=cuda), vec):
        got = cuda_bitpack.bit_multi_step_cm(cm, rule, 5)
        want = cuda_bitpack.bit_multi_step_cm_plain(cm, rule, 5)
        assert torch.equal(got.to(torch.int64), want.to(torch.int64))
        assert torch.equal(cuda_ca.ca_multi_step(grid, rule, 5),
                           cuda_ca.ca_multi_step_plain(grid, rule, 5))
    life = torch.tensor(rules.LIFE, dtype=torch.int32, device=cuda)
    sums = {int(bitpack.unpack_grid(cuda_bitpack.bit_multi_step(rm, life, 7), w).sum()),
            int(bitpack.unpack_grid(cuda_bitpack.bit_multi_step_static(rm, [3], [2, 3], 7),
                                    w).sum()),
            int(bitpack.unpack_grid_cm(cuda_bitpack.bit_multi_step_static_cm(cm, [3], [2, 3], 7),
                                       h).sum()),
            int(bitpack.unpack_grid_cm(cuda_bitpack.bit_multi_step_cm(cm, life, 7), h).sum()),
            int(cuda_ca.ca_multi_step(grid, life, 7).sum(dtype=torch.int64))}
    assert len(sums) == 1


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b) if x is not None)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
def test_packed_cell_loader_is_bit_equal_to_uint8(cuda, drop_p):
    """Each kernel that reads cells, fed the packed words, gives the bits it
    gives fed the same cells as uint8: forward and backward."""
    n, h, w, seed = 8, 256, 256, 99
    rng = np.random.RandomState(5)
    u8 = torch.from_numpy(_soup(5, (n, 1, h, w))).to(cuda)
    o8 = torch.from_numpy(_soup(6, (n, 1, h, w))).to(cuda)
    u32, o32 = bitpack.pack_grid(u8), bitpack.pack_grid(o8)
    ps = [p.to(cuda) for p in _params(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4),
                                            (1,), (1, 1, 4, 4), (1,)])]
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(n, 2, h // 4, w // 4).astype(np.float32)).to(cuda)
    ch, cs = cuda_head, cuda_stages
    assert _same(ch.encoder_fwd(u32, *ps[:4], (2, 2), drop_p, seed),
                 ch.encoder_fwd(u8, *ps[:4], (2, 2), drop_p, seed))
    assert _same(ch.encoder_bwd(u32, *ps[:4], g, (2, 2), drop_p, seed),
                 ch.encoder_bwd(u8, *ps[:4], g, (2, 2), drop_p, seed))
    want = ch.ae_loss_fwd(u8, *ps, o8, (2, 2), drop_p, seed)
    want_g = ch.ae_loss_bwd(u8, *ps, o8, gbar, (2, 2), drop_p, seed)
    for src, obs in ((u32, o8), (u8, o32), (u32, o32)):
        assert _same(ch.ae_loss_fwd(src, *ps, obs, (2, 2), drop_p, seed), want)
        assert _same(ch.ae_loss_bwd(src, *ps, obs, gbar, (2, 2), drop_p, seed), want_g)
    emb = ch.encoder_fwd(u8, *ps[:4], (2, 2), drop_p, seed)
    assert _same(cs.decoder_loss_fwd(emb, *ps[4:], o32, drop_p, seed),
                 cs.decoder_loss_fwd(emb, *ps[4:], o8, drop_p, seed))
    assert _same(cs.decoder_loss_bwd(emb, *ps[4:], o32, gbar, drop_p, seed),
                 cs.decoder_loss_bwd(emb, *ps[4:], o8, gbar, drop_p, seed))
    gh = torch.from_numpy(rng.randn(n, 4, h // 2, w // 2).astype(np.float32)).to(cuda)
    assert _same(cs.head_fwd(u32, ps[0], ps[1], 2, drop_p, seed),
                 cs.head_fwd(u8, ps[0], ps[1], 2, drop_p, seed))
    assert _same(cs.head_bwd(u32, ps[0], ps[1], gh, 2, drop_p, seed),
                 cs.head_bwd(u8, ps[0], ps[1], gh, 2, drop_p, seed))
    mid = torch.relu(torch.from_numpy(rng.randn(n, 1, h // 2, w // 2).astype(np.float32))).to(cuda)
    assert _same(cs.loss_tail_fwd(mid, ps[6], ps[7], o32, "sigmoid", drop_p, seed),
                 cs.loss_tail_fwd(mid, ps[6], ps[7], o8, "sigmoid", drop_p, seed))
    assert _same(cs.loss_tail_bwd(mid, ps[6], ps[7], o32, gbar, "sigmoid", drop_p, seed),
                 cs.loss_tail_bwd(mid, ps[6], ps[7], o8, gbar, "sigmoid", drop_p, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_halo_kernels_match_plain(cuda, slots):
    """Rows 13-15: the halo kernels on slots of one card against their twins
    and the single-device engines, bit for bit; a ragged case of 3 universes
    with a per-universe rule."""
    from carle_tpu_torch.parallel import cuda_halo
    from carle_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_rows

    mesh = make_mesh([cuda] * slots, "space")
    grid = torch.from_numpy(_soup(slots, (3, 4 * 64, 128))).to(cuda)
    words = bitpack.pack_grid(grid)
    vec = torch.tensor([rules.LIFE, rules.MORLEY, rules.DAY_AND_NIGHT], dtype=torch.int32,
                       device=cuda)
    for rule in (rules.LIFE, vec):
        for steps in (1, 6):
            x = shard_rows(grid, mesh)
            got = cuda_halo.spatial_multi_step_cuda(x, rule, steps)
            twin = cuda_halo.spatial_multi_step_plain(x, rule, steps)
            assert all(torch.equal(a, b) for a, b in zip(got.parts, twin.parts))
            assert torch.equal(gather_rows(got), cuda_ca.ca_multi_step(grid, rule, steps))
            w = shard_rows(words, mesh)
            got = cuda_halo.bit_spatial_multi_step_cuda(w, rule, steps)
            assert torch.equal(gather_rows(got), cuda_bitpack.bit_multi_step(words, rule, steps))
    one = cuda_halo.spatial_ca_step_cuda(shard_rows(grid, mesh), vec)
    assert torch.equal(gather_rows(one), cuda_ca.ca_multi_step(grid, vec, 1))
    got = cuda_halo.bit_spatial_multi_step_cuda(shard_rows(words, mesh), 0, 5, ([3], [2, 3]))
    assert torch.equal(gather_rows(got), cuda_bitpack.bit_multi_step_static(words, [3], [2, 3], 5))


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
def test_head_kernels_in_column_tiles(cuda, monkeypatch, drop_p):
    """The head at width 8192 (1 -> 4 channels, pool 2: past one band of the
    whole width) against its twin, and tiles forced at 256 against one tile."""
    rng = np.random.RandomState(5)
    w, b = (t.to(cuda) for t in _params(rng, [(4, 1, 3, 3), (4,)]))
    x = torch.from_numpy(_soup(6, (1, 1, 16, 8192))).to(cuda)
    g = torch.randn((1, 4, 8, 4096), device=cuda)
    torch.testing.assert_close(cuda_stages.head_fwd(x, w, b, 2, drop_p, 9),
                               cuda_stages.head_fwd_plain(x, w, b, 2, drop_p, 9),
                               rtol=1e-4, atol=1e-4)
    grads = cuda_stages.head_bwd(x, w, b, g, 2, drop_p, 9, need_dx=True)
    twin = cuda_stages.head_bwd_plain(x, w, b, g, 2, drop_p, 9, need_dx=True)
    for a, t in zip(grads, twin):
        assert float((a - t).abs().max() / t.abs().max()) < 1e-4
    x = torch.from_numpy(_soup(7, (4, 1, 256, 256))).to(cuda)
    g = torch.randn((4, 4, 128, 128), device=cuda)
    one = cuda_stages.head_fwd(x, w, b, 2, drop_p, 9), cuda_stages.head_bwd(x, w, b, g, 2,
                                                                            drop_p, 9)
    monkeypatch.setattr(cuda_head, "TILE_CELLS", 48)
    assert torch.equal(cuda_stages.head_fwd(x, w, b, 2, drop_p, 9), one[0])
    tiled = cuda_stages.head_bwd(x, w, b, g, 2, drop_p, 9)
    for a, t in zip(tiled[:2], one[1][:2]):
        assert float((a - t).abs().max() / t.abs().max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_u8_halo_bits_match_present_and_plain(cuda, slots):
    """Row 13's redesigned launcher (spatial_multi_step_bits) against the
    present kernel forced (HALO_U8_BITS = False), the twin and the uint8
    engine, bit for bit: K = 2, 6 and 9 (two chunks), scalar and
    per-universe rules, u8_halo_plan's plan and forced ones (T = 2 on bands
    of 5 rows, V = 1 on one warp), one launch a chunk a device."""
    from carle_tpu_torch.parallel import cuda_halo
    from carle_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_rows

    mesh = make_mesh([cuda] * slots, "space")
    grid = torch.from_numpy(_soup(slots + 20, (3, 4 * 64, 128))).to(cuda)
    vec = torch.tensor([rules.LIFE, rules.MORLEY, rules.DAY_AND_NIGHT], dtype=torch.int32,
                       device=cuda)
    for rule in (rules.LIFE, vec):
        for steps in (2, 6, 9):
            x = shard_rows(grid, mesh)
            want = cuda_ca.ca_multi_step(grid, rule, steps)
            twin = cuda_halo.spatial_multi_step_plain(x, rule, steps)
            cuda_halo.HALO_U8_BITS = False
            try:
                present = cuda_halo.spatial_multi_step_cuda(x, rule, steps)
            finally:
                cuda_halo.HALO_U8_BITS = True
            assert all(torch.equal(a, b) for a, b in zip(present.parts, twin.parts))
            before = cuda_halo.KERNEL_U8_BITS.launches
            got = cuda_halo.spatial_multi_step_cuda(x, rule, steps)
            assert cuda_halo.KERNEL_U8_BITS.launches == before + -(-steps // 8)
            assert torch.equal(gather_rows(got), want)
            for plan in ((2, 4, 5, 2, 64), (8, 1, 64, 3, 32)):
                got = cuda_halo._launch_u8_bits(x, rule, steps, plan)
                assert all(torch.equal(a, b) for a, b in zip(got.parts, twin.parts)), plan
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("geom", [  # n, cin, h, w, act, stage
    (8, 2, 64, 64, "relu", 2),           # AE deconv1
    (8, 1, 128, 128, "sigmoid", 3),      # AE deconv2
    (2, 2, 37, 90, "sigmoid", 3),        # ragged bands and tiles
])
def test_loss_tail2_matches_generic(cuda, geom, drop_p):
    """The loss tail's forward at the package's widths against the generic
    kernel forced (LOSS_TAIL2_KERNELS = False) within rtol 1e-5 (the same
    terms, added in another order) and bit for bit from run to run, over
    uint8, packed and float32 obs; one launch a call."""
    n, cin, h, w, act, stage = geom
    rng = np.random.RandomState(5 * h + cin)
    x = torch.from_numpy(np.maximum(rng.randn(n, cin, h, w), 0).astype(np.float32)).to(cuda)
    wt, b = (p.to(cuda) for p in _params(rng, [(cin, 1, 4, 4), (1,)]))
    cells = torch.from_numpy(_soup(n + h, (n, 1, 2 * h, 2 * w), 0.3)).to(cuda)
    obs_kinds = [cells, cells.float() * 0.75]
    if (2 * w) % 32 == 0:
        obs_kinds.append(bitpack.pack_grid(cells))
    args = (act, drop_p, 4321, stage)
    assert cuda_stages.loss_tail_route(cin, 1, w)
    for obs in obs_kinds:
        before = cuda_stages.LOSS_TAIL2_FWD.launches
        err = cuda_stages.loss_tail_fwd(x, wt, b, obs, *args)
        assert cuda_stages.LOSS_TAIL2_FWD.launches == before + 1
        assert torch.equal(err, cuda_stages.loss_tail_fwd(x, wt, b, obs, *args))
        try:
            cuda_stages.LOSS_TAIL2_KERNELS = False
            generic = cuda_stages.loss_tail_fwd(x, wt, b, obs, *args)
        finally:
            cuda_stages.LOSS_TAIL2_KERNELS = True
        torch.testing.assert_close(err, generic, rtol=1e-5, atol=0)
        torch.testing.assert_close(err, cuda_stages.loss_tail_fwd_plain(x, wt, b, obs, *args),
                                   rtol=1e-4, atol=1e-4)


def test_launch_table_covers_every_source():
    assert {k.source for k in cuda_build.KERNELS.values()} == set(cuda_build.SOURCES)
    for name in cuda_build.SOURCES:
        assert (cuda_build.CSRC / f"{name}.cu").exists()
        assert cuda_build.library_path(name).name.startswith(name + "-")
    fixed = cuda_build.library_path("bit_multi_step", ("STATIC_RULE=0x01808",))
    assert fixed.name.startswith("bit_multi_step-static_rule0x01808-")
    assert fixed != cuda_build.library_path("bit_multi_step")


def test_counts_reset():
    cuda_build.KERNELS["ca_step"].launches = 3
    cuda_build.reset_launch_counts()
    assert set(cuda_build.launch_counts().values()) == {0}
