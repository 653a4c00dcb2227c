"""PERF.md row 9b redesigned for the H100: the head's backward at the
package's three stage widths (C, O, pool) = (1, 4, 2), (1, 4, 4) and
(4, 2, 2) (csrc/head2_bwd.cu, which ``cuda_stages.head_route`` sends there),
its body built for the host (the ``emulated`` fixture of
tests/test_torch_emulated.py: one thread a block, so every block walks its
tiles alone and the last block adds the partial rows).

Held over uint8, packed and float32 cells, dropout 0 and 0.1, universes half
blank (whole pool windows tie at the bias), the planner's plan and forced
plans (blocks that walk several tiles, ragged bands and column tiles):

- dW, db and gx within 1e-5 of each leaf's largest entry against the
  generic kernel's emulated build (``cuda_stages.HEAD2_KERNELS`` off) and
  against the plain twin: every pre-activation is summed in the generic
  order, but the weight-gradient sums run in another order, and the twin's
  convolutions in yet another;
- gx bit for bit against the generic kernel (its sum's order);
- without dropout, within 1e-4 against ``jax.vjp`` of
  ``make_fused_head(pool, 0.0, False, interpret=True, need_dx=...)``;
- two calls bit for bit;
- ``head_route`` picks the kernel at the three widths and the generic
  kernel elsewhere, and the launch counts follow it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carle_tpu.ops.pallas_head import make_fused_head

from carle_tpu_torch.ops import bitpack, cuda_head, cuda_stages
from test_torch_emulated import emulated  # noqa: F401  (the fixture)

WIDTHS = {  # label: (c, o, pool, cell kinds, need_dx options, stage)
    "AE conv1": (1, 4, 2, ("u8", "u32", "f32"), (False,), 0),
    "RND conv1": (1, 4, 4, ("u8", "u32"), (False,), 0),
    "AE conv2": (4, 2, 2, ("f32",), (True, False), 1),
}
CASES = [(label, kind, dx) for label, (c, o, p, kinds, dxs, s) in WIDTHS.items()
         for kind in kinds for dx in dxs]


def _inputs(label, kind, n=2, h=32, w=64, seed=0):
    c, o, pool, _, _, _ = WIDTHS[label]
    rng = np.random.RandomState(seed + 17 * c + pool)
    if c == 1:
        cells = (rng.rand(n, 1, h, w) < 0.35).astype(np.uint8)
        cells[0, :, : h // 2] = 0   # a blank band: whole pool windows tie at the bias
        x = torch.from_numpy(cells)
        x = (bitpack.pack_grid(x[:, 0])[:, None] if kind == "u32"
             else x.float() if kind == "f32" else x)
    else:   # relu output of the first stage: zeros tie constantly
        x = np.maximum(rng.randn(n, c, h, w), 0).astype(np.float32)
        x[0, :, : h // 2] = 0
        x = torch.from_numpy(x)
    wt = torch.from_numpy((rng.randn(o, c, 3, 3) * 0.3).astype(np.float32))
    b = torch.from_numpy(np.abs(rng.randn(o) * 0.3).astype(np.float32))
    g = torch.from_numpy(rng.randn(n, o, h // pool, w // pool).astype(np.float32))
    return x, wt, b, g, pool


def pool_of(label):
    return WIDTHS[label][2]


def _worst(got, want):
    return max(float((a - t).abs().max() / t.abs().max().clamp_min(1e-12))
               for a, t in zip(got, want) if a is not None)


def _generic(fn):
    cuda_stages.HEAD2_KERNELS = False
    try:
        return fn()
    finally:
        cuda_stages.HEAD2_KERNELS = True


def _plans(n, pool, h, w):
    """The planner's plan and forced ones: one block walking every tile,
    ragged bands of 3 rows and column tiles of 5, more blocks than tiles."""
    ho, wo = h // pool, w // pool
    tiles = n * -(-ho // 3) * -(-wo // 5)
    return [None, (1, wo, 1), (3, 5, 2), (3, 5, tiles), (ho, wo, n + 1)]


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("label,kind,need_dx", CASES)
def test_head2_bwd_emulated(emulated, label, kind, need_dx, drop_p):
    x, wt, b, g, pool = _inputs(label, kind)
    c, o, _, _, _, stage = WIDTHS[label]
    n, _, h, w = cuda_head.cell_shape(x)
    seed = 20240301 + h
    assert cuda_stages.head_route(c, o, pool, w, cuda_head.cell_kind(x), need_dx)
    args = (x, wt, b, g, pool, drop_p, seed, stage, need_dx)
    before = cuda_stages.HEAD2_BWD.launches, cuda_stages.HEAD_BWD.launches
    got = cuda_stages._head_bwd_kernel(*args)   # the route
    assert (cuda_stages.HEAD2_BWD.launches, cuda_stages.HEAD_BWD.launches) == (before[0] + 1,
                                                                               before[1])
    assert (got[2] is None) == (not need_dx)
    generic = _generic(lambda: cuda_stages._head_bwd_kernel(*args))
    assert cuda_stages.HEAD_BWD.launches == before[1] + 1
    twin = cuda_stages.head_bwd_plain(*args)
    assert float(got[0].abs().max()) > 0
    assert _worst(got, generic) < 1e-5 and _worst(got, twin) < 1e-5
    if need_dx:
        assert torch.equal(got[2], generic[2])
    again = cuda_stages._head_bwd_kernel(*args)
    assert all(torch.equal(a, t) for a, t in zip(got, again) if a is not None)
    for plan in _plans(n, pool, h, w):
        forced = cuda_stages._head2_bwd_kernel(*args, plan=plan)
        assert _worst(forced, generic) < 1e-5, plan
        if need_dx:
            assert torch.equal(forced[2], generic[2]), plan


@pytest.mark.parametrize("label,kind,need_dx", [c for c in CASES if c[1] != "u32"])
def test_head2_bwd_narrow_rows_emulated(emulated, label, kind, need_dx):
    """Rows that are not whole words of 32 cells (uint8 rows of 4-byte words
    staged as bits, the last word partly past the row) and heights that leave
    a ragged band, by the planner's plan and one block walking every tile."""
    x, wt, b, g, pool = _inputs(label, kind, n=2, h=24, w=44 if pool_of(label) == 4 else 36,
                                seed=9)
    c, o, _, _, _, stage = WIDTHS[label]
    n, _, h, w = cuda_head.cell_shape(x)
    assert cuda_stages.head_route(c, o, pool, w, cuda_head.cell_kind(x), need_dx)
    args = (x, wt, b, g, pool, 0.1, 77, stage, need_dx)
    generic = _generic(lambda: cuda_stages._head_bwd_kernel(*args))
    twin = cuda_stages.head_bwd_plain(*args)
    for plan in (None, (5, 3, 1)):
        got = cuda_stages._head2_bwd_kernel(*args, plan=plan)
        assert _worst(got, generic) < 1e-5 and _worst(got, twin) < 1e-5, plan
        if need_dx:
            assert torch.equal(got[2], generic[2])


@pytest.mark.parametrize("label,kind,need_dx", [c for c in CASES if c[1] != "u32"])
def test_head2_bwd_matches_jax_interpret(emulated, label, kind, need_dx):
    """Without dropout, against jax.vjp of make_fused_head in interpret mode
    (cells cast to float32 outside, as the JAX callers do)."""
    x, wt, b, g, pool = _inputs(label, kind, n=2, h=16, w=32, seed=5)
    c, o, _, _, _, stage = WIDTHS[label]
    head = make_fused_head(pool, 0.0, False, interpret=True, need_dx=need_dx)
    xf = jnp.asarray(x.float().numpy())
    _, vjp = jax.vjp(lambda x_, w_, b_: head(x_, w_, b_, jnp.int32(0)), xf,
                     jnp.asarray(wt.numpy()), jnp.asarray(b.numpy()))
    jgx, jdw, jdb = vjp(jnp.asarray(g.numpy()))
    got = cuda_stages._head_bwd_kernel(x, wt, b, g, pool, 0.0, 0, stage, need_dx)
    want = [torch.from_numpy(np.array(t)) for t in (jdw, jdb)]
    if need_dx:
        want.append(torch.from_numpy(np.array(jgx)))
    assert _worst([t for t in got if t is not None], want) < 1e-4


def test_head_route_picks_the_specialised_kernel_at_the_three_widths():
    route = cuda_stages.head_route
    f32, u8, u32 = 0, 1, 2
    for kind in (u8, u32, f32):
        assert route(1, 4, 2, 256, kind, False)
    assert route(1, 4, 4, 256, u8, False) and route(1, 4, 4, 256, u32, False)
    assert route(4, 2, 2, 128, f32, True) and route(4, 2, 2, 128, f32, False)
    # elsewhere the generic kernel: other widths, pools, the input cotangent of
    # a first stage, cells at the second, uint8 rows not whole 4-byte words,
    # floats at pool 4
    for args in ((1, 4, 8, 256, u8, False), (4, 1, 2, 64, f32, False),
                 (2, 1, 4, 64, f32, False), (3, 5, 2, 16, f32, True),
                 (1, 4, 2, 256, u8, True), (1, 4, 2, 8192, u8, True), (4, 2, 2, 128, u8, False),
                 (1, 4, 2, 30, u8, False), (1, 4, 4, 256, f32, False)):
        assert not route(*args), args
    cuda_stages.HEAD2_KERNELS = False
    try:
        assert not route(1, 4, 2, 256, u8, False)
    finally:
        cuda_stages.HEAD2_KERNELS = True


def test_head2_plan_at_the_main_shapes():
    """The planner on an H100's 132 multiprocessors at row 9b's three cases:
    whole-width tiles, the tallest whose tiles still fill every resident
    block (two a multiprocessor on cells, one on floats) and whose shared
    memory fits."""
    plan = cuda_stages._head2_plan
    assert plan(64, 1, 4, 2, 256, 256, True, False, 132) == (16, 128, 264)
    assert plan(64, 1, 4, 4, 256, 256, True, False, 132) == (8, 64, 264)
    assert plan(64, 4, 2, 2, 128, 128, False, True, 132) == (16, 64, 132)
    for args in ((64, 1, 4, 2, 256, 256, True, False), (64, 1, 4, 4, 256, 256, True, False),
                 (64, 4, 2, 2, 128, 128, False, True), (3, 1, 4, 2, 32, 8192, True, False),
                 (64, 4, 2, 2, 512, 512, False, True), (64, 1, 4, 2, 512, 512, False, False)):
        n, c, o, pool, h, w, binary, dx = args
        rb, tw, grid = plan(*args, 132)
        tiles = n * -(-(h // pool) // rb) * -(-(w // pool) // tw)
        assert tw == min(w // pool, cuda_stages.HEAD2_TILE)
        assert grid == min(tiles, cuda_stages.HEAD2_BLOCKS[c] * 132)
        assert cuda_stages._head2_bwd_smem(c, o, pool, binary, dx, rb, tw) <= 227 * 1024
    assert plan(64, 4, 2, 2, 512, 512, False, True, 132)[0] < 16   # 16 rows would not fit
    assert plan(1, 1, 4, 2, 16, 16, True, False, 132) == (1, 8, 8)   # fewer tiles than slots
