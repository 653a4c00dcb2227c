"""The decoder-stage kernels specialised at the package's two stage widths
(CIN, COUT) = (2, 1) and (1, 1) (``csrc/tail2_fwd.cu``, ``tail2_bwd.cu``),
run on the CPU: the sources compiled as plain C++ against the stand-in
``<cuda_runtime.h>`` (the ``emulated`` fixture of tests/test_torch_emulated.py,
one thread a block).

Each case holds them against the generic kernel at the same widths
(``cuda_stages.TAIL2_KERNELS = False``): the forward bit for bit (every
pre-activation by the parity stencils in the generic order) and gx bit for
bit (the generic sum over the same cotangents), dW and db within 1e-5 of each
leaf's largest entry (their sums run in other orders); against the plain twins
within 1e-4 of each output's largest entry; the training forward's saved keep
bits against ``philox_keep_mask``, and the backward from them against the one
that draws them, bit for bit; and, without dropout, against ``carle_tpu``'s
``make_fused_tail`` in interpret mode within 1e-5.  The plans are held at the
main paths' shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carle_tpu.ops.pallas_head import make_fused_tail

from carle_tpu_torch.ops import cuda_head as ch, cuda_stages as cs
from test_torch_emulated import _params, _rel, emulated  # noqa: F401  (the fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STAGES = [(2, "relu", 2), (1, "sigmoid", 3), (2, "sigmoid", 3), (1, "relu", 2)]  # cin, act, stage
# (RI, TJ): several bands and tiles, the last ragged (w = 20 is no multiple of 6)
PLAN = (3, 6)


def _case(n, cin, h, w, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(np.maximum(rng.randn(n, cin, h, w), 0).astype(np.float32))
    wt, b = _params(rng, [(cin, 1, 4, 4), (1,)])
    g = torch.from_numpy(rng.randn(n, 1, 2 * h, 2 * w).astype(np.float32))
    return x, wt, b, g


def _generic(monkeypatch, fn):
    """fn() on the generic kernel at the same widths."""
    with monkeypatch.context() as m:
        m.setattr(cs, "TAIL2_KERNELS", False)
        return fn()


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("cin,act,stage", STAGES)
def test_tail2_kernels_emulated(emulated, monkeypatch, cin, act, stage, drop_p):
    """Forward and gradients against the generic kernel and the twins, under
    the planner's plan and a forced one of ragged bands and tiles; the
    training forward's keep bits against the twin's Philox mask."""
    n, h, w, seed = 2, 10, 20, 4242 + cin
    x, wt, b, g = _case(n, cin, h, w, 17 * cin + stage)
    args = (act, drop_p, seed, stage)
    assert cs.tail_route(cin, 1, w)
    y0 = _generic(monkeypatch, lambda: cs._tail_fwd_kernel(x, wt, b, *args))
    dw0, db0, gx0 = _generic(monkeypatch, lambda: cs._tail_bwd_kernel(x, wt, b, g, *args))
    want_y = cs.tail_fwd_plain(x, wt, b, *args)
    twin = cs.tail_bwd_plain(x, wt, b, g, *args)
    for plan in (None, PLAN):
        counts = cs.TAIL2_FWD.launches, cs.TAIL2_BWD.launches, cs.TAIL_FWD.launches
        y, keep = cs._tail2_fwd_kernel(x, wt, b, *args, save=True, plan=plan)
        dw, db, gx = cs._tail2_bwd_kernel(x, wt, b, g, *args, plan=plan)
        assert (cs.TAIL2_FWD.launches, cs.TAIL2_BWD.launches, cs.TAIL_FWD.launches) == (
            counts[0] + 1, counts[1] + 1, counts[2])
        assert torch.equal(y, y0)
        assert float(want_y.abs().max()) > 0 and _rel(y, want_y) < 1e-4
        assert torch.equal(gx, gx0)
        assert max(_rel(a, t) for a, t in zip((dw, db), (dw0, db0))) < 1e-5
        assert max(_rel(a, t) for a, t in zip((dw, db, gx), twin)) < 1e-4
        assert (keep is None) == (drop_p == 0)
        if drop_p > 0:
            want = ch.philox_keep_mask(seed, stage, (n, 1, 2 * h, 2 * w), drop_p, "cpu")
            mask = cs.tail2_keep_mask(keep)
            assert torch.equal(mask, want) and 0.8 < float(mask.float().mean()) < 0.97
            fed = cs._tail2_bwd_kernel(x, wt, b, g, *args, keep=keep, plan=plan)
            assert all(torch.equal(a, t) for a, t in zip(fed, (dw, db, gx)))
    # the public kernels take the route
    assert torch.equal(cs._tail_fwd_kernel(x, wt, b, *args), y0)
    assert torch.equal(cs._tail_bwd_kernel(x, wt, b, g, *args)[2], gx0)


@pytest.mark.parametrize("cin,act,stage", STAGES[:2])
def test_tail2_matches_jax_kernel_emulated(emulated, cin, act, stage):
    """Without dropout, against carle_tpu's make_fused_tail in interpret mode:
    the output and dW, db, gx (jax.grad through its custom VJP) within 1e-5 of
    each output's largest entry."""
    n, h, w = 2, 8, 16
    x, wt, b, g = _case(n, cin, h, w, 90 + cin)
    tail = make_fused_tail(act, 0.0, train=False, interpret=True)
    seed0 = jnp.int32(0)
    want = tail(jnp.asarray(x.numpy()), jnp.asarray(wt.numpy()), jnp.asarray(b.numpy()), seed0)
    jg = jax.grad(lambda *a: (tail(*a, seed0) * jnp.asarray(g.numpy())).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (x, wt, b)))
    y = cs._tail_fwd_kernel(x, wt, b, act, 0.0, 0, stage)
    assert _rel(y, torch.from_numpy(np.array(want))) < 1e-5
    dw, db, gx = cs._tail_bwd_kernel(x, wt, b, g, act, 0.0, 0, stage)
    got = (gx, dw, db)
    assert max(_rel(a, torch.from_numpy(np.array(t))) for a, t in zip(got, jg)) < 1e-5


def test_tail2_route_is_decided_by_widths_and_shape(emulated, monkeypatch):
    """Widths (2, 1) and (1, 1) at an even input width take tail2; (2, 2),
    (1, 2), an odd width and TAIL2_KERNELS = False take the generic kernel."""
    for cin in (1, 2):
        assert cs.tail_route(cin, 1, 64) and cs.tail_route(cin, 1, 2048)
        assert not cs.tail_route(cin, 2, 64)
        assert not cs.tail_route(cin, 1, 63)
    monkeypatch.setattr(cs, "TAIL2_KERNELS", False)
    assert not cs.tail_route(2, 1, 64)
    monkeypatch.setattr(cs, "TAIL2_KERNELS", True)
    rng = np.random.RandomState(3)
    for cin, cout, w, kernels in ((2, 1, 8, (cs.TAIL2_FWD, cs.TAIL2_BWD)),
                                  (1, 1, 8, (cs.TAIL2_FWD, cs.TAIL2_BWD)),
                                  (2, 2, 8, (cs.TAIL_FWD, cs.TAIL_BWD)),
                                  (1, 2, 8, (cs.TAIL_FWD, cs.TAIL_BWD)),
                                  (1, 1, 7, (cs.TAIL_FWD, cs.TAIL_BWD))):
        x = torch.from_numpy(rng.rand(1, cin, 4, w).astype(np.float32))
        wt, b = _params(rng, [(cin, cout, 4, 4), (cout,)])
        g = torch.from_numpy(rng.randn(1, cout, 8, 2 * w).astype(np.float32))
        counts = [k.launches for k in kernels]
        cs._tail_fwd_kernel(x, wt, b, "relu", 0.0, 0, 2)
        cs._tail_bwd_kernel(x, wt, b, g, "relu", 0.0, 0, 2)
        assert [k.launches for k in kernels] == [c + 1 for c in counts], (cin, cout, w)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_tail2_plans_keep_two_blocks_a_multiprocessor(backward):
    """At every main-path shape of the tails (the stage phase's [160] and
    [64], ae_forward's, SpaceSharding's slot blocks of 8192² on 4 slots) the
    plan's shared memory lets two blocks of 256 threads share a multiprocessor
    of an H100 (228 KB, 1 KB a block), the grid gives each of its 132
    multiprocessors a block at least, and a block's window is a band of rows
    and a tile of columns, not whole rows of the wide blocks."""
    shapes = [(160, 1, 128, 128), (160, 2, 64, 64), (64, 1, 128, 128), (64, 2, 64, 64),
              (1, 2, 514, 2048), (1, 1, 1026, 4096)]
    for n, cin, h, w in shapes:
        ri, tj, smem = cs._tail2_plan(n, cin, h, w, backward, 132)
        blocks = n * -(-h // ri) * -(-w // tj)
        assert 2 * (smem + 1024) <= ch.SMEM_SM, (n, cin, h, w, smem)
        assert blocks >= 132 and tj % 2 == 0 and tj <= 128
        want = cs._tail2_bwd_smem(cin, w, ri, tj) if backward else cs._tail2_fwd_smem(cin, w, ri, tj)
        assert smem == want
