"""PERF.md row 8a redesigned for the H100: the loss tail's forward at the
package's two stage widths (CIN, COUT) = (2, 1) and (1, 1)
(``csrc/loss_tail2_fwd.cu``, routed by ``cuda_stages.loss_tail_route``), run
on the CPU: the source compiled as plain C++ against the stand-in
``<cuda_runtime.h>`` (the ``emulated`` fixture of tests/test_torch_emulated.py,
one thread a block).

Each case runs both widths and acts, obs as uint8 cells, packed uint32 words
and float32, with and without dropout 0.1, under the planner's plan and a
forced one whose last band and tile are cut short: err within rtol 1e-5 of
the generic kernel's emulated build (``LOSS_TAIL2_KERNELS = False``: the same
squared errors, added in another order), within 1e-4 of
``loss_tail_fwd_plain``, the same bits from two calls and from uint8 and
packed obs; without dropout within 1e-5 of ``carle_tpu``'s
``make_fused_loss_tail`` in interpret mode.  Then the route and the plan at
the routes path's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carle_tpu.ops.pallas_head import make_fused_loss_tail

from carle_tpu_torch.ops import bitpack, cuda_stages as cs
from test_torch_emulated import _params, emulated  # noqa: F401  (the fixture)

STAGES = [(2, "relu", 2), (1, "sigmoid", 3), (2, "sigmoid", 3), (1, "relu", 2)]  # cin, act, stage
PLAN = (4, 6)   # (RI, TJ): 3 bands of 4 input rows (the last 2), 3 tiles of 6 columns (the last 4)
H100_SMS = 132


def _case(n, cin, h, w, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(np.maximum(rng.randn(n, cin, h, w), 0).astype(np.float32))
    wt, b = _params(rng, [(cin, 1, 4, 4), (1,)])
    cells = torch.from_numpy((rng.rand(n, 1, 2 * h, 2 * w) < 0.3).astype(np.uint8))
    frame = torch.from_numpy(rng.rand(n, 1, 2 * h, 2 * w).astype(np.float32))
    return x, wt, b, cells, frame


def _rel(a, b):
    return float(((a - b).abs() / b.abs()).max())


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("cin,act,stage", STAGES)
def test_loss_tail2_emulated(emulated, monkeypatch, cin, act, stage, drop_p):
    n, h, w, seed = 3, 10, 16, 9090 + cin
    x, wt, b, cells, frame = _case(n, cin, h, w, 31 * cin + stage)
    args = (act, drop_p, seed, stage)
    assert cs.loss_tail_route(cin, 1, w)
    for obs in (cells, bitpack.pack_grid(cells), frame):
        before = cs.LOSS_TAIL2_FWD.launches
        err = cs._loss_tail_fwd_kernel(x, wt, b, obs, *args)
        assert cs.LOSS_TAIL2_FWD.launches == before + 1
        assert torch.equal(err, cs._loss_tail_fwd_kernel(x, wt, b, obs, *args))
        forced = cs._loss_tail2_fwd_kernel(x, wt, b, obs, *args, plan=PLAN)
        with monkeypatch.context() as m:
            m.setattr(cs, "LOSS_TAIL2_KERNELS", False)
            generic = cs._loss_tail_fwd_kernel(x, wt, b, obs, *args)
        plain = cs.loss_tail_fwd_plain(x, wt, b, obs, *args)
        assert float(generic.min()) > 0
        for got in (err, forced):
            assert _rel(got, generic) < 1e-5
            assert _rel(got, plain) < 1e-4
        if obs.dtype == torch.uint8:
            cell_err = err
        elif obs.dtype == torch.uint32:
            assert torch.equal(err, cell_err)   # the same cells, the same bits


@pytest.mark.parametrize("obs_dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("cin,act", [(1, "sigmoid"), (2, "relu")])
def test_loss_tail2_matches_jax_kernel(emulated, cin, act, obs_dtype):
    """Without dropout, against make_fused_loss_tail in interpret mode."""
    x, wt, b, cells, frame = _case(2, cin, 12, 24, 70 + cin)
    obs = cells if obs_dtype == np.uint8 else frame
    lt = make_fused_loss_tail(act, 0.0, train=False, interpret=True)
    want = np.asarray(lt(*(jnp.asarray(t.numpy()) for t in (x, wt, b, obs)), 0))
    got = cs._loss_tail_fwd_kernel(x, wt, b, obs, act, 0.0, 0, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_loss_tail2_route_and_plan():
    """The routes path's loss tail (x [64 or 160, 1, 128, 128] -> 256²) and
    the spatial path's slot block take the specialised forward on the tail's
    plan; other widths and LOSS_TAIL2_KERNELS = False the generic kernel."""
    assert cs.loss_tail_route(1, 1, 128) and cs.loss_tail_route(2, 1, 64)
    assert cs.loss_tail_route(1, 1, 4096)
    assert not cs.loss_tail_route(1, 2, 128) and not cs.loss_tail_route(1, 1, 127)
    assert cs._tail2_plan(160, 1, 128, 128, False, H100_SMS)[:2] == (16, 128)
    assert cs._tail2_plan(64, 1, 128, 128, False, H100_SMS)[:2] == (16, 128)
    assert cs.LOSS_TAIL2_KERNELS


def test_loss_tail2_flag_forces_the_generic_kernel(emulated, monkeypatch):
    x, wt, b, cells, _ = _case(2, 1, 8, 16, 5)
    monkeypatch.setattr(cs, "LOSS_TAIL2_KERNELS", False)
    before = cs.LOSS_TAIL2_FWD.launches, cs.LOSS_TAIL_FWD.launches
    cs._loss_tail_fwd_kernel(x, wt, b, cells, "sigmoid", 0.0, 0, 3)
    assert (cs.LOSS_TAIL2_FWD.launches, cs.LOSS_TAIL_FWD.launches) == (before[0], before[1] + 1)
