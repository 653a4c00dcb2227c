"""The decoder-loss kernels specialised at the package's one decoder width
(C2, CMID, COUT) = (2, 1, 1) (``csrc/dec2_fwd.cu``, ``dec2_bwd.cu``), run on
the CPU: the sources compiled as plain C++ against the stand-in
``<cuda_runtime.h>`` (the ``emulated`` fixture of tests/test_torch_emulated.py,
one thread a block).

Each case holds them against the generic instantiation at the same width
(``cuda_stages.DEC2_KERNELS = False``): the error within 1e-6 relative (only
the partial sums' order differs), gx bit for bit (it reads every middle
activation through the relu gate, every output pre-activation through the
sigmoid and every middle cotangent, each summed in the generic order) and
each gradient leaf within 1e-5 of its largest entry (the weight-gradient
sums run in other orders); against the plain twins within 1e-4 of each
output's largest entry; the training forward's saved keep bits against
``philox_keep_mask`` on the rows whose weight is not zero (and the middle
positions they read); and, without dropout, against ``carle_tpu``'s
``make_fused_decoder_loss`` and ``make_fused_decoder_loss_banded`` in
interpret mode within 1e-4 (float32 sums in other orders).  The plans that
choose a block's rows and columns are held at the shapes of the bands of
8192².
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carle_tpu.ops.bitpack import pack_grid as jpack_grid
from carle_tpu.ops.pallas_head import make_fused_decoder_loss, make_fused_decoder_loss_banded

from carle_tpu_torch.ops import bitpack, cuda_head as ch, cuda_stages as cs
from carle_tpu_torch.parallel import band_heads as bh
from test_torch_emulated import _params, _rel, emulated  # noqa: F401  (the fixture)

SHAPES = [(2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)]


def _case(n, h, w, seed, obs_kind="u8", em_kind="none"):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(np.maximum(rng.randn(n, 2, h // 4, w // 4), 0).astype(np.float32))
    ps = _params(rng, SHAPES)
    ps[1] = ps[1].abs()                  # positive middle activations where the embedding is 0
    cells = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    obs = {"u8": cells, "u32": bitpack.pack_grid(cells) if w % 32 == 0 else None,
           "f32": torch.from_numpy(rng.rand(n, 1, h, w).astype(np.float32))}[obs_kind]
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32))
    em = None
    if em_kind == "ones":
        em = torch.ones(n, h)
    elif em_kind == "bands":             # BandTiling's windows: a core of ones, zero margins
        em = torch.ones(n, h)
        em[0, :8], em[0, h - 8:] = 0.0, 0.0      # a middle band
        em[1:, h - 16:] = 0.0                      # the first band: its margin below
    elif em_kind == "scattered":         # fractions, zero rows anywhere
        em = torch.from_numpy(np.where(rng.rand(n, h) < 0.3, 0.0,
                                       rng.rand(n, h) + 0.5).astype(np.float32))
    return x, ps, obs, gbar, em


def _generic(monkeypatch, fn):
    """fn() on the generic kernels at the same width."""
    with monkeypatch.context() as m:
        m.setattr(cs, "DEC2_KERNELS", False)
        return fn()


def _leaves_rel(got, want):
    return max(_rel(a, b) for a, b in zip(got, want))


def _weighted(em, n, h):
    """[N, H] bool: the output rows whose weight is not zero."""
    return torch.ones(n, h, dtype=torch.bool) if em is None else em != 0


def _mid_rows_read(rows):
    """[N, H/2] bool: the middle rows the weighted output rows read (output y
    reads middle rows (y - 1) // 2 and the next)."""
    n, h = rows.shape
    out = torch.zeros(n, h // 2, dtype=torch.bool)
    for y in range(h):
        for r in ((y - 1) // 2, (y - 1) // 2 + 1):
            if 0 <= r < h // 2:
                out[:, r] |= rows[:, y]
    return out


@pytest.mark.parametrize("tiles", ["whole", "tiles48"])
@pytest.mark.parametrize("em_kind", ["none", "ones", "bands", "scattered"])
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("obs_kind", ["u8", "u32", "f32"])
def test_dec2_kernels_emulated(emulated, monkeypatch, obs_kind, drop_p, em_kind, tiles):
    """Forward and gradients against the generic kernel and the twins, the
    training forward's keep bits against the twin's Philox mask; 48-column
    tiles put a tile edge inside a packed word, and a 40-row output with
    zero-weight margins leaves whole blocks without a weighted row."""
    n, h, w = 2, 40, 96
    x, ps, obs, gbar, em = _case(n, h, w, 11 + h, obs_kind, em_kind)
    seed = 20261017
    monkeypatch.setattr(ch, "TILE_CELLS", w if tiles == "whole" else 48)
    assert cs.decoder_route(h, w, (2, 1, 1))
    assert cs._dec2_plan(n, h, w, False, ch.TILE_CELLS)[1] == (w if tiles == "whole" else 48)
    counts = cs.DEC2_FWD.launches, cs.DEC2_BWD.launches, cs.DECODER_LOSS_FWD.launches
    err = cs._decoder_loss_fwd_kernel(x, *ps, obs, drop_p, seed, em)
    *grads, gx = cs._decoder_loss_bwd_kernel(x, *ps, obs, gbar, drop_p, seed, em)
    # the forward; with dropout the backward's saving forward; its own launch
    assert (cs.DEC2_FWD.launches, cs.DEC2_BWD.launches, cs.DECODER_LOSS_FWD.launches) == (
        counts[0] + 1 + (drop_p > 0), counts[1] + 1, counts[2])
    want = cs.decoder_loss_fwd_plain(x, *ps, obs, drop_p, seed, em)
    assert float(want.abs().max()) > 0 and _rel(err, want) < 1e-4
    twin = cs.decoder_loss_bwd_plain(x, *ps, obs, gbar, drop_p, seed, em)
    assert [tuple(t.shape) for t in (*grads, gx)] == [tuple(t.shape) for t in twin]
    assert _leaves_rel((*grads, gx), twin) < 1e-4
    generic = cs.DECODER_LOSS_FWD.launches
    err0 = _generic(monkeypatch, lambda: cs._decoder_loss_fwd_kernel(x, *ps, obs, drop_p, seed,
                                                                      em))
    *grads0, gx0 = _generic(monkeypatch, lambda: cs._decoder_loss_bwd_kernel(
        x, *ps, obs, gbar, drop_p, seed, em))
    assert cs.DECODER_LOSS_FWD.launches == generic + 1
    assert float(((err - err0).abs() / err0.abs()).max()) < 1e-6
    assert torch.equal(gx, gx0)
    assert _leaves_rel(grads, grads0) < 1e-5
    if em_kind == "ones":   # an em of ones is no em, bit for bit
        assert torch.equal(err, cs._decoder_loss_fwd_kernel(x, *ps, obs, drop_p, seed))
        assert all(torch.equal(a, b) for a, b in zip(
            (*grads, gx), cs._decoder_loss_bwd_kernel(x, *ps, obs, gbar, drop_p, seed)))
    if drop_p > 0:
        err_s, saved = cs._decoder_fwd_launch(x, ps, obs, drop_p, seed, em, True)
        assert torch.equal(err_s, err)
        rows = _weighted(em, n, h)
        mid = _mid_rows_read(rows)
        keep1, keep2 = cs.dec2_keep_masks(saved)
        want1 = ch.philox_keep_mask(seed, ch.STAGE_DEC1, tuple(keep1.shape), drop_p, "cpu")
        want2 = ch.philox_keep_mask(seed, ch.STAGE_DEC2, tuple(keep2.shape), drop_p, "cpu")
        assert torch.equal(keep1[:, 0][mid], want1[:, 0][mid])
        assert torch.equal(keep2[:, 0][rows], want2[:, 0][rows])
        assert keep1[:, 0][mid].float().mean() > 0.8 and keep2[:, 0][rows].float().mean() > 0.8


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("em_kind", ["none", "bands"])
def test_dec2_backward_from_saved_bits_emulated(emulated, em_kind, drop_p):
    """What the training step runs (DecoderLossFn on the card): the saving
    forward, then the backward from its keep bits, equals the backward that
    draws them (which runs that forward itself), bit for bit; and a backward
    fed them draws nothing."""
    n, h, w = 3, 32, 64
    x, ps, obs, gbar, em = _case(n, h, w, 5, "u8", em_kind)
    seed = 777
    err, saved = cs._decoder_fwd_launch(x, ps, obs, drop_p, seed, em, True)
    assert (saved is None) == (drop_p == 0)
    launches = cs.DEC2_FWD.launches
    fed = cs._dec2_bwd_kernel(x, ps, obs, gbar, drop_p, em, saved)
    assert cs.DEC2_FWD.launches == launches
    drawn = cs._decoder_loss_bwd_kernel(x, *ps, obs, gbar, drop_p, seed, em)
    assert all(torch.equal(a, b) for a, b in zip(fed, drawn))


@pytest.mark.parametrize("plan", [(4, 4), (8, 12), (16, 64), (40, 24), (12, 96)],
                         ids=lambda p: f"{p[0]}x{p[1]}")
def test_dec2_gx_equal_across_plans_emulated(emulated, monkeypatch, plan):
    """A block's rows and columns change what it recomputes, not what it
    computes: gx is the generic kernel's bit for bit under every plan (and
    the error and weight gradients within their tolerances), with dropout and
    zero-weight rows."""
    n, h, w = 2, 40, 96
    x, ps, obs, gbar, em = _case(n, h, w, 23, "u32", "bands")
    ry, tx = plan
    monkeypatch.setattr(cs, "_dec2_plan", lambda n_, h_, w_, backward, cells=None: (
        ry, tx, cs._dec2_bwd_smem(w, ry, tx) if backward else cs._dec2_fwd_smem(w, ry, tx, True)))
    err = cs._decoder_loss_fwd_kernel(x, *ps, obs, 0.1, 99, em)
    *grads, gx = cs._decoder_loss_bwd_kernel(x, *ps, obs, gbar, 0.1, 99, em)
    err0 = _generic(monkeypatch, lambda: cs._decoder_loss_fwd_kernel(x, *ps, obs, 0.1, 99, em))
    *grads0, gx0 = _generic(monkeypatch, lambda: cs._decoder_loss_bwd_kernel(
        x, *ps, obs, gbar, 0.1, 99, em))
    assert torch.equal(gx, gx0)
    assert float(((err - err0).abs() / err0.abs()).max()) < 1e-6
    assert _leaves_rel(grads, grads0) < 1e-5


@pytest.mark.parametrize("banded", [False, True], ids=["plain", "banded"])
@pytest.mark.parametrize("obs_kind", ["u8", "u32"])
def test_dec2_matches_jax_kernel_emulated(emulated, obs_kind, banded):
    """Without dropout, against carle_tpu's make_fused_decoder_loss (and
    make_fused_decoder_loss_banded with band row weights) in interpret mode:
    the error, the four parameter gradients and gx (jax.grad through its
    custom VJP), within 1e-4 of each output's largest entry."""
    n, h, w = 2, 32, 64
    x, ps, obs, gbar, em = _case(n, h, w, 41 + banded, obs_kind, "bands" if banded else "none")
    jobs = (jpack_grid(jnp.asarray(bitpack.unpack_grid(obs, w).numpy())) if obs_kind == "u32"
            else jnp.asarray(obs.numpy()))
    if banded:
        dl = make_fused_decoder_loss_banded(0.0, train=False, interpret=True)
        call = lambda *a: dl(*a, jobs, jnp.int32(0), jnp.asarray(em.numpy())[:, :, None])
    else:
        dl = make_fused_decoder_loss(0.0, train=False, interpret=True)
        call = lambda *a: dl(*a, jobs, jnp.int32(0))

    def loss(*args):
        err = call(*args)
        return jnp.sum(err * jnp.asarray(gbar.numpy())), err

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(t.numpy()) for t in (x, *ps)))
    err = cs._decoder_loss_fwd_kernel(x, *ps, obs, 0.0, 0, em)
    assert _rel(err, torch.from_numpy(np.array(want))) < 1e-4
    *grads, gx = cs._decoder_loss_bwd_kernel(x, *ps, obs, gbar, 0.0, 0, em)
    jg = [torch.from_numpy(np.array(t)) for t in jgrads]
    assert _leaves_rel((gx, *grads), jg) < 1e-4


def test_dec2_route_is_decided_by_widths_and_shape(emulated, monkeypatch):
    """The decoder's width takes the specialised kernels at any shape; other
    widths, and DEC2_KERNELS = False, take the generic ones."""
    for h, w in ((256, 256), (80, 8192), (8192, 8192), (2048, 2048), (16, 32), (4, 4)):
        assert cs.decoder_route(h, w, (2, 1, 1))
    assert not cs.decoder_route(256, 256, (3, 2, 5))
    assert not cs.decoder_route(256, 256, (2, 1, 2))
    assert not cs.decoder_route(256, 256, (2, 2, 1))
    monkeypatch.setattr(cs, "DEC2_KERNELS", False)
    assert not cs.decoder_route(256, 256, (2, 1, 1))
    monkeypatch.setattr(cs, "DEC2_KERNELS", True)
    rng = np.random.RandomState(9)
    x = torch.from_numpy(np.maximum(rng.randn(1, 3, 4, 8), 0).astype(np.float32))
    ps = _params(rng, [(3, 2, 4, 4), (2,), (2, 5, 4, 4), (5,)])
    obs = torch.from_numpy((rng.rand(1, 5, 16, 32) < 0.3).astype(np.uint8))
    counts = cs.DECODER_LOSS_FWD.launches, cs.DEC2_FWD.launches
    cs._decoder_loss_fwd_kernel(x, *ps, obs, 0.0, 0)
    assert (cs.DECODER_LOSS_FWD.launches, cs.DEC2_FWD.launches) == (counts[0] + 1, counts[1])


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
def test_encoder_then_dec2_is_the_whole_ae_emulated(emulated, drop_p):
    """The autoencoder as two kernels (the encoder, then the decoder loss) with
    one seed gives the whole-AE kernel's error within 1e-6 relative: one mask,
    every pre-activation the same, only the error's partial sums in another
    order."""
    n, h, w, seed = 2, 32, 64, 31337
    rng = np.random.RandomState(5)
    src = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    obs = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    ps = _params(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), *SHAPES])
    ps[1] = ps[1].abs()
    assert ch.ae2d_route(h, w, (4, 2, 1, 1)) and cs.decoder_route(h, w, (2, 1, 1))
    one = ch._ae_loss_fwd_kernel(src, *ps, obs, (2, 2), drop_p, seed)
    emb = ch._encoder_fwd_kernel(src, *ps[:4], (2, 2), drop_p, seed)
    two = cs._decoder_loss_fwd_kernel(emb, *ps[4:], obs, drop_p, seed)
    assert float(((two - one).abs() / one.abs()).max()) < 1e-6


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_dec2_plans_at_the_band_shapes(backward):
    """Prediction's bands of 8192² ([128, 2, 20, 2048] -> 80 x 8192 outputs)
    and the whole 8192² universe: column tiles, blocks of more than a few
    rows, and shared memory for the blocks a multiprocessor the kernel is
    compiled for."""
    for n, h, w in ((128, 80, 8192), (1, 8192, 8192), (160, 256, 256)):
        ry, tx, smem = cs._dec2_plan(n, h, w, backward)
        assert ry >= 16 and tx % 4 == 0 and (w < 1024 or tx < w)
        assert cs.DEC2_BLOCKS[int(backward)] * (smem + 1024) <= ch.SMEM_SM
    starts, win = bh.decoder_windows(2048, 128)
    em = bh.decoder_row_weights(2048, 128, 1)
    assert win == 20 and em.shape == (128, 80) and float(em.sum(1).min()) == 64.0
