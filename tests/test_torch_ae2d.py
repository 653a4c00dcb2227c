"""The whole autoencoder's kernels specialised at AE2D's widths (C1, C2, CMID,
COUT) = (4, 2, 1, 1) (``csrc/ae2d_fwd.cu``, ``ae2d_bwd.cu``), run on the CPU:
the sources compiled as plain C++ against the stand-in ``<cuda_runtime.h>``
(the ``emulated`` fixture of tests/test_torch_emulated.py, one thread a
block).

Each case holds them against the plain twins (1e-4 of the largest entry, the
twins summing in other orders) and against the generic instantiation at the
same widths (``cuda_head.AE2D_KERNELS = False``): the pre-activations keep the
generic sums, so the error agrees within 1e-6 relative and each gradient leaf
within 1e-5 of its largest entry (only the error and weight-gradient sums run
in other orders).  The training forward's saved keep bits are the twin's
Philox mask stage by stage, and a backward fed them is bit for bit the
backward that draws them.
"""

import numpy as np
import pytest
import torch

from carle_tpu_torch.ops import bitpack, cuda_head as ch
from test_torch_emulated import _params, _rel, emulated  # noqa: F401  (the fixture)

AE2D = [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)]


def _err_rel(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(1e-12)).max())


def _case(n, h, w, seed, blank=True):
    rng = np.random.RandomState(seed)
    src = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    if blank:
        src[0, 0, : h // 2] = 0   # a blank band: whole pool windows tie
    obs = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    ps = _params(rng, AE2D)
    ps[1] = ps[1].abs()
    gbar = torch.from_numpy(rng.randn(n).astype(np.float32))
    return src, obs, ps, gbar


def _generic(monkeypatch, fn):
    """fn() on the generic kernels at AE2D's widths."""
    with monkeypatch.context() as m:
        m.setattr(ch, "AE2D_KERNELS", False)
        return fn()


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("kinds", ["u8 src=obs", "u8 src!=obs", "u32 src", "u32 obs", "u32 both"])
@pytest.mark.parametrize("geom", [  # n, h, w
    (2, 32, 32),     # one band a universe
    (1, 72, 64),     # three bands, the last ragged
])
def test_ae2d_kernels_emulated(emulated, monkeypatch, geom, kinds, drop_p):
    n, h, w = geom
    src, obs, ps, gbar = _case(n, h, w, h + w)
    if kinds == "u8 src=obs":
        obs = src
    if kinds in ("u32 src", "u32 both"):
        src = bitpack.pack_grid(src)
    if kinds in ("u32 obs", "u32 both"):
        obs = bitpack.pack_grid(obs)
    seed = 987654321012345 + w
    fwd = lambda: ch._ae_loss_fwd_kernel(src, *ps, obs, (2, 2), drop_p, seed)
    bwd = lambda: ch._ae_loss_bwd_kernel(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    launches = ch.AE2D_FWD.launches, ch.AE2D_BWD.launches
    err, grads = fwd(), bwd()
    # the forward, and the backward's saving forward, then its own launch
    assert (ch.AE2D_FWD.launches, ch.AE2D_BWD.launches) == (launches[0] + 2, launches[1] + 1)
    assert _err_rel(err, ch.ae_loss_fwd_plain(src, *ps, obs, (2, 2), drop_p, seed)) < 1e-4
    twin = ch.ae_loss_bwd_plain(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    assert [tuple(t.shape) for t in grads] == [tuple(t.shape) for t in twin]
    assert max(_rel(a, b) for a, b in zip(grads, twin)) < 1e-4
    generic = ch.AE_LOSS.launches
    err0, grads0 = _generic(monkeypatch, fwd), _generic(monkeypatch, bwd)
    assert ch.AE_LOSS.launches == generic + 1
    assert _err_rel(err, err0) < 1e-6
    assert max(_rel(a, b) for a, b in zip(grads, grads0)) < 1e-5


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("geom", [(1, 24, 40), (2, 40, 12)])   # ragged, words not whole
def test_ae2d_ragged_widths_emulated(emulated, monkeypatch, geom, drop_p):
    """Widths that are not whole words (uint8 only) and a band taller than
    the universe."""
    n, h, w = geom
    src, obs, ps, gbar = _case(n, h, w, 3 * h + w)
    seed = 424242 + h
    err = ch._ae_loss_fwd_kernel(src, *ps, obs, (2, 2), drop_p, seed)
    grads = ch._ae_loss_bwd_kernel(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    assert _err_rel(err, ch.ae_loss_fwd_plain(src, *ps, obs, (2, 2), drop_p, seed)) < 1e-4
    twin = ch.ae_loss_bwd_plain(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    assert max(_rel(a, b) for a, b in zip(grads, twin)) < 1e-4
    err0 = _generic(monkeypatch, lambda: ch._ae_loss_fwd_kernel(src, *ps, obs, (2, 2), drop_p,
                                                                 seed))
    grads0 = _generic(monkeypatch, lambda: ch._ae_loss_bwd_kernel(src, *ps, obs, gbar, (2, 2),
                                                                  drop_p, seed))
    assert _err_rel(err, err0) < 1e-6
    assert max(_rel(a, b) for a, b in zip(grads, grads0)) < 1e-5


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
def test_ae2d_blank_input_ties_emulated(emulated, monkeypatch, drop_p):
    """Blank cells: every stage-1 pool window ties exactly (four equal
    pixels), and with equal biases stage 2's windows too; the gradient is
    shared g / count as the twin and the generic kernel share it."""
    n, h, w, seed = 2, 40, 32, 777
    src = torch.zeros((n, 1, h, w), dtype=torch.uint8)
    obs = torch.from_numpy((np.random.RandomState(1).rand(n, 1, h, w) < 0.5).astype(np.uint8))
    ps = _params(np.random.RandomState(2), AE2D)
    ps[1] = ps[1].abs() + 0.1   # positive stage-1 maxima: the ties carry gradient
    ps[3] = ps[3].abs() + 0.1
    gbar = torch.ones(n)
    grads = ch._ae_loss_bwd_kernel(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    twin = ch.ae_loss_bwd_plain(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    assert float(grads[1].abs().max()) > 0 and float(grads[3].abs().max()) > 0
    assert max(_rel(a, b) for a, b in zip(grads, twin)) < 1e-4
    grads0 = _generic(monkeypatch, lambda: ch._ae_loss_bwd_kernel(src, *ps, obs, gbar, (2, 2),
                                                                  drop_p, seed))
    assert max(_rel(a, b) for a, b in zip(grads, grads0)) < 1e-5


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("drop_p", [0.1, 0.5])
def test_ae2d_saved_keep_bits_emulated(emulated, drop_p, packed):
    """The training forward draws each element's bit once and saves it: the
    saved bits are philox_keep_mask stage by stage, its error is the
    forward's, and a backward fed them equals the backward that draws (which
    runs that forward itself), bit for bit."""
    n, h, w, seed = 2, 72, 64, 31337
    src, obs, ps, gbar = _case(n, h, w, 5)
    if packed:
        src = bitpack.pack_grid(src)
    err, saved = ch._ae_fwd_launch(src, ps, obs, (2, 2), drop_p, seed, True)
    assert torch.equal(err, ch._ae_loss_fwd_kernel(src, *ps, obs, (2, 2), drop_p, seed))
    masks = ch.saved_keep_masks(saved)
    assert [tuple(m.shape) for m in masks] == [(n, 4, h, w), (n, 2, h // 2, w // 2),
                                               (n, 1, h // 2, w // 2), (n, 1, h, w)]
    for stage, mask in enumerate(masks):
        assert torch.equal(mask, ch.philox_keep_mask(seed, stage, tuple(mask.shape), drop_p,
                                                     "cpu"))
    launches = ch.AE2D_FWD.launches
    fed = ch._ae2d_bwd_kernel(src, ps, obs, gbar, drop_p, saved)
    assert ch.AE2D_FWD.launches == launches   # no forward, no draw
    drawn = ch._ae_loss_bwd_kernel(src, *ps, obs, gbar, (2, 2), drop_p, seed)
    assert all(torch.equal(a, b) for a, b in zip(fed, drawn))


def test_ae2d_saved_embedding_emulated(emulated):
    """Without dropout the training forward saves no keep bits, and its
    embedding is the encoder kernel's output at the same weights, bit for
    bit (the same pre-activation sums)."""
    n, h, w = 2, 72, 64
    src, obs, ps, gbar = _case(n, h, w, 6)
    err, saved = ch._ae_fwd_launch(src, ps, obs, (2, 2), 0.0, 0, True)
    assert saved.keep1 is None and saved.keep2 is None and saved.keepd is None
    assert torch.equal(saved.emb, ch._encoder_fwd_kernel(src, *ps[:4], (2, 2), 0.0, 0))
    fed = ch._ae2d_bwd_kernel(src, ps, obs, gbar, 0.0, saved)
    drawn = ch._ae_loss_bwd_kernel(src, *ps, obs, gbar, (2, 2), 0.0, 0)
    assert all(torch.equal(a, b) for a, b in zip(fed, drawn))


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
def test_ae2d_strided_weights_emulated(emulated, drop_p):
    """Each launch reads its own weight tensors: views that are not
    contiguous give the contiguous weights' error and gradients bit for bit."""
    n, h, w, seed = 1, 32, 32, 4242
    src, obs, ps, gbar = _case(n, h, w, 8)
    strided = [t.transpose(-1, -2).contiguous().transpose(-1, -2) if t.dim() == 4 else t
               for t in ps]
    assert not strided[2].is_contiguous()
    for call in (lambda q: ch._ae_loss_fwd_kernel(src, *q, obs, (2, 2), drop_p, seed),
                 lambda q: ch._ae_loss_bwd_kernel(src, *q, obs, gbar, (2, 2), drop_p, seed)):
        a, b = call(ps), call(strided)
        assert all(torch.equal(x, y) for x, y in zip(a if isinstance(a, tuple) else [a],
                                                     b if isinstance(b, tuple) else [b]))


def test_ae2d_route_is_decided_by_widths_and_shape(emulated, monkeypatch):
    """AE2D's widths take the AE2D kernels; other widths and AE2D_KERNELS =
    False take the generic ones; whole_ae_fits answers as before."""
    assert ch.ae2d_route(256, 256, (4, 2, 1, 1))
    assert not ch.ae2d_route(256, 256, (3, 2, 2, 2))
    monkeypatch.setattr(ch, "AE2D_KERNELS", False)
    assert not ch.ae2d_route(256, 256, (4, 2, 1, 1))
    monkeypatch.setattr(ch, "AE2D_KERNELS", True)
    assert ch.whole_ae_fits(256, 256, 4, 2, 1, 1)
    assert not ch.whole_ae_fits(2048, 2048, 4, 2, 1, 1)
    assert not ch.whole_ae_fits(8192, 8192, 4, 2, 1, 1)
    rng = np.random.RandomState(9)
    src = torch.from_numpy((rng.rand(1, 1, 16, 48) < 0.3).astype(np.uint8))
    ps = _params(rng, [(3, 1, 3, 3), (3,), (2, 3, 3, 3), (2,), (2, 2, 4, 4), (2,),
                       (2, 2, 4, 4), (2,)])
    obs = torch.from_numpy((rng.rand(1, 2, 16, 48) < 0.3).astype(np.uint8))
    counts = ch.AE_LOSS.launches, ch.AE2D_FWD.launches
    ch._ae_loss_fwd_kernel(src, *ps, obs, (2, 2), 0.0, 0)
    assert (ch.AE_LOSS.launches, ch.AE2D_FWD.launches) == (counts[0] + 1, counts[1])
    with pytest.raises(ValueError, match="4-byte"):
        wide = torch.zeros(1 * 16 * 48 + 1, dtype=torch.uint8)[1:].view(1, 1, 16, 48)
        ch._ae_loss_fwd_kernel(wide, *_params(rng, AE2D), wide, (2, 2), 0.0, 0)
