"""The encoder's kernels specialised at the package's three encoder widths
(C1, C2, P1, P2) = (4, 1, 4, 2), (2, 1, 4, 2) and (4, 2, 2, 2)
(``csrc/enc3_fwd.cu``, ``enc3_bwd.cu``), run on the CPU: the sources compiled
as plain C++ against the stand-in ``<cuda_runtime.h>`` (the ``emulated``
fixture of tests/test_torch_emulated.py, one thread a block).

Each case holds them against the generic instantiation at the same widths
(``cuda_head.ENC3_KERNELS = False``): the forward bit for bit (every
pre-activation keeps the generic sum, so the outputs and pool ties are the
generic kernel's) and each gradient leaf within 1e-5 of its largest entry
(only the weight-gradient sums run in another order); against the plain twins
within 1e-4 of each output's largest entry (the twins sum in other orders);
the training forward's saved keep bits against ``philox_keep_mask``; and,
without dropout, against ``carle_tpu``'s ``make_fused_encoder`` in interpret
mode within 1e-4 of each output's largest entry (float32 sums in other
orders).  The plans that choose a block's rows and column tile are held at
the shapes of the 8192² paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carle_tpu.ops.pallas_head import make_fused_encoder

from carle_tpu_torch.ops import bitpack, cuda_head as ch
from test_torch_emulated import _params, _rel, emulated  # noqa: F401  (the fixture)

WIDTHS = [(4, 1, 4, 2), (2, 1, 4, 2), (4, 2, 2, 2)]   # RND predictor, RND target, AE2D


def _case(c1, c2, p1, p2, n, h, w, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.rand(n, 1, h, w) < 0.3).astype(np.uint8))
    x[0, 0, : h // 2] = 0                # a blank band: whole pool windows tie
    x[-1, 0, h // 2:, : w // 3] = 1      # a full one: ties whose taps are all set
    ps = _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])
    ps[1], ps[3] = ps[1].abs(), ps[3].abs()
    g = torch.from_numpy(rng.randn(n, c2, h // (p1 * p2), w // (p1 * p2)).astype(np.float32))
    mask = torch.from_numpy((rng.rand(n, h // p1) < 0.7).astype(np.float32))
    mask[0, :2] = 0.0
    return x, ps, g, mask


def _generic(monkeypatch, fn):
    """fn() on the generic kernels at the same widths."""
    with monkeypatch.context() as m:
        m.setattr(ch, "ENC3_KERNELS", False)
        return fn()


def _leaves_rel(got, want):
    return max(_rel(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("tiles", [None, 48], ids=["whole", "tiles48"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["u8", "u32"])
@pytest.mark.parametrize("widths", WIDTHS, ids=["rnd", "target", "ae"])
def test_enc3_kernels_emulated(emulated, monkeypatch, widths, kind, drop_p, masked, tiles):
    """Forward bit for bit against the generic kernel, gradients against the
    generic kernel (1e-5) and the twin (1e-4), the training forward's keep
    bits against the twin's Philox mask; tiles of 48 cells put a tile edge
    inside a packed word, and a 40-row universe gives ragged last bands."""
    c1, c2, p1, p2 = widths
    n, h, w = 2, 40, 96
    x, ps, g, mask = _case(c1, c2, p1, p2, n, h, w, 11 * p1 + c1 + c2)
    if kind == "u32":
        x = bitpack.pack_grid(x)
    m = mask if masked else None
    seed = 20241017 + p1
    monkeypatch.setattr(ch, "TILE_CELLS", tiles)
    assert ch.encoder_route(h, w, (c1, c2), (p1, p2))
    counts = ch.ENC3_FWD.launches, ch.ENC3_BWD.launches, ch.ENCODER.launches
    out = ch._encoder_fwd_kernel(x, *ps, (p1, p2), drop_p, seed, m)
    grads = ch._encoder_bwd_kernel(x, *ps, g, (p1, p2), drop_p, seed, m)
    # the forward; with dropout the backward's saving forward, then its own launch
    assert (ch.ENC3_FWD.launches, ch.ENC3_BWD.launches, ch.ENCODER.launches) == (
        counts[0] + 1 + (drop_p > 0), counts[1] + 1, counts[2])
    want = ch.encoder_fwd_plain(x, *ps, (p1, p2), drop_p, seed, m)
    assert float(want.abs().max()) > 0 and _rel(out, want) < 1e-4
    twin = ch.encoder_bwd_plain(x, *ps, g, (p1, p2), drop_p, seed, m)
    assert [tuple(t.shape) for t in grads] == [tuple(t.shape) for t in twin]
    assert _leaves_rel(grads, twin) < 1e-4
    generic = ch.ENCODER.launches
    out0 = _generic(monkeypatch, lambda: ch._encoder_fwd_kernel(x, *ps, (p1, p2), drop_p, seed, m))
    grads0 = _generic(monkeypatch, lambda: ch._encoder_bwd_kernel(x, *ps, g, (p1, p2), drop_p,
                                                                   seed, m))
    assert ch.ENCODER.launches == generic + 1
    assert torch.equal(out, out0)
    assert _leaves_rel(grads, grads0) < 1e-5
    if drop_p > 0:
        out_s, saved = ch._encoder_fwd_launch(x, ps, (p1, p2), drop_p, seed, m, True)
        assert torch.equal(out_s, out)
        for stage, keep in enumerate(ch.enc3_keep_masks(saved, c1, c2, p1)):
            assert torch.equal(keep, ch.philox_keep_mask(seed, stage, tuple(keep.shape), drop_p,
                                                         "cpu"))


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("widths", WIDTHS, ids=["rnd", "target", "ae"])
def test_enc3_backward_from_saved_bits_emulated(emulated, widths, drop_p):
    """What the training step runs (EncoderFn on the card): the saving
    forward, then the backward from its keep bits, equals the backward that
    draws them (which runs that forward itself), bit for bit; and a backward
    fed them draws nothing."""
    c1, c2, p1, p2 = widths
    n, h, w = 3, 32, 64
    x, ps, g, mask = _case(c1, c2, p1, p2, n, h, w, 5 + c1)
    seed = 777 + c2
    out, saved = ch._encoder_fwd_launch(x, ps, (p1, p2), drop_p, seed, mask, True)
    assert (saved is None) == (drop_p == 0)
    launches = ch.ENC3_FWD.launches
    fed = ch._enc3_bwd_kernel(x, ps, g, (p1, p2), drop_p, mask, saved)
    assert ch.ENC3_FWD.launches == launches
    drawn = ch._encoder_bwd_kernel(x, *ps, g, (p1, p2), drop_p, seed, mask)
    assert all(torch.equal(a, b) for a, b in zip(fed, drawn))


@pytest.mark.parametrize("drop_p", [0.0, 0.1])
@pytest.mark.parametrize("widths", WIDTHS, ids=["rnd", "target", "ae"])
def test_enc3_whole_window_ties_emulated(emulated, monkeypatch, widths, drop_p):
    """Blank and full universes: every stage-1 pool window ties exactly (all
    P1 x P1 pixels equal: 16 at pool 4), and with equal biases stage 2's too.
    On the full one every tied pixel has every tap set, so dW1 adds counts of
    16, past the 3-bit fields that serve pool 2; the gradient is shared
    g / count as the twin and the generic kernel share it."""
    c1, c2, p1, p2 = widths
    n, h, w, seed = 2, 32, 64, 4040
    x = torch.zeros((n, 1, h, w), dtype=torch.uint8)
    x[1] = 1
    rng = np.random.RandomState(3)
    ps = _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])
    ps[0] = ps[0].abs() * 0.1            # positive maxima on both universes
    ps[1] = ps[1].abs() + 0.1
    ps[3] = ps[3].abs() + 0.1
    g = torch.from_numpy(rng.randn(n, c2, h // (p1 * p2), w // (p1 * p2)).astype(np.float32))
    grads = ch._encoder_bwd_kernel(x, *ps, g, (p1, p2), drop_p, seed)
    twin = ch.encoder_bwd_plain(x, *ps, g, (p1, p2), drop_p, seed)
    assert float(grads[0].abs().max()) > 0 and float(grads[1].abs().max()) > 0
    assert _leaves_rel(grads, twin) < 1e-4
    grads0 = _generic(monkeypatch, lambda: ch._encoder_bwd_kernel(x, *ps, g, (p1, p2), drop_p,
                                                                   seed))
    assert _leaves_rel(grads, grads0) < 1e-5


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("widths", WIDTHS, ids=["rnd", "target", "ae"])
def test_enc3_matches_jax_kernel_emulated(emulated, widths, masked):
    """Without dropout, against carle_tpu's make_fused_encoder in interpret
    mode: the output and the four gradients (jax.grad through its custom
    VJP), within 1e-4 of each output's largest entry."""
    c1, c2, p1, p2 = widths
    n, h, w = 2, 32, 64
    x, ps, g, mask = _case(c1, c2, p1, p2, n, h, w, 17 + c1 * c2)
    rows = mask if masked else torch.ones(n, h // p1)
    enc = make_fused_encoder(p1, p2, 0.0, train=False, interpret=True)
    jx, jm, jg = jnp.asarray(x.numpy()), jnp.asarray(rows.numpy())[:, :, None], jnp.asarray(g.numpy())

    def loss(*params):
        out = enc(jx, *params, jnp.int32(0), jm)
        return jnp.sum(out * jg), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(p.numpy()) for p in ps))
    m = mask if masked else None
    out = ch._encoder_fwd_kernel(x, *ps, (p1, p2), 0.0, 0, m)
    assert _rel(out, torch.from_numpy(np.asarray(want))) < 1e-4
    grads = ch._encoder_bwd_kernel(x, *ps, g, (p1, p2), 0.0, 0, m)
    assert _leaves_rel(grads, [torch.from_numpy(np.asarray(t)) for t in jgrads]) < 1e-4


def test_enc3_route_is_decided_by_widths_and_shape(emulated, monkeypatch):
    """The three widths take the specialised kernels at any shape; other
    widths and pools, and ENC3_KERNELS = False, take the generic ones."""
    for c1, c2, p1, p2 in WIDTHS:
        for h, w in ((256, 256), (32, 8192), (2064, 8192), (8192, 8192), (16, 32)):
            if h % (p1 * p2) == 0 and w % (p1 * p2) == 0:
                assert ch.encoder_route(h, w, (c1, c2), (p1, p2))
    assert not ch.encoder_route(256, 256, (4, 2), (4, 2))
    assert not ch.encoder_route(256, 256, (5, 3), (2, 2))
    assert not ch.encoder_route(256, 256, (4, 1), (4, 4))
    monkeypatch.setattr(ch, "ENC3_KERNELS", False)
    assert not ch.encoder_route(256, 256, (4, 1), (4, 2))
    monkeypatch.setattr(ch, "ENC3_KERNELS", True)
    rng = np.random.RandomState(9)
    x = torch.from_numpy((rng.rand(1, 1, 16, 32) < 0.3).astype(np.uint8))
    ps = _params(rng, [(3, 1, 3, 3), (3,), (2, 3, 3, 3), (2,)])
    counts = ch.ENCODER.launches, ch.ENC3_FWD.launches
    ch._encoder_fwd_kernel(x, *ps, (2, 2), 0.0, 0)
    assert (ch.ENCODER.launches, ch.ENC3_FWD.launches) == (counts[0] + 1, counts[1])
    with pytest.raises(ValueError, match="4-byte"):
        odd = torch.zeros(16 * 32 + 1, dtype=torch.uint8)[1:].view(1, 1, 16, 32)
        ch._encoder_fwd_kernel(odd, *_params(rng, [(4, 1, 3, 3), (4,), (1, 4, 3, 3), (1,)]),
                               (4, 2), 0.0, 0)


@pytest.mark.parametrize("shape", [  # h, w, (c1, c2, p1, p2), instances
    (32, 8192, (2, 1, 4, 2), 512),      # the target on RND's 512 bands of 8192²
    (2064, 8192, (2, 1, 4, 2), 1),      # the target on a slot of 4 (its halo'd block)
    (32, 8192, (4, 1, 4, 2), 512),      # the predictor on the bands
    (2056, 8192, (4, 2, 2, 2), 1),      # AE2D's encoder on a slot
])
def test_encoder_plans_at_the_8192_shapes(shape):
    """The generic plans no longer give the whole width first: no one-row
    forward blocks of 213 KB for the target, no one-row stage-1 backward
    blocks at width 8192; every plan leaves at least two blocks a
    multiprocessor (shared memory at most 113 KB)."""
    h, w, (c1, c2, p1, p2), n = shape
    r2, _, smem = ch._encoder_fwd_plan(h, w, c1, c2, p1, p2, None, n)
    (r2b, _, smem2), (rb, _, smem1) = ch._encoder_bwd_bands(h, w, c1, c2, p1, p2, None, n)
    assert r2 > 1 and r2b > 1 and rb > 1
    for backward in (False, True):
        assert ch._enc3_plan(n, h, w, c1, c2, p1, backward)[2] <= 113 * 1024
    assert max(smem, smem2, smem1) <= 113 * 1024


@pytest.mark.parametrize("widths", [(4, 1, 4, 2), (2, 1, 4, 2), (4, 2, 2, 2), (3, 2, 2, 2)],
                         ids=["rnd", "target", "ae", "other"])
def test_encoder_outputs_equal_across_plans_emulated(emulated, monkeypatch, widths):
    """A block's rows and tile change what it recomputes, not what it
    computes: the generic and the specialised forwards give the same outputs
    bit for bit under every plan tried (and the same as each other)."""
    c1, c2, p1, p2 = widths
    n, h, w = 2, 64, 128
    x, ps, _, mask = _case(c1, c2, p1, p2, n, h, w, 23 + c1)
    ho, wo = h // (p1 * p2), w // (p1 * p2)
    outs = []
    for r2, tw in ((1, 1), (2, 3), (4, wo), (ho, 4), (ho, wo)):
        monkeypatch.setattr(ch, "_encoder_fwd_plan", lambda *a, r2=r2, tw=tw: (
            r2, tw, ch._encoder_smem(h, w, c1, c2, p1, p2, r2, tw)))
        monkeypatch.setattr(ch, "_enc3_plan", lambda *a, r2=r2, tw=tw: (
            r2, tw, ch._enc3_fwd_smem(c1, p1, r2, tw)))
        outs.append(_generic(monkeypatch, lambda: ch._encoder_fwd_kernel(
            x, *ps, (p1, p2), 0.1, 99, mask)))
        outs.append(ch._encoder_fwd_kernel(x, *ps, (p1, p2), 0.1, 99, mask))
    assert all(torch.equal(o, outs[0]) for o in outs)
