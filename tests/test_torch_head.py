"""carle_tpu_torch vs carle_tpu: the wrapper nets' fused conv stages,
forward and backward.

The JAX side runs its Pallas kernels in interpret mode
(``make_fused_encoder`` / ``make_fused_ae_loss`` with ``interpret=True``,
as tests/test_pallas_head.py does); the port's CPU path is the plain twin.
Tolerances: encoder outputs rtol 1e-5 / atol 1e-6 (float32 sums of at most
36 taps, in another order); AE errors rtol 1e-5 (float32 sums over the
universe); gradients rtol and atol 1e-5 after scaling each leaf by its
largest entry (sums over every position of the batch).  Dropout cannot be
compared bit for bit (the interpreter stubs the TPU's generator), so it is
held by its rate, its reproducibility and its effect on the gradients.  The
kernels themselves are held against these plain twins in
tests/test_torch_kernels.py and tests/test_torch_emulated.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from carle_tpu import nets as jnets
from carle_tpu.ops.pallas_head import make_fused_ae_loss, make_fused_encoder

from carle_tpu_torch import nets
from carle_tpu_torch.ops import cuda_head


def _params(rng, shapes):
    return [rng.randn(*s).astype(np.float32) * 0.3 for s in shapes]


def _encoder_case(seed, n, h, w, c1, c2):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, 1, h, w) < 0.3).astype(np.uint8)
    w1, b1, w2, b2 = _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])
    return x, w1, b1, w2, b2


def _ae_case(seed, n, h, w):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, 1, h, w) < 0.3).astype(np.uint8)
    ps = _params(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4),
                       (1,), (1, 1, 4, 4), (1,)])
    return x, ps


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("cfg", [  # (p1, p2, c1, c2): RND predictor, RND
    (4, 2, 4, 1), (4, 2, 2, 1), (2, 2, 4, 2),   # target, AE encoder
])
def test_encoder_matches_jax_kernel(cfg):
    p1, p2, c1, c2 = cfg
    x, w1, b1, w2, b2 = _encoder_case(0, 4, 32, 64, c1, c2)
    enc = make_fused_encoder(p1, p2, 0.0, train=False, interpret=True)
    ones = jnp.ones((x.shape[2] // p1, 1), jnp.float32)
    want = enc(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
               jnp.asarray(w2), jnp.asarray(b2), jnp.int32(0), ones)
    got = cuda_head.encoder_fwd(*_t([x, w1, b1, w2, b2]), (p1, p2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    p1_, p2_ = ({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
                for w, b in ((w1, b1), (w2, b2)))
    via_nets = nets.conv_encoder(torch.from_numpy(x), p1_, p2_, pools=(p1, p2))
    torch.testing.assert_close(via_nets, got, rtol=0, atol=0)


def test_ae_loss_matches_jax_kernel():
    x, ps = _ae_case(1, 3, 32, 32)
    ae = make_fused_ae_loss(2, 2, 0.0, train=False, interpret=True)
    ones = jnp.ones((x.shape[2] // 2, 1), jnp.float32)
    jx = jnp.asarray(x)
    want = ae(jx, *[jnp.asarray(p) for p in ps], jx, jnp.int32(0), ones)
    tx = torch.from_numpy(x)
    got = cuda_head.ae_loss_fwd(tx, *_t(ps), tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_ae_loss_matches_jax_unfused_at_universe_size():
    """The port's plain twin against the JAX package's unfused conv_ae_loss
    (its off-TPU path) at the battery's 256 x 256."""
    x, ps = _ae_case(2, 2, 256, 256)
    names = ["conv1", "conv2", "deconv1", "deconv2"]
    jp = [{"w": jnp.asarray(ps[2 * i]), "b": jnp.asarray(ps[2 * i + 1])}
          for i in range(4)]
    jx = jnp.asarray(x)
    want = jnets.conv_ae_loss(jx, *jp, jx, None, pools=(2, 2), drop_p=0.0,
                              train=False)
    tp = {n: {"w": torch.from_numpy(ps[2 * i]), "b": torch.from_numpy(ps[2 * i + 1])}
          for i, n in enumerate(names)}
    tx = torch.from_numpy(x)
    got = nets.conv_ae_loss(tx, tp["conv1"], tp["conv2"], tp["deconv1"],
                            tp["deconv2"], tx, pools=(2, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_layers_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 8, 12).astype(np.float32)
    conv = {"w": rng.randn(4, 3, 3, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    deconv = {"w": rng.randn(3, 2, 4, 4).astype(np.float32), "b": rng.randn(2).astype(np.float32)}
    dense = {"w": rng.randn(5, 3 * 8 * 12).astype(np.float32), "b": rng.randn(5).astype(np.float32)}

    def j(p):
        return {k: jnp.asarray(v) for k, v in p.items()}

    def t(p):
        return {k: torch.from_numpy(v) for k, v in p.items()}

    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (nets.conv2d(tx, t(conv), padding=1), jnets.conv2d(jx, j(conv), padding=1)),
        (nets.conv_transpose2d(tx, t(deconv)), jnets.conv_transpose2d(jx, j(deconv))),
        (nets.max_pool2(tx), jnets.max_pool2(jx)),
        (nets.linear(nets.flatten(tx), t(dense)), jnets.linear(jnets.flatten(jx), j(dense))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_reject_what_they_do_not_take():
    x, w1, b1, w2, b2 = _encoder_case(0, 2, 32, 32, 4, 1)
    with pytest.raises(ValueError, match="powers of two"):
        cuda_head.encoder_fwd(*_t([x, w1, b1, w2, b2]), (3, 2))
    meta = torch.empty((2, 1, 32, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        cuda_head.encoder_fwd(meta, *_t([w1, b1, w2, b2]), (4, 2))


# ---------------------------------------------------------------------------
# backward: gradients against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------


def _assert_leaves_close(got, want, tol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=tol, atol=tol)


def _autograd_leaves(fn, arrays):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    return torch.autograd.grad(fn(*leaves), leaves)


@pytest.mark.parametrize("cfg", [(4, 2, 4, 1), (2, 2, 4, 2)])  # RND, AE shapes
def test_encoder_grads_match_jax_kernel(cfg):
    p1, p2, c1, c2 = cfg
    x, w1, b1, w2, b2 = _encoder_case(5, 4, 32, 64, c1, c2)
    rng = np.random.RandomState(6)
    co = rng.randn(4, c2, 32 // (p1 * p2), 64 // (p1 * p2)).astype(np.float32)
    enc = make_fused_encoder(p1, p2, 0.0, train=False, interpret=True)
    ones = jnp.ones((x.shape[2] // p1, 1), jnp.float32)
    want = jax.grad(lambda *p: (enc(jnp.asarray(x), *p, jnp.int32(0), ones)
                                * jnp.asarray(co)).sum(),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, (w1, b1, w2, b2)))
    tx, tco = torch.from_numpy(x), torch.from_numpy(co)
    got = _autograd_leaves(
        lambda *p: (cuda_head.encoder(tx, *p, (p1, p2)) * tco).sum(), (w1, b1, w2, b2))
    _assert_leaves_close(got, want)
    explicit = cuda_head.encoder_bwd_plain(tx, *_t([w1, b1, w2, b2]), tco, (p1, p2))
    for a, b in zip(got, explicit):  # the Function's backward IS the twin
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ae_loss_grads_match_jax_kernel():
    rng = np.random.RandomState(11)
    src, ps = _ae_case(11, 4, 32, 32)
    obs = (rng.rand(4, 1, 32, 32) < 0.3).astype(np.uint8)  # src != obs
    gbar = rng.randn(4).astype(np.float32)
    ae = make_fused_ae_loss(2, 2, 0.0, False, interpret=True)
    mask = jnp.ones((16, 1), jnp.float32)
    want = jax.grad(lambda *p: jnp.sum(ae(jnp.asarray(src), *p, jnp.asarray(obs),
                                          jnp.int32(0), mask) * jnp.asarray(gbar)),
                    argnums=tuple(range(8)))(*map(jnp.asarray, ps))
    tsrc, tobs, tg = torch.from_numpy(src), torch.from_numpy(obs), torch.from_numpy(gbar)
    got = _autograd_leaves(
        lambda *p: (cuda_head.ae_loss(tsrc, *p, tobs) * tg).sum(), ps)
    _assert_leaves_close(got, want)


def _tie_case():
    """Cells that differ only in their neighbours tie: stage 1 weighs the
    centre tap alone, so every live cell of a pool window reaches the same
    maximum while its other taps (which dW1 sums) differ."""
    rng = np.random.RandomState(7)
    x = (rng.rand(2, 1, 32, 32) < 0.4).astype(np.uint8)
    x[0, 0, :8] = 0  # and a blank band, where whole windows tie at the bias
    w1, b1, w2, b2 = _params(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,)])
    centre = np.zeros_like(w1)
    centre[:, :, 1, 1] = np.abs(w1[:, :, 1, 1]) + 0.1
    co = rng.randn(2, 2, 8, 8).astype(np.float32)
    return x, centre, np.abs(b1) + 0.1, w2, np.abs(b2) + 0.1, co


def test_pool_ties_share_the_gradient_as_the_jax_kernel():
    x, w1, b1, w2, b2, co = _tie_case()
    enc = make_fused_encoder(2, 2, 0.0, train=False, interpret=True)
    ones = jnp.ones((16, 1), jnp.float32)
    want = jax.grad(lambda *p: (enc(jnp.asarray(x), *p, jnp.int32(0), ones)
                                * jnp.asarray(co)).sum(),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, (w1, b1, w2, b2)))
    tx, tco = torch.from_numpy(x), torch.from_numpy(co)
    got = _autograd_leaves(
        lambda *p: (cuda_head.encoder(tx, *p, (2, 2)) * tco).sum(), (w1, b1, w2, b2))
    _assert_leaves_close(got, want)

    def torch_own(w1, b1, w2, b2):  # F.max_pool2d's backward: all to one element
        z = F.max_pool2d(F.relu(F.conv2d(tx.float(), w1, b1, padding=1)), 2)
        return (F.max_pool2d(F.relu(F.conv2d(z, w2, b2, padding=1)), 2) * tco).sum()

    own = _autograd_leaves(torch_own, (w1, b1, w2, b2))
    worst = max(float((o - g).abs().max() / g.abs().max()) for o, g in zip(own, got))
    assert worst > 1e-2, "the case does not tie: torch's own backward agrees"


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_philox_known_answers():
    """Philox4x32-10 test vectors of the Random123 distribution."""
    def words(counter, key):
        c = [torch.tensor([v], dtype=torch.int64) for v in counter]
        return [int(w) for w in cuda_head.philox4x32(*c, key[0] | (key[1] << 32))]

    assert words([0, 0, 0, 0], [0, 0]) == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    ff = 0xffffffff
    assert words([ff] * 4, [ff, ff]) == [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]
    assert words([0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344],
                 [0xa4093822, 0x299f31d0]) == [0xd16cfe09, 0x94fdcceb, 0x5001e420,
                                               0x24126ea1]


def test_dropout_rate_and_reproducibility():
    shape, p = (4, 5, 64, 64), 0.1
    keep = cuda_head.philox_keep_mask(123, 0, shape, p, "cpu")
    n = keep.numel()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(1.0 - keep.float().mean().item() - p) < 3 * sigma
    assert torch.equal(keep, cuda_head.philox_keep_mask(123, 0, shape, p, "cpu"))
    for other in (cuda_head.philox_keep_mask(124, 0, shape, p, "cpu"),    # seed
                  cuda_head.philox_keep_mask(123, 1, shape, p, "cpu")):   # stage
        assert 0.1 < (other != keep).float().mean().item() < 0.25
    # an element's bit does not depend on the batch or the channels around it
    sub = cuda_head.philox_keep_mask(123, 0, (2, 3, 64, 64), p, "cpu")
    assert torch.equal(sub, keep[:2, :3])


def test_dropout_off_is_the_inference_path_and_on_reproduces():
    x, w1, b1, w2, b2 = _encoder_case(8, 3, 32, 32, 4, 2)
    args = _t([x, w1, b1, w2, b2])
    base = cuda_head.encoder_fwd(*args, (2, 2))
    plain = F.max_pool2d(F.relu(F.conv2d(F.max_pool2d(F.relu(F.conv2d(
        args[0].float(), args[1], args[2], padding=1)), 2), args[3], args[4],
        padding=1)), 2)
    assert torch.equal(base, plain)
    assert torch.equal(base, cuda_head.encoder_fwd(*args, (2, 2), 0.0, 99))
    p1_, p2_ = ({"w": a, "b": b} for a, b in ((args[1], args[2]), (args[3], args[4])))
    for kw in (dict(train=False, drop_p=0.1, seed=5), dict(train=True, drop_p=0.0, seed=5)):
        assert torch.equal(base, nets.conv_encoder(args[0], p1_, p2_, pools=(2, 2), **kw))
    a = nets.conv_encoder(args[0], p1_, p2_, pools=(2, 2), train=True, drop_p=0.1, seed=5)
    b = nets.conv_encoder(args[0], p1_, p2_, pools=(2, 2), train=True, drop_p=0.1, seed=5)
    c = nets.conv_encoder(args[0], p1_, p2_, pools=(2, 2), train=True, drop_p=0.1, seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, base)


def test_dropout_backward_uses_the_forward_mask():
    """Finite differences of the dropped forward agree with the backward twin
    only if both draw the same mask; the last stage's dropped cells give
    sigmoid(0) = 0.5 and pass no gradient."""
    rng = np.random.RandomState(12)
    src, ps = _ae_case(12, 2, 16, 16)
    tsrc = torch.from_numpy(src)
    gbar = torch.from_numpy(rng.randn(2).astype(np.float32))
    tps = [torch.from_numpy(p).double() for p in ps]

    def loss(*p):
        p32 = [q.float() for q in p]
        return (cuda_head.ae_loss_fwd_plain(tsrc, *p32, tsrc, (2, 2), 0.3, 77).double()
                * gbar.double()).sum()

    grads = cuda_head.ae_loss_bwd_plain(tsrc, *[q.float() for q in tps], tsrc, gbar,
                                        (2, 2), 0.3, 77)
    for leaf in (6, 7, 4, 1):  # wt2, bt2, wt1, b1
        flat = tps[leaf].reshape(-1)
        k = int(np.argmax(np.abs(grads[leaf].reshape(-1).numpy())))
        eps = 1e-2
        hi, lo = [t.clone() for t in tps], [t.clone() for t in tps]
        hi[leaf].reshape(-1)[k] += eps
        lo[leaf].reshape(-1)[k] -= eps
        fd = float(loss(*hi) - loss(*lo)) / (2 * eps)
        np.testing.assert_allclose(float(grads[leaf].reshape(-1)[k]), fd, rtol=5e-2)
    y = cuda_head._ae_planes(tsrc, *[q.float() for q in tps], (2, 2), 0.3, 77)[7]
    keep = cuda_head.philox_keep_mask(77, cuda_head.STAGE_DEC2, y.shape, 0.3, "cpu")
    assert torch.all(y[~keep] == 0.5) and (~keep).float().mean() > 0.2


def test_functions_build_no_graph_without_a_parameter_that_needs_one():
    x, w1, b1, w2, b2 = _encoder_case(9, 2, 32, 32, 4, 1)
    out = cuda_head.encoder(*_t([x, w1, b1, w2, b2]), (4, 2))
    assert not out.requires_grad and out.grad_fn is None
    leaves = [t.requires_grad_(True) for t in _t([w1, b1, w2, b2])]
    with torch.no_grad():
        assert cuda_head.encoder(torch.from_numpy(x), *leaves, (4, 2)).grad_fn is None
    assert cuda_head.encoder(torch.from_numpy(x), *leaves, (4, 2)).grad_fn is not None
