"""carle_tpu_torch vs carle_tpu: the wrapper nets' fused forwards.

The JAX side runs its Pallas kernels in interpret mode
(``make_fused_encoder`` / ``make_fused_ae_loss`` with ``interpret=True``,
as tests/test_pallas_head.py does); the port's CPU path is the plain twin.
Tolerances: encoder outputs rtol 1e-5 / atol 1e-6 (float32 sums of at most
36 taps, in another order); AE errors rtol 1e-5 (float32 sums over the
universe).  The kernels themselves are held against these plain twins in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

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
