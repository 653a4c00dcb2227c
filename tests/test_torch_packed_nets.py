"""carle_tpu_torch vs carle_tpu: the net kernels fed the packed universe.

On the packed path the wrapper nets read the uint32 words [N, 1, H, W/32]
themselves (``_online.net_input``).  The port's plain twins unpack the words
(``cuda_head.cells``); the JAX kernels expand them in VMEM.  Here the port's
entry points with packed inputs run against the JAX kernels in interpret mode
fed the same words (``make_fused_encoder``, ``make_fused_ae_loss`` with src
and obs each packed or not, ``make_fused_decoder_loss``, ``make_fused_loss_tail``; ``make_fused_head``
takes cells only, so the port's head on words runs against it on the cells):
forwards rtol 1e-5, gradients 1e-5 of each leaf's
largest entry, the tolerances of tests/test_torch_head.py and
tests/test_torch_stages.py.  The twins on words also equal the twins on the
same cells as uint8 bit for bit; the kernels' packed loader is held against
their uint8 loader in tests/test_torch_emulated.py and on the card.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from carle_tpu.ops import bitpack as jbitpack
from carle_tpu.ops.pallas_head import (make_fused_ae_loss, make_fused_decoder_loss,
                                       make_fused_encoder, make_fused_head,
                                       make_fused_loss_tail)

from carle_tpu_torch import nets
from carle_tpu_torch.ops import bitpack, cuda_head, cuda_stages


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, H, W = 3, 32, 64
SEED0 = jnp.int32(0)


def _cells(rng, *shape):
    return (rng.rand(*shape) < 0.3).astype(np.uint8)


def _packed(cells):
    return np.array(jbitpack.pack_grid(jnp.asarray(cells)))


def _randn(rng, *shape, scale=0.3):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def _assert_leaves_close(got, want, tol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g.detach().numpy() / scale, w / scale, rtol=tol, atol=tol)


def test_packed_words_expand_to_the_cells():
    cells = _cells(np.random.RandomState(0), N, 1, H, W)
    words = torch.from_numpy(_packed(cells))
    assert words.dtype == torch.uint32 and words.shape == (N, 1, H, W // 32)
    assert cuda_head.cell_shape(words) == (N, 1, H, W)
    assert torch.equal(cuda_head.cells(words), torch.from_numpy(cells))
    assert [cuda_head.cell_kind(t) for t in (words, torch.from_numpy(cells),
                                             torch.zeros(1))] == [2, 1, 0]


@pytest.mark.parametrize("pools", [(4, 2), (2, 2)])
def test_encoder_on_packed_words_matches_jax_kernel(pools):
    p1, p2 = pools
    rng = np.random.RandomState(1)
    c1, c2 = (4, 1) if pools == (4, 2) else (4, 2)
    cells = _cells(rng, N, 1, H, W)
    x = _packed(cells)
    ps = [_randn(rng, c1, 1, 3, 3), _randn(rng, c1), _randn(rng, c2, c1, 3, 3), _randn(rng, c2)]
    co = _randn(rng, N, c2, H // (p1 * p2), W // (p1 * p2), scale=1.0)
    enc = make_fused_encoder(p1, p2, 0.0, train=False, interpret=True)
    ones = jnp.ones((H // p1, 1), jnp.float32)
    want = enc(jnp.asarray(x), *map(jnp.asarray, ps), SEED0, ones)
    jgrads = jax.grad(lambda *p: (enc(jnp.asarray(x), *p, SEED0, ones) * jnp.asarray(co)).sum(),
                      argnums=(0, 1, 2, 3))(*map(jnp.asarray, ps))
    tx = torch.from_numpy(x)
    tps = _leaves(ps)
    got = nets.conv_encoder(tx, {"w": tps[0], "b": tps[1]}, {"w": tps[2], "b": tps[3]},
                            pools=pools)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad((got * torch.from_numpy(co)).sum(), tps)
    _assert_leaves_close(grads, jgrads)
    on_cells = cuda_head.encoder_fwd(torch.from_numpy(cells), *map(torch.from_numpy, ps), pools)
    assert torch.equal(got.detach(), on_cells)


@pytest.mark.parametrize("kinds", [("u32", "u32"), ("u32", "u8"), ("u8", "u32")])
def test_ae_loss_on_packed_words_matches_jax_kernel(kinds):
    rng = np.random.RandomState(2)
    src_cells, obs_cells = _cells(rng, N, 1, H, W), _cells(rng, N, 1, H, W)
    src = _packed(src_cells) if kinds[0] == "u32" else src_cells
    obs = _packed(obs_cells) if kinds[1] == "u32" else obs_cells
    ps = [_randn(rng, 4, 1, 3, 3), _randn(rng, 4), _randn(rng, 2, 4, 3, 3), _randn(rng, 2),
          _randn(rng, 2, 1, 4, 4), _randn(rng, 1), _randn(rng, 1, 1, 4, 4), _randn(rng, 1)]
    gbar = _randn(rng, N, scale=1.0)
    ae = make_fused_ae_loss(2, 2, 0.0, False, interpret=True)
    mask = jnp.ones((H // 2, 1), jnp.float32)
    want = ae(jnp.asarray(src), *map(jnp.asarray, ps), jnp.asarray(obs), SEED0, mask)
    jgrads = jax.grad(lambda *p: jnp.sum(ae(jnp.asarray(src), *p, jnp.asarray(obs), SEED0, mask)
                                         * jnp.asarray(gbar)),
                      argnums=tuple(range(8)))(*map(jnp.asarray, ps))
    tps = _leaves(ps)
    got = cuda_head.ae_loss(torch.from_numpy(src), *tps, torch.from_numpy(obs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    grads = torch.autograd.grad((got * torch.from_numpy(gbar)).sum(), tps)
    _assert_leaves_close(grads, jgrads)
    on_cells = cuda_head.ae_loss_fwd(torch.from_numpy(src_cells), *map(torch.from_numpy, ps),
                                     torch.from_numpy(obs_cells))
    assert torch.equal(got.detach(), on_cells)


def test_decoder_loss_on_packed_obs_matches_jax_kernel():
    """Forward, the four parameter leaves and gx (the data of
    tests/test_torch_stages.py's decoder-loss case, obs packed)."""
    rng = np.random.RandomState(40)
    x = np.maximum(_randn(rng, N, 2, H // 4, W // 4, scale=1.0), 0)
    ps = [_randn(rng, 2, 1, 4, 4), _randn(rng, 1), _randn(rng, 1, 1, 4, 4), _randn(rng, 1)]
    obs = _packed(_cells(rng, N, 1, H, W))
    gbar = _randn(rng, N, scale=1.0)
    jobs, tobs = jnp.asarray(obs), torch.from_numpy(obs)
    dl = make_fused_decoder_loss(0.0, train=False, interpret=True)
    want = dl(jnp.asarray(x), *map(jnp.asarray, ps), jobs, SEED0)
    jgrads = jax.grad(lambda *a: (dl(*a, jobs, SEED0) * jnp.asarray(gbar)).sum(),
                      argnums=tuple(range(5)))(jnp.asarray(x), *map(jnp.asarray, ps))
    tx, *tps = _leaves((x, *ps))
    got = nets.conv_decoder_loss(tx, {"w": tps[0], "b": tps[1]}, {"w": tps[2], "b": tps[3]}, tobs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    _assert_leaves_close(torch.autograd.grad((got * torch.from_numpy(gbar)).sum(), (tx, *tps)),
                         jgrads)


def test_loss_tail_on_packed_obs_matches_jax_kernel():
    """The data of tests/test_torch_stages.py's loss-tail case, obs packed."""
    rng = np.random.RandomState(30)
    mid = np.maximum(_randn(rng, N, 1, H // 2, W // 2, scale=1.0), 0)
    wt, b = _randn(rng, 1, 1, 4, 4), _randn(rng, 1)
    obs = _packed(_cells(rng, N, 1, H, W))
    gbar = _randn(rng, N, scale=1.0)
    jobs, tobs = jnp.asarray(obs), torch.from_numpy(obs)
    lt = make_fused_loss_tail("sigmoid", 0.0, train=False, interpret=True)
    want = lt(jnp.asarray(mid), jnp.asarray(wt), jnp.asarray(b), jobs, SEED0)
    jgrads = jax.grad(lambda *a: (lt(*a, jobs, SEED0) * jnp.asarray(gbar)).sum(),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (mid, wt, b)))
    tm, tw, tb = _leaves((mid, wt, b))
    got = nets.conv_loss_tail(tm, {"w": tw, "b": tb}, tobs, act="sigmoid")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    _assert_leaves_close(torch.autograd.grad((got * torch.from_numpy(gbar)).sum(), (tm, tw, tb)),
                         jgrads)


def test_head_on_packed_words_matches_jax_kernel_on_the_cells():
    """The JAX head takes cells only (its wrapper casts before the kernel):
    the port's head on the words against it on the same cells."""
    rng = np.random.RandomState(4)
    cells = _cells(rng, N, 1, H, W)
    x = _packed(cells)
    w, b = _randn(rng, 4, 1, 3, 3), _randn(rng, 4)
    co = _randn(rng, N, 4, H // 2, W // 2, scale=1.0)
    head = make_fused_head(2, 0.0, train=False, interpret=True)
    want = head(jnp.asarray(cells), jnp.asarray(w), jnp.asarray(b), SEED0)
    jgrads = jax.grad(lambda *a: (head(jnp.asarray(cells), *a, SEED0) * jnp.asarray(co)).sum(),
                      argnums=(0, 1))(jnp.asarray(w), jnp.asarray(b))
    tw, tb = _leaves((w, b))
    got = nets.conv_head(torch.from_numpy(x), {"w": tw, "b": tb}, pool=2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    _assert_leaves_close(torch.autograd.grad((got * torch.from_numpy(co)).sum(), (tw, tb)),
                         jgrads)
    assert torch.equal(got.detach(), cuda_stages.head_fwd(
        bitpack.unpack_grid(torch.from_numpy(x), W), *map(torch.from_numpy, (w, b)), 2))
