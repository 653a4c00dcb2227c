"""carle_tpu_torch vs carle_tpu: the wrapper nets' single stages (head, tail,
loss tail), the two-stage decoder loss, and the autoencoder built from one,
two and four kernels.

The JAX side runs its Pallas kernels in interpret mode (``make_fused_head``,
``make_fused_tail``, ``make_fused_loss_tail``, ``make_fused_decoder_loss``,
``make_fused_ae_loss`` with ``interpret=True``, as tests/test_pallas_head.py
does); the port's CPU path is the plain twin.  Inputs come from
``np.random.RandomState``.  Tolerances: forwards rtol 1e-5 / atol 1e-6
(float32 sums of at most 36 taps in another order), errors rtol 1e-5 (float32
sums over the universe), gradients rtol and atol 1e-5 after scaling each leaf
by its largest entry (sums over every position of the batch).  Dropout cannot
be compared with JAX bit for bit (the interpreter stubs the TPU's generator,
and the JAX compositions draw from different streams anyway): against JAX
only dropout-free results are held; among the port's three routes the masked
results are, since every route draws an element's bit from the same Philox
counter.  The kernels themselves are held against these twins in
tests/test_torch_emulated.py and tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from carle_tpu.mcl.ae import ae_forward as jae_forward
from carle_tpu.ops.pallas_head import (make_fused_ae_loss, make_fused_decoder_loss,
                                       make_fused_head, make_fused_loss_tail,
                                       make_fused_tail)

from carle_tpu_torch import nets
from carle_tpu_torch.mcl.ae import ae_forward
from carle_tpu_torch.ops import cuda_stages


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


def _randn(rng, *shape, scale=0.3):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _cells(rng, *shape, density=0.3):
    return (rng.rand(*shape) < density).astype(np.uint8)


def _assert_leaves_close(got, want, tol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=tol, atol=tol)


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def _ae_arrays(rng):
    shapes = [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)]
    return [_randn(rng, *s) for s in shapes]


def _param_dict(flat):
    names = ("conv1", "conv2", "deconv1", "deconv2")
    return {k: {"w": flat[2 * i], "b": flat[2 * i + 1]} for i, k in enumerate(names)}


# ---------------------------------------------------------------------------
# head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("pool", [2, 4])
def test_head_matches_jax_kernel(pool, c, need_dx):
    rng = np.random.RandomState(10 * pool + c)
    x = np.maximum(_randn(rng, N, c, H, W, scale=1.0), 0)   # a relu output: zeros tie
    w, b = _randn(rng, 4, c, 3, 3), _randn(rng, 4)
    co = _randn(rng, N, 4, H // pool, W // pool, scale=1.0)
    head = make_fused_head(pool, 0.0, train=False, interpret=True, need_dx=need_dx)
    want = head(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), SEED0)
    jgrads = jax.grad(lambda x_, w_, b_: (head(x_, w_, b_, SEED0) * jnp.asarray(co)).sum(),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    tx, tw, tb = _leaves((x, w, b))
    p = {"w": tw, "b": tb}
    got = nets.conv_head(tx, p, pool=pool, need_dx=need_dx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    leaves = (tx, tw, tb) if need_dx else (tw, tb)
    grads = torch.autograd.grad((got * torch.from_numpy(co)).sum(), leaves)
    _assert_leaves_close(grads, jgrads if need_dx else jgrads[1:])
    if not need_dx:   # the JAX rule's input cotangent is then structurally zero
        assert not np.asarray(jgrads[0]).any()


def test_head_takes_the_uint8_observation():
    rng = np.random.RandomState(3)
    x, w, b = _cells(rng, N, 1, H, W), _randn(rng, 4, 1, 3, 3), _randn(rng, 4)
    head = make_fused_head(2, 0.0, train=False, interpret=True)
    want = head(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), SEED0)  # cast outside
    got = cuda_stages.head_fwd(*map(torch.from_numpy, (x, w, b)), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_head_pool_ties_share_the_gradient_as_the_jax_kernel():
    """The weights weigh the centre tap alone, so every positive cell of a
    window with equal centres ties while the other taps (which dW sums and gx
    spreads) differ; F.max_pool2d's own backward sends all to one element."""
    rng = np.random.RandomState(7)
    x = (rng.rand(2, 2, 16, 32) < 0.5).astype(np.float32)
    x[0, :, :4] = 0   # a blank band: whole windows tie at the bias
    w = np.zeros((3, 2, 3, 3), np.float32)
    w[:, :, 1, 1] = np.abs(_randn(rng, 3, 2)) + 0.1
    b = np.abs(_randn(rng, 3)) + 0.1
    co = _randn(rng, 2, 3, 8, 16, scale=1.0)
    head = make_fused_head(2, 0.0, train=False, interpret=True, need_dx=True)
    want = jax.grad(lambda x_, w_, b_: (head(x_, w_, b_, SEED0) * jnp.asarray(co)).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    tco = torch.from_numpy(co)
    leaves = _leaves((x, w, b))
    got = torch.autograd.grad(
        (cuda_stages.head(*leaves, 2, need_dx=True) * tco).sum(), leaves)
    _assert_leaves_close(got, want)
    own_leaves = _leaves((x, w, b))
    own = torch.autograd.grad(
        (F.max_pool2d(F.relu(F.conv2d(own_leaves[0], own_leaves[1], own_leaves[2], padding=1)),
                      2) * tco).sum(), own_leaves)
    worst = max(float((o - g).abs().max() / g.abs().max()) for o, g in zip(own, got))
    assert worst > 1e-2, "the case does not tie: torch's own backward agrees"


# ---------------------------------------------------------------------------
# tail, loss tail, decoder loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin", [1, 2])
@pytest.mark.parametrize("act", ["relu", "sigmoid"])
def test_tail_matches_jax_kernel(act, cin):
    rng = np.random.RandomState(20 + cin)
    x = np.maximum(_randn(rng, N, cin, H // 2, W // 2, scale=1.0), 0)
    wt, b = _randn(rng, cin, 2, 4, 4), _randn(rng, 2)
    co = _randn(rng, N, 2, H, W, scale=1.0)
    tail = make_fused_tail(act, 0.0, train=False, interpret=True)
    want = tail(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), SEED0)
    jgrads = jax.grad(lambda x_, w_, b_: (tail(x_, w_, b_, SEED0) * jnp.asarray(co)).sum(),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (x, wt, b)))
    tx, tw, tb = _leaves((x, wt, b))
    got = nets.conv_tail(tx, {"w": tw, "b": tb}, act=act)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad((got * torch.from_numpy(co)).sum(), (tx, tw, tb))
    _assert_leaves_close(grads, jgrads)


@pytest.mark.parametrize("act", ["relu", "sigmoid"])
@pytest.mark.parametrize("obs_dtype", [np.uint8, np.float32])
def test_loss_tail_matches_jax_kernel(obs_dtype, act):
    rng = np.random.RandomState(30)
    x = np.maximum(_randn(rng, N, 1, H // 2, W // 2, scale=1.0), 0)
    wt, b = _randn(rng, 1, 1, 4, 4), _randn(rng, 1)
    obs = _cells(rng, N, 1, H, W).astype(obs_dtype)
    gbar = _randn(rng, N, scale=1.0)
    lt = make_fused_loss_tail(act, 0.0, train=False, interpret=True)
    jobs = jnp.asarray(obs)
    want = lt(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), jobs, SEED0)
    jgrads = jax.grad(lambda x_, w_, b_: (lt(x_, w_, b_, jobs, SEED0) * jnp.asarray(gbar)).sum(),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (x, wt, b)))
    tx, tw, tb = _leaves((x, wt, b))
    got = nets.conv_loss_tail(tx, {"w": tw, "b": tb}, torch.from_numpy(obs), act=act)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    grads = torch.autograd.grad((got * torch.from_numpy(gbar)).sum(), (tx, tw, tb))
    _assert_leaves_close(grads, jgrads)


@pytest.mark.parametrize("obs_dtype", [np.uint8, np.float32])
def test_decoder_loss_matches_jax_kernel(obs_dtype):
    """Forward, the four parameter leaves and gx, the embedding's cotangent."""
    rng = np.random.RandomState(40)
    x = np.maximum(_randn(rng, N, 2, H // 4, W // 4, scale=1.0), 0)
    ps = [_randn(rng, 2, 1, 4, 4), _randn(rng, 1), _randn(rng, 1, 1, 4, 4), _randn(rng, 1)]
    obs = _cells(rng, N, 1, H, W).astype(obs_dtype)
    gbar = _randn(rng, N, scale=1.0)
    dl = make_fused_decoder_loss(0.0, train=False, interpret=True)
    jobs = jnp.asarray(obs)
    want = dl(jnp.asarray(x), *map(jnp.asarray, ps), jobs, SEED0)
    jgrads = jax.grad(lambda *a: (dl(*a, jobs, SEED0) * jnp.asarray(gbar)).sum(),
                      argnums=tuple(range(5)))(jnp.asarray(x), *map(jnp.asarray, ps))
    tx, *tps = _leaves((x, *ps))
    p1, p2 = {"w": tps[0], "b": tps[1]}, {"w": tps[2], "b": tps[3]}
    got = nets.conv_decoder_loss(tx, p1, p2, torch.from_numpy(obs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    grads = torch.autograd.grad((got * torch.from_numpy(gbar)).sum(), (tx, *tps))
    _assert_leaves_close(grads, jgrads)
    explicit = cuda_stages.decoder_loss_bwd_plain(
        *map(torch.from_numpy, (x, *ps, obs, gbar)))
    for a, e in zip(grads, (explicit[4], *explicit[:4])):   # the Function's backward IS the twin
        torch.testing.assert_close(a, e, rtol=0, atol=0)


def test_ae_loss_with_a_source_that_is_not_the_target_matches_jax_kernel():
    """PredictionBonus's call: src is a ring frame, obs the current frame."""
    rng = np.random.RandomState(50)
    src, obs = _cells(rng, N, 1, H, W), _cells(rng, N, 1, H, W, density=0.4)
    ps = _ae_arrays(rng)
    gbar = _randn(rng, N, scale=1.0)
    ae = make_fused_ae_loss(2, 2, 0.0, False, interpret=True)
    mask = jnp.ones((H // 2, 1), jnp.float32)
    jsrc, jobs = jnp.asarray(src), jnp.asarray(obs)
    want = ae(jsrc, *map(jnp.asarray, ps), jobs, SEED0, mask)
    jgrads = jax.grad(lambda *p: (ae(jsrc, *p, jobs, SEED0, mask) * jnp.asarray(gbar)).sum(),
                      argnums=tuple(range(8)))(*map(jnp.asarray, ps))
    tsrc, tobs = torch.from_numpy(src), torch.from_numpy(obs)
    leaves = _leaves(ps)
    got = nets.conv_ae_loss(tsrc, *_param_dict(leaves).values(), tobs, pools=(2, 2))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    same = nets.conv_ae_loss(tsrc, *_param_dict(leaves).values(), tsrc, pools=(2, 2))
    assert not torch.allclose(got, same)
    grads = torch.autograd.grad((got * torch.from_numpy(gbar)).sum(), leaves)
    _assert_leaves_close(grads, jgrads)


# ---------------------------------------------------------------------------
# the autoencoder by one, two and four kernels
# ---------------------------------------------------------------------------


def _routes(flat, src, obs, **kw):
    """{route: (error, gradients of its mean)} over fresh leaves of ``flat``."""
    out = {}
    for route in ("one", "two", "four"):
        leaves = _leaves(flat)
        p = _param_dict(leaves)
        if route == "one":
            err = nets.conv_ae_loss(src, *p.values(), obs, pools=(2, 2), **kw)
        elif route == "two":
            emb = nets.conv_encoder(src, p["conv1"], p["conv2"], pools=(2, 2), **kw)
            err = nets.conv_decoder_loss(emb, p["deconv1"], p["deconv2"], obs, **kw)
        else:
            err = nets.ae_loss_by_stages(p, src, obs, **kw)
        out[route] = (err.detach(), torch.autograd.grad(err.mean(), leaves))
    return out


@pytest.mark.parametrize("drop_p", [0.0, 0.1, 0.5])
def test_three_routes_agree(drop_p):
    """With one seed the three routes apply one dropout mask."""
    rng = np.random.RandomState(60)
    src = torch.from_numpy(_cells(rng, N, 1, H, W))
    obs = torch.from_numpy(_cells(rng, N, 1, H, W))
    flat = _ae_arrays(rng)
    res = _routes(flat, src, obs, drop_p=drop_p, train=True, seed=4242)
    for route in ("two", "four"):
        torch.testing.assert_close(res[route][0], res["one"][0], rtol=1e-5, atol=0)
        _assert_leaves_close(res[route][1], [g.numpy() for g in res["one"][1]])
    plain = _routes(flat, src, obs)["one"][0]
    assert torch.equal(plain, res["one"][0]) == (drop_p == 0.0)
    other = _routes(flat, src, obs, drop_p=drop_p, train=True, seed=4243)["four"][0]
    assert torch.equal(other, res["four"][0]) == (drop_p == 0.0)


def test_stage_route_matches_jax_stage_by_stage():
    """nets.ae_loss_by_stages against the JAX package's own composition of
    head, head with need_dx, tail and loss tail, error and all 8 leaves."""
    rng = np.random.RandomState(70)
    obs = _cells(rng, 2, 1, H, W)
    flat = _ae_arrays(rng)
    h1 = make_fused_head(2, 0.0, train=False, interpret=True)
    h2 = make_fused_head(2, 0.0, train=False, interpret=True, need_dx=True)
    t1 = make_fused_tail("relu", 0.0, train=False, interpret=True)
    lt = make_fused_loss_tail("sigmoid", 0.0, train=False, interpret=True)
    jobs = jnp.asarray(obs)

    def fused(*p):
        x = h1(jobs, p[0], p[1], SEED0)
        x = h2(x, p[2], p[3], SEED0)
        x = t1(x, p[4], p[5], SEED0)
        return lt(x, p[6], p[7], jobs, SEED0)

    jps = tuple(map(jnp.asarray, flat))
    want = fused(*jps)
    jgrads = jax.grad(lambda *p: fused(*p).mean(), argnums=tuple(range(8)))(*jps)
    leaves = _leaves(flat)
    tobs = torch.from_numpy(obs)
    got = nets.ae_loss_by_stages(_param_dict(leaves), tobs, tobs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    _assert_leaves_close(torch.autograd.grad(got.mean(), leaves), jgrads)


def test_ae_forward_matches_jax_and_the_loss():
    rng = np.random.RandomState(80)
    obs = _cells(rng, 2, 1, H, W)
    flat = _ae_arrays(rng)
    jparams = {k: {n: jnp.asarray(a) for n, a in v.items()}
               for k, v in _param_dict(flat).items()}
    want = jae_forward(jparams, jnp.asarray(obs), None, False, fused_head=True)
    tparams = _param_dict([torch.from_numpy(a) for a in flat])
    tobs = torch.from_numpy(obs)
    got = ae_forward(tparams, tobs)
    assert got.shape == (2, 1, H, W) and got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    err = ((tobs.float() - got) ** 2).sum(dim=(1, 2, 3))
    torch.testing.assert_close(
        err, nets.conv_ae_loss(tobs, *tparams.values(), tobs, pools=(2, 2)),
        rtol=1e-5, atol=0)
    # with dropout: the mask of the whole-autoencoder kernel's seed
    dropped = ae_forward(tparams, tobs, train=True, seed=9)
    err = ((tobs.float() - dropped) ** 2).sum(dim=(1, 2, 3))
    torch.testing.assert_close(
        err, nets.conv_ae_loss(tobs, *tparams.values(), tobs, pools=(2, 2), drop_p=0.1,
                               train=True, seed=9), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the functions' checks
# ---------------------------------------------------------------------------


def test_stage_functions_reject_what_they_do_not_take():
    rng = np.random.RandomState(90)
    x = torch.from_numpy(_randn(rng, 2, 1, 16, 16))
    conv = {"w": torch.from_numpy(_randn(rng, 2, 1, 3, 3)), "b": torch.zeros(2)}
    deconv = {"w": torch.from_numpy(_randn(rng, 1, 1, 4, 4)), "b": torch.zeros(1)}
    obs = torch.zeros((2, 1, 32, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="power of two"):
        nets.conv_head(x, conv, pool=3)
    with pytest.raises(ValueError, match="requires a seed"):
        nets.conv_head(x, conv, pool=2, drop_p=0.1, train=True)
    with pytest.raises(ValueError, match="requires a seed"):
        nets.conv_loss_tail(x, deconv, obs, act="sigmoid", drop_p=0.1, train=True)
    with pytest.raises(ValueError, match="relu"):
        nets.conv_tail(x, deconv, act="tanh")
    meta = torch.empty((2, 1, 16, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        cuda_stages.tail_fwd(meta, deconv["w"], deconv["b"], "relu")
    # drop_p without train, and train without drop_p, are the inference path
    base = nets.conv_tail(x, deconv, act="sigmoid")
    assert torch.equal(base, nets.conv_tail(x, deconv, act="sigmoid", drop_p=0.1))
    assert torch.equal(base, nets.conv_tail(x, deconv, act="sigmoid", train=True))
    assert not torch.equal(base, nets.conv_tail(x, deconv, act="sigmoid", drop_p=0.1,
                                                train=True, seed=1))


def test_stage_functions_build_no_graph_without_a_gradient_request():
    rng = np.random.RandomState(91)
    x = torch.from_numpy(_randn(rng, 2, 1, 16, 16))
    wt, b = torch.from_numpy(_randn(rng, 1, 1, 4, 4)), torch.zeros(1)
    obs = torch.zeros((2, 1, 32, 32), dtype=torch.uint8)
    assert cuda_stages.tail(x, wt, b, "relu").grad_fn is None
    assert cuda_stages.loss_tail(x, wt, b, obs).grad_fn is None
    wt.requires_grad_(True)
    with torch.no_grad():
        assert cuda_stages.tail(x, wt, b, "relu").grad_fn is None
    err = cuda_stages.loss_tail(x, wt, b, obs)
    assert err.grad_fn is not None
    (g,) = torch.autograd.grad(err.sum(), (wt,))   # obs takes no gradient
    assert g.shape == wt.shape
    # a head's input cotangent only with need_dx
    w3, b3 = torch.from_numpy(_randn(rng, 2, 1, 3, 3)), torch.zeros(2)
    xg = x.clone().requires_grad_(True)
    assert cuda_stages.head(xg, w3, b3, 2).grad_fn is None
    assert cuda_stages.head(xg, w3, b3, 2, need_dx=True).grad_fn is not None
