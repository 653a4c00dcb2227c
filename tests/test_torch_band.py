"""carle_tpu_torch vs carle_tpu: band tiling on one device.

The encoder with its per-instance stage-1 row mask against
``make_fused_encoder`` and the row-weighted decoder loss against
``make_fused_decoder_loss_banded`` (Pallas in interpret mode, as
tests/test_pallas_head.py runs them); ``parallel/band_heads.py`` against the
JAX package's with ``force_kernel=True`` and against the port's own global
functions; the learning wrappers with ``fused_head=BandTiling(4)`` against
the JAX stacks (which run their global functions on the CPU), dropout off;
the errors band tiling raises, against the JAX package's messages; the
whole-autoencoder route's size predicate.

Inputs come from numpy seeds; wrapper parameters cross by the weight
carrier.  Tolerances: values rtol 1e-5 / atol 1e-6 (float32 sums in another
order), gradients 1e-5 of each leaf's largest entry (sums over every
position), learning stacks through 4 Adam updates rtol 2e-3 (Adam divides by
the gradient's own scale).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import carle_tpu.mcl as jmcl
from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu import nets as jnets
from carle_tpu.checkpoint import _path_str
from carle_tpu.mcl import packed_stats as jpacked_stats
from carle_tpu.ops.bitpack import pack_grid as jpack_grid
from carle_tpu.ops.pallas_head import make_fused_decoder_loss_banded, make_fused_encoder
from carle_tpu.parallel import band_heads as jband
from carle_tpu.parallel.packed_env import PackedSpatialStack as JPackedSpatialStack
from carle_tpu.rollout import Rollout as JRollout

from carle_tpu_torch import EnvConfig, nets, rules
from carle_tpu_torch import mcl as tmcl
from carle_tpu_torch.checkpoint import learner_state_from_numpy
from carle_tpu_torch.mcl.ae import ae_forward, init_ae_params
from carle_tpu_torch.ops import bitpack, cuda_head, cuda_stages
from carle_tpu_torch.parallel import band_heads
from carle_tpu_torch.parallel.packed_env import PackedSpatialStack
from carle_tpu_torch.rollout import Rollout


def _draw(rng, shapes, scale=0.3):
    return [rng.randn(*s).astype(np.float32) * scale for s in shapes]


def _leaf_close(got, want, tol=1e-5):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g / scale, w / scale, rtol=tol, atol=tol)


def _tparams(arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def _packs(ts, keys):
    return {k: {"w": ts[2 * i], "b": ts[2 * i + 1]} for i, k in enumerate(keys)}


# ---------------------------------------------------------------------------
# the kernel features: row 3's mask, row 6's row weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pools, c1, c2", [((2, 2), 4, 2), ((4, 2), 4, 1)])
def test_masked_encoder_matches_jax_kernel(pools, c1, c2):
    """Forward and the 4 gradients under a per-instance stage-1 row mask with
    zeroed rows at both edges and inside."""
    p1, p2 = pools
    rng = np.random.RandomState(40 + p1)
    n, h, w = 2, 16, 32
    x = (rng.rand(n, 1, h, w) < 0.3).astype(np.uint8)
    ps = _draw(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])
    ps[1], ps[3] = np.abs(ps[1]), np.abs(ps[3])
    mask = (rng.rand(n, h // p1) < 0.7).astype(np.float32)
    mask[0, :2] = 0.0
    mask[1, -1] = 0.0
    g = rng.randn(n, c2, h // (p1 * p2), w // (p1 * p2)).astype(np.float32)
    enc = make_fused_encoder(p1, p2, 0.0, train=False, interpret=True)
    jm = jnp.asarray(mask)[:, :, None]

    def jloss(*params):
        out = enc(jnp.asarray(x), *params, jnp.int32(0), jm)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, ps))
    ts = _tparams(ps)
    got = cuda_head.encoder(torch.from_numpy(x), *ts, pools, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    unmasked = cuda_head.encoder_fwd(torch.from_numpy(x), *map(torch.from_numpy, ps), pools)
    assert not torch.equal(got.detach(), unmasked)
    grads = torch.autograd.grad((got * torch.from_numpy(g)).sum(), ts)
    _leaf_close([t.numpy() for t in grads], jgrads)


@pytest.mark.parametrize("packed", [False, True])
def test_row_weighted_decoder_loss_matches_jax_kernel(packed):
    """Value, the 4 parameter gradients and gx under error row weights em
    (zeros, ones and fractions)."""
    rng = np.random.RandomState(50 + packed)
    n, he, we = 2, 4, 8
    x = np.maximum(rng.randn(n, 2, he, we), 0).astype(np.float32)
    ps = _draw(rng, [(2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)])
    cells = (rng.rand(n, 1, 4 * he, 4 * we) < 0.3).astype(np.uint8)
    em = np.where(rng.rand(n, 4 * he) < 0.3, 0.0, rng.rand(n, 4 * he) + 0.5).astype(np.float32)
    jobs = jpack_grid(jnp.asarray(cells)) if packed else jnp.asarray(cells)
    tobs = bitpack.pack_grid(torch.from_numpy(cells)) if packed else torch.from_numpy(cells)
    dl = make_fused_decoder_loss_banded(0.0, train=False, interpret=True)

    def jloss(xx, *params):
        err = dl(xx, *params, jobs, jnp.int32(0), jnp.asarray(em)[:, :, None])
        return jnp.sum(err * jnp.asarray([1.0, -0.5])), err

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        jnp.asarray(x), *map(jnp.asarray, ps))
    tx, *ts = _tparams([x] + ps)
    got = cuda_stages.decoder_loss(tx, *ts, tobs, em=torch.from_numpy(em))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad((got * torch.tensor([1.0, -0.5])).sum(), [tx] + ts)
    _leaf_close([t.numpy() for t in grads], jgrads)
    ones = torch.ones(n, 4 * he)
    assert torch.equal(cuda_stages.decoder_loss_fwd(tx.detach(), *[t.detach() for t in ts],
                                                    tobs, em=ones),
                       cuda_stages.decoder_loss_fwd(tx.detach(), *[t.detach() for t in ts],
                                                    tobs))


# ---------------------------------------------------------------------------
# parallel/band_heads.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("pools", [(2, 2), (4, 2)])
def test_encoder_banded_matches_jax_and_global(pools, packed):
    rng = np.random.RandomState(21)
    n, h, w = 2, 64, 64
    cells = (rng.rand(n, h, w) < 0.3).astype(np.uint8)
    ps = _draw(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,)])
    ps[1], ps[3] = ps[1] / 3, ps[3] / 3
    jp1, jp2 = ({"w": jnp.asarray(ps[i]), "b": jnp.asarray(ps[i + 1])} for i in (0, 2))
    jx = jpack_grid(jnp.asarray(cells))[:, None] if packed else jnp.asarray(cells)[:, None]
    tx = bitpack.pack_grid(torch.from_numpy(cells))[:, None] if packed else \
        torch.from_numpy(cells)[:, None]
    want = jband.encoder_banded(jx, jp1, jp2, None, pools=pools, drop_p=0.0, train=False,
                                tiling=jnets.BandTiling(4), force_kernel=True)
    ts = _tparams(ps)
    tp = _packs(ts, ("p1", "p2"))
    got = nets.conv_encoder(tx, tp["p1"], tp["p2"], pools=pools, mesh=nets.BandTiling(4))
    glob = nets.conv_encoder(tx, tp["p1"], tp["p2"], pools=pools)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), glob.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    g = torch.from_numpy(rng.randn(*got.shape).astype(np.float32))
    _leaf_close(torch.autograd.grad((got * g).sum(), ts),
                torch.autograd.grad((glob * g).sum(), ts))


def test_decoder_loss_banded_matches_jax_and_global():
    """Per-band row-weighted errors add up to the global loss; parameter
    gradients and the embedding cotangent match."""
    rng = np.random.RandomState(22)
    n, he = 2, 16
    x = rng.randn(n, 2, he, he).astype(np.float32)
    ps = _draw(rng, [(2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)])
    obs = (rng.rand(n, 1, 4 * he, 4 * he) < 0.3).astype(np.uint8)
    jpd1, jpd2 = ({"w": jnp.asarray(ps[i]), "b": jnp.asarray(ps[i + 1])} for i in (0, 2))

    def jloss(xx, w1):
        return jnp.sum(jband.decoder_loss_banded(
            xx, {"w": w1, "b": jpd1["b"]}, jpd2, jnp.asarray(obs), None, drop_p=0.0,
            train=False, tiling=jnets.BandTiling(4), force_kernel=True))

    want = float(jloss(jnp.asarray(x), jpd1["w"]))
    jgrads = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jpd1["w"])
    tx, *ts = _tparams([x] + ps)
    tp = _packs(ts, ("pd1", "pd2"))
    got = nets.conv_decoder_loss(tx, tp["pd1"], tp["pd2"], torch.from_numpy(obs),
                                 mesh=nets.BandTiling(4))
    glob = nets.conv_decoder_loss(tx, tp["pd1"], tp["pd2"], torch.from_numpy(obs))
    np.testing.assert_allclose(float(got.detach().sum()), want, rtol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), glob.detach().numpy(), rtol=1e-5)
    grads = torch.autograd.grad(got.sum(), [tx] + ts)
    _leaf_close([grads[0], grads[1]], jgrads)
    _leaf_close(grads, torch.autograd.grad(glob.sum(), [tx] + ts))


def test_ae_loss_banded_matches_jax_and_global():
    """The banded autoencoder's error against the JAX package's banded
    composition, and with its 8 gradients against the port's whole-AE kernel
    twin (the banded pieces' gradients meet the JAX package's above); fed the
    packed words, the same bits as fed the cells."""
    rng = np.random.RandomState(23)
    n, h = 1, 32
    src = (rng.rand(n, 1, h, h) < 0.3).astype(np.uint8)
    obs = (rng.rand(n, 1, h, h) < 0.3).astype(np.uint8)
    ps = _draw(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4), (1,),
                     (1, 1, 4, 4), (1,)])
    keys = ("p1", "p2", "pd1", "pd2")

    def jloss(*params):
        jp = {k: {"w": params[2 * i], "b": params[2 * i + 1]} for i, k in enumerate(keys)}
        return jnp.sum(jnets.conv_ae_loss(jnp.asarray(src), jp["p1"], jp["p2"], jp["pd1"],
                                          jp["pd2"], jnp.asarray(obs), None, pools=(2, 2),
                                          drop_p=0.0, train=False, force_kernel=True,
                                          mesh=jnets.BandTiling(2)))

    want = jloss(*map(jnp.asarray, ps))
    ts = _tparams(ps)
    tp = _packs(ts, keys)
    params = (tp["p1"], tp["p2"], tp["pd1"], tp["pd2"])
    cells = (torch.from_numpy(src), torch.from_numpy(obs))
    got = nets.conv_ae_loss(cells[0], *params, cells[1], pools=(2, 2), mesh=nets.BandTiling(2))
    glob = nets.conv_ae_loss(cells[0], *params, cells[1], pools=(2, 2))
    words = nets.conv_ae_loss(*(bitpack.pack_grid(c) for c in cells[:1]), *params,
                              bitpack.pack_grid(cells[1]), pools=(2, 2),
                              mesh=nets.BandTiling(2))
    np.testing.assert_allclose(float(got.detach().sum()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), glob.detach().numpy(), rtol=1e-5)
    assert torch.equal(words.detach(), got.detach())
    grads = torch.autograd.grad(got.sum(), ts)
    _leaf_close(grads, torch.autograd.grad(glob.sum(), ts))
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(words.sum(), ts), grads))


def test_band_input_slices_exact_halos_and_zero_edges():
    x = torch.arange(2 * 16 * 3, dtype=torch.int32).view(2, 1, 16, 3).to(torch.uint8)
    xb = band_heads._band_input(x, 4, 2)
    assert xb.shape == (8, 1, 8, 3)
    want = np.asarray(jband._band_input(jnp.asarray(x.numpy()), 4, 2))
    np.testing.assert_array_equal(xb.numpy(), want)
    words = bitpack.pack_grid(torch.from_numpy(
        (np.random.RandomState(0).rand(2, 1, 16, 64) < 0.5).astype(np.uint8)))
    wb = band_heads._band_input(words, 4, 2)
    assert wb.dtype == torch.uint32
    np.testing.assert_array_equal(
        wb.view(torch.int32).numpy(),
        np.asarray(jband._band_input(jnp.asarray(words.view(torch.int32).numpy()), 4, 2)))
    y = torch.randn(8, 2, 3, 5)
    np.testing.assert_array_equal(band_heads._unband(y, 2, 4).numpy(),
                                  np.asarray(jband._unband(jnp.asarray(y.numpy()), 2, 4)))


# ---------------------------------------------------------------------------
# the wrappers with fused_head=BandTiling(4), against the JAX stacks
# ---------------------------------------------------------------------------

CFG = EnvConfig(64, 96, 16, 16, 3)
JCFG = JEnvConfig(height=64, width=96, action_height=16, action_width=16, instances=3)
KW = dict(train=True, dropout=False, batch_size=2)


def _flat_numpy(tree):
    return {_path_str(p): np.array(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _run_pair(jdefs, tdefs, packed, steps=8):
    """Both stacks from the JAX stack's initial learner states with
    numpy-drawn parameters, one action stream; (port rewards, JAX rewards,
    port carry, JAX carry)."""
    rng = np.random.RandomState(3)
    jstack = JPackedSpatialStack(JCFG, jdefs, mesh=None) if packed else None
    jro = JRollout(JCFG, jdefs, stack=jstack)
    tro = Rollout(CFG, tdefs, device="cpu",
                  stack=PackedSpatialStack(CFG, tdefs) if packed else None)
    jcarry = jro.init(jax.random.PRNGKey(1), rules.LIFE)
    carry = tro.init(tro.generator(0), rules.LIFE)
    jw, tw = [], []
    for js in jcarry.stack.wrappers:
        flat = {k: (rng.randn(*v.shape).astype(np.float32) * 0.3
                    if k.startswith(("params/", "target_params/")) else v)
                for k, v in _flat_numpy(js).items()}
        leaves = jax.tree_util.tree_flatten_with_path(js)[0]
        jw.append(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(js),
            [jnp.asarray(flat[_path_str(p)]) for p, _ in leaves]))
        tw.append(learner_state_from_numpy(flat, "cpu"))
    jcarry = jcarry._replace(stack=jcarry.stack._replace(wrappers=tuple(jw)))
    carry = carry._replace(stack=carry.stack._replace(wrappers=tuple(tw)))
    acts = (rng.rand(steps, *CFG.action_shape) < 0.4).astype(np.float32)
    jcarry, want = jro.run_actions(jcarry, jnp.asarray(acts))
    carry, got = tro.run_actions(carry, torch.from_numpy(acts))
    return got.numpy(), np.asarray(want), carry, jcarry


@pytest.mark.parametrize("packed", [False, True])
def test_learners_banded_match_jax_through_adam_updates(packed):
    """RND2D, AE2D, PredictionBonus and SurpriseBonus (dense, on the uint8
    stack) and the packed-ring Prediction and Surprise with RND2D (on the
    packed stack), all with BandTiling(4)."""
    tiling, jtiling = nets.BandTiling(4), jnets.BandTiling(4)
    if packed:
        jdefs = [jpacked_stats.prediction_def_packed(JCFG, fused_head=jtiling, **KW),
                 jpacked_stats.surprise_def_packed(JCFG, reward_scale=0.5,
                                                   fused_head=jtiling, **KW),
                 jmcl.rnd2d_def(JCFG, fused_head=jtiling, **KW)]
        tdefs = [tmcl.prediction_def_packed(CFG, fused_head=tiling, **KW),
                 tmcl.surprise_def_packed(CFG, reward_scale=0.5, fused_head=tiling, **KW),
                 tmcl.rnd2d_def(CFG, fused_head=tiling, **KW)]
    else:
        jdefs = [jmcl.rnd2d_def(JCFG, fused_head=jtiling, **KW),
                 jmcl.ae2d_def(JCFG, fused_head=jtiling, **KW),
                 jmcl.prediction_def(JCFG, fused_head=jtiling, **KW),
                 jmcl.surprise_def(JCFG, reward_scale=0.5, fused_head=jtiling, **KW)]
        tdefs = [tmcl.rnd2d_def(CFG, fused_head=tiling, **KW),
                 tmcl.ae2d_def(CFG, fused_head=tiling, **KW),
                 tmcl.prediction_def(CFG, fused_head=tiling, **KW),
                 tmcl.surprise_def(CFG, reward_scale=0.5, fused_head=tiling, **KW)]
    got, want, carry, jcarry = _run_pair(jdefs, tdefs, packed)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert np.all(got != 0.0)
    for ts, js in zip(carry.stack.wrappers, jcarry.stack.wrappers):
        assert int(ts.updates) == int(js.updates) == 4
    if packed:
        assert carry.stack.wrappers[0].extra.frames.dtype == torch.uint32


def test_banded_stack_matches_the_unbanded_port_stack():
    """The port's own stacks, banded and not, on one stream: the same rewards
    (rtol 1e-5: the bands' sums in another order)."""
    out = []
    for fused_head in (False, nets.BandTiling(4)):
        defs = [tmcl.rnd2d_def(CFG, fused_head=fused_head, **KW),
                tmcl.prediction_def_packed(CFG, fused_head=fused_head, **KW)]
        ro = Rollout(CFG, defs, device="cpu", stack=PackedSpatialStack(CFG, defs))
        carry = ro.init(ro.generator(5), rules.LIFE)
        acts = (np.random.RandomState(6).rand(6, *CFG.action_shape) < 0.4).astype(np.float32)
        out.append(ro.run_actions(carry, torch.from_numpy(acts))[1].numpy())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# what band tiling refuses, and the whole-AE route
# ---------------------------------------------------------------------------


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("args", [(63, 4, 8, "observation"), (64, 4, 32, "observation"),
                                  (18, 4, 1, "embedding")])
def test_check_errors_match_jax(args):
    assert _message(lambda: band_heads._check(*args)) == _message(lambda: jband._check(*args))


def test_decoder_window_error_matches_jax():
    x = np.zeros((1, 2, 4, 8), np.float32)
    p = {"w": np.zeros((2, 1, 4, 4), np.float32), "b": np.zeros((1,), np.float32)}
    q = {"w": np.zeros((1, 1, 4, 4), np.float32), "b": np.zeros((1,), np.float32)}
    obs = np.zeros((1, 1, 16, 32), np.uint8)
    tconv = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    jconv = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    got = _message(lambda: nets.conv_decoder_loss(
        torch.from_numpy(x), tconv(p), tconv(q), torch.from_numpy(obs),
        mesh=nets.BandTiling(2)))
    want = _message(lambda: jband.decoder_loss_banded(
        jnp.asarray(x), jconv(p), jconv(q), jnp.asarray(obs), None, drop_p=0.0,
        train=False, tiling=jnets.BandTiling(2), force_kernel=True))
    assert got == want and "exceeds height" in got


def test_single_stages_refuse_band_tiling_as_jax_does():
    x = np.zeros((1, 1, 8, 8), np.float32)
    p = {"w": np.zeros((1, 1, 3, 3), np.float32), "b": np.zeros((1,), np.float32)}
    pt = {"w": np.zeros((1, 1, 4, 4), np.float32), "b": np.zeros((1,), np.float32)}
    obs = np.zeros((1, 1, 16, 16), np.uint8)
    T = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    tb, jb = nets.BandTiling(2), jnets.BandTiling(2)
    pairs = [
        (lambda: nets.conv_head(torch.from_numpy(x), T(p), pool=2, mesh=tb),
         lambda: jnets.conv_head(jnp.asarray(x), J(p), None, pool=2, drop_p=0.0,
                                 train=False, mesh=jb)),
        (lambda: nets.conv_tail(torch.from_numpy(x), T(pt), act="relu", mesh=tb),
         lambda: jnets.conv_tail(jnp.asarray(x), J(pt), None, act="relu", drop_p=0.0,
                                 train=False, mesh=jb)),
        (lambda: nets.conv_loss_tail(torch.from_numpy(x), T(pt), torch.from_numpy(obs),
                                     act="sigmoid", mesh=tb),
         lambda: jnets.conv_loss_tail(jnp.asarray(x), J(pt), jnp.asarray(obs), None,
                                      act="sigmoid", drop_p=0.0, train=False, mesh=jb)),
    ]
    for port, jax_side in pairs:
        assert _message(port) == _message(jax_side)
    params = init_ae_params(torch.Generator().manual_seed(0))
    assert "BandTiling serves" in _message(lambda: ae_forward(
        params, torch.zeros((1, 1, 16, 16), dtype=torch.uint8), fused_head=tb))


def test_space_sharding_is_refused_naming_the_multi_device_tier():
    """Once refused, SpaceSharding now routes the nets over row shards
    (tests/test_torch_spatial_heads.py holds the values); what is no tag
    still raises ValueError, and True/False still mean one device."""
    from carle_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_rows

    mesh = make_mesh([torch.device("cpu")] * 2, "space")
    tag = nets.SpaceSharding(mesh)
    assert nets.fused_route(tag) is tag and nets.check_mesh(tag) is tag
    tmcl.rnd2d_def(CFG, fused_head=tag)
    x = torch.zeros((1, 1, 16, 16), dtype=torch.uint8)
    p = {"w": torch.zeros(4, 1, 3, 3), "b": torch.zeros(4)}
    q = {"w": torch.zeros(1, 4, 3, 3), "b": torch.ones(1)}
    got = nets.conv_encoder(shard_rows(x, mesh), p, q, pools=(4, 2), mesh=tag)
    assert torch.equal(gather_rows(got), nets.conv_encoder(x, p, q, pools=(4, 2)))
    for bad in (object(), mesh, "space"):
        with pytest.raises(ValueError, match="mesh must be None, BandTiling or SpaceSharding"):
            nets.conv_encoder(x, p, q, pools=(4, 2), mesh=bad)
    with pytest.raises(ValueError):
        tmcl.rnd2d_def(CFG, fused_head=object())
    assert nets.fused_route(True) is None and nets.fused_route(False) is None


def test_whole_ae_route_from_shapes_alone():
    """The whole-AE kernel where both its plans fit (256²); encoder plus
    decoder loss where its backward's band does not (2048²), with the same
    value and gradients as the two-kernel route."""
    assert cuda_head.whole_ae_fits(256, 256, 4, 2, 1, 1)
    assert not cuda_head.whole_ae_fits(2048, 2048, 4, 2, 1, 1)
    assert not cuda_head.whole_ae_fits(8192, 8192, 4, 2, 1, 1)
    gen = torch.Generator().manual_seed(3)
    params = init_ae_params(gen)
    for p in params.values():
        for v in p.values():
            v.requires_grad_(True)
    src = torch.zeros((1, 1, 2048, 64), dtype=torch.uint8)
    assert nets.whole_ae_route(src[..., :256, :256], params["conv1"], params["conv2"],
                               params["deconv1"], params["deconv2"])
    assert not nets.whole_ae_route(torch.zeros((1, 1, 64, 2048), dtype=torch.uint8),
                                   params["conv1"], params["conv2"], params["deconv1"],
                                   params["deconv2"])


def test_conv_ae_loss_falls_back_to_two_kernels(monkeypatch):
    """Where the whole-AE plans do not fit, conv_ae_loss is the whole_ae=False
    computation (encoder then decoder loss, one seed): the same value and 8
    gradients, and the whole-AE function is not called."""
    rng = np.random.RandomState(7)
    src = torch.from_numpy((rng.rand(2, 1, 32, 64) < 0.3).astype(np.uint8))
    ps = _tparams(_draw(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4), (1,),
                              (1, 1, 4, 4), (1,)]))
    tp = _packs(ps, ("p1", "p2", "pd1", "pd2"))
    args = (src, tp["p1"], tp["p2"], tp["pd1"], tp["pd2"], src)
    whole = nets.conv_ae_loss(*args, pools=(2, 2))
    monkeypatch.setattr(cuda_head, "whole_ae_fits", lambda *shape: False)
    monkeypatch.setattr(cuda_head, "ae_loss", lambda *a, **k: pytest.fail("whole-AE route"))
    fallback = nets.conv_ae_loss(*args, pools=(2, 2))
    x = nets.conv_encoder(src, tp["p1"], tp["p2"], pools=(2, 2))
    two = nets.conv_decoder_loss(x, tp["pd1"], tp["pd2"], src)
    assert torch.equal(fallback, two)
    np.testing.assert_allclose(fallback.detach().numpy(), whole.detach().numpy(), rtol=1e-5)
    g_fb = torch.autograd.grad(fallback.sum(), ps)
    g_two = torch.autograd.grad(two.sum(), ps)
    assert all(torch.equal(a, b) for a, b in zip(g_fb, g_two))
    _leaf_close(g_fb, torch.autograd.grad(whole.sum(), ps))
