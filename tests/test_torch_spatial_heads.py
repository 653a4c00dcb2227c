"""carle_tpu_torch vs carle_tpu: the fused nets on row-sharded observations.

``parallel/spatial_heads.py`` on a port mesh of 8 ``cpu`` slots (the kernels'
plain twins, the halo rows copied between slots) against
``carle_tpu.parallel.spatial_heads`` on the JAX tests' 8-device CPU mesh with
``force_kernel=True`` (the Pallas kernels in interpret mode inside
shard_map), as tests/test_spatial_heads.py runs them; and against the port's
own global functions.  Dropout off: the interpreter stubs the TPU PRNG, and
each shard draws its own mask by design.

Inputs come from numpy seeds.  Tolerances: outputs rtol and atol 1e-5
(float32 sums in another order), gradients 1e-4 of each leaf's largest entry
(sums over every position in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from carle_tpu import nets as jnets
from carle_tpu.parallel import spatial_heads as jsh

from carle_tpu_torch import nets
from carle_tpu_torch.ops import bitpack
from carle_tpu_torch.parallel import spatial_heads as sh
from carle_tpu_torch.parallel.mesh import RowShards, gather_rows, make_mesh, shard_rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")


def _jmesh():
    return JMesh(np.array(jax.devices()[:8]), ("space",))


def _mesh(n=8):
    return make_mesh([torch.device("cpu")] * n, "space")


def _leaf_close(got, want, tol=1e-4):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g / scale, w / scale, rtol=tol, atol=tol)


def _params(rng, shapes, scale=0.3):
    return [rng.randn(*s).astype(np.float32) * scale for s in shapes]


def _jpack(ps):
    return [{"w": jnp.asarray(ps[i]), "b": jnp.asarray(ps[i + 1])} for i in range(0, len(ps), 2)]


def _tpack(ts):
    return [{"w": ts[i], "b": ts[i + 1]} for i in range(0, len(ts), 2)]


_JAX = {}


def _jax_once(key, fn):
    """The JAX side of a comparison, computed once for every port variant
    (cells or words, slot count) that shares its inputs: interpreted
    kernels under shard_map take tens of seconds."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("pools, c1, c2", [((2, 2), 4, 2), ((4, 2), 4, 1)])
def test_encoder_spatial_matches_jax_kernels(pools, c1, c2, packed):
    """Forward and the four parameter gradients, uint8 cells or packed words."""
    rng = np.random.RandomState(10 + pools[0])
    cells = (rng.rand(2, 1, 64, 128) < 0.3).astype(np.uint8)
    ps = _params(rng, [(c1, 1, 3, 3), (c1,), (c2, c1, 3, 3), (c2,)])
    ps[1], ps[3] = ps[1] / 3, ps[3] / 3
    co = rng.randn(2, c2, 64 // (pools[0] * pools[1]),
                   128 // (pools[0] * pools[1])).astype(np.float32)
    jx = jnp.asarray(cells)
    sharding = jnets.SpaceSharding(_jmesh())

    def jloss(q):
        out = jsh.encoder_spatial(jx, q[0], q[1], None, pools=pools, drop_p=0.0, train=False,
                                  sharding=sharding, force_kernel=True)
        return (out * co).sum(), out

    (_, want), jg = _jax_once(("encoder", pools), lambda: jax.value_and_grad(
        jloss, has_aux=True)(_jpack(ps)))
    jgrads = [jg[0]["w"], jg[0]["b"], jg[1]["w"], jg[1]["b"]]

    mesh = _mesh()
    x = torch.from_numpy(cells)
    x = bitpack.pack_grid(x) if packed else x
    ts = [torch.from_numpy(p).requires_grad_(True) for p in ps]
    tp = _tpack(ts)
    got = nets.conv_encoder(shard_rows(x, mesh), tp[0], tp[1], pools=pools,
                            mesh=nets.SpaceSharding(mesh))
    assert isinstance(got, RowShards) and got.mesh is mesh
    whole = gather_rows(got)
    np.testing.assert_allclose(whole.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    glob = nets.conv_encoder(x, tp[0], tp[1], pools=pools)
    np.testing.assert_allclose(whole.detach().numpy(), glob.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    grads = torch.autograd.grad((whole * torch.from_numpy(co)).sum(), ts)
    _leaf_close(grads, jgrads)
    _leaf_close(grads, torch.autograd.grad((glob * torch.from_numpy(co)).sum(), ts))


@pytest.mark.parametrize("slots", [1, 2, 8])
@pytest.mark.parametrize("act", ["relu", "sigmoid"])
def test_tail_spatial_matches_jax_kernels(act, slots):
    """Forward, the two parameter gradients and the input cotangent (the
    tail sits mid-net); the port also on 1 and 2 slots (the open ring's
    edges)."""
    rng = np.random.RandomState(30)
    x = rng.randn(2, 2, 32, 64).astype(np.float32)
    ps = _params(rng, [(2, 1, 4, 4), (1,)])
    co = rng.randn(2, 1, 64, 128).astype(np.float32)
    sharding = jnets.SpaceSharding(_jmesh())

    def jloss(px):
        out = jsh.tail_spatial(px["x"], px["p"], None, act=act, drop_p=0.0, train=False,
                               sharding=sharding, force_kernel=True)
        return (out * co).sum(), out

    (_, want), jg = _jax_once(("tail", act), lambda: jax.value_and_grad(
        jloss, has_aux=True)({"x": jnp.asarray(x), "p": _jpack(ps)[0]}))

    mesh = _mesh(slots)
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = [torch.from_numpy(p).requires_grad_(True) for p in ps]
    got = gather_rows(nets.conv_tail(shard_rows(tx, mesh), _tpack(ts)[0], act=act,
                                     mesh=nets.SpaceSharding(mesh)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((got * torch.from_numpy(co)).sum(), [tx] + ts)
    _leaf_close(grads, [jg["x"], jg["p"]["w"], jg["p"]["b"]])


@pytest.mark.parametrize("packed", [False, True])
def test_loss_tail_and_decoder_loss_spatial_match_jax(packed):
    """The row-sharded reconstruction error, one stage (loss tail) and both
    (decoder loss as tail then loss tail), with the gradients of the
    embedding and the four parameters; obs uint8 cells or packed words."""
    rng = np.random.RandomState(40)
    x = rng.randn(2, 2, 16, 32).astype(np.float32)
    ps = _params(rng, [(2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)])
    obs = (rng.rand(2, 1, 64, 128) < 0.3).astype(np.uint8)
    sharding = jnets.SpaceSharding(_jmesh())

    def jloss(px):
        return jnp.sum(jnets.conv_decoder_loss(
            px["x"], px["p1"], px["p2"], jnp.asarray(obs), None, drop_p=0.0, train=False,
            mesh=sharding, force_kernel=True))

    jp = _jpack(ps)
    want, jg = _jax_once("decoder_loss", lambda: jax.value_and_grad(jloss)(
        {"x": jnp.asarray(x), "p1": jp[0], "p2": jp[1]}))
    want = float(want)

    mesh = _mesh()
    tobs = torch.from_numpy(obs)
    tobs = bitpack.pack_grid(tobs) if packed else tobs
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = [torch.from_numpy(p).requires_grad_(True) for p in ps]
    tp = _tpack(ts)
    got = nets.conv_decoder_loss(shard_rows(tx, mesh), tp[0], tp[1], shard_rows(tobs, mesh),
                                 mesh=nets.SpaceSharding(mesh))
    np.testing.assert_allclose(float(got.detach().sum()), want, rtol=1e-5)
    glob = nets.conv_decoder_loss(tx, tp[0], tp[1], tobs)
    np.testing.assert_allclose(got.detach().numpy(), glob.detach().numpy(), rtol=1e-5)
    grads = torch.autograd.grad(got.sum(), [tx] + ts)
    _leaf_close(grads, [jg["x"], jg["p1"]["w"], jg["p1"]["b"], jg["p2"]["w"], jg["p2"]["b"]])
    a = nets.conv_tail(shard_rows(tx, mesh), tp[0], act="relu", mesh=nets.SpaceSharding(mesh))
    one = nets.conv_loss_tail(a, tp[1], shard_rows(tobs, mesh), act="sigmoid",
                              mesh=nets.SpaceSharding(mesh))
    assert torch.equal(one.detach(), got.detach())


def test_ae_loss_spatial_matches_the_port_global_route():
    """conv_ae_loss on row shards (encoder, then decoder loss) against the
    whole-autoencoder kernel's twin: the error and its 8 gradients."""
    rng = np.random.RandomState(50)
    cells = torch.from_numpy((rng.rand(2, 1, 64, 64) < 0.3).astype(np.uint8))
    ps = _params(rng, [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4), (1,),
                       (1, 1, 4, 4), (1,)])
    ts = [torch.from_numpy(p).requires_grad_(True) for p in ps]
    tp = _tpack(ts)
    mesh = _mesh()
    x = shard_rows(cells, mesh)
    got = nets.conv_ae_loss(x, *tp, x, pools=(2, 2), mesh=nets.SpaceSharding(mesh))
    want = nets.conv_ae_loss(cells, *tp, cells, pools=(2, 2))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5)
    _leaf_close(torch.autograd.grad(got.sum(), ts), torch.autograd.grad(want.sum(), ts))


def test_halo_rows_open_ring_and_shard_seeds():
    """The nets' halo rows come from the neighbours with zero rows past the
    universe's edges (no wraparound, unlike the CA's ring); packed words keep
    their bits; each slot's dropout seed is the JAX formula's."""
    mesh = _mesh(4)
    x = torch.arange(2 * 1 * 16 * 3, dtype=torch.float32).reshape(2, 1, 16, 3)
    padded = sh._halo_rows(shard_rows(x, mesh), 2)
    assert torch.equal(padded[0][:, :, :2], torch.zeros(2, 1, 2, 3))
    assert torch.equal(padded[3][:, :, -2:], torch.zeros(2, 1, 2, 3))
    assert torch.equal(padded[1], x[:, :, 2:10])
    words = torch.tensor([[[[0xFFFFFFFF], [1], [2], [0x80000000]]]], dtype=torch.int64).to(
        torch.uint32)
    got = sh._halo_rows(shard_rows(words, _mesh(2)), 1)
    assert got[0].dtype == torch.uint32
    assert got[0].to(torch.int64).flatten().tolist() == [0, 0xFFFFFFFF, 1, 2]
    assert got[1].to(torch.int64).flatten().tolist() == [1, 2, 0x80000000, 0]
    assert [sh._shard_seed(7, s) for s in range(3)] == [7, 7 + 0x3779B1, 7 + 2 * 0x3779B1]
    with pytest.raises(ValueError, match="exceeds"):
        sh._halo_rows(shard_rows(x, mesh), 5)
