"""carle_tpu_torch vs carle_tpu: the two-axis env x space mesh.

The port's ``Mesh([[cpu] * 4] * 2, ("env", "space"))`` of 8 ``cpu`` slots
shards a universe's instances over ``env`` and its rows over ``space`` at
once (parallel/mesh.py: one ring of slots an env group, every halo launcher
handed one ring at a time; the kernels' plain twins copy the ghost rows).
Held against ``carle_tpu`` on its 8-device CPU mesh reshaped 2 x 4
(tests/conftest.py), as tests/test_parallel.py and
tests/test_packed_spatial.py run it, and against the port's ``mesh=None``
stacks:

* the uint8 env mode (``shard_carry_2d``) with per-instance Speed;
* the packed stack (``PackedSpatialStack(env_axis="env")``) with RND2D, and
  with RND2D and AE2D on ``SpaceSharding(mesh, "space", "env")`` (the JAX
  nets through their plain XLA compositions, which GSPMD partitions, as
  carle_tpu's spatial heads run off the TPU without ``force_kernel``), and
  the nets' parameter gradients on the 2-D shards;
* a leaf whose instances do not divide over ``env`` (rows over ``space``
  only) and the batch-global master reset across env groups.

Inputs and learner parameters come from numpy seeds (those of carle_tpu's
own tests).  Tolerances: grids bit for bit everywhere; the frozen stacks'
rewards rtol 1e-5 / atol 1e-7 (tests/test_parallel.py's bound); the packed
RND2D stack's rtol 2e-5 / atol 1e-6 (tests/test_packed_spatial.py's); the
SpaceSharding stack's rtol 1e-4 against JAX and the mesh=None stack (float32
sums in other orders through an Adam update); gradients 1e-5 of each leaf's
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import carle_tpu.mcl as jmcl
from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu import nets as jnets
from carle_tpu import rules as jrules
from carle_tpu.checkpoint import _path_str
from carle_tpu.parallel import PackedSpatialStack as JPackedSpatialStack
from carle_tpu.parallel import shard_carry_2d as jshard_carry_2d
from carle_tpu.parallel import shard_carry_packed as jshard_carry_packed
from carle_tpu.rollout import Rollout as JRollout

from carle_tpu_torch import EnvConfig, nets, rules
from carle_tpu_torch import mcl as tmcl
from carle_tpu_torch.checkpoint import learner_state_from_numpy
from carle_tpu_torch.parallel import (PackedSpatialStack, RowShards, gather_rows,
                                      shard_carry_2d, shard_carry_packed, shard_rows, spatial,
                                      spatial_sharding)
from carle_tpu_torch.parallel import spatial_heads as sh
from carle_tpu_torch.parallel.mesh import Mesh
from carle_tpu_torch.rollout import Rollout


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")


def _jmesh2():
    return JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("env", "space"))


def _mesh2():
    return Mesh([[torch.device("cpu")] * 4] * 2, ("env", "space"))


def _flat_numpy(tree):
    return {_path_str(p): np.array(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shared_learners(jcarry, carry, rng):
    """Both carries' learner states from numpy-drawn parameters
    (tests/test_torch_spatial.py's helper)."""
    jw, tw = [], []
    for js, ts in zip(jcarry.stack.wrappers, carry.stack.wrappers):
        if not hasattr(js, "params"):
            jw.append(js)
            tw.append(ts)
            continue
        flat = {k: (rng.randn(*v.shape).astype(np.float32) * 0.3
                    if k.startswith(("params/", "target_params/")) else v)
                for k, v in _flat_numpy(js).items()}
        leaves = jax.tree_util.tree_flatten_with_path(js)[0]
        jw.append(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(js),
            [jnp.asarray(flat[_path_str(p)]) for p, _ in leaves]))
        tw.append(learner_state_from_numpy(flat, "cpu"))
    return (jcarry._replace(stack=jcarry.stack._replace(wrappers=tuple(jw))),
            carry._replace(stack=carry.stack._replace(wrappers=tuple(tw))))


# ---------------------------------------------------------------------------
# (a) the uint8 env mode
# ---------------------------------------------------------------------------


def _speed_run(cfg, jcfg, actions, two_d):
    """(grid, rewards) of carle_tpu's wrapped rollout with per-instance
    Speed, on the 2 x 4 mesh or on one device (test_parallel.py's case)."""
    ro = JRollout(jcfg, [jmcl.speed_def(jcfg, per_instance=True, reward_scale=1e-2)])
    carry = ro.init(jax.random.PRNGKey(0), jrules.LIFE)
    if two_d:
        carry = jshard_carry_2d(carry, _jmesh2(), jcfg)
    carry, rewards = ro.run_actions(carry, jnp.asarray(actions))
    return np.asarray(carry.stack.env.grid), np.asarray(rewards)


def _port_speed_run(cfg, actions, mesh):
    ro = Rollout(cfg, [tmcl.speed_def(cfg, per_instance=True, reward_scale=1e-2)],
                 device="cpu")
    carry = ro.init(ro.generator(0), rules.LIFE)
    if mesh is not None:
        carry = shard_carry_2d(carry, mesh, cfg)
    carry, rewards = ro.run_actions(carry, torch.from_numpy(actions))
    return carry, ro, rewards


def test_shard_carry_2d_rollout_matches_jax_and_mesh_none():
    """shard_carry_2d on 2 x 4: the universes shard their instances over env
    and their rows over space; the wrapped rollout equals carle_tpu's 2-D
    run and the port's mesh=None run, grids bit for bit."""
    cfg = EnvConfig(64, 64, 16, 16, 4)
    jcfg = JEnvConfig(height=64, width=64, action_height=16, action_width=16, instances=4)
    actions = (np.random.RandomState(3).rand(5, 4, 16, 16) < 0.2).astype(np.uint8)
    jgrid, jrewards = _speed_run(cfg, jcfg, actions, two_d=True)
    mesh = _mesh2()
    carry, ro, rewards = _port_speed_run(cfg, actions, mesh)
    grid = carry.stack.env.grid
    assert isinstance(grid, RowShards) and grid.env_axis == "env" and grid.groups == 2
    assert [tuple(p.shape) for p in grid.parts] == [(2, 16, 64)] * 8
    whole, _, rewards_1 = _port_speed_run(cfg, actions, None)
    np.testing.assert_array_equal(ro.stack.universe(carry.stack).numpy(), jgrid)
    np.testing.assert_allclose(rewards.numpy(), jrewards, rtol=1e-5, atol=1e-7)
    assert torch.equal(ro.stack.universe(carry.stack), whole.stack.env.grid)
    np.testing.assert_allclose(rewards.numpy(), rewards_1.numpy(), rtol=1e-5, atol=1e-7)
    assert ro.stack.gathers == 5   # Speed's one cell view a step
    assert torch.equal(ro.stack.universe(carry.stack, instance=3), whole.stack.env.grid[3])


# ---------------------------------------------------------------------------
# (b, c) the packed stack
# ---------------------------------------------------------------------------

PCFG = EnvConfig(128, 128, 16, 16, 4)
JPCFG = JEnvConfig(height=128, width=128, action_height=16, action_width=16, instances=4)
KW = dict(batch_size=2, dropout=False)


def _packed_runs(defs_fn, jdefs_fn, env_axis_of_tag):
    """The packed stack on the 2 x 4 mesh (env_axis="env") and with
    mesh=None, and carle_tpu's packed 2-D stack, from the same learner
    parameters and RandomState(13) actions (test_packed_spatial.py's case):
    {name: (rewards, universe, carry)}."""
    actions = (np.random.RandomState(13).rand(4, 4, 16, 16) < 0.2).astype(np.uint8)
    jmesh = _jmesh2()
    jdefs = jdefs_fn(jnets.SpaceSharding(jmesh, "space", env_axis_of_tag)
                     if env_axis_of_tag else None)
    jstack = JPackedSpatialStack(JPCFG, jdefs, jmesh, env_axis="env")
    jro = JRollout(JPCFG, stack=jstack)
    jcarry = jro.init(jax.random.PRNGKey(1), jrules.LIFE)
    out = {}
    for name, mesh in (("2d", _mesh2()), ("whole", None)):
        tag = nets.SpaceSharding(mesh, "space", "env") if mesh and env_axis_of_tag else None
        stack = PackedSpatialStack(PCFG, defs_fn(tag), mesh,
                                   env_axis="env" if mesh else None)
        ro = Rollout(PCFG, device="cpu", stack=stack)
        carry = ro.init(ro.generator(1), rules.LIFE)
        jc, carry = _shared_learners(jcarry, carry, np.random.RandomState(3))
        if mesh is not None:
            carry = shard_carry_packed(carry, mesh, PCFG, env_axis="env")
            assert carry.stack.env.grid.env_axis == "env"
        carry, r = ro.run_actions(carry, torch.from_numpy(actions))
        out[name] = (r.numpy(), stack.universe(carry.stack).numpy(), carry)
    jc = jshard_carry_packed(jc, jmesh, JPCFG, env_axis="env")
    jc, jr = jro.run_actions(jc, jnp.asarray(actions))
    out["jax"] = (np.asarray(jr), np.asarray(jstack.universe(jc.stack)), jc)
    return out


def test_packed_2d_stack_with_rnd2d_matches_jax():
    """The packed stack on 2 x 4 with RND2D learning (its net on the
    gathered words) against carle_tpu's packed 2-D stack and the port's
    mesh=None stack."""
    out = _packed_runs(lambda tag: [tmcl.rnd2d_def(PCFG, **KW)],
                       lambda tag: [jmcl.rnd2d_def(JPCFG, **KW)], None)
    (r, grid, carry), (jr, jgrid, jc) = out["2d"], out["jax"]
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(grid, out["whole"][1])
    np.testing.assert_allclose(r, jr, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(r, out["whole"][0], rtol=2e-5, atol=1e-6)
    assert int(carry.stack.wrappers[0].updates) == int(jc.stack.wrappers[0].updates) == 2
    assert np.all(r != 0.0)


def test_space_sharding_2d_heads_match_jax_and_mesh_none():
    """RND2D and AE2D with fused_head=SpaceSharding(mesh, "space", "env")
    (dropout off): their kernels' twins run a ring an env group; rewards
    through two Adam updates against carle_tpu and the mesh=None stack."""
    defs = lambda mod, cfg: (lambda tag: [mod.rnd2d_def(cfg, fused_head=tag or True, **KW),
                                          mod.ae2d_def(cfg, fused_head=tag or True, **KW)])
    out = _packed_runs(defs(tmcl, PCFG), defs(jmcl, JPCFG), "env")
    (r, grid, carry), (jr, jgrid, jc) = out["2d"], out["jax"]
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(grid, out["whole"][1])
    np.testing.assert_allclose(r, jr, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r, out["whole"][0], rtol=1e-4, atol=1e-6)
    for ts in carry.stack.wrappers:
        assert int(ts.updates) == 2
    assert np.all(r[:, :, 0] != 0.0)


def _leaf_close(got, want, tol=1e-5):
    for g, w in zip(got, want):
        g, w = g.detach().double(), w.detach().double()
        scale = float(w.abs().max()) or 1.0
        torch.testing.assert_close(g / scale, w / scale, rtol=tol, atol=tol)


@pytest.mark.parametrize("packed", [False, True])
def test_space_sharding_2d_gradients_equal_mesh_none(packed):
    """The autoencoder's error on 2-D shards (encoder, then the decoder's
    loss tail, slot by slot a ring a group) and its 8 parameter gradients,
    which reach the home parameters from every slot through autograd, equal
    the unsharded functions'; the seeds take the env index as JAX's do."""
    rng = np.random.RandomState(50)
    cells = torch.from_numpy((rng.rand(4, 1, 64, 64) < 0.3).astype(np.uint8))
    shapes = [(4, 1, 3, 3), (4,), (2, 4, 3, 3), (2,), (2, 1, 4, 4), (1,), (1, 1, 4, 4), (1,)]
    ts = [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3).requires_grad_(True)
          for s in shapes]
    tp = [{"w": ts[i], "b": ts[i + 1]} for i in range(0, 8, 2)]
    src = cells
    if packed:
        from carle_tpu_torch.ops.bitpack import pack_grid

        src = pack_grid(cells[:, 0])[:, None]
    mesh = _mesh2()
    x = shard_rows(src, mesh, "space", "env")
    assert len(x.parts) == 8 and x.parts[0].shape[0] == 2
    tag = nets.SpaceSharding(mesh, "space", "env")
    got = nets.conv_ae_loss(x, *tp, x, pools=(2, 2), mesh=tag)
    want = nets.conv_ae_loss(src, *tp, src, pools=(2, 2))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    _leaf_close(torch.autograd.grad(got.sum(), ts), torch.autograd.grad(want.sum(), ts))
    enc = nets.conv_encoder(x, tp[0], tp[1], pools=(2, 2), mesh=tag)
    assert enc.env_axis == "env"
    torch.testing.assert_close(gather_rows(enc), nets.conv_encoder(src, tp[0], tp[1],
                                                                   pools=(2, 2)),
                               rtol=1e-5, atol=1e-5)
    # JAX's _shard_seed offset: off = space * 1013904223 + env in int32, on the
    # 64-bit seed: seed + off * 0x3779B1 modulo 2**64 (the seed keeps its high word)
    for s, e in ((0, 0), (3, 1), (2, 1)):
        off = int(np.int32(np.int64(s) * 1013904223 + e))
        assert sh._shard_seed(7, s, e) == (7 + off * 0x3779B1) % 2 ** 64


# ---------------------------------------------------------------------------
# (d) indivisible instances, (e) the master reset
# ---------------------------------------------------------------------------


def test_indivisible_instances_shard_rows_only():
    """3 instances on 2 x 4: the universe shards its rows over space only
    (JAX's spec (None, "space", None)), on the first group's ring, and the
    rollout equals the mesh=None run."""
    cfg = EnvConfig(64, 64, 16, 16, 3)
    jcfg = JEnvConfig(height=64, width=64, action_height=16, action_width=16, instances=3)
    mesh = _mesh2()
    out = shard_carry_2d({"g": torch.zeros((3, 64, 64), dtype=torch.uint8)}, mesh, cfg)
    jout = jshard_carry_2d({"g": np.zeros((3, 64, 64), np.uint8)}, _jmesh2(), jcfg)
    assert tuple(jout["g"].sharding.spec) == (None, "space", None)
    assert spatial_sharding(mesh, out["g"], cfg, env_axis="env") is None   # shards already
    assert spatial_sharding(mesh, torch.zeros((3, 64, 64), dtype=torch.uint8), cfg,
                            env_axis="env") == (None, "space", None)
    g = out["g"]
    assert g.env_axis is None and g.groups == 1 and len(g.parts) == 4
    assert all(p.shape == (3, 16, 64) for p in g.parts)
    actions = (np.random.RandomState(3).rand(4, 3, 16, 16) < 0.2).astype(np.uint8)
    carry, ro, rewards = _port_speed_run(cfg, actions, mesh)
    whole, _, rewards_1 = _port_speed_run(cfg, actions, None)
    assert torch.equal(ro.stack.universe(carry.stack), whole.stack.env.grid)
    assert torch.equal(rewards, rewards_1)
    _, jrewards = _speed_run(cfg, jcfg, actions, two_d=True)
    np.testing.assert_allclose(rewards.numpy(), jrewards, rtol=1e-5, atol=1e-7)


def _reset_actions(n_steps=4):
    """Toggle steps, then a step whose action values average 1.0 over the
    batch but 0.5 and 1.5 over the two env groups: the batch-global master
    reset fires, where a per-group mean would fire in neither group."""
    acts = (np.random.RandomState(5).rand(n_steps, 4, 16, 16) < 0.3).astype(np.float32)
    acts[-1, :2] = 0.5
    acts[-1, 2:] = 1.5
    return acts


@pytest.mark.parametrize("packed", [False, True])
def test_master_reset_is_batch_global_across_env_groups(packed):
    """The reset flag is worked out once over every instance and clears
    every env group's ring, bit for bit as the mesh=None stack (and, uint8,
    as carle_tpu's 2-D run)."""
    cfg = EnvConfig(64, 64, 16, 16, 4)
    acts = _reset_actions()
    mesh = _mesh2()
    runs = []
    for m in (mesh, None):
        if packed:
            stack = PackedSpatialStack(cfg, [tmcl.speed_def_packed(cfg)], m,
                                       env_axis="env" if m else None)
            ro = Rollout(cfg, device="cpu", stack=stack)
        else:
            ro = Rollout(cfg, [tmcl.speed_def(cfg)], device="cpu")
        carry = ro.init(ro.generator(0), rules.LIFE)
        if m is not None:
            carry = (shard_carry_packed(carry, m, cfg, env_axis="env") if packed
                     else shard_carry_2d(carry, m, cfg))
        carry, r = ro.run_actions(carry, torch.from_numpy(acts[:-1]))
        before = ro.stack.universe(carry.stack)
        carry, r_last = ro.run_actions(carry, torch.from_numpy(acts[-1:]))
        runs.append((before, ro.stack.universe(carry.stack), torch.cat([r, r_last]), carry))
    (b2, g2, r2, c2), (b1, g1, r1, c1) = runs
    assert int(b2[:2].sum()) > 0 and int(b2[2:].sum()) > 0 and torch.equal(b2, b1)
    assert int(g2.sum()) == 0 and torch.equal(g2, g1) and torch.equal(r2, r1)
    assert int(c2.stack.env.step_num) == 0 and int(c2.stack.env.steps_since_action) == 0
    assert isinstance(c2.stack.env.grid, RowShards) and c2.stack.env.grid.groups == 2
    if not packed:
        jcfg = JEnvConfig(height=64, width=64, action_height=16, action_width=16, instances=4)
        jro = JRollout(jcfg, [jmcl.speed_def(jcfg)])
        jc = jshard_carry_2d(jro.init(jax.random.PRNGKey(0), jrules.LIFE), _jmesh2(), jcfg)
        jc, jr = jro.run_actions(jc, jnp.asarray(acts))
        np.testing.assert_array_equal(np.asarray(jc.stack.env.grid), g2.numpy())
        np.testing.assert_allclose(np.asarray(jr), r2.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("packed", [False, True])
def test_halo_steps_on_2d_shards_equal_one_axis(packed):
    """The bare halo calls on 2-D shards (8 generations, a rule vector)
    equal the one-axis mesh's, a ring an env group: no ghost row crosses
    into another group."""
    rng = np.random.RandomState(9)
    cells = torch.from_numpy((rng.rand(4, 64, 64) < 0.35).astype(np.uint8))
    other = rules.pack_rule_bits([3, 6, 8], [2, 4, 5])
    vec = torch.tensor([rules.LIFE, rules.DAY_AND_NIGHT, other, rules.LIFE], dtype=torch.int32)
    mesh1 = Mesh([torch.device("cpu")] * 4, ("space",))
    if packed:
        from carle_tpu_torch.ops.bitpack import pack_grid

        words = pack_grid(cells)
        got = spatial.bit_spatial_multi_step(shard_rows(words, _mesh2(), "space", "env"), vec, 8)
        want = spatial.bit_spatial_multi_step(words, vec, 8, mesh1)
    else:
        got = spatial.spatial_multi_step(shard_rows(cells, _mesh2(), "space", "env"), vec, 8)
        want = spatial.spatial_multi_step(cells, vec, 8, mesh1)
    assert got.env_axis == "env" and len(got.parts) == 8
    assert torch.equal(gather_rows(got), gather_rows(want))
