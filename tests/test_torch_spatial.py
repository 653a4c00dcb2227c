"""carle_tpu_torch vs carle_tpu: the row-sharded spatial tier.

The port runs one controller over a mesh of ``cpu`` slots here (8, as the
JAX tests' 8-device CPU mesh, and 1 and 2 for the ring's edges): each slot's
rows its own tensor, the halo kernels' plain twins copying the ghost rows.
Held bit for bit against ``carle_tpu.parallel.spatial`` (ppermute halos on
the JAX mesh), against the Pallas halo kernels in interpret mode
(``carle_tpu.parallel.pallas_halo``, as tests/test_parallel.py runs them) and
against the port's single-device engines.  The packed stack with a mesh
(Speed dense and packed, RND2D + AE2D with ``fused_head=SpaceSharding``)
against the JAX packed spatial stack on its mesh (the nets' Pallas kernels
in interpret mode, as tests/test_spatial_heads.py's kernel_path case) and
against the port's ``mesh=None`` stack; master reset, reset hooks,
``free_steps`` and per-universe rules as tests/test_packed_spatial.py.

Inputs and learner parameters come from numpy seeds.  Tolerances: grids bit
for bit; learning rewards rtol 2e-4 / atol 2e-5 against JAX (that test's own
bounds: float32 sums in another order through Adam), rtol 1e-5 against the
port's own unsharded stack.
"""

import functools

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
from carle_tpu.ops.bitpack import pack_grid as jpack_grid
from carle_tpu.parallel import pallas_halo as jhalo
from carle_tpu.parallel import spatial as jspatial
from carle_tpu.parallel import spatial_heads as jsh
from carle_tpu.parallel.packed_env import PackedSpatialStack as JPackedSpatialStack
from carle_tpu.parallel.packed_env import shard_carry_packed as jshard_carry_packed
from carle_tpu.rollout import Rollout as JRollout

from carle_tpu_torch import EnvConfig, nets, rules
from carle_tpu_torch import mcl as tmcl
from carle_tpu_torch.checkpoint import learner_state_from_numpy
from carle_tpu_torch.mcl.base import WrapperStack
from carle_tpu_torch.ops import bitpack, ca
from carle_tpu_torch.parallel import (PackedSpatialStack, RowShards, gather_rows, make_mesh,
                                      packed_spatial_sharding, shard_carry_packed, shard_rows,
                                      spatial)
from carle_tpu_torch.parallel.mesh import Mesh
from carle_tpu_torch.rollout import Rollout

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")

OTHER = rules.pack_rule_bits([3, 6, 8], [2, 4, 5])


def _jmesh():
    return JMesh(np.array(jax.devices()[:8]), ("space",))


def _mesh(n=8):
    return make_mesh([torch.device("cpu")] * n, "space")


_JAX = {}


def _jax_once(key, fn):
    """The JAX side, computed once for the port's slot counts (the
    interpreted halo kernels take seconds)."""
    if key not in _JAX:
        _JAX[key] = np.asarray(fn())
    return _JAX[key]


def _grid(seed, shape, p=0.3):
    return (np.random.RandomState(seed).rand(*shape) < p).astype(np.uint8)


# ---------------------------------------------------------------------------
# the CA on shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots", [1, 2, 8])
@pytest.mark.parametrize("rule", [rules.LIFE, rules.DAY_AND_NIGHT])
def test_spatial_ca_step_matches_jax(rule, slots):
    grid = _grid(4, (2, 64, 128))
    got = gather_rows(spatial.spatial_ca_step(torch.from_numpy(grid), rule, _mesh(slots)))
    want = _jax_once(("step", rule), lambda: jspatial.spatial_ca_step(
        jnp.asarray(grid), rule, _jmesh()))
    kernel = _jax_once(("step_pallas", rule), lambda: jhalo.spatial_ca_step_pallas(
        jnp.asarray(grid), rule, _jmesh(), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), kernel)
    assert torch.equal(got, ca.ca_step_grid(torch.from_numpy(grid), rule))


@pytest.mark.parametrize("slots", [1, 2, 8])
def test_spatial_multi_step_matches_jax(slots):
    grid = _grid(6, (2, 64, 128))
    mesh = _mesh(slots)
    got = gather_rows(spatial.spatial_multi_step(torch.from_numpy(grid), rules.LIFE, 5, mesh))
    want = _jax_once("multi", lambda: jspatial.spatial_multi_step(
        jnp.asarray(grid), rules.LIFE, 5, _jmesh()))
    kernel = _jax_once("multi_pallas", lambda: jhalo.spatial_multi_step_pallas(
        jnp.asarray(grid), rules.LIFE, 5, _jmesh(), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), kernel)
    assert torch.equal(got, ca.ca_multi_step(torch.from_numpy(grid), rules.LIFE, 5))
    # a per-universe rule vector (the ppermute path takes one; the Pallas
    # kernels read one rule)
    vec = np.asarray([rules.MORLEY, OTHER], np.int32)
    got = gather_rows(spatial.spatial_multi_step(torch.from_numpy(grid), torch.from_numpy(vec),
                                                 8, mesh))
    want = _jax_once("multi_vec", lambda: jspatial.spatial_multi_step(
        jnp.asarray(grid), jnp.asarray(vec), 8, _jmesh()))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("slots", [1, 2, 8])
def test_bit_spatial_multi_step_matches_jax(slots):
    """Packed words: the rule as data (scalar and per universe) and fixed
    (static_rules), against the JAX ppermute path, the interpreted packed
    halo kernel and the port's single-device engines."""
    grid = _grid(13, (2, 64, 128))
    words = bitpack.pack_grid(torch.from_numpy(grid))
    jwords = jpack_grid(jnp.asarray(grid))
    mesh = _mesh(slots)
    got = gather_rows(spatial.bit_spatial_multi_step(words, OTHER, 5, mesh))
    want = _jax_once("bit", lambda: jspatial.bit_spatial_multi_step(jwords, OTHER, 5, _jmesh()))
    kernel = _jax_once("bit_pallas", lambda: jhalo.bit_spatial_multi_step_pallas(
        jwords, OTHER, 5, _jmesh(), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), kernel)
    assert torch.equal(got, bitpack.bit_multi_step(words, OTHER, 5))
    vec = torch.tensor([rules.LIFE, OTHER], dtype=torch.int32)
    got = gather_rows(spatial.bit_spatial_multi_step(words, vec, 7, mesh))
    want = _jax_once("bit_vec", lambda: jspatial.bit_spatial_multi_step(
        jwords, jnp.asarray(vec.numpy()), 7, _jmesh()))
    np.testing.assert_array_equal(got.numpy(), want)
    got = gather_rows(spatial.bit_spatial_multi_step(words, 0, 6, mesh,
                                                     static_rules=([3], [2, 3])))
    want = _jax_once("bit_static", lambda: jspatial.bit_spatial_multi_step(
        jwords, 0, 6, _jmesh(), static_rules=([3], [2, 3])))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, bitpack.bit_multi_step_static(words, [3], [2, 3], 6))


def test_shards_are_own_allocations_and_inputs_stay():
    """Each slot holds its rows in a tensor of its own; a step returns new
    shards and leaves its input alone; zero steps copy."""
    grid = torch.from_numpy(_grid(1, (1, 32, 64)))
    x = shard_rows(grid, _mesh(4))
    ptrs = {p.untyped_storage().data_ptr() for p in x.parts}
    assert len(ptrs) == 4 and grid.untyped_storage().data_ptr() not in ptrs
    before = [p.clone() for p in x.parts]
    y = spatial.spatial_multi_step(x, rules.LIFE, 3)
    assert all(torch.equal(a, b) for a, b in zip(x.parts, before))
    z = spatial.spatial_multi_step(x, rules.LIFE, 0)
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(z.parts, x.parts))
    assert isinstance(y, RowShards) and y.shape == grid.shape and y.rows == 8


# ---------------------------------------------------------------------------
# the packed stack with a mesh
# ---------------------------------------------------------------------------

CFG = EnvConfig(64, 64, 16, 16, 2)
JCFG = JEnvConfig(height=64, width=64, action_height=16, action_width=16, instances=2)
KW = dict(batch_size=2, dropout=False)


def _flat_numpy(tree):
    return {_path_str(p): np.array(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _patched_force_kernel(monkeypatch):
    """Route the JAX SpaceSharding nets through the interpreted Pallas
    kernels (tests/test_spatial_heads.py::_patched_force_kernel)."""
    for name in ("encoder_spatial", "tail_spatial", "loss_tail_spatial"):
        orig = getattr(jsh, name)
        monkeypatch.setattr(jsh, name, functools.partial(orig, force_kernel=True))


def _shared_learners(jcarry, carry, rng):
    """Both carries' learner states from numpy-drawn parameters (the other
    wrappers keep their own, equal, initial states)."""
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


def _defs(mod, cfg, fused):
    return [mod.speed_def(cfg, reward_scale=1e-2), mod.speed_def_packed(cfg, reward_scale=1e-2),
            mod.rnd2d_def(cfg, fused_head=fused, **KW), mod.ae2d_def(cfg, fused_head=fused, **KW)]


def test_sharded_learning_stack_matches_jax_and_the_unsharded_stack(monkeypatch):
    """Speed (dense and packed), RND2D and AE2D (fused_head=SpaceSharding) on
    the packed stack
over 8 slots against the JAX packed spatial stack on its 8-device mesh
    (interpreted kernels) and against the port's mesh=None stack: rewards
    through an Adam update, update counts, universes bit for bit."""
    _patched_force_kernel(monkeypatch)
    jmesh, mesh = _jmesh(), _mesh()
    rng = np.random.RandomState(7)
    acts = (rng.rand(3, *CFG.action_shape) < 0.3).astype(np.float32)

    jdefs = _defs(jmcl, JCFG, jnets.SpaceSharding(jmesh))
    jro = JRollout(JCFG, jdefs, stack=JPackedSpatialStack(JCFG, jdefs, jmesh))
    jcarry = jro.init(jax.random.PRNGKey(7), rules.LIFE)
    runs = {}
    for name, m in (("sharded", mesh), ("whole", None)):
        defs = _defs(tmcl, CFG, nets.SpaceSharding(m) if m is not None else True)
        stack = PackedSpatialStack(CFG, defs, m)
        ro = Rollout(CFG, defs, device="cpu", stack=stack)
        carry = ro.init(ro.generator(0), rules.LIFE)
        jc, carry = _shared_learners(jcarry, carry, np.random.RandomState(3))
        if m is not None:
            carry = shard_carry_packed(carry, mesh, CFG)
            assert isinstance(carry.stack.env.grid, RowShards)
        carry, r = ro.run_actions(carry, torch.from_numpy(acts))
        runs[name] = (r.numpy(), stack.universe(carry.stack).numpy(), carry, stack)
    jc = jshard_carry_packed(jc, jmesh, JCFG)
    jc, want = jro.run_actions(jc, jnp.asarray(acts))
    got, grid, carry, stack = runs["sharded"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(grid, np.asarray(jro.stack.universe(jc.stack)))
    np.testing.assert_allclose(got, runs["whole"][0], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(grid, runs["whole"][1])
    for ts, js in zip(carry.stack.wrappers[2:], jc.stack.wrappers[2:]):
        assert int(ts.updates) == int(js.updates) == 1
    assert np.all(got[:, :, 0] != 0.0)
    assert stack.gathers == 3 and stack.unpacks == 3   # Speed's dense views, once a step


@pytest.mark.parametrize("slots", [2, 8])
def test_packed_speed_on_shards_equals_dense_speed_bit_for_bit(slots):
    """speed_def_packed reduces each shard exactly (integer sums from each
    shard's first global row), gathering and unpacking nothing; its bonus is
    the mesh=None stack's bit for bit, and the dense def's within 1e-6."""
    cfg = EnvConfig(128, 96, 16, 16, 2)
    acts = torch.from_numpy((np.random.RandomState(2).rand(5, 2, 16, 16) < 0.4)
                            .astype(np.float32))
    out = {}
    for name, m, defs in (("sharded", _mesh(slots), [tmcl.speed_def_packed(cfg),
                                                     tmcl.corner_def_packed(cfg),
                                                     tmcl.puffer_def_packed(cfg)]),
                          ("whole", None, [tmcl.speed_def_packed(cfg),
                                           tmcl.corner_def_packed(cfg),
                                           tmcl.puffer_def_packed(cfg)]),
                          ("dense", None, [tmcl.speed_def(cfg), tmcl.corner_def(cfg),
                                           tmcl.puffer_def(cfg)])):
        stack = PackedSpatialStack(cfg, defs, m)
        ro = Rollout(cfg, defs, device="cpu", stack=stack)
        carry = ro.init(ro.generator(0), rules.LIFE)
        carry = carry._replace(stack=carry.stack._replace(env=carry.stack.env._replace(
            grid=bitpack.pack_grid(torch.from_numpy(_grid(5, (2, 128, 96)))))))
        carry, r = ro.run_actions(carry, acts)
        out[name] = (r, stack)
    assert torch.equal(out["sharded"][0], out["whole"][0])
    torch.testing.assert_close(out["sharded"][0], out["dense"][0], rtol=1e-6, atol=1e-6)
    assert out["sharded"][1].gathers == 0 and out["sharded"][1].unpacks == 0
    assert out["dense"][1].unpacks > 0


def _stack_pair(defs_fn, actions, cfg, slots=8):
    out = []
    for m in (_mesh(slots), None):
        stack = PackedSpatialStack(cfg, defs_fn(), m)
        ro = Rollout(cfg, stack.wrappers, device="cpu", stack=stack)
        carry = ro.init(ro.generator(0), rules.LIFE)
        carry, r = ro.run_actions(carry, torch.from_numpy(actions))
        out.append((stack.universe(carry.stack), r, carry, ro))
    return out


def test_master_reset_on_shards():
    """An all-ones action fires the batch-global master reset on every slot."""
    cfg = EnvConfig(128, 128, 16, 16, 2)
    rng = np.random.RandomState(0)
    acts = (rng.rand(4, 2, 16, 16) < 0.4).astype(np.float32)
    acts[3] = 1.0
    (g_s, r_s, c_s, ro), (g_w, r_w, c_w, _) = _stack_pair(lambda: [tmcl.speed_def(cfg)],
                                                          acts[:3], cfg)
    assert int(g_s.sum()) > 0 and torch.equal(g_s, g_w) and torch.equal(r_s, r_w)
    assert int(c_s.stack.env.step_num) == 3
    c_s, _ = ro.run_actions(c_s, torch.from_numpy(acts[3:]))
    assert int(ro.stack.universe(c_s.stack).sum()) == 0
    assert int(c_s.stack.env.step_num) == 0 and int(c_s.stack.env.steps_since_action) == 0


def test_reset_hooks_on_shards():
    """reset() runs the wrappers' hooks on cells (Morpho's nucleation noise)
    and reshards: the uint8 stack's observation, bit for bit."""
    cfg = EnvConfig(64, 64, 16, 16, 1)
    mesh = _mesh()
    ro_p = Rollout(cfg, device="cpu", stack=PackedSpatialStack(cfg, [tmcl.morpho_def(cfg)], mesh))
    ro_u = Rollout(cfg, [tmcl.morpho_def(cfg)], device="cpu")
    carry_p, obs_p = ro_p.reset(ro_p.init(ro_p.generator(5), rules.LIFE))
    carry_u, obs_u = ro_u.reset(ro_u.init(ro_u.generator(5), rules.LIFE))
    assert torch.equal(obs_p, obs_u) and float(obs_p.sum()) > 0
    assert isinstance(carry_p.stack.env.grid, RowShards)
    assert torch.equal(ro_p.stack.universe(carry_p.stack), carry_u.stack.env.grid)


def test_free_steps_and_rule_vector_on_shards():
    """free_steps is the halo engine's burst: it equals zero-action steps,
    advances step_num and steps_since_action; a per-universe rule vector
    rides through both."""
    cfg = EnvConfig(128, 128, 16, 16, 2)
    stack = PackedSpatialStack(cfg, [], _mesh())
    words = bitpack.pack_grid(torch.from_numpy(_grid(11, (2, 128, 128))))
    vec = torch.tensor([rules.LIFE, OTHER], dtype=torch.int32)
    state = stack.init(torch.Generator().manual_seed(0), vec, "cpu")
    state = state._replace(env=state.env._replace(grid=words))
    fast = stack.free_steps(state, 8)
    slow = state
    for _ in range(8):
        slow, _ = stack.step(slow, torch.zeros((2, 16, 16)))
    assert torch.equal(stack.universe(fast), stack.universe(slow))
    assert torch.equal(gather_rows(fast.env.grid), bitpack.bit_multi_step(words, vec, 8))
    assert int(fast.env.step_num) == 8 and int(fast.env.steps_since_action) == 8
    assert int(slow.env.steps_since_action) == 8
    assert torch.equal(stack.universe(fast, instance=1), stack.universe(fast)[1])


def test_shard_carry_packed_places_the_universe():
    mesh = _mesh(4)
    defs = [tmcl.rnd2d_def(CFG, batch_size=2)]
    ro = Rollout(CFG, defs, device="cpu", stack=PackedSpatialStack(CFG, defs))
    carry = ro.init(ro.generator(0), rules.LIFE)
    placed = shard_carry_packed(carry, mesh, CFG)
    grid = placed.stack.env.grid
    assert isinstance(grid, RowShards) and len(grid.parts) == 4 and grid.rows == 16
    assert torch.equal(gather_rows(grid), carry.stack.env.grid)
    assert placed.stack.wrappers[0].params["conv1"]["w"].device == mesh.home
    assert packed_spatial_sharding(mesh, carry.stack.env.grid, CFG) == "space"
    assert packed_spatial_sharding(mesh, carry.stack.env.rule_bits, CFG) is None


# ---------------------------------------------------------------------------
# what the tier refuses
# ---------------------------------------------------------------------------


def test_refusals():
    mesh = _mesh(4)
    with pytest.raises(ValueError, match="not divisible by the space axis"):
        PackedSpatialStack(EnvConfig(66, 64, 16, 16, 1), [], mesh)
    with pytest.raises(ValueError, match="width"):
        PackedSpatialStack(EnvConfig(64, 48, 16, 16, 1), [], mesh)
    with pytest.raises(ValueError, match="not divisible"):
        shard_rows(torch.zeros((1, 30, 64), dtype=torch.uint8), mesh)
    with pytest.raises(ValueError, match="4 cells a word"):
        spatial.spatial_ca_step(torch.zeros((1, 32, 30), dtype=torch.uint8), rules.LIFE, mesh)
    with pytest.raises(ValueError, match="rule must be"):
        spatial.spatial_ca_step(torch.zeros((2, 32, 32), dtype=torch.uint8),
                                torch.tensor([1, 2, 3]), mesh)
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        Mesh([torch.device("cpu"), torch.device("meta")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="found none"):
            make_mesh()
    with pytest.raises(ValueError, match="parallel.mesh.Mesh"):
        tmcl.rnd2d_def(CFG, fused_head=nets.SpaceSharding(mesh=None))
    with pytest.raises(NotImplementedError, match="env_axis"):
        nets.check_mesh(nets.SpaceSharding(mesh, env_axis="env"))
    with pytest.raises(NotImplementedError, match="env_axis"):
        PackedSpatialStack(CFG, [], mesh, env_axis="env")
