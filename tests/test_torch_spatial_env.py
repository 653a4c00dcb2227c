"""carle_tpu_torch vs carle_tpu: the uint8 spatial env mode.

The port shards a rollout carry's uint8 universe over a mesh of ``cpu``
slots (``shard_carry_spatial``) and drives it with the unchanged ``Rollout``,
the sharded step taking the halo kernel's plain twin
(``cuda_halo.spatial_env_step_plain``: the window's toggles XOR-ed into the
slots that hold it, ghost rows copied from the ring neighbours, zeros under
the reset flag).  Held against ``carle_tpu.parallel.spatial_env`` on the JAX
8-device CPU mesh (tests/test_parallel.py's two cases), against the port's
``mesh=None`` stack, and step by step against ``carle_tpu.env.env_step`` on
the gathered grid over slot counts, window geometries, reset flags, rules
and action values.  The kernel itself (``csrc/halo_words.cu``) is held
against the same twin in tests/test_torch_emulated.py.

Inputs and learner parameters come from numpy seeds.  Tolerances: grids and
counters bit for bit; the frozen stack's rewards rtol 1e-4 / atol 1e-5
against JAX (float32 sums in other orders, as tests/test_torch_wrappers.py's
frozen stacks) and bit for bit against the port's mesh=None stack; RND2D's
through its Adam updates rtol 2e-3 (that file's learning tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carle_tpu.mcl as jmcl
from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu.checkpoint import _path_str
from carle_tpu.env import env_step as jenv_step
from carle_tpu.env import init_state as jinit_state
from carle_tpu.parallel import make_mesh as jmake_mesh
from carle_tpu.parallel import shard_carry_spatial as jshard_carry_spatial
from carle_tpu.rollout import Rollout as JRollout

from carle_tpu_torch import EnvConfig, rules
from carle_tpu_torch import mcl as tmcl
from carle_tpu_torch.agents import make_random_agent
from carle_tpu_torch.checkpoint import learner_state_from_numpy
from carle_tpu_torch.env import env_step, init_state
from carle_tpu_torch.parallel import (RowShards, gather_rows, make_mesh, shard_carry_spatial,
                                      spatial_sharding)
from carle_tpu_torch.parallel import cuda_halo
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

OTHER = rules.pack_rule_bits([3, 6, 8], [2, 4, 5])
_JAX = {}


def _jax_once(key, fn):
    """The JAX side, computed once a test run."""
    if key not in _JAX:
        _JAX[key] = jax.tree.map(np.asarray, fn())
    return _JAX[key]


def _mesh(n=8):
    return make_mesh([torch.device("cpu")] * n, "space")


def _flat_numpy(tree):
    return {_path_str(p): np.array(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# tests/test_parallel.py's flows
# ---------------------------------------------------------------------------


def test_wrapped_rollout_1024_matches_jax_and_the_unsharded_stack():
    """tests/test_parallel.py's 1024² case: Speed + Puffer, 64 x 64 actions
    at p = 0.15, 4 steps, the universe over 8 slots."""
    cfg = EnvConfig(1024, 1024, 64, 64, 1)
    jcfg = JEnvConfig(height=1024, width=1024, action_height=64, action_width=64, instances=1)
    actions = (np.random.RandomState(7).rand(4, 1, 64, 64) < 0.15).astype(np.uint8)

    def jax_run():
        ro = JRollout(jcfg, [jmcl.speed_def(jcfg, reward_scale=1e-2),
                             jmcl.puffer_def(jcfg, reward_scale=1e-3)])
        carry = jshard_carry_spatial(ro.init(jax.random.PRNGKey(0), rules.LIFE),
                                     jmake_mesh(jax.devices(), axis_name="space"), jcfg)
        carry, rewards = ro.run_actions(carry, actions)
        return carry.stack.env.grid, rewards

    want_grid, want_rewards = _jax_once("rollout_1024", jax_run)
    runs = {}
    for name, mesh in (("sharded", _mesh()), ("whole", None)):
        ro = Rollout(cfg, [tmcl.speed_def(cfg, reward_scale=1e-2),
                           tmcl.puffer_def(cfg, reward_scale=1e-3)], device="cpu")
        carry = ro.init(ro.generator(0), rules.LIFE)
        if mesh is not None:
            carry = shard_carry_spatial(carry, mesh, cfg)
            assert isinstance(carry.stack.env.grid, RowShards)
            assert carry.stack.env.grid.parts[0].shape == (1, 128, 1024)
        carry, rewards = ro.run_actions(carry, actions)
        runs[name] = (ro.stack.universe(carry.stack).numpy(), rewards.numpy(), ro.stack.gathers)
    grid, rewards, gathers = runs["sharded"]
    np.testing.assert_array_equal(grid, want_grid)
    np.testing.assert_allclose(rewards, want_rewards, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(grid, runs["whole"][0])
    np.testing.assert_array_equal(rewards, runs["whole"][1])
    assert gathers == 4 and runs["whole"][2] == 0   # Speed and Puffer share one obs a step
    assert grid.sum() > 0


def test_master_reset_and_learning_on_shards():
    """tests/test_parallel.py's 128² case: RND2D (batch 2) learns on the
    sharded universe (2 updates in 4 steps), then one all-ones step resets
    it.  The random agent's flow as JAX writes it, and, dropout off, one
    numpy action stream through both packages from the same parameters."""
    cfg = EnvConfig(128, 128, 32, 32, 2)
    jcfg = JEnvConfig(height=128, width=128, action_height=32, action_width=32, instances=2)
    ones = np.ones((1, 2, 32, 32), dtype=np.uint8)

    ro = Rollout(cfg, [tmcl.rnd2d_def(cfg, batch_size=2)], agent=make_random_agent(32, 32),
                 device="cpu")
    carry = shard_carry_spatial(ro.init(ro.generator(1), rules.LIFE), _mesh(), cfg)
    carry, rewards = ro.run(carry, num_steps=4)
    assert int(carry.stack.wrappers[0].updates) == 2
    assert bool(torch.isfinite(rewards).all())
    assert int(ro.stack.universe(carry.stack).sum()) > 0
    carry, _ = ro.run_actions(carry, ones)
    assert isinstance(carry.stack.env.grid, RowShards)
    assert int(ro.stack.universe(carry.stack).sum()) == 0
    assert int(carry.stack.env.step_num) == 0

    actions = np.concatenate([(np.random.RandomState(5).rand(4, 2, 32, 32) < 0.2)
                              .astype(np.uint8), ones])

    def jax_run():
        jro = JRollout(jcfg, [jmcl.rnd2d_def(jcfg, batch_size=2, dropout=False)])
        jcarry = jro.init(jax.random.PRNGKey(1), rules.LIFE)
        state = _flat_numpy(jcarry.stack.wrappers[0])
        jcarry = jshard_carry_spatial(jcarry, jmake_mesh(jax.devices(), axis_name="space"),
                                      jcfg)
        jcarry, rewards = jro.run_actions(jcarry, actions)
        return state, rewards, jcarry.stack.env.grid, jcarry.stack.wrappers[0].updates

    state, want, want_grid, want_updates = _jax_once("rnd2d_128", jax_run)
    ro = Rollout(cfg, [tmcl.rnd2d_def(cfg, batch_size=2, dropout=False)], device="cpu")
    carry = ro.init(ro.generator(1), rules.LIFE)
    carry = carry._replace(stack=carry.stack._replace(
        wrappers=(learner_state_from_numpy(state, "cpu"),)))
    carry = shard_carry_spatial(carry, _mesh(), cfg)
    carry, got = ro.run_actions(carry, torch.from_numpy(actions))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3)
    assert int(carry.stack.wrappers[0].updates) == int(want_updates) == 2
    np.testing.assert_array_equal(ro.stack.universe(carry.stack).numpy(), want_grid)
    assert int(ro.stack.universe(carry.stack).sum()) == 0


# ---------------------------------------------------------------------------
# the sharded step against carle_tpu.env.env_step
# ---------------------------------------------------------------------------

GEOMETRIES = {   # slots, H, W, AH, AW
    "one slot": (1, 32, 48, 8, 8),
    "inside a slot": (3, 48, 32, 8, 8),         # window rows 20-27 of slot 1's 16-31
    "across an edge": (2, 32, 48, 8, 12),        # rows 12-19 over the edge at 16
    "across an edge, 8 slots": (8, 64, 32, 8, 8),
    "over whole slots": (8, 64, 32, 32, 16),     # rows 16-47: slots 2-5 whole
    "the whole universe": (8, 64, 48, 64, 48),   # ghost rows toggle at the torus' wrap
    "odd height": (3, 63, 32, 9, 9),             # the window cut to 8 rows, 27-34
}


def _env_actions(kind, steps, shape, rng):
    """float32 [steps, N, AH, AW]: 'half' random 0.5 toggles; 'twos' 2.0
    everywhere (toggles, no reset); 'reset' a step whose values' mean is 1.0
    (0s and 2s) between random toggles."""
    acts = (rng.rand(steps, *shape) < 0.3).astype(np.float32) * 0.5
    if kind == "twos":
        acts[1] = 2.0
    elif kind == "reset":
        acts[1] = 2.0 * (np.arange(int(np.prod(shape))).reshape(shape) % 2)
    return acts


@pytest.mark.parametrize("rule", ["scalar", "vector"])
@pytest.mark.parametrize("kind", ["half", "twos", "reset"])
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_sharded_env_step_matches_jax_env_step(geom, kind, rule):
    """Three steps of env_step on row shards against carle_tpu.env.env_step
    on the whole grid: grids, step_num and steps_since_action bit for bit."""
    slots, h, w, ah, aw = GEOMETRIES[geom]
    n = 2
    cfg = EnvConfig(h, w, ah, aw, n)
    jcfg = JEnvConfig(height=h, width=w, action_height=ah, action_width=aw, instances=n)
    rng = np.random.RandomState(h * w + slots)
    grid = (rng.rand(n, h, w) < 0.35).astype(np.uint8)
    acts = _env_actions(kind, 3, cfg.action_shape, rng)
    rule_bits = (np.array([rules.LIFE, OTHER], dtype=np.int32) if rule == "vector"
                 else np.array(OTHER, dtype=np.int32))

    def jax_run():
        state = jinit_state(jcfg, jnp.asarray(rule_bits))._replace(grid=jnp.asarray(grid))
        out = []
        for a in acts:
            state, _ = jenv_step(state, jnp.asarray(a), config=jcfg)
            out.append((state.grid, state.step_num, state.steps_since_action))
        return out

    want = _jax_once(("env_step", geom, kind, rule), jax_run)
    state = init_state(cfg, torch.from_numpy(rule_bits), "cpu")
    state = state._replace(grid=shard_carry_spatial(torch.from_numpy(grid), _mesh(slots), cfg))
    for a, (g, step, ssa) in zip(acts, want):
        state, obs = env_step(state, torch.from_numpy(a), cfg)
        assert isinstance(obs, RowShards) and obs is state.grid
        np.testing.assert_array_equal(gather_rows(obs).numpy(), g)
        assert (int(state.step_num), int(state.steps_since_action)) == (int(step), int(ssa))
    if kind == "reset":
        assert int(want[1][1]) == 0 and not want[1][0].any()


def test_kernel_route_and_twin_agree_with_the_unfused_step():
    """spatial_env_step_cuda on CPU slots is its twin; the twin equals the
    unfused step (toggled slots, one generation, then the flag) and
    ops.ca.ca_step_with_action on the gathered grid."""
    from carle_tpu_torch.ops.ca import ca_step_with_action

    cfg = EnvConfig(64, 32, 32, 16, 2)
    rng = np.random.RandomState(3)
    grid = torch.from_numpy((rng.rand(2, 64, 32) < 0.4).astype(np.uint8))
    action = torch.from_numpy((rng.rand(2, 32, 16) < 0.5).astype(np.uint8) * 3)
    x = shard_carry_spatial(grid, _mesh(), cfg)
    for reset in (None, torch.tensor(False), torch.tensor(True)):
        got = cuda_halo.spatial_env_step_cuda(x, action, OTHER, cfg, reset)
        want = ca_step_with_action(grid, action, OTHER, cfg, reset)
        assert torch.equal(gather_rows(got), want)
        assert all(torch.equal(a, b) for a, b in zip(
            got.parts, cuda_halo.spatial_env_step_plain(x, action, OTHER, cfg, reset).parts))
    assert torch.equal(gather_rows(x), grid)   # the input shards stay


def test_stack_entry_points_on_shards():
    """observe, universe and reset (the reset hooks on the home device, the
    result resharded) on a sharded carry; shard_carry_spatial places only
    the universe."""
    cfg = EnvConfig(64, 64, 16, 16, 2)
    ro = Rollout(cfg, [tmcl.speed_def(cfg), tmcl.morpho_def(cfg)], device="cpu")
    carry = ro.init(ro.generator(2), rules.LIFE)
    mesh = _mesh(4)
    assert spatial_sharding(mesh, carry.stack.env.grid, cfg) == "space"
    assert spatial_sharding(mesh, carry.stack.env.rule_bits, cfg) is None
    # env_axis: no axis of this one-axis mesh, so the rows alone shard; on a
    # two-axis mesh the instances too, as JAX's PartitionSpec
    assert spatial_sharding(mesh, carry.stack.env.grid, cfg, env_axis="env") == (
        None, "space", None)
    mesh2 = Mesh([[torch.device("cpu")] * 2] * 2, ("env", "space"))
    assert spatial_sharding(mesh2, carry.stack.env.grid, cfg, env_axis="env") == (
        "env", "space", None)
    assert spatial_sharding(mesh2, carry.stack.env.rule_bits, cfg, env_axis="env") is None
    carry = shard_carry_spatial(carry, mesh, cfg)
    assert isinstance(carry.stack.env.grid, RowShards)
    assert all(isinstance(t, torch.Tensor) for t in carry.stack.wrappers[0])
    acts = torch.from_numpy((np.random.RandomState(0).rand(3, 2, 16, 16) < 0.3)
                            .astype(np.float32))
    carry, _ = ro.run_actions(carry, acts)
    stack = ro.stack
    whole = stack.universe(carry.stack)
    assert whole.shape == (2, 64, 64) and int(whole.sum()) > 0
    assert torch.equal(stack.observe(carry.stack), whole.to(torch.float32)[:, None])
    carry, obs = ro.reset(carry)
    assert isinstance(carry.stack.env.grid, RowShards)
    assert torch.equal(stack.observe(carry.stack), obs)
    assert int(carry.stack.env.step_num) == 0
