"""carle_tpu_torch vs carle_tpu: the packed path on the CPU.

The packed env core (``packed.py``) against ``carle_tpu.packed`` word for
word: trajectories with valued actions and random rules, the master reset,
``pack_action`` over odd geometries, ``packed_multi_step``.  The port's packed
stack (``parallel/packed_env.PackedSpatialStack``, one device) against its
own uint8 stack, bit for bit on grids and rewards, learning wrappers included
(after tests/test_packed.py and tests/test_packed_spatial.py).  Training:
``train(packed_state=True)`` equals ``train()`` exactly; the training stack on
the packed stacks of both packages, one numpy action stream, shared
parameters, dropout off, agrees within rtol 2e-3 through four Adam updates
(the tolerance of tests/test_torch_train.py: Adam divides by the gradient's
own scale; the two packages' random agents draw different actions, so
``train`` itself cannot be compared across them).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu import packed as jpacked
from carle_tpu.checkpoint import _path_str
from carle_tpu.env import init_state as jinit_state
from carle_tpu.mcl import ae2d_def as jae2d_def, rnd2d_def as jrnd2d_def
from carle_tpu.parallel.packed_env import PackedSpatialStack as JPackedSpatialStack
from carle_tpu.rollout import Rollout as JRollout

from carle_tpu_torch import EnvConfig, packed, rules, train_mcl
from carle_tpu_torch.agents import make_random_agent
from carle_tpu_torch.checkpoint import learner_state_from_numpy
from carle_tpu_torch.mcl import ae2d_def, morpho_def, rnd2d_def, speed_def
from carle_tpu_torch.ops import bitpack
from carle_tpu_torch.parallel.mesh import make_mesh
from carle_tpu_torch.parallel.packed_env import PackedSpatialStack
from carle_tpu_torch.rollout import Rollout


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CFG = EnvConfig(64, 64, 16, 16, 2)
JCFG = JEnvConfig(height=64, width=64, action_height=16, action_width=16, instances=2)


def _flat_numpy(tree):
    return {_path_str(p): np.array(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _randomise(state, rng):
    def draw(p):
        return jax.tree.map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.3), p)
    return state._replace(params=draw(state.params),
                          target_params=draw(state.target_params))


def _words(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("rule_kind", ["day_and_night", "vector"])
def test_packed_trajectory_matches_jax_word_for_word(rule_kind):
    rng = np.random.RandomState(0)
    rule = (rules.DAY_AND_NIGHT if rule_kind == "day_and_night"
            else np.asarray([rules.LIFE, rules.MORLEY], dtype=np.int32))
    s = packed.init_packed_state(CFG, rule, "cpu")
    js = jpacked.init_packed_state(JCFG, rules.LIFE)._replace(rule_bits=jnp.asarray(rule))
    for t in range(12):
        act = (rng.rand(2, 16, 16) < (0.15 if t % 3 else 0.0)) * rng.randint(1, 4, (2, 16, 16))
        act = act.astype(np.float32)
        s, grid = packed.packed_env_step(s, torch.from_numpy(act), CFG)
        js, jgrid = jpacked.packed_env_step(js, jnp.asarray(act), config=JCFG)
        np.testing.assert_array_equal(_words(grid), np.asarray(jgrid))
        assert int(s.step_num) == int(js.step_num)
        assert int(s.steps_since_action) == int(js.steps_since_action)
    assert int(bitpack.popcount(s.grid).sum()) > 0


def test_packed_master_reset_and_all_twos():
    s = packed.init_packed_state(CFG, rules.LIFE, "cpu")
    js = jpacked.init_packed_state(JCFG, rules.LIFE)
    act = (np.random.RandomState(1).rand(2, 16, 16) < 0.4).astype(np.uint8)
    s, _ = packed.packed_env_step(s, torch.from_numpy(act), CFG)
    js, _ = jpacked.packed_env_step(js, jnp.asarray(act), config=JCFG)
    twos = np.full((2, 16, 16), 2.0, np.float32)   # mean 2.0: toggles, no reset
    s, g2 = packed.packed_env_step(s, torch.from_numpy(twos), CFG)
    js, jg2 = jpacked.packed_env_step(js, jnp.asarray(twos), config=JCFG)
    np.testing.assert_array_equal(_words(g2), np.asarray(jg2))
    assert int(s.step_num) == 2 and int(bitpack.popcount(s.grid).sum()) > 0
    s, g = packed.packed_env_step(s, torch.ones((2, 16, 16)), CFG)
    assert int(bitpack.popcount(g).sum()) == 0
    assert int(s.step_num) == 0 and int(s.steps_since_action) == 0


def test_pack_action_fuzz_matches_jax():
    rng = np.random.RandomState(0)
    cases = [(64, 64, 16, 16), (64, 96, 7, 31), (32, 64, 5, 33),
             (96, 128, 64, 64), (64, 64, 1, 1), (48, 160, 11, 63)]
    for h, w, ah, aw in cases:
        cfg = EnvConfig(h, w, ah, aw, 2)
        jcfg = JEnvConfig(height=h, width=w, action_height=ah, action_width=aw, instances=2)
        patch = (rng.rand(2, cfg.eff_action_height, cfg.eff_action_width) < 0.4).astype(np.uint8)
        got = packed.pack_action(torch.from_numpy(patch), cfg)
        want = np.asarray(jpacked.pack_action(jnp.asarray(patch), jcfg))
        np.testing.assert_array_equal(_words(got), want, err_msg=str((h, w, ah, aw)))
    with pytest.raises(ValueError, match="action patch"):
        packed.pack_action(torch.zeros((2, 8, 8), dtype=torch.uint8), CFG)


def test_packed_multi_step_state_and_observe():
    rng = np.random.RandomState(2)
    grid = (rng.rand(2, 64, 64) < 0.3).astype(np.uint8)
    js = jpacked.pack_state(jinit_state(JCFG, rules.LIFE)._replace(grid=jnp.asarray(grid)))
    from carle_tpu_torch.env import init_state
    s = packed.pack_state(init_state(CFG, rules.LIFE, "cpu")._replace(grid=torch.from_numpy(grid)))
    np.testing.assert_array_equal(_words(s.grid), np.asarray(js.grid))
    s = packed.packed_multi_step(s, 6, CFG)
    js = jpacked.packed_multi_step(js, 6, config=JCFG)
    np.testing.assert_array_equal(_words(s.grid), np.asarray(js.grid))
    assert int(s.step_num) == 6
    np.testing.assert_array_equal(packed.unpack_state(s, CFG).grid.numpy(),
                                  np.asarray(jpacked.unpack_state(js, JCFG).grid))
    obs = packed.observe(s, CFG)
    assert obs.shape == (2, 1, 64, 64) and obs.dtype == torch.float32
    with pytest.raises(ValueError, match="width"):
        packed.init_packed_state(EnvConfig(64, 48, 16, 16, 1), rules.LIFE, "cpu")


def _stack_pair(defs_fn, actions, rule=rules.LIFE, reset_every=None):
    """The same action stream through the uint8 stack and the packed stack."""
    out = []
    for make in (lambda d: None, lambda d: PackedSpatialStack(CFG, d)):
        defs = defs_fn()
        ro = Rollout(CFG, defs, device="cpu", stack=make(defs))
        carry = ro.init(ro.generator(3), rule)
        carry, _ = ro.reset(carry)
        rewards = []
        for t, a in enumerate(actions):
            if reset_every and t and t % reset_every == 0:
                carry, _ = ro.reset(carry)
            carry, r = ro.run_actions(carry, torch.from_numpy(a[None]))
            rewards.append(r)
        out.append((ro.stack.universe(carry.stack).numpy(), torch.cat(rewards).numpy(),
                    carry))
    return out


def test_packed_stack_matches_uint8_stack_bit_exact():
    """Toggles, a master reset, resets with Morpho's nucleation noise and the
    learning nets reading the words: grids and rewards equal bit for bit."""
    rng = np.random.RandomState(9)
    actions = (rng.rand(10, 2, 16, 16) < 0.2).astype(np.float32)
    actions[6] = 1.0   # the master reset

    def defs():
        kw = dict(batch_size=2, dropout=False)
        return [speed_def(CFG, reward_scale=1e-2), morpho_def(CFG),
                rnd2d_def(CFG, **kw), ae2d_def(CFG, **kw)]

    (grid_d, r_d, c_d), (grid_p, r_p, c_p) = _stack_pair(defs, actions, reset_every=4)
    np.testing.assert_array_equal(grid_p, grid_d)
    np.testing.assert_array_equal(r_p, r_d)
    assert int(c_p.stack.env.step_num) == int(c_d.stack.env.step_num)
    assert all(int(s.updates) == 5 for s in c_p.stack.wrappers[2:])


def test_packed_stack_rule_vector_free_steps_and_universe():
    stack = PackedSpatialStack(CFG, [])
    state = stack.init(torch.Generator().manual_seed(0), rules.LIFE, "cpu")
    grid = (np.random.RandomState(2).rand(2, 64, 64) < 0.3).astype(np.uint8)
    rule_vec = torch.tensor([rules.LIFE, rules.MORLEY], dtype=torch.int32)
    state = state._replace(env=state.env._replace(
        grid=bitpack.pack_grid(torch.from_numpy(grid)), rule_bits=rule_vec))
    state, (obs, reward) = stack.step(state, torch.zeros((2, 16, 16)))
    from carle_tpu_torch.ops.ca import ca_step_grid
    want = ca_step_grid(torch.from_numpy(grid), rule_vec)
    assert torch.equal(stack.universe(state), want)
    assert torch.equal(stack.universe(state, instance=1), want[1])
    assert torch.equal(obs, want.to(torch.float32)[:, None])
    fast = stack.free_steps(state, 5)
    assert torch.equal(stack.universe(fast),
                       bitpack.unpack_grid(bitpack.bit_multi_step(state.env.grid, rule_vec, 5),
                                           64))
    assert int(fast.env.step_num) == 6 and int(fast.env.steps_since_action) == 6
    mesh = make_mesh([torch.device("cpu")] * 4, "space")
    assert PackedSpatialStack(CFG, [], mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="not divisible by the space axis"):
        PackedSpatialStack(EnvConfig(66, 64, 16, 16, 1), [], mesh=mesh)
    with pytest.raises(ValueError, match="width"):
        PackedSpatialStack(EnvConfig(64, 48, 16, 16, 1), [])


def test_packed_stack_unpacks_only_what_wrappers_read():
    """The cell views are lazy: a stack whose wrappers read the words
    unpacks nothing; a dense wrapper's read unpacks once a step."""
    acts = torch.from_numpy((np.random.RandomState(0).rand(3, 2, 16, 16) < 0.2)
                            .astype(np.float32))
    for defs, want in (([rnd2d_def(CFG, batch_size=2)], 0),
                       ([speed_def(CFG), speed_def(CFG)], 3)):
        stack = PackedSpatialStack(CFG, defs)
        ro = Rollout(CFG, defs, make_random_agent(16, 16), device="cpu", stack=stack)
        carry = ro.init(ro.generator(0), rules.LIFE)
        carry, _ = ro.run_actions(carry, acts)
        assert stack.unpacks == want


def test_train_packed_state_equals_uint8_carry(tmp_path):
    kw = dict(instances=2, steps=(1, 8), rules=[[[3], [2, 3]], [[3, 6, 8], [2, 4, 5]]],
              height=64, width=64, batch_size=4, seed=0, device="cpu")
    h_default = train_mcl.train(log_dir=str(tmp_path / "a"), **kw)
    h_packed = train_mcl.train(log_dir=str(tmp_path / "b"), packed_state=True, **kw)
    np.testing.assert_array_equal(h_packed, h_default)
    assert np.any(h_packed != 0.0)


def test_packed_training_stack_matches_jax_packed_stack():
    """train(packed_state=True)'s stack (RND2D then AE2D on the packed stack,
    the nets reading the words) against the JAX package's, dropout off."""
    cfg = EnvConfig(64, 64, 64, 64, 3)
    jcfg = JEnvConfig(height=64, width=64, action_height=64, action_width=64, instances=3)
    kw = dict(train=True, dropout=False, batch_size=2)
    jdefs = [jrnd2d_def(jcfg, 1.0, **kw), jae2d_def(jcfg, 1.0, **kw)]
    jro = JRollout(jcfg, jdefs, stack=JPackedSpatialStack(jcfg, jdefs, mesh=None))
    tdefs = [rnd2d_def(cfg, 1.0, **kw), ae2d_def(cfg, 1.0, **kw)]
    tro = Rollout(cfg, tdefs, device="cpu", stack=PackedSpatialStack(cfg, tdefs))
    rng = np.random.RandomState(0)
    jcarry = jro.init(jax.random.PRNGKey(1), rules.LIFE)
    jw = tuple(_randomise(s, rng) for s in jcarry.stack.wrappers)
    flat = [_flat_numpy(s) for s in jw]
    jcarry = jcarry._replace(stack=jcarry.stack._replace(wrappers=jw))
    carry = tro.init(tro.generator(0), rules.LIFE)
    carry = carry._replace(stack=carry.stack._replace(wrappers=tuple(
        learner_state_from_numpy(f, "cpu") for f in flat)))
    acts = (rng.rand(8, *cfg.action_shape) < 0.5).astype(np.float32)
    jcarry, want = jro.run_actions(jcarry, jnp.asarray(acts))
    carry, got = tro.run_actions(carry, torch.from_numpy(acts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3)
    np.testing.assert_array_equal(_words(carry.stack.env.grid),
                                  np.asarray(jcarry.stack.env.grid))
    assert all(int(s.updates) == 4 for s in carry.stack.wrappers)
    assert tro.stack.unpacks == 0
