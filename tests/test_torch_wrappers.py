"""carle_tpu_torch vs carle_tpu: all nine reward wrappers on the CPU.

One numpy action stream runs through both packages' ``Rollout.run_actions``
with parameters carried from the JAX states to the port
(``checkpoint.learner_state_from_numpy``, ``state_from_numpy``).  Tolerances:
frozen stacks rtol 1e-4 / atol 1e-5 (float32 sums in other orders; Corner sums
a signed mask over the universe); learning stacks through four Adam updates
rtol 2e-3 (Adam divides by the gradient's own scale, as
tests/test_torch_train.py).  The JAX defs take their off-TPU path here
(``fused_head=True`` falls back to the unfused composition on the CPU); the
kernels' own rules are held in tests/test_torch_stages.py.  Morpho's reset
noise comes from another generator: it is held by its rate.  Random-agent
scores are not compared: the two packages draw different actions.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import carle_tpu.mcl as jmcl
from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu.checkpoint import _path_str
from carle_tpu.checkpoint import load_pytree as jload_pytree
from carle_tpu.checkpoint import save_pytree as jsave_pytree
from carle_tpu.evaluation import eval as jeval
from carle_tpu.mcl.base import WrapperDef as JWrapperDef
from carle_tpu.rollout import Rollout as JRollout

from carle_tpu_torch import CARLE, EnvConfig, rules
from carle_tpu_torch import mcl as tmcl
from carle_tpu_torch.checkpoint import (flatten, learner_state_from_numpy, load_pytree,
                                        save_pytree, state_from_numpy)
from carle_tpu_torch.evaluation import eval as teval
from carle_tpu_torch.mcl import patterns as tpatterns
from carle_tpu_torch.mcl.base import WrapperDef, default_on_reset
from carle_tpu_torch.mcl.prediction import FrameBuffer, _push
from carle_tpu_torch.rollout import Rollout

NINE = ["RND2D", "AE2D", "PredictionBonus", "SurpriseBonus", "MorphoBonus",
        "CornerBonus", "ParsimonyBonus", "SpeedDetector", "PufferDetector"]


def _configs(h, w, ah, aw, n):
    return (EnvConfig(h, w, ah, aw, n),
            JEnvConfig(height=h, width=w, action_height=ah, action_width=aw, instances=n))


def _flat_numpy(tree):
    return {_path_str(p): np.array(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _randomise(state, rng):
    """A JAX learner state with every net parameter redrawn from numpy."""
    if not hasattr(state, "params"):
        return state

    def draw(p):
        return jax.tree.map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.3), p)
    return state._replace(params=draw(state.params),
                          target_params=draw(state.target_params))


def _carry_over(jstate, like):
    """A JAX wrapper state as the port's, on the CPU."""
    flat = _flat_numpy(jstate)
    if hasattr(jstate, "params"):
        return learner_state_from_numpy(flat, "cpu")
    return state_from_numpy(flat, like, "cpu") if flat else like


def _run_both(cfg, jcfg, jdefs, tdefs, acts, rule=rules.LIFE, seed=0):
    """(port carry, JAX carry, port rewards, JAX rewards) of one action stream
    from the JAX stack's initial states with numpy-drawn parameters."""
    rng = np.random.RandomState(seed)
    jro, tro = JRollout(jcfg, jdefs), Rollout(cfg, tdefs, device="cpu")
    jcarry = jro.init(jax.random.PRNGKey(1), rule)
    jw = tuple(_randomise(s, rng) for s in jcarry.stack.wrappers)
    carry = tro.init(tro.generator(0), rule)
    tw = tuple(_carry_over(js, ts) for js, ts in zip(jw, carry.stack.wrappers))
    jcarry = jcarry._replace(stack=jcarry.stack._replace(wrappers=jw))
    carry = carry._replace(stack=carry.stack._replace(wrappers=tw))
    jcarry, want = jro.run_actions(jcarry, jnp.asarray(acts))
    carry, got = tro.run_actions(carry, torch.from_numpy(acts))
    return carry, jcarry, got.numpy(), np.asarray(want)


def _valued_actions(rng, steps, cfg, rate=0.3):
    """Toggles with values 1, 2 and 3, one all-2.0 step (toggles everything,
    resets nothing) and one action-free step."""
    acts = ((rng.rand(steps, *cfg.action_shape) < rate)
            * rng.randint(1, 4, size=(steps, *cfg.action_shape))).astype(np.float32)
    acts[steps // 2] = 2.0
    acts[steps // 2 + 1] = 0.0
    return acts


# ---------------------------------------------------------------------------
# the step context
# ---------------------------------------------------------------------------


def test_step_ctx_action_fields_match_jax():
    cfg, jcfg = _configs(32, 64, 8, 12, 3)
    seen, jseen = [], []

    def spy(ctxs):
        def apply(state, ctx, reward):
            ctxs.append(ctx)
            return state, reward
        return apply

    tdef = WrapperDef("spy", lambda g, d: (), spy(seen), default_on_reset)
    jdef = JWrapperDef("spy", lambda key: (), spy(jseen), lambda s, k, g: (s, g))
    tstack, jstack = tmcl.WrapperStack(cfg, [tdef]), jmcl.WrapperStack(jcfg, [jdef])
    tstate = tstack.init(torch.Generator().manual_seed(0), rules.LIFE, torch.device("cpu"))
    jstate = jstack.init(jax.random.PRNGKey(0), rules.LIFE)
    acts = _valued_actions(np.random.RandomState(0), 6, cfg)
    for a in acts:
        tstate, _ = tstack.step(tstate, torch.from_numpy(a))
        jstate, _ = jstack.step(jstate, jnp.asarray(a), jax.random.PRNGKey(0))
    for t, j in zip(seen, jseen):
        assert t.action_sum.dtype == torch.float32 and t.action_full.dtype == torch.uint8
        assert t.action_sum.shape == (3, 1) and t.action_full.shape == (3, 32, 64)
        np.testing.assert_array_equal(t.action_sum.numpy(), np.asarray(j.action_sum))
        np.testing.assert_array_equal(t.action_full.numpy(), np.asarray(j.action_full))
        np.testing.assert_array_equal(t.action.numpy(), np.asarray(j.action))
        np.testing.assert_array_equal(t.obs_cells.numpy(), np.asarray(j.obs_cells))
    assert float(seen[3].action_sum[0]) == 2.0 * 8 * 12   # the all-2.0 step: raw values


# ---------------------------------------------------------------------------
# the learners: AE2D by two kernels, PredictionBonus, SurpriseBonus
# ---------------------------------------------------------------------------


def test_learning_wrappers_match_jax_through_adam_updates():
    """8 steps, 4 Adam updates a learner (batch_size 2, dropout off); the ring
    warms up over steps 1-5 and shifts from step 6."""
    cfg, jcfg = _configs(32, 64, 16, 16, 3)
    kw = dict(train=True, dropout=False, batch_size=2)
    jdefs = [jmcl.ae2d_def(jcfg, 1.0, fused_head=True, whole_ae=False, **kw),
             jmcl.prediction_def(jcfg, reward_scale=1.0, fused_head=True, **kw),
             jmcl.surprise_def(jcfg, reward_scale=0.5, fused_head=True, **kw)]
    tdefs = [tmcl.ae2d_def(cfg, 1.0, whole_ae=False, **kw),
             tmcl.prediction_def(cfg, reward_scale=1.0, **kw),
             tmcl.surprise_def(cfg, reward_scale=0.5, **kw)]
    rng = np.random.RandomState(2)
    acts = (rng.rand(8, *cfg.action_shape) < 0.4).astype(np.float32)
    acts[6, 1:] = 0.0
    carry, jcarry, got, want = _run_both(cfg, jcfg, jdefs, tdefs, acts)
    assert got.shape == (8, 3, 1)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    for ts, js in zip(carry.stack.wrappers, jcarry.stack.wrappers):
        assert int(ts.updates) == int(js.updates) == 4
        assert int(ts.buffer_length) == int(js.buffer_length) == 0
    for ts, js in zip(carry.stack.wrappers[1:], jcarry.stack.wrappers[1:]):
        assert isinstance(ts.extra, FrameBuffer) and ts.extra.frames.dtype == torch.uint8
        assert int(ts.extra.count) == int(js.extra.count) == 5
        np.testing.assert_array_equal(ts.extra.frames.numpy(), np.asarray(js.extra.frames))


def test_prediction_each_wrapper_alone_and_float32_ring():
    """Each forward-model wrapper alone against JAX, step by step through the
    warm-up (frozen: the rewards are the errors themselves), and the float32
    ring gives the uint8 ring's rewards."""
    cfg, jcfg = _configs(32, 64, 16, 16, 2)
    rng = np.random.RandomState(3)
    acts = (rng.rand(8, *cfg.action_shape) < 0.4).astype(np.float32)
    acts[3:] = 0.0   # the pattern evolves on its own; an empty universe earns 0
    for jmake, tmake in ((jmcl.prediction_def, tmcl.prediction_def),
                         (jmcl.surprise_def, tmcl.surprise_def)):
        jdef = jmake(jcfg, reward_scale=2.0, train=False, fused_head=True)
        _, _, got, want = _run_both(cfg, jcfg, [jdef],
                                    [tmake(cfg, reward_scale=2.0, train=False)], acts)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        _, _, f32, _ = _run_both(cfg, jcfg, [jdef], [tmake(
            cfg, reward_scale=2.0, train=False, buffer_dtype="float32")], acts)
        np.testing.assert_array_equal(f32, got)
    dense = tmcl.WrapperStack(cfg, [tmcl.prediction_def(cfg, buffer_dtype="packed")])
    state = dense.init(torch.Generator().manual_seed(0), rules.LIFE, torch.device("cpu"))
    with pytest.raises(ValueError, match="packed stack"):   # the ring needs ctx.packed
        dense.step(state, torch.from_numpy(acts[0]))
    with pytest.raises(ValueError, match="buffer_dtype"):
        tmcl.prediction_def(cfg, buffer_dtype="int4")


def test_frame_ring_has_the_reference_list_semantics():
    k, buf_list = 3, []
    buf = FrameBuffer(torch.zeros((2, k, 1, 4, 4), dtype=torch.uint8),
                      torch.zeros((), dtype=torch.int32))
    rng = np.random.RandomState(4)
    for _ in range(7):
        obs = torch.from_numpy((rng.rand(2, 1, 4, 4) < 0.5).astype(np.uint8))
        buf_list.append(obs)            # the reference: append, read [0], pop
        want_src = buf_list[0]
        if len(buf_list) > k:
            buf_list.pop(0)
        src, buf = _push(buf, obs, k)
        assert torch.equal(src, want_src)
        assert int(buf.count) == len(buf_list)
        for i, frame in enumerate(buf_list):
            assert torch.equal(buf.frames[:, i], frame)


# ---------------------------------------------------------------------------
# Corner, Parsimony, Morpho
# ---------------------------------------------------------------------------


def test_corner_parsimony_and_morpho_match_jax():
    cfg, jcfg = _configs(128, 128, 32, 32, 3)   # the corner masks need 96 rows
    jdefs = [jmcl.corner_def(jcfg, reward_scale=0.5), jmcl.morpho_def(jcfg, reward_scale=2.0),
             jmcl.parsimony_def()]
    tdefs = [tmcl.corner_def(cfg, reward_scale=0.5), tmcl.morpho_def(cfg, reward_scale=2.0),
             tmcl.parsimony_def()]
    acts = _valued_actions(np.random.RandomState(5), 10, cfg)
    carry, jcarry, got, want = _run_both(cfg, jcfg, jdefs, tdefs, acts,
                                         rule=rules.pack_rule_bits([3, 6], [2, 3]))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.abs(want).max() > 1.0
    # the carried states equal the port's own initial ones: same masks, same bank
    own = Rollout(cfg, tdefs, device="cpu")
    fresh = own.init(own.generator(0), rules.LIFE).stack.wrappers
    for a, b in zip(flatten(carry.stack.wrappers).values(), flatten(fresh).values()):
        assert torch.equal(a, b)
    assert carry.stack.wrappers[1].kernels.shape == (12, 1, 8, 8)


def test_parsimony_divides_by_the_raw_value_sum():
    cfg, jcfg = _configs(32, 32, 16, 16, 2)
    acts = np.zeros((3, 2, 16, 16), np.float32)
    acts[0, 0] = 2.0           # 256 toggles of value 2: scaled by 100 / 512
    acts[0, 1, :5] = 1.0       # 80 toggles: below the floor of 100
    acts[2] = 3.0
    jdefs = [jmcl.corner_def(jcfg), jmcl.parsimony_def()]
    tdefs = [tmcl.corner_def(cfg), tmcl.parsimony_def()]
    _, _, got, want = _run_both(cfg, jcfg, jdefs, tdefs, acts)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    _, _, unscaled, _ = _run_both(cfg, jcfg, jdefs[:1], tdefs[:1], acts)
    np.testing.assert_allclose(got[0, 0], unscaled[0, 0] * 100.0 / 512.0, rtol=1e-6)
    np.testing.assert_allclose(got[0, 1], unscaled[0, 1], rtol=1e-6)


def test_morpho_reset_noise_and_pattern_bank():
    cfg = EnvConfig(256, 256, 64, 64, 4)
    ro = Rollout(cfg, [tmcl.morpho_def(cfg)], device="cpu")
    carry = ro.init(ro.generator(7), rules.LIFE)
    carry, obs = ro.reset(carry)
    n = obs.numel()
    rate, sigma = float(obs.mean()), (0.005 * 0.995 / n) ** 0.5
    assert abs(rate - 0.005) < 4 * sigma and set(obs.unique().tolist()) == {0.0, 1.0}
    again, obs2 = ro.reset(carry)
    assert not torch.equal(obs, obs2)   # fresh noise each reset
    with pytest.raises(ValueError, match="generator"):
        ro.stack.reset(carry.stack)
    # the shipped assets are the JAX package's, and the shell grows the bank
    for name in ("glider_1", "glider_2", "lwss"):
        with open(tpatterns.pattern_path(name)) as f, \
                open(jmcl.patterns.pattern_path(name)) as g:
            assert f.read() == g.read()
    env = tmcl.MorphoBonus(CARLE(device="cpu", height=64, width=64, action_height=16,
                                 action_width=16), seed=1)
    env.add_rle_pattern(tpatterns.pattern_path("lwss"))
    assert env._wstate.kernels.shape == (18, 1, 8, 8)
    assert float(env.reset().mean()) > 0.0
    np.testing.assert_array_equal(tpatterns.get_glider(), jmcl.patterns.get_glider())
    np.testing.assert_array_equal(tpatterns.get_morley_puffer(),
                                  jmcl.patterns.get_morley_puffer())
    np.testing.assert_array_equal(tpatterns.get_symmetric_action(seed=3),
                                  jmcl.patterns.get_symmetric_action(seed=3))


# ---------------------------------------------------------------------------
# the battery with all nine, checkpoints, shells
# ---------------------------------------------------------------------------


def test_nine_wrapper_battery_matches_jax_eval():
    """The port's ``wrapper_defs`` against the defs of
    ``carle_tpu.evaluation.eval``'s factory, 8 steps, per-ruleset rules."""
    cfg, jcfg = _configs(128, 128, 32, 32, 5)
    scales = [1.0, 1.0, 0.5, 0.5, 0.1, 1e-3, 1.0, 1e-2, 1e-3]
    specs = [[name, s, None] for name, s in zip(NINE, scales)]
    factory = jeval._fused_wrapper_factory(jcfg)
    jdefs = [factory[getattr(jmcl, name)](s) for name, s in zip(NINE, scales)]
    tdefs = teval.wrapper_defs(cfg, specs, per_instance=False)
    assert [d.name for d in tdefs] == [d.name for d in jdefs] == NINE
    rule = np.array([teval.battery_rule_bits(rs, True) for rs in teval.DEFAULT_RULES],
                    np.int32)
    acts = _valued_actions(np.random.RandomState(6), 8, cfg, rate=0.2)
    carry, jcarry, got, want = _run_both(cfg, jcfg, jdefs, tdefs, acts, rule=rule)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert all(int(s.updates) == 0 for s in carry.stack.wrappers[:4])   # frozen
    with pytest.raises(ValueError, match="unknown wrapper"):
        teval.wrapper_defs(cfg, [["Nonesuch", 1.0, None]], per_instance=False)


def test_nine_wrapper_battery_entry_point_on_cpu():
    specs = [[name, 1e-2, None] for name in NINE]
    score, per_rule = teval.evaluate_fused_batched(steps=6, wrappers=specs, seed=2,
                                                   verbose=False, device="cpu")
    again, _ = teval.evaluate_fused_batched(steps=6, wrappers=specs, seed=2,
                                            verbose=False, device="cpu")
    assert np.isfinite(score) and score == again and per_rule.shape == (5,)


def test_prediction_checkpoints_cross_both_ways(tmp_path):
    cfg, jcfg = _configs(32, 64, 16, 16, 2)
    tdef, jdef = tmcl.prediction_def(cfg, batch_size=2), jmcl.prediction_def(
        jcfg, batch_size=2, fused_head=True)
    ro = Rollout(cfg, [tdef], device="cpu")
    carry = ro.init(ro.generator(3), rules.LIFE)
    acts = (np.random.RandomState(7).rand(3, *cfg.action_shape) < 0.3).astype(np.float32)
    carry, _ = ro.run_actions(carry, torch.from_numpy(acts))
    state = carry.stack.wrappers[0]
    assert int(state.extra.count) == 3 and int(state.updates) == 1
    # port -> JAX
    path = save_pytree(str(tmp_path / "pred_torch.npz"), state)
    jlike = jdef.init(jax.random.PRNGKey(0))
    jstate = jload_pytree(path, jlike)
    assert jstate.extra.frames.dtype == jnp.uint8
    for key, leaf in flatten(state).items():
        np.testing.assert_array_equal(leaf.numpy(), _flat_numpy(jstate)[key])
    # JAX -> port, by file and by flat dict
    jpath = jsave_pytree(str(tmp_path / "pred_jax.npz"), jstate)
    like = tdef.init(torch.Generator().manual_seed(9), torch.device("cpu"))
    back = load_pytree(jpath, like)
    direct = learner_state_from_numpy(_flat_numpy(jstate), "cpu")
    for loaded in (back, direct):
        assert isinstance(loaded.extra, FrameBuffer)
        leaves = flatten(loaded)
        for key, b in flatten(state).items():
            assert leaves[key].dtype == b.dtype and torch.equal(leaves[key], b)
    # and the loaded state steps on as the original does
    more = torch.from_numpy(acts[:2])
    _, r1 = ro.run_actions(carry, more)
    _, r2 = ro.run_actions(carry._replace(stack=carry.stack._replace(wrappers=(back,))), more)
    assert torch.equal(r1, r2)


def test_shells_stack_with_the_reference_signature():
    env = CARLE(device="cpu", height=64, width=64, action_height=16, action_width=16,
                instances=2)
    env = tmcl.RND2D(env, seed=1)
    env = tmcl.AE2D(env, seed=2, whole_ae=False)
    env = tmcl.PredictionBonus(env, seed=3, batch_size=2)
    env = tmcl.SurpriseBonus(env, seed=4)
    env = tmcl.MorphoBonus(env, seed=5)
    env = tmcl.CornerBonus(env, reward_scale=1e-3)
    env = tmcl.ParsimonyBonus(env)
    assert env.inner_env.__class__ is CARLE and env.parsimony_threshold == 128
    obs = env.reset()
    assert obs.shape == (2, 1, 64, 64) and float(obs.sum()) > 0   # Morpho's noise
    rng = np.random.RandomState(8)
    for _ in range(3):
        obs, reward, done, info = env.step((rng.rand(2, 1, 16, 16) < 0.3) * 2.0)
        assert reward.shape == (2, 1) and bool(torch.isfinite(reward).all())
    pred = env.env.env.env.env
    assert pred.my_name == "PredictionBonus" and pred.prediction_steps == 5
    assert pred.updates == 1 and int(pred._wstate.extra.count) == 3
    pred.eval()
    env.step(np.zeros((2, 1, 16, 16)))
    assert pred.updates == 1   # frozen: no further update
