"""carle_tpu_torch vs carle_tpu: the online-training slice on the CPU.

The training stack (RND2D then AE2D, both learning inside the step, dropout
off, carried parameters) runs one numpy action stream through both packages'
``Rollout.run_actions``: rewards through four Adam updates agree within rtol
2e-3 (Adam divides by the gradient's own scale, so a last-bit difference in a
small gradient moves a parameter by a visible fraction of the learning rate).
The JAX defs take their off-TPU path here; the kernels' own gradient rules
(ties in the max pools) are held in tests/test_torch_head.py.  Then the
trainer's files, resume and mixed rules, checkpoints crossing both ways, and
the class shells against ``carle_tpu.CARLE``.
"""

import glob
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import carle_tpu
from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu.checkpoint import _path_str
from carle_tpu.checkpoint import load_pytree as jload_pytree
from carle_tpu.checkpoint import save_pytree as jsave_pytree
from carle_tpu.mcl import ae2d_def as jae2d_def, rnd2d_def as jrnd2d_def
from carle_tpu.rollout import Rollout as JRollout

from carle_tpu_torch import CARLE, EnvConfig, rules, train_mcl
from carle_tpu_torch.checkpoint import (flatten, learner_state_from_numpy, load_pytree,
                                        read_npz, save_pytree)
from carle_tpu_torch.mcl import AE2D, RND2D, ae2d_def, rnd2d_def
from carle_tpu_torch.rollout import Rollout


def _flat_numpy(tree):
    return {_path_str(p): np.array(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _randomise(state, rng):
    def draw(p):
        return jax.tree.map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.3), p)
    return state._replace(params=draw(state.params),
                          target_params=draw(state.target_params))


def test_training_stack_matches_jax_through_adam_updates():
    h = w = 64
    cfg = EnvConfig(h, w, 64, 64, 3)
    jcfg = JEnvConfig(height=h, width=w, action_height=64, action_width=64, instances=3)
    kw = dict(train=True, dropout=False, batch_size=2)
    jro = JRollout(jcfg, [jrnd2d_def(jcfg, 1.0, **kw), jae2d_def(jcfg, 1.0, **kw)])
    tro = Rollout(cfg, [rnd2d_def(cfg, 1.0, **kw), ae2d_def(cfg, 1.0, **kw)],
                  device="cpu")
    rng = np.random.RandomState(0)
    jcarry = jro.init(jax.random.PRNGKey(1), rules.LIFE)
    jw = tuple(_randomise(s, rng) for s in jcarry.stack.wrappers)
    flat = [_flat_numpy(s) for s in jw]   # copies: the JAX rollout donates its carry
    jcarry = jcarry._replace(stack=jcarry.stack._replace(wrappers=jw))
    carry = tro.init(tro.generator(0), rules.LIFE)
    carry = carry._replace(stack=carry.stack._replace(wrappers=tuple(
        learner_state_from_numpy(f, "cpu") for f in flat)))
    acts = (rng.rand(8, *cfg.action_shape) < 0.5).astype(np.float32)

    jcarry, want = jro.run_actions(jcarry, jnp.asarray(acts))
    carry, got = tro.run_actions(carry, torch.from_numpy(acts))
    assert got.shape == (8, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3)
    for ts, js in zip(carry.stack.wrappers, jcarry.stack.wrappers):
        assert int(ts.updates) == int(js.updates) == 4
        assert int(ts.buffer_length) == int(js.buffer_length) == 0
        assert not ts.params["conv1"]["w"].requires_grad
    # the rewards moved: the nets did learn between steps
    frozen = Rollout(cfg, [rnd2d_def(cfg, 1.0, train=False),
                           ae2d_def(cfg, 1.0, train=False)], device="cpu")
    fcarry = frozen.init(frozen.generator(0), rules.LIFE)
    fcarry = fcarry._replace(stack=fcarry.stack._replace(wrappers=tuple(
        learner_state_from_numpy(f, "cpu") for f in flat)))
    _, still = frozen.run_actions(fcarry, torch.from_numpy(acts))
    np.testing.assert_allclose(still[:2].numpy(), got[:2].numpy(), rtol=1e-5)
    assert float((still[-1] - got[-1]).abs().max()) > 1e-3


def test_training_with_dropout_is_reproducible_and_differs_from_without():
    cfg = EnvConfig(64, 64, 64, 64, 2)
    acts = (np.random.RandomState(1).rand(4, *cfg.action_shape) < 0.3).astype(np.float32)

    def run(dropout, seed):
        ro = Rollout(cfg, [rnd2d_def(cfg, batch_size=2, dropout=dropout),
                           ae2d_def(cfg, batch_size=2, dropout=dropout)], device="cpu")
        carry = ro.init(ro.generator(seed), rules.LIFE)
        carry, r = ro.run_actions(carry, torch.from_numpy(acts))
        assert all(int(s.updates) == 2 for s in carry.stack.wrappers)
        return r

    on, again, off = run(True, 5), run(True, 5), run(False, 5)
    assert torch.equal(on, again) and not torch.equal(on, off)
    assert bool(torch.isfinite(on).all())


def test_train_writes_resumes_and_mixes(tmp_path):
    log_dir = str(tmp_path / "run")
    progress = str(tmp_path / "progress.json")
    seen = []
    hist = train_mcl.train(instances=2, steps=(1, 8), height=64, width=64,
                           batch_size=4, seed=0, log_dir=log_dir,
                           progress_file=progress, segment_callback=seen.append,
                           device="cpu")
    assert hist.shape == (4 * 8,) and np.isfinite(hist).all() and (hist > 0).all()
    assert [s["ruleset"] for s in seen] == train_mcl.DEFAULT_RULES
    with open(progress) as f:
        done = json.load(f)
    assert done["completed_segments"] == done["total_segments"] == 4
    saved = np.load(glob.glob(os.path.join(log_dir, "metrics", "mcl_rewards_*.npy"))[0])
    np.testing.assert_array_equal(saved, hist)
    like = rnd2d_def(EnvConfig(64, 64, 64, 64, 2)).init(torch.Generator().manual_seed(0),
                                                       "cpu")
    rnd = load_pytree(train_mcl._find_checkpoint(os.path.join(log_dir, "models"),
                                                 "RND2D"), like)
    assert int(rnd.updates) == 8 and int(rnd.buffer_length) == 0   # 32 steps / 4

    # resume: the last segment only, from the saved learner states
    resumed = train_mcl.train(instances=2, steps=(1, 8), height=64, width=64,
                              batch_size=4, seed=1, log_dir=str(tmp_path / "again"),
                              resume_from=os.path.join(log_dir, "models"),
                              skip_segments=3, device="cpu")
    assert resumed.shape == (8,)
    rnd2 = load_pytree(train_mcl._find_checkpoint(str(tmp_path / "again" / "models"),
                                                  "RND2D"), like)
    assert int(rnd2.updates) == 10
    with pytest.raises(FileNotFoundError):
        train_mcl.train(resume_from=str(tmp_path / "nowhere"), device="cpu")

    mixed = train_mcl.train(instances=4, steps=(2, 4), height=64, width=64,
                            batch_size=4, mixed_rules=True,
                            log_dir=str(tmp_path / "mixed"), device="cpu")
    assert mixed.shape == (2 * 4,) and np.isfinite(mixed).all()


def test_train_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mcl.train(instances=1, steps=(1, 1), log_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CARLE()
    with pytest.raises(NotImplementedError):
        train_mcl.train(agent_fn=object, device="cpu", log_dir=str(tmp_path))


def test_checkpoints_cross_both_ways(tmp_path):
    jcfg = JEnvConfig(height=64, width=64, action_height=64, action_width=64)
    rng = np.random.RandomState(4)
    jstate = _randomise(jae2d_def(jcfg).init(jax.random.PRNGKey(0)), rng)
    jstate = jstate._replace(
        opt_state=jax.tree.map(lambda a: a + 1, jstate.opt_state),
        buffer_length=jnp.asarray(17, jnp.int32), updates=jnp.asarray(5, jnp.int32))
    # JAX -> port -> file -> JAX
    tstate = learner_state_from_numpy(_flat_numpy(jstate), "cpu")
    path = save_pytree(str(tmp_path / "AE2D_port.npz"), tstate)
    back = jload_pytree(path, jae2d_def(jcfg).init(jax.random.PRNGKey(9)))
    want = _flat_numpy(jstate)
    got = _flat_numpy(back)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key
    assert carle_tpu.checkpoint.checkpoint_meta(path) == {"format_version": 1}
    # JAX file -> port
    jpath = jsave_pytree(str(tmp_path / "AE2D_jax.npz"), jstate)
    like = ae2d_def(EnvConfig(64, 64, 64, 64, 1)).init(torch.Generator().manual_seed(0),
                                                      "cpu")
    loaded = load_pytree(jpath, like)
    for key, t in flatten(loaded).items():
        np.testing.assert_array_equal(t.numpy(), want[key], err_msg=key)
    assert set(read_npz(path)) == set(read_npz(jpath))


# ---------------------------------------------------------------------------
# class shells
# ---------------------------------------------------------------------------


def _shell_pair(**kw):
    return CARLE(device="cpu", **kw), carle_tpu.CARLE(**kw)


def test_carle_shell_trajectories_equal_the_jax_shell_s():
    kw = dict(height=48, width=40, action_height=16, action_width=12, instances=3)
    env, jenv = _shell_pair(**kw)
    assert (env.action_height, env.action_width) == (jenv.action_height, jenv.action_width)
    rng = np.random.RandomState(0)
    env.reset(), jenv.reset()
    for step in range(12):
        if step == 4:
            env.rules_from_string("B36/S23"), jenv.rules_from_string("B36/S23")
        if step == 7:   # oversized, universe-shaped action: centre-cropped
            action = (rng.rand(3, 1, 48, 40) < 0.3).astype(np.float32)
        elif step == 9:  # valued action: any nonzero toggles
            action = rng.randint(0, 3, size=(3, 1, 16, 12)).astype(np.float32)
        else:
            action = (rng.rand(3, 1, 16, 12) < 0.3).astype(np.float32)
        obs, reward, done, info = env.step(torch.from_numpy(action) if step % 2 else action)
        jobs, _, _, _ = jenv.step(action)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        assert obs.shape == (3, 1, 48, 40) and float(reward.abs().max()) == 0.0
        assert len(info) == 3 and float(done.abs().max()) == 0.0
    assert (env.step_number, env.steps_since_action) == (jenv.step_number,
                                                         jenv.steps_since_action)
    assert env.birth == [3, 6] and env.survive == [2, 3]
    np.testing.assert_array_equal(env.multi_step(5).numpy(), np.asarray(jenv.multi_step(5)))
    # all ones: the master reset
    obs, _, _, _ = env.step(np.ones((3, 1, 16, 12), np.float32))
    assert float(obs.sum()) == 0.0 and env.step_number == 0
    # all ones inside a full-frame action only toggles; all 2.0 never resets
    env.step(np.pad(np.ones((3, 1, 16, 12), np.float32), ((0, 0), (0, 0), (16, 16), (14, 14))))
    jenv.step(np.ones((3, 1, 16, 12), np.float32))  # reset the JAX twin too
    jenv.step(np.pad(np.ones((3, 1, 16, 12), np.float32), ((0, 0), (0, 0), (16, 16), (14, 14))))
    np.testing.assert_array_equal(env.universe.numpy(), np.asarray(jenv.universe))
    assert env.step_number == 1 and float(env.universe.sum()) > 0
    # the universe setter
    soup = (rng.rand(3, 1, 48, 40) < 0.5).astype(np.float32)
    env.universe = soup
    np.testing.assert_array_equal(env.get_observation().numpy(), soup)


def test_wrapper_shells_step_learn_and_freeze():
    kw = dict(height=64, width=64, action_height=16, action_width=16, instances=2)
    inner = RND2D(CARLE(device="cpu", **kw), seed=0)
    env = AE2D(RND2D(CARLE(device="cpu", **kw), seed=0), seed=1)
    assert env.inner_env is env.env.env and env.my_name == "AE2D"
    for shell in (inner, env, env.env):
        shell.batch_size = 2
        shell.eval()   # same nets, no dropout: the rewards are comparable
    rng = np.random.RandomState(2)
    inner.reset(), env.reset()
    for _ in range(3):
        action = (rng.rand(2, 1, 16, 16) < 0.4).astype(np.float32)
        _, r_inner, _, _ = inner.step(action)
        obs, r_outer, done, info = env.step(action)
        assert r_outer.shape == (2, 1) and obs.shape == (2, 1, 64, 64)
        assert bool((r_outer > r_inner).all())   # the reward grows outward
    assert env.updates == env.env.updates == 0   # eval(): no learning
    env.train(), env.env.train()
    for _ in range(4):
        env.step((rng.rand(2, 1, 16, 16) < 0.4).astype(np.float32))
    assert env.updates == env.env.updates == 2
    env.eval(), env.env.eval()
    env.step(np.zeros((2, 1, 16, 16), np.float32))
    assert env.updates == 2
    # rule setters reach the inner environment
    env.birth = [3, 6]
    env.survive_rule_from_string("s238")
    assert env.inner_env.birth == [3, 6] and env.inner_env.survive == [2, 3, 8]
    assert int(env.inner_env.state.rule_bits) == rules.pack_rule_bits([3, 6], [2, 3, 8])
    env.rules_from_string("B3/S23")
    assert int(env.inner_env.state.rule_bits) == rules.LIFE
    # wrapper state survives a reset
    before = env.updates
    assert float(env.reset().sum()) == 0.0 and env.updates == before
