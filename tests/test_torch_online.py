"""carle_tpu_torch vs carle_tpu: the online learners' optimizer machinery.

Adam is held against ``optax.adam`` from the same numpy gradients (rtol 1e-6:
the same float32 formula, whose bias corrections ``1 - beta ** count`` may
differ by an ulp of the power), and the accumulate-then-update step against
``carle_tpu.mcl._online.accumulate_and_maybe_update``: counters, the zeroed
accumulator and the update landing on step ``batch_size``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from carle_tpu.mcl import _online as jonline

from carle_tpu_torch import CARLE
from carle_tpu_torch.checkpoint import flatten
from carle_tpu_torch.mcl import AE2D, RND2D, _online
from carle_tpu_torch.mcl.ae import init_ae_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = {"conv1": {"w": (4, 1, 3, 3), "b": (4,)}, "dense": {"w": (16, 8), "b": (16,)}}


def _tree(rng, scale=1.0):
    return {k: {n: (rng.randn(*s) * scale).astype(np.float32) for n, s in v.items()}
            for k, v in SHAPES.items()}


def _to_torch(tree):
    return _online.tree_map(torch.from_numpy, tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees_close(got, want, rtol=1e-6, atol=1e-7):
    flat_got = flatten(got)
    flat_want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): v
                 for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(flat_got) == set(flat_want)
    for key, value in flat_got.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(flat_want[key]),
                                   rtol=rtol, atol=atol, err_msg=key)


def test_adam_matches_optax_over_five_updates():
    rng = np.random.RandomState(0)
    params = _tree(rng)
    opt = optax.adam(6e-2, b1=0.9, b2=0.999, eps=1e-8)
    jparams, jstate = _to_jax(params), opt.init(_to_jax(params))
    like = _to_torch(params)
    flat = _online._flat(like)
    mu, nu = torch.zeros_like(flat), torch.zeros_like(flat)
    count = torch.zeros((), dtype=torch.int32)
    for step in range(5):
        grads = _tree(rng, scale=10.0 ** (step - 2))
        updates, jstate = opt.update(_to_jax(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat, mu, nu, count = _online.adam_step(
            flat, _online._flat(_to_torch(grads)), mu, nu, count, 6e-2)
        assert int(count) == step + 1 and count.dtype == torch.int32
        _assert_trees_close(_online._unflat(flat, like), jparams)
        _assert_trees_close(_online._unflat(mu, like), jstate[0].mu)
        _assert_trees_close(_online._unflat(nu, like), jstate[0].nu, atol=1e-12)


def _learner_pair(rng, batch_size, buffer_length=0):
    params = _tree(rng)
    opt = jonline.make_optimizer(jonline.REFERENCE_EFFECTIVE_LR)
    jstate = jonline.init_learner(1.0, batch_size, _to_jax(params), {}, opt)
    tstate = _online.init_learner(1.0, _to_torch(params), {}, torch.device("cpu"),
                                  batch_size)
    if buffer_length:
        accum = _tree(rng)
        jstate = jstate._replace(grad_accum=_to_jax(accum),
                                 buffer_length=jnp.asarray(buffer_length, jnp.int32))
        tstate = tstate._replace(grad_accum=_to_torch(accum),
                                 buffer_length=torch.tensor(buffer_length,
                                                            dtype=torch.int32))
    return opt, jstate, tstate


def _assert_states_match(tstate, jstate):
    for name in ("buffer_length", "updates", "batch_size"):
        assert int(getattr(tstate, name)) == int(getattr(jstate, name)), name
        assert getattr(tstate, name).dtype == torch.int32
    assert int(tstate.opt_state[0]["count"]) == int(jstate.opt_state[0].count)
    _assert_trees_close(tstate.params, jstate.params)
    _assert_trees_close(tstate.grad_accum, jstate.grad_accum)
    _assert_trees_close(tstate.opt_state[0]["mu"], jstate.opt_state[0].mu)
    _assert_trees_close(tstate.opt_state[0]["nu"], jstate.opt_state[0].nu, atol=1e-12)


def test_accumulate_and_update_matches_jax():
    rng = np.random.RandomState(1)
    opt, jstate, tstate = _learner_pair(rng, batch_size=3)
    for step in range(1, 8):
        grads = _tree(rng)
        jstate = jonline.accumulate_and_maybe_update(jstate, _to_jax(grads), opt)
        tstate = _online.accumulate_and_maybe_update(tstate, _to_torch(grads), 6e-2)
        _assert_states_match(tstate, jstate)
        assert int(tstate.updates) == step // 3 and int(tstate.buffer_length) == step % 3
        if step % 3 == 0:  # the update lands on step batch_size and clears the sum
            assert all(float(t.abs().max()) == 0.0
                       for t in _online.tree_leaves(tstate.grad_accum))


def test_loaded_state_one_short_of_the_window_updates_on_the_next_step():
    rng = np.random.RandomState(2)
    opt, jstate, tstate = _learner_pair(rng, batch_size=64, buffer_length=63)
    before = [t.clone() for t in _online.tree_leaves(tstate.params)]
    grads = _tree(rng)
    jstate = jonline.accumulate_and_maybe_update(jstate, _to_jax(grads), opt)
    tstate = _online.accumulate_and_maybe_update(tstate, _to_torch(grads), 6e-2)
    _assert_states_match(tstate, jstate)
    assert int(tstate.updates) == 1 and int(tstate.buffer_length) == 0
    assert all(not torch.equal(a, b)
               for a, b in zip(before, _online.tree_leaves(tstate.params)))


def test_learner_state_keys_are_the_jax_package_s():
    tstate = _online.init_learner(1.0, init_ae_params(torch.Generator().manual_seed(0)),
                                  {}, torch.device("cpu"))
    from carle_tpu.mcl.ae import init_ae_params as jinit

    opt = jonline.make_optimizer(6e-2)
    jstate = jonline.init_learner(1.0, 64, jinit(jax.random.PRNGKey(0), None), {}, opt)
    from carle_tpu.checkpoint import _path_str

    jkeys = {_path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert set(flatten(tstate)) == jkeys


@pytest.mark.parametrize("shell", [RND2D, AE2D])
def test_batch_size_set_through_the_shell_takes_effect(shell):
    env = shell(CARLE(device="cpu", height=32, width=32, action_height=8,
                      action_width=8, instances=2), seed=3)
    assert env.batch_size == 64
    env.batch_size = 2
    env.reward_scale = 0.5
    assert env.batch_size == 2 and env.reward_scale == 0.5
    action = np.zeros((2, 1, 8, 8), np.float32)
    action[:, :, 2:5, 3] = 1
    env.reset()
    for step in range(1, 6):
        _, reward, _, _ = env.step(action)
        assert env.updates == step // 2
    assert reward.shape == (2, 1) and bool(torch.isfinite(reward).all())
