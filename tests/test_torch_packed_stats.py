"""carle_tpu_torch vs carle_tpu: the packed-native wrappers on the CPU.

Each ``*_def_packed`` on the port's packed stack against
``carle_tpu.mcl.packed_stats`` on the JAX packed stack (``mesh=None``), one
numpy action stream with valued toggles, a master reset and an action-free
stretch: Corner, Parsimony and Morpho exactly (integer popcounts and
bit-sliced sums; Morpho's float32 division by n is the same one operation),
Speed and Puffer within rtol 1e-5 (float32 weighted sums in another order),
Prediction and Surprise on the packed frame ring through four Adam updates
within rtol 2e-3 (Adam divides by the gradient's own scale; the JAX side runs
its unfused path on the CPU).  Then each against the port's dense def on the
uint8 stack (rtol 1e-5; Morpho's dense float32 correlation rounds where the
packed sum is exact: atol 1e-5), the all-packed stack's step unpacking
nothing, and the error a packed def raises on the dense stack.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import carle_tpu.mcl as jmcl
from carle_tpu.mcl import packed_stats as jpacked_stats
from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu.checkpoint import _path_str
from carle_tpu.parallel.packed_env import PackedSpatialStack as JPackedSpatialStack
from carle_tpu.rollout import Rollout as JRollout

from carle_tpu_torch import EnvConfig, rules
from carle_tpu_torch import mcl as tmcl
from carle_tpu_torch.checkpoint import learner_state_from_numpy, state_from_numpy
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


CFG = EnvConfig(64, 96, 16, 16, 3)
JCFG = JEnvConfig(height=64, width=96, action_height=16, action_width=16, instances=3)
KW = dict(train=True, dropout=False, batch_size=2)


def _flat_numpy(tree):
    return {_path_str(p): np.array(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _actions(seed, steps=10):
    rng = np.random.RandomState(seed)
    acts = ((rng.rand(steps, *CFG.action_shape) < 0.3)
            * rng.randint(1, 4, size=(steps, *CFG.action_shape))).astype(np.float32)
    acts[3] = 1.0    # the master reset
    acts[5:] = 0.0   # action-free: Puffer's window fills
    return acts


def _carry_over(jstate, like):
    flat = _flat_numpy(jstate)
    if hasattr(jstate, "params"):
        rng = np.random.RandomState(0)
        flat = {k: (rng.randn(*v.shape).astype(np.float32) * 0.3
                    if k.startswith("params/") else v) for k, v in flat.items()}
        return learner_state_from_numpy(flat, "cpu"), flat
    return state_from_numpy(flat, like, "cpu"), None


def _jax_state(jstate, flat):
    """The JAX learner state with the parameters the port got."""
    if flat is None:
        return jstate
    leaves = jax.tree_util.tree_flatten_with_path(jstate)[0]
    values = [jnp.asarray(flat[_path_str(p)]) for p, _ in leaves]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jstate), values)


def _run_packed_pair(jdefs, tdefs, acts):
    jro = JRollout(JCFG, jdefs, stack=JPackedSpatialStack(JCFG, jdefs, mesh=None))
    stack = PackedSpatialStack(CFG, tdefs)
    tro = Rollout(CFG, tdefs, device="cpu", stack=stack)
    jcarry = jro.init(jax.random.PRNGKey(1), rules.LIFE)
    carry = tro.init(tro.generator(0), rules.LIFE)
    pairs = [_carry_over(js, ts) for js, ts in zip(jcarry.stack.wrappers,
                                                  carry.stack.wrappers)]
    jw = tuple(_jax_state(js, flat) for js, (_, flat) in zip(jcarry.stack.wrappers, pairs))
    jcarry = jcarry._replace(stack=jcarry.stack._replace(wrappers=jw))
    carry = carry._replace(stack=carry.stack._replace(wrappers=tuple(t for t, _ in pairs)))
    jcarry, want = jro.run_actions(jcarry, jnp.asarray(acts))
    carry, got = tro.run_actions(carry, torch.from_numpy(acts))
    return carry, jcarry, got.numpy(), np.asarray(want), stack


STATS = {  # name: (port def, JAX def, rtol vs JAX)
    "speed": (lambda: tmcl.speed_def_packed(CFG, per_instance=True),
              lambda: jmcl.speed_def_packed(JCFG, per_instance=True), 1e-5),
    "speed_global": (lambda: tmcl.speed_def_packed(CFG),
                     lambda: jmcl.speed_def_packed(JCFG), 1e-5),
    "puffer": (lambda: tmcl.puffer_def_packed(CFG, growth_threshold=2, per_instance=True),
               lambda: jmcl.puffer_def_packed(JCFG, growth_threshold=2, per_instance=True),
               1e-5),
    "corner": (lambda: tmcl.corner_def_packed(CFG), lambda: jmcl.corner_def_packed(JCFG), 0),
    "parsimony": (lambda: tmcl.parsimony_def_packed(), lambda: jmcl.parsimony_def_packed(), 0),
    "morpho": (lambda: tmcl.morpho_def_packed(CFG), lambda: jmcl.morpho_def_packed(JCFG), 0),
}


@pytest.mark.parametrize("name", sorted(STATS))
def test_packed_stat_matches_jax_packed_stack(name):
    tmake, jmake, rtol = STATS[name]
    # a reward for Parsimony to scale: Corner's, inner
    inner_t = [tmcl.corner_def_packed(CFG)] if name == "parsimony" else []
    inner_j = [jmcl.corner_def_packed(JCFG)] if name == "parsimony" else []
    _, _, got, want, stack = _run_packed_pair(inner_j + [jmake()], inner_t + [tmake()],
                                              _actions(1))
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    assert np.any(got != 0.0)
    assert stack.unpacks == 0


def test_packed_prediction_ring_matches_jax_through_adam_updates():
    jdefs = [jpacked_stats.prediction_def_packed(JCFG, reward_scale=1.0, **KW),
             jpacked_stats.surprise_def_packed(JCFG, reward_scale=0.5, **KW)]
    tdefs = [tmcl.prediction_def_packed(CFG, reward_scale=1.0, **KW),
             tmcl.surprise_def_packed(CFG, reward_scale=0.5, **KW)]
    acts = _actions(2, 8)
    acts[4] = acts[3]
    carry, jcarry, got, want, stack = _run_packed_pair(jdefs, tdefs, acts)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert stack.unpacks == 0
    for ts, js in zip(carry.stack.wrappers, jcarry.stack.wrappers):
        assert int(ts.updates) == int(js.updates) == 4
        assert ts.extra.frames.dtype == torch.uint32
        assert ts.extra.frames.shape == (3, 5, 64, 96 // 32)
        np.testing.assert_array_equal(ts.extra.frames.numpy(), np.asarray(js.extra.frames))


DENSE = {  # name: (packed def, dense def, atol)
    "speed": (lambda: tmcl.speed_def_packed(CFG, per_instance=True),
              lambda: tmcl.speed_def(CFG, per_instance=True), 1e-6),
    "puffer": (lambda: tmcl.puffer_def_packed(CFG, growth_threshold=2, per_instance=True),
               lambda: tmcl.puffer_def(CFG, per_instance=True, growth_threshold=2), 0),
    "corner": (lambda: tmcl.corner_def_packed(CFG), lambda: tmcl.corner_def(CFG), 0),
    "morpho": (lambda: tmcl.morpho_def_packed(CFG), lambda: tmcl.morpho_def(CFG), 1e-5),
    "prediction": (lambda: tmcl.prediction_def_packed(CFG, **KW),
                   lambda: tmcl.prediction_def(CFG, **KW), 1e-6),
    "surprise": (lambda: tmcl.surprise_def_packed(CFG, **KW),
                 lambda: tmcl.surprise_def(CFG, **KW), 1e-6),
}


@pytest.mark.parametrize("name", sorted(DENSE))
def test_packed_def_matches_dense_def(name):
    """The packed def on the packed stack against the dense def on the uint8
    stack, one seed for both (Morpho's reset noise included)."""
    pmake, dmake, atol = DENSE[name]
    acts = torch.from_numpy(_actions(3))
    out = []
    for defs, stack in (([dmake()], None), ([pmake()], "packed")):
        ro = Rollout(CFG, defs, device="cpu",
                     stack=PackedSpatialStack(CFG, defs) if stack else None)
        carry = ro.init(ro.generator(4), rules.LIFE)
        carry, _ = ro.reset(carry)
        carry, r = ro.run_actions(carry, acts)
        out.append((r.numpy(), ro.stack.universe(carry.stack).numpy()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(out[1][1], out[0][1])
    assert np.any(out[0][0] != 0.0)


def test_all_packed_native_stack_never_unpacks():
    """Every packed def and both nets reading the words: a step builds no cell
    view (the counter), and the unpack function is never called."""
    defs = [tmcl.speed_def_packed(CFG), tmcl.puffer_def_packed(CFG),
            tmcl.corner_def_packed(CFG), tmcl.morpho_def_packed(CFG),
            tmcl.parsimony_def_packed(), tmcl.prediction_def_packed(CFG, **KW),
            tmcl.surprise_def_packed(CFG, **KW), tmcl.rnd2d_def(CFG, **KW),
            tmcl.ae2d_def(CFG, **KW), tmcl.ae2d_def(CFG, whole_ae=False, **KW)]
    stack = PackedSpatialStack(CFG, defs)
    ro = Rollout(CFG, defs, device="cpu", stack=stack)
    carry = ro.init(ro.generator(0), rules.LIFE)
    calls = []
    real = PackedSpatialStack._unpack
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PackedSpatialStack, "_unpack",
                   lambda self, words: calls.append(words.shape) or real(self, words))
        carry, r = ro.run_actions(carry, torch.from_numpy(_actions(5, 6)))
    assert stack.unpacks == 0 and not calls
    assert bool(torch.isfinite(r).all())


@pytest.mark.parametrize("make", [
    lambda: tmcl.speed_def_packed(CFG), lambda: tmcl.puffer_def_packed(CFG),
    lambda: tmcl.corner_def_packed(CFG), lambda: tmcl.morpho_def_packed(CFG),
    lambda: tmcl.prediction_def_packed(CFG)])
def test_packed_def_on_the_dense_stack_raises(make):
    stack = tmcl.WrapperStack(CFG, [make()])
    state = stack.init(torch.Generator().manual_seed(0), rules.LIFE, torch.device("cpu"))
    with pytest.raises(ValueError, match="packed stack"):
        stack.step(state, torch.zeros(CFG.action_shape))
