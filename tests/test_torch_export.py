"""carle_tpu_torch vs carle_tpu: torch weight interchange on the CPU.

The reference's torch checkpoints of a shell stack (``state_dict``,
``mcl/export.py``) against ``carle_tpu.mcl.export``: the same keys in the same
order (``inner_env.*`` and ``env.*`` at every level, the Sequential indices)
and the same values, bit for bit.  ``.pt`` files written by
``carle_tpu.mcl.export`` load into the port's shells, its scoring battery and
``inject_wrapper_checkpoints``, and give JAX's bonuses within rtol 1e-4 /
atol 1e-5 on one numpy action stream (the frozen stack's float32 sums in
other orders).  The protocol's geometry (256², 64² actions) with the shipped
``.npz`` learner states, except where a test says otherwise.
"""

import functools
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import carle_tpu
from carle_tpu import mcl as jmcl
from carle_tpu.checkpoint import _path_str
from carle_tpu.checkpoint import checkpoint_meta as jcheckpoint_meta
from carle_tpu.evaluation import eval as jeval
from carle_tpu.mcl import export as jexport

from carle_tpu_torch import CARLE, EnvConfig
from carle_tpu_torch import mcl as tmcl
from carle_tpu_torch.checkpoint import (checkpoint_meta, flatten, learner_state_from_numpy,
                                        save_pytree)
from carle_tpu_torch.evaluation import eval as teval
from carle_tpu_torch.mcl import export

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them
    (the 256² twins here ran 10-40x slower under that load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHIPPED = {"RND2D": teval._HERE + "/RND2D_mcl.npz", "AE2D": teval._HERE + "/AE2D_mcl.npz"}
ACTS = (np.random.RandomState(1).rand(3, 1, 1, 64, 64) < 0.1).astype(np.float32)
LEARNERS = ("RND2D", "AE2D", "PredictionBonus", "SurpriseBonus")


def _flat_numpy(tree):
    return {_path_str(p): np.array(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _built():
    """The JAX shells take seconds to build, so each stack is built once."""
    port, jx = tmcl.RND2D(CARLE(device="cpu"), seed=0), jmcl.RND2D(carle_tpu.CARLE(), seed=0)
    teval._load_wrapper_checkpoint(port, SHIPPED["RND2D"])
    jeval._load_wrapper_checkpoint(jx, SHIPPED["RND2D"])
    stacks = {"rnd2d": (port, jx)}
    port, jx = tmcl.AE2D(port, seed=1), jmcl.AE2D(jx, seed=1)
    teval._load_wrapper_checkpoint(port, SHIPPED["AE2D"])
    jeval._load_wrapper_checkpoint(jx, SHIPPED["AE2D"])
    stacks["ae2d_over_rnd2d"] = (port, jx)
    return stacks


def _stacks(kind):
    """(port, JAX) shell stacks over CARLE at 256² with the shipped learner
    states loaded into both: RND2D, or AE2D over that RND2D.  Read only."""
    return _built()[kind]


def _assert_same_state_dict(got, want):
    assert list(got) == list(want)   # the keys, in order
    for key in want:
        value = got[key]
        assert value.dtype == torch.float32 and value.device.type == "cpu", key
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("kind", ["rnd2d", "ae2d_over_rnd2d"])
def test_state_dict_matches_jax_to_state_dict(kind):
    port, jx = _stacks(kind)
    got = port.state_dict()
    _assert_same_state_dict(got, jexport.to_state_dict(jx))
    assert got["inner_env.neighborhood.weight"].shape == (1, 1, 3, 3)
    if kind == "ae2d_over_rnd2d":
        assert "env.predictor.11.weight" in got and "predictor.11.weight" in got
        assert "env.env.neighborhood.weight" in got
    as_numpy = export.to_state_dict(port, torch_tensors=False)
    assert list(as_numpy) == list(got)
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32 for v in as_numpy.values())


def _random_learner(kind, seed):
    """(port, JAX) learner states of ``kind`` at 64², the JAX one's net
    parameters drawn from numpy and carried to the port."""
    jcfg = carle_tpu.EnvConfig(height=64, width=64, action_height=16, action_width=16)
    jdef = jmcl.rnd2d_def if kind == "RND2D" else jmcl.ae2d_def
    jstate = jdef(jcfg).init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    draw = lambda p: jax.tree.map(   # noqa: E731
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), p)
    jstate = jstate._replace(params=draw(jstate.params),
                             target_params=draw(jstate.target_params))
    return learner_state_from_numpy(_flat_numpy(jstate), "cpu"), jstate


@pytest.mark.parametrize("kind", LEARNERS)
def test_learner_state_to_state_dict_matches_jax(kind):
    tstate, jstate = _random_learner(kind, LEARNERS.index(kind))
    target = tstate.target_params if kind == "RND2D" else None
    got = export.learner_state_to_state_dict(kind, tstate.params, target)
    want = jexport.learner_state_to_state_dict(
        kind, jstate.params, jstate.target_params if kind == "RND2D" else None)
    _assert_same_state_dict(got, want)
    as_numpy = export.learner_state_to_state_dict(kind, tstate.params, target,
                                                  torch_tensors=False)
    for key, value in want.items():
        np.testing.assert_array_equal(as_numpy[key], value.numpy())


def test_learner_state_to_state_dict_refuses_as_jax_does():
    tstate, jstate = _random_learner("RND2D", 0)
    for fn, params in ((export.learner_state_to_state_dict, tstate.params),
                       (jexport.learner_state_to_state_dict, jstate.params)):
        with pytest.raises(ValueError, match="target_params"):
            fn("RND2D", params)
        with pytest.raises(ValueError, match="no torch checkpoint layout"):
            fn("CornerBonus", params)


def test_jax_pt_loads_into_port_shells_and_gives_jax_bonuses(tmp_path):
    paths = {}
    for kind, name in (("rnd2d", "RND2D"), ("ae2d_over_rnd2d", "AE2D")):
        port, jx = _stacks(kind)
        paths[name] = str(tmp_path / f"{name}.pt")
        jexport.save_torch_checkpoint(paths[name], jx)
        # a fresh port shell takes the .pt and holds the JAX shell's weights
        fresh = getattr(tmcl, name)(CARLE(device="cpu"), seed=7)
        fresh.load_state_dict(torch.load(paths[name], weights_only=True))
        for key, leaf in flatten(fresh._wstate.params).items():
            np.testing.assert_array_equal(leaf.numpy(), _flat_numpy(jx._wstate.params)[key])
        assert fresh._wstate.params["conv1"]["w"].device.type == "cpu"

    class Replay:
        def __init__(self, **kwargs):
            self.i = 0

        def __call__(self, obs):
            self.i += 1
            return ACTS[self.i - 1]

    rules = [[[3], [2, 3]]]
    tspecs = [[tmcl.RND2D, 1.0, paths["RND2D"]], [tmcl.AE2D, 1.0, paths["AE2D"]],
              [tmcl.SpeedDetector, 1e-2, None], [tmcl.PufferDetector, 1e-3, None]]
    jspecs = [[jmcl.RND2D, 1.0, paths["RND2D"]], [jmcl.AE2D, 1.0, paths["AE2D"]],
              [jmcl.SpeedDetector, 1e-2, None], [jmcl.PufferDetector, 1e-3, None]]
    _, trace = teval.evaluate(Replay, rules, tspecs, steps=3, verbose=False, device="cpu")
    _, want = jeval.evaluate(Replay, rules, jspecs, steps=3, verbose=False)
    np.testing.assert_allclose(np.asarray(trace), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert min(trace) > 0.0
    # the fused battery takes the same .pt specs
    _, fused = teval.evaluate_fused(Agent=None, rules=rules, wrappers=tspecs, steps=3,
                                    verbose=False, device="cpu")
    assert fused.shape == (3,) and np.isfinite(fused).all()


def test_inject_wrapper_checkpoints_takes_pt_for_every_learner(tmp_path):
    cfg = EnvConfig(64, 64, 16, 16, 1)
    jcfg = carle_tpu.EnvConfig(height=64, width=64, action_height=16, action_width=16)
    tspecs, jspecs = [], []
    for i, kind in enumerate(LEARNERS):
        _, jstate = _random_learner(kind, 10 + i)
        path = str(tmp_path / f"{kind}.pt")
        torch.save(jexport.learner_state_to_state_dict(kind, jstate.params,
                                                       jstate.target_params or None), path)
        tspecs.append([getattr(tmcl, kind), 0.5, path])
        jspecs.append([getattr(jmcl, kind), 0.5, path])
    tstates = tuple(d.init(torch.Generator().manual_seed(0), torch.device("cpu"))
                    for d in teval.wrapper_defs(cfg, tspecs, False))
    factory = jeval._fused_wrapper_factory(jcfg)
    jstates = tuple(factory[cls](s).init(jax.random.PRNGKey(0)) for cls, s, _ in jspecs)
    got = teval.inject_wrapper_checkpoints(tstates, tspecs)
    want = jeval.inject_wrapper_checkpoints(jstates, jspecs)
    for kind, g, w in zip(LEARNERS, got, want):
        for part in ("params", "target_params"):
            wflat = _flat_numpy(getattr(w, part))
            gflat = flatten(getattr(g, part)) if getattr(g, part) else {}
            assert set(gflat) == set(wflat), (kind, part)
            for key in wflat:
                np.testing.assert_array_equal(gflat[key].numpy(), wflat[key], err_msg=key)
        assert float(g.reward_scale) == 0.5
    # the shells take the same files: Prediction and Surprise through AE2D's
    for kind, (_, _, path) in zip(LEARNERS, tspecs):
        shell = getattr(tmcl, kind)(CARLE(device="cpu", height=64, width=64,
                                          action_height=16, action_width=16))
        teval._load_wrapper_checkpoint(shell, path)
        want_params = _flat_numpy(want[LEARNERS.index(kind)].params)
        for key, leaf in flatten(shell._wstate.params).items():
            np.testing.assert_array_equal(leaf.numpy(), want_params[key], err_msg=key)
    # a statistic wrapper has nothing to load a .pt into
    for cls in (tmcl.SpeedDetector, tmcl.CornerBonus):
        specs = [[cls, 1.0, tspecs[0][2]]]
        states = tuple(d.init(torch.Generator(), torch.device("cpu"))
                       for d in teval.wrapper_defs(cfg, specs, False))
        with pytest.raises(ValueError):
            teval.inject_wrapper_checkpoints(states, specs)


def test_torch_checkpoint_round_trip_within_the_port(tmp_path):
    port, _ = _stacks("ae2d_over_rnd2d")
    path = str(tmp_path / "stack.pt")
    tmcl.save_torch_checkpoint(path, port)
    sd = torch.load(path, weights_only=True)
    inner = tmcl.RND2D(CARLE(device="cpu"), seed=3)
    fresh = tmcl.AE2D(inner, seed=4)
    fresh.load_state_dict(sd)
    inner.load_state_dict({k[len("env."):]: v for k, v in sd.items() if k.startswith("env.")})
    _assert_same_state_dict(fresh.state_dict(), port.state_dict())


def test_checkpoint_meta_matches_jax(tmp_path):
    tstate, _ = _random_learner("AE2D", 3)
    written = save_pytree(str(tmp_path / "port.npz"), tstate)
    bare = str(tmp_path / "bare.npz")
    np.savez(bare, x=np.zeros(3))
    for path in (SHIPPED["RND2D"], SHIPPED["AE2D"], written, bare):
        assert checkpoint_meta(path) == jcheckpoint_meta(path), os.path.basename(path)
    assert checkpoint_meta(written) == {"format_version": 1}
    assert checkpoint_meta(bare) == {"format_version": 0}
