"""The port's ``carle`` facade (carle_tpu_torch.compat) against carle_tpu's.

Both packages alias ``carle``, so each facade runs in a subprocess of its
own: one reference-style script (``FACADE_SCRIPT``) runs under
``carle_tpu.compat`` (JAX on the CPU) and then under
``carle_tpu_torch.compat`` installed with ``device="cpu"``, on one numpy
action stream (a glider, then random toggles, on 2 universes of 128²):

* ``CARLE`` alone: observations bit for bit, and both sides return torch
  tensors on the host from ``reset`` and ``step``;
* ``PufferDetector(SpeedDetector(CARLE()))``: rewards within rtol 1e-5;
* the reference's stack ``PufferDetector(SpeedDetector(AE2D(RND2D(CARLE()))))``
  with dropout off and batch_size 4 (three Adam updates a learner in 12
  steps), the port's learners starting from the JAX shells' weights
  (``checkpoint.learner_state_from_numpy``): observations bit for bit,
  rewards within rtol 2e-3 (Adam divides by the gradient's own scale, as in
  tests/test_torch_wrappers.py);
* the pattern helpers bit for bit.

In-process: ``install``/``uninstall`` round trips, a module displaced by
``install`` is given back as the same object, installing carle_tpu's facade
and then the port's and uninstalling the port's gives back carle_tpu's
aliases, and ``sys.modules`` is left exactly as found (JAX-side test files
share module state).  The trainer through the facade mirrors
tests/test_compat.py's cases.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 12

FACADE_SCRIPT = r"""
import json, sys
import numpy as np
side, out, weights = sys.argv[1], sys.argv[2], sys.argv[3]
if side == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import carle_tpu.compat as compat
    compat.install()
else:
    import torch
    torch.set_num_threads(1)
    import carle_tpu_torch.compat as compat
    compat.install(device="cpu")
import torch
from carle.env import CARLE
from carle.mcl import (AE2D, RND2D, PufferDetector, SpeedDetector, get_glider,
                       get_morley_puffer, get_symmetric_action)

SIZE, INSTANCES, STEPS = 128, 2, %d
rng = np.random.RandomState(0)
actions = [np.broadcast_to(get_glider().numpy(), (INSTANCES, 1, 64, 64)).copy()]
actions += [(rng.rand(INSTANCES, 1, 64, 64) < 0.05).astype(np.float32) for _ in range(STEPS - 1)]
result, kinds = {}, set()


def host(x):
    kinds.add((type(x).__name__, str(x.device)))
    return x.numpy()


def drive(env, tag):
    result[tag + "_reset"] = host(env.reset())
    for t, a in enumerate(actions):
        obs, reward, done, info = env.step(torch.from_numpy(a))
        result[f"{tag}_obs{t}"] = host(obs)
        result[f"{tag}_reward{t}"] = host(reward)
        host(done)


def make(**kw):
    return CARLE(height=SIZE, width=SIZE, instances=INSTANCES, **kw)


drive(make(), "carle")
drive(PufferDetector(SpeedDetector(make())), "stats")
rnd = RND2D(make(), dropout=False, batch_size=4, seed=1)
ae = AE2D(rnd, dropout=False, batch_size=4, seed=2)
if side == "jax":
    from carle_tpu.checkpoint import _path_str
    flat = {}
    for name, shell in (("rnd", rnd), ("ae", ae)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shell._wstate)[0]:
            flat[name + "/" + _path_str(path)] = np.array(leaf)
    np.savez(weights, **flat)
else:
    from carle_tpu_torch.checkpoint import learner_state_from_numpy
    stored = np.load(weights)
    for name, shell in (("rnd", rnd), ("ae", ae)):
        flat = {k.split("/", 1)[1]: stored[k] for k in stored.files if k.startswith(name + "/")}
        shell._wstate = learner_state_from_numpy(flat, "cpu")
drive(PufferDetector(SpeedDetector(ae)), "learners")
result["updates"] = np.array([int(rnd._wstate.updates), int(ae._wstate.updates)])
for name, fn in (("glider", get_glider), ("puffer", get_morley_puffer),
                 ("symmetric", lambda: get_symmetric_action(seed=3))):
    result["pattern_" + name] = host(fn())
np.savez(out, **result)
print(json.dumps({"kinds": sorted(kinds)}))
""" % STEPS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def facades(tmp_path_factory):
    """(JAX facade's results, port facade's results, the kinds each returned)."""
    import json

    tmp = tmp_path_factory.mktemp("facades")
    weights = str(tmp / "weights.npz")
    results, kinds = {}, {}
    for side in ("jax", "port"):   # the JAX side writes the learners' weights first
        out = str(tmp / f"{side}.npz")
        env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
        proc = subprocess.run([sys.executable, "-c", FACADE_SCRIPT, side, out, weights],
                              cwd=str(tmp), capture_output=True, text=True, timeout=600,
                              env=env)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        kinds[side] = json.loads(proc.stdout.strip().splitlines()[-1])["kinds"]
        with np.load(out) as f:
            results[side] = {k: f[k] for k in f.files}
    return results["jax"], results["port"], kinds


def _keys(results, prefix):
    return [k for k in results if k.startswith(prefix)]


def test_both_facades_return_host_torch_tensors(facades):
    jax_side, port, kinds = facades
    assert kinds["jax"] == kinds["port"] == [["Tensor", "cpu"]]
    assert set(jax_side) == set(port)


def test_carle_observations_bit_for_bit(facades):
    jax_side, port, _ = facades
    keys = _keys(port, "carle_")
    assert len(keys) == 2 * STEPS + 1
    for k in keys:
        np.testing.assert_array_equal(port[k], jax_side[k], err_msg=k)
    assert port["carle_obs0"].sum() > 0   # the glider is in the universe


def test_speed_and_puffer_rewards(facades):
    jax_side, port, _ = facades
    for k in _keys(port, "stats_"):
        if "reward" in k:
            np.testing.assert_allclose(port[k], jax_side[k], rtol=1e-5, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(port[k], jax_side[k], err_msg=k)


def test_reference_stack_with_carried_weights(facades):
    jax_side, port, _ = facades
    np.testing.assert_array_equal(port["updates"], jax_side["updates"])
    assert list(port["updates"]) == [STEPS // 4] * 2
    for k in _keys(port, "learners_"):
        if "reward" in k:
            np.testing.assert_allclose(port[k], jax_side[k], rtol=2e-3, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(port[k], jax_side[k], err_msg=k)


def test_pattern_helpers_bit_for_bit(facades):
    jax_side, port, _ = facades
    for name in ("glider", "puffer", "symmetric"):
        np.testing.assert_array_equal(port["pattern_" + name], jax_side["pattern_" + name])


# ---------------------------------------------------------------------------
# install / uninstall in process
# ---------------------------------------------------------------------------


def _carle_modules():
    return {k: v for k, v in sys.modules.items() if k == "carle" or k.startswith("carle.")}


@pytest.fixture
def as_found():
    """Fails the test unless it leaves the ``carle`` entries of sys.modules
    as it found them; restores them either way."""
    before = _carle_modules()
    yield
    after = _carle_modules()
    for k in set(after) - set(before):
        del sys.modules[k]
    sys.modules.update(before)
    assert after.keys() == before.keys() and all(after[k] is before[k] for k in before)


def test_install_uninstall_round_trip(as_found):
    import carle_tpu_torch.compat as compat

    compat.install(device="cpu")
    try:
        import carle

        assert carle is compat
        from carle.env import CARLE as FacadeCARLE
        from carle.mcl import RND2D as FacadeRND2D
        from carle_tpu_torch.compat.env import CARLE as DirectCARLE
        from carle_tpu_torch.compat.mcl import RND2D as DirectRND2D

        assert FacadeCARLE is DirectCARLE and FacadeRND2D is DirectRND2D
        assert sys.modules["carle.train_mcl"] is compat.train_mcl
        assert FacadeCARLE(height=64, width=64).device == torch.device("cpu")
    finally:
        compat.uninstall()
    assert "carle" not in sys.modules or sys.modules["carle"] is not compat
    assert compat.env.DEVICE is None


def test_displaced_module_is_given_back_as_the_same_object(as_found):
    import carle_tpu_torch.compat as compat

    fake, fake_env = types.ModuleType("carle"), types.ModuleType("carle.env")
    sys.modules["carle"], sys.modules["carle.env"] = fake, fake_env
    try:
        compat.install(device="cpu")
        assert sys.modules["carle"] is compat
        compat.uninstall()
        assert sys.modules["carle"] is fake and sys.modules["carle.env"] is fake_env
        assert "carle.mcl" not in sys.modules
    finally:
        for name in ("carle", "carle.env"):
            sys.modules.pop(name, None)


def test_port_facade_over_jax_facade_gives_back_jaxs_aliases(as_found):
    import carle_tpu.compat as jcompat
    import carle_tpu_torch.compat as compat

    jcompat.install()
    try:
        jaliases = _carle_modules()
        compat.install(device="cpu")
        try:
            assert sys.modules["carle"] is compat
        finally:
            compat.uninstall()
        after = _carle_modules()
        assert after.keys() == jaliases.keys()
        assert all(after[k] is jaliases[k] for k in jaliases)
        assert sys.modules["carle"] is jcompat
    finally:
        jcompat.uninstall()


def test_facade_without_a_card_raises_unless_asked_for_the_cpu(as_found):
    import carle_tpu_torch.compat as compat

    if torch.cuda.is_available():
        pytest.skip("a card is present: the facade's default is valid")
    compat.install()
    try:
        from carle.env import CARLE

        with pytest.raises(Exception, match="(?i)cuda"):
            CARLE(height=64, width=64)
        assert CARLE(height=64, width=64, device="cpu").device.type == "cpu"
    finally:
        compat.uninstall()


# ---------------------------------------------------------------------------
# The trainer through the facade (tests/test_compat.py's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("agent", ["RandomAgent", "RandomNetworkAgent"])
def test_train_facade_takes_reference_agent_classes(tmp_path, as_found, agent):
    """``carle.train_mcl.train(AgentClass, ...)`` at 64²: the network agent
    sizes its dense layer from the observation dims, so all four must pass."""
    import carle_tpu_torch.compat as compat

    compat.install(device="cpu")
    try:
        from carle import agents
        from carle.train_mcl import train

        hist = train(getattr(agents, agent), 2, [1, 4], [[[3], [2, 3]]], None, 64, 64, 4,
                     log_dir=str(tmp_path), mesh=False)
        assert np.asarray(hist).shape == (4,) and np.isfinite(hist).all()
        action = getattr(agents, agent)(observation_width=64, observation_height=64)(
            torch.zeros(1, 1, 64, 64))
        assert action.device.type == "cpu" and tuple(action.shape) == (1, 1, 64, 64)
    finally:
        compat.uninstall()
