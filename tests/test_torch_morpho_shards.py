"""carle_tpu_torch vs carle_tpu: packed Morpho on row shards.

``morpho_def_packed`` on a row-sharded packed stack: each slot computes
``prev ^ action`` on its rows padded below with the next slot's first
``dim - 1`` rows of its ring, the bit-sliced window counts on the padded
rows cropped to its own, the per-instance integer extremes over its VALID
anchors, combined over the slots by max and min before the one float
division (mcl/packed_stats.py).  On the port's 8-slot ``cpu`` mesh and on
its 2 x 4 env x space mesh, held bit for bit against the port's
``mesh=None`` packed stack, and against ``carle_tpu``'s packed and dense
defs through its packed spatial stack on the 8-device CPU mesh
(tests/test_packed_spatial.py's case, Parsimony composed after Morpho).
The edge cases: a bottom slot without a VALID anchor, and slots of fewer
than ``dim - 1`` rows (refused).

Inputs come from numpy seeds (RandomState(31), carle_tpu's own).
Tolerances: the port's sharded and unsharded bonuses bit for bit; against
carle_tpu rtol 1e-4 / atol 1e-4 (that test's bound: the dense def's float32
correlation rounds where the packed one is exact).
"""

import jax
import numpy as np
import pytest
import torch

import carle_tpu.mcl as jmcl
from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu import rules as jrules
from carle_tpu.parallel import PackedSpatialStack as JPackedSpatialStack
from carle_tpu.parallel import make_mesh as jmake_mesh
from carle_tpu.parallel import shard_carry_packed as jshard_carry_packed
from carle_tpu.rollout import Rollout as JRollout

from carle_tpu_torch import EnvConfig, rules
from carle_tpu_torch import mcl as tmcl
from carle_tpu_torch.parallel import PackedSpatialStack, make_mesh, shard_carry_packed
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

CPU = torch.device("cpu")
MESHES = {
    "8": lambda: (make_mesh([CPU] * 8, "space"), None),
    "2x4": lambda: (Mesh([[CPU] * 4] * 2, ("env", "space")), "env"),
}
_JAX = {}


def _actions(cfg):
    """RandomState(31) toggles with a heavy step, so that Parsimony's
    100 / max(sum, 100) takes both sides (test_packed_spatial.py)."""
    rng = np.random.RandomState(31)
    ah, aw = cfg.action_height, cfg.action_width
    actions = (rng.rand(5, cfg.instances, ah, aw) < 0.1).astype(np.uint8)
    actions[3] = (rng.rand(cfg.instances, ah, aw) < 0.5).astype(np.uint8)
    return actions


def _port(cfg, mesh_name, actions):
    """(rewards, universe, stack) of the port's packed Morpho + Parsimony
    stack on a mesh of MESHES, or with mesh=None."""
    mesh, env_axis = MESHES[mesh_name]() if mesh_name else (None, None)
    defs = [tmcl.morpho_def_packed(cfg, reward_scale=1.0), tmcl.parsimony_def_packed()]
    stack = PackedSpatialStack(cfg, defs, mesh, env_axis=env_axis)
    ro = Rollout(cfg, device="cpu", stack=stack)
    carry = ro.init(ro.generator(7), rules.LIFE)
    if mesh is not None:
        carry = shard_carry_packed(carry, mesh, cfg, env_axis=env_axis)
    carry, rewards = ro.run_actions(carry, torch.from_numpy(actions))
    return rewards, stack.universe(carry.stack), stack


def _jax(jcfg, actions, packed):
    """carle_tpu's rewards: packed or dense Morpho + Parsimony through its
    packed stack on the 8-device mesh, computed once a test run."""
    def run():
        defs = ([jmcl.morpho_def_packed(jcfg, reward_scale=1.0), jmcl.parsimony_def_packed()]
                if packed else [jmcl.morpho_def(jcfg, reward_scale=1.0), jmcl.parsimony_def()])
        mesh = jmake_mesh(jax.devices(), axis_name="space")
        ro = JRollout(jcfg, stack=JPackedSpatialStack(jcfg, defs, mesh))
        carry = jshard_carry_packed(ro.init(jax.random.PRNGKey(7), jrules.LIFE), mesh, jcfg)
        return np.asarray(ro.run_actions(carry, actions)[1])

    key = (jcfg.height, packed)
    if key not in _JAX:
        _JAX[key] = run()
    return _JAX[key]


@pytest.mark.parametrize("mesh_name", ["8", "2x4"])
def test_sharded_packed_morpho_matches_mesh_none_and_jax(mesh_name):
    """Packed Morpho + Parsimony at 128² on the 8-slot mesh and on 2 x 4:
    bit for bit the mesh=None packed stack; within 1e-4 carle_tpu's packed
    and dense results."""
    cfg = EnvConfig(128, 128, 32, 32, 2)
    jcfg = JEnvConfig(height=128, width=128, action_height=32, action_width=32, instances=2)
    actions = _actions(cfg)
    got, grid, stack = _port(cfg, mesh_name, actions)
    want, want_grid, _ = _port(cfg, None, actions)
    assert torch.equal(got, want) and torch.equal(grid, want_grid)
    assert stack.unpacks == 0 and stack.gathers == 0
    assert bool((got != 0).any())
    for packed in (True, False):
        np.testing.assert_allclose(got.numpy(), _jax(jcfg, actions, packed),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mesh_name", ["8", "2x4"])
def test_bottom_slot_without_valid_anchor(mesh_name):
    """56 rows over 8 slots (7 a slot: the bottom slot holds no VALID
    anchor and is skipped) and over 2 x 4 (14 a slot): bit for bit the
    mesh=None stack."""
    cfg = EnvConfig(56, 64, 16, 16, 2)
    actions = _actions(cfg)
    got, grid, stack = _port(cfg, mesh_name, actions)
    want, want_grid, _ = _port(cfg, None, actions)
    assert torch.equal(got, want) and torch.equal(grid, want_grid)
    assert bool((got != 0).any())


def test_slots_of_fewer_than_dim_minus_one_rows_are_refused():
    """48 rows over 8 slots leave 6 rows a slot: a window of 8 rows would
    need the rows of two slots below, so the def refuses, naming both."""
    cfg = EnvConfig(48, 64, 16, 16, 2)
    with pytest.raises(ValueError, match=r"6 rows a slot.*dim - 1 = 7"):
        _port(cfg, "8", _actions(cfg))
