"""carle_tpu_torch across processes: one mesh over two spawned gloo
processes of 4 ``cpu`` slots each (parallel/distributed.py's launcher,
``file://`` rendezvous under ``tmp_path``), the counterpart of
tests/test_parallel.py::test_multiprocess_mesh_rollout.

One spawn runs tests/_torch_multiprocess_worker.py in both processes: the
three legs of tests/_multiprocess_worker.py at its sizes (the RND2D rollout
sharded over ``env``; ``spatial_multi_step`` with its ghost rows crossing the
process boundary; the packed stack with RND2D on the ``space`` mesh), the
packed stack with RND2D and AE2D on the row shards themselves
(``SpaceSharding``: the nets' halo rows cross processes forward and
backward), Speed and Puffer at 2 instances on a mesh of one slot a
process, the master reset's three cases, the learners' parameters after
their updates, and ``train(mesh=True)`` (uint8 and packed).  Each is held
against the port's one-controller 8-slot mesh in this process (grids bit for
bit, rewards rtol 1e-6, ``train``'s histories rtol 1e-5 as
tests/test_drivers.py's), leg 1's total with the learner and actions from
numpy seeds (dropout off) also against ``carle_tpu``'s single-device run
(1e-4, the JAX worker's bound).  A second spawn checks the launcher's
failure path.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_multiprocess_worker as worker
import carle_tpu.mcl as jmcl
from carle_tpu import EnvConfig as JEnvConfig
from carle_tpu import rules as jrules
from carle_tpu.checkpoint import _path_str
from carle_tpu.ops.ca import ca_step_grid
from carle_tpu.rollout import Rollout as JRollout

from carle_tpu_torch.checkpoint import learner_state_from_numpy
from carle_tpu_torch.parallel import distributed, make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SPAWN_TIMEOUT = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores, and
    torch's default of a thread a core in every worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_leg1(rng):
    """carle_tpu's single-device leg 1 with dropout off, the learner from
    numpy: (flat learner state, actions, total reward)."""
    jcfg = JEnvConfig(height=32, width=32, action_height=8, action_width=8, instances=8)
    jro = JRollout(jcfg, [jmcl.rnd2d_def(jcfg, batch_size=2, dropout=False)])
    js = jro.init(jax.random.PRNGKey(0), jrules.LIFE).stack.wrappers[0]
    leaves = jax.tree_util.tree_flatten_with_path(js)[0]
    flat = {_path_str(p): (rng.randn(*np.shape(v)).astype(np.float32) * 0.3
                           if _path_str(p).startswith(("params/", "target_params/"))
                           else np.array(v)) for p, v in leaves}
    js = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(js),
                                      [jnp.asarray(flat[_path_str(p)]) for p, _ in leaves])
    actions = (rng.rand(4, 8, 8, 8) < 0.2).astype(np.uint8)
    jcarry = jro.init(jax.random.PRNGKey(0), jrules.LIFE)
    jcarry = jcarry._replace(stack=jcarry.stack._replace(wrappers=(js,)))
    _, rewards = jro.run_actions(jcarry, jnp.asarray(actions))
    return flat, actions, float(jnp.sum(rewards))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The spawn: (its output directory, each rank's arrays and scalars, the
    inputs, carle_tpu's leg-1 total)."""
    out = str(tmp_path_factory.mktemp("mp"))
    rng = np.random.RandomState(7)
    flat, actions, jax_total = _jax_leg1(rng)
    grid2 = (rng.rand(1, 32, 64) < 0.3).astype(np.uint8)
    np.savez(os.path.join(out, "inputs.npz"), actions=actions, grid2=grid2,
             **{"learner/" + k: v for k, v in flat.items()})
    distributed.launch(os.path.join(ROOT, "tests", "_torch_multiprocess_worker.py") + ":main",
                       2, [out], slots_per_process=4, device="cpu", timeout=SPAWN_TIMEOUT,
                       env={"OMP_NUM_THREADS": "1"}, workdir=out)
    ranks = [(dict(np.load(os.path.join(out, f"rank{r}.npz"))),
              json.load(open(os.path.join(out, f"rank{r}.json")))) for r in range(2)]
    return out, ranks, dict(flat=flat, actions=actions, grid2=grid2), jax_total


def _meshes():
    return make_mesh([CPU] * 8, "env"), make_mesh([CPU] * 8, "space")


def test_launcher_spans_one_mesh(run):
    """make_mesh() under the group spans both processes' slots, in process
    order."""
    for _, meta in run[1]:
        assert meta["mesh"] == ("Mesh(['cpu', 'cpu', 'cpu', 'cpu', 'cpu', 'cpu', 'cpu', 'cpu'], "
                                "('env',), owners=(0, 0, 0, 0, 1, 1, 1, 1))")


def test_sharded_rollout_matches_one_controller(run):
    """Leg 1: RND2D (batch 2, dropout on) with the random agent, 8 universes
    of 32², 4 steps, sharded over both processes: the universe bit for bit,
    rewards rtol 1e-6 of the one-controller mesh (the agent and the plain
    dropout draw the whole batch on every process); the parameters after the
    2 updates equal bit for bit on both processes."""
    mesh, _ = _meshes()
    rewards, grid, learner = worker.leg1_random(mesh)
    assert int(learner.updates) == 2
    for arrays, meta in run[1]:
        np.testing.assert_array_equal(arrays["g1"], grid.numpy())
        np.testing.assert_allclose(arrays["r1"], rewards.numpy(), rtol=1e-6, atol=0)
        assert meta["updates"] == 2
        assert len(set(meta["checksums"])) == 1


def test_sharded_rollout_total_matches_carle_tpu(run):
    """Leg 1 with the learner and the action stream from numpy (dropout off):
    rewards rtol 1e-6 of the one-controller mesh, the total within 1e-4 of
    carle_tpu's single-device run."""
    mesh, _ = _meshes()
    inputs, jax_total = run[2], run[3]
    want = worker.leg1_actions(mesh, learner_state_from_numpy(inputs["flat"], "cpu"),
                               torch.from_numpy(inputs["actions"])).numpy()
    for arrays, _ in run[1]:
        np.testing.assert_allclose(arrays["r1b"], want, rtol=1e-6, atol=0)
        total = float(arrays["r1b"].sum())
        assert abs(total - jax_total) < 1e-4 * max(1.0, abs(jax_total))


def test_spatial_ghost_rows_cross_processes(run):
    """Leg 2: one universe of 32 x 64, 4 rows a slot, 5 generations: bit for
    bit the one-controller mesh and carle_tpu's full-grid oracle."""
    _, smesh = _meshes()
    grid2 = run[2]["grid2"]
    want = worker.leg2(smesh, torch.from_numpy(grid2)).numpy()
    ref = jnp.asarray(grid2)
    for _ in range(5):
        ref = ca_step_grid(ref, jrules.LIFE)
    np.testing.assert_array_equal(want, np.asarray(ref))
    for arrays, _ in run[1]:
        np.testing.assert_array_equal(arrays["g2"], want)


def test_packed_stack_across_processes(run):
    """Leg 3: the packed stack with RND2D (batch 2) on the space mesh, 2
    universes of 32 x 64, 6 steps: ghost words and the wrapper's gathers
    cross processes; grid bit for bit, rewards rtol 1e-6."""
    _, smesh = _meshes()
    grid, rewards = worker.leg3(smesh)
    for arrays, _ in run[1]:
        np.testing.assert_array_equal(arrays["g3"], grid.numpy())
        np.testing.assert_allclose(arrays["r3"], rewards.numpy(), rtol=1e-6, atol=0)


def test_space_sharded_nets_across_processes(run):
    """RND2D and AE2D on the packed row shards (SpaceSharding, dropout on),
    128 x 64, 4 steps: the nets' halo rows and the error sums cross
    processes; grid bit for bit, rewards rtol 1e-6."""
    _, smesh = _meshes()
    grid, rewards = worker.leg4(smesh)
    for arrays, _ in run[1]:
        np.testing.assert_array_equal(arrays["g4"], grid.numpy())
        np.testing.assert_allclose(arrays["r4"], rewards.numpy(), rtol=1e-6, atol=0)


def test_env_space_mesh_across_processes(run):
    """The uint8 env mode on a 2 x 4 env x space mesh, rings spanning both
    processes and rings of one process each (4 universes of 64², Speed and
    Puffer batch-global, RND2D learning, 6 steps): grid bit for bit and
    rewards rtol 1e-6 of the one-controller 2 x 4 mesh."""
    from carle_tpu_torch.parallel import Mesh

    grid, rewards = worker.leg5(Mesh([[CPU] * 4] * 2, ("env", "space")))
    for arrays, _ in run[1]:
        for g, r in (("g5", "r5"), ("g6", "r6")):
            np.testing.assert_array_equal(arrays[g], grid.numpy())
            np.testing.assert_allclose(arrays[r], rewards.numpy(), rtol=1e-6, atol=0)


def test_speed_and_puffer_at_two_instances_across_processes(run):
    """Speed (batch-global and per instance) and Puffer (per instance) on 2
    universes of 32², one a process, the carry sharded after 12 steps (Speed's
    centre of mass nonzero): its [2, instances] centre of mass is not cut to one
    process's rows although its first dimension equals the instances; the
    4 steps after, grid bit for bit and rewards rtol 1e-6 of the
    one-controller 2-slot mesh."""
    grid, rewards = worker.leg7(make_mesh([CPU] * 2, "env"))
    assert float(rewards.abs().sum()) > 0
    for arrays, _ in run[1]:
        np.testing.assert_array_equal(arrays["g7"], grid.numpy())
        np.testing.assert_allclose(arrays["r7"], rewards.numpy(), rtol=1e-6, atol=0)


def test_master_reset_is_global_across_processes(run):
    """All ones on both processes fires (every universe cleared); all ones on
    process 0 alone does not; all 2.0 does not."""
    for _, meta in run[1]:
        assert meta["resets"] == [[True, True], [False, False], [False, False]]


def test_train_under_group_matches_one_controller(run, monkeypatch, tmp_path):
    """train(mesh=True) under the group (16 universes of 64², 4 steps, batch
    2, the learners' dropout off by patching the defs train builds; RND2D's
    dense weight [16, 64] stays whole on both processes), uint8
    and packed, against the one-controller 8-slot mesh: histories rtol 1e-5;
    three all_reduce a step (the reset flag, the two learners' gradients)
    and one for the rewards, no ghost rows (rings of one slot)."""
    import functools

    from carle_tpu_torch import train_mcl

    monkeypatch.setattr(train_mcl, "rnd2d_def",
                        functools.partial(train_mcl.rnd2d_def, dropout=False))
    monkeypatch.setattr(train_mcl, "ae2d_def", functools.partial(train_mcl.ae2d_def,
                                                                 dropout=False))
    kw = dict(instances=16, steps=(1, 4), rules=[[[3], [2, 3]]], height=64, width=64,
              batch_size=2, seed=0, device="cpu")
    want = train_mcl.train(log_dir=str(tmp_path / "a"), mesh=_meshes()[0], **kw)
    want_packed = train_mcl.train(log_dir=str(tmp_path / "b"), mesh=_meshes()[0],
                                  packed_state=True, **kw)
    for arrays, meta in run[1]:
        np.testing.assert_allclose(arrays["hist"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(arrays["hist_packed"], want_packed, rtol=1e-5, atol=1e-6)
        stats = meta["train_stats"]
        assert (stats["all_reduce"], stats["exchanges"]) == (3 * 4 + 1, 0)


def test_process_zero_alone_writes(run):
    """Process 0 writes the checkpoints and metrics; process 1 writes
    nothing."""
    out = run[0]
    models = os.listdir(os.path.join(out, "train0", "models"))
    assert sorted(n.split("_")[0] for n in models) == ["AE2D", "RND2D"]
    assert os.listdir(os.path.join(out, "train0", "metrics"))
    assert not os.path.exists(os.path.join(out, "train1"))


def test_initialize_refuses_several_cards_a_process(tmp_path):
    """Under a group of several processes a process's slots lie on one card:
    slots of two cards raise before the rendezvous."""
    with pytest.raises(ValueError, match="one card"):
        distributed.initialize("file://" + str(tmp_path / "rendezvous"), 2, 0,
                               local_devices=["cuda:0", "cuda:1"])
    assert not distributed.is_initialized()


def test_launcher_fails_with_the_failing_childs_lines(tmp_path):
    """A child that raises: the launcher kills the other and exits non-zero
    with the failing child's last lines."""
    target = os.path.join(ROOT, "tests", "_torch_multiprocess_worker.py") + ":fail"
    proc = subprocess.run([sys.executable, "-m", "carle_tpu_torch.parallel.distributed",
                           "--nprocs", "2", "--device", "cpu", "--timeout",
                           str(SPAWN_TIMEOUT), target], cwd=ROOT, capture_output=True,
                          text=True, timeout=SPAWN_TIMEOUT + 30,
                          env=dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path)))
    assert proc.returncode != 0
    assert "process 1 exited with 1" in proc.stderr
    assert "process 1 fails on purpose" in proc.stderr
